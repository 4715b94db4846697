"""Host-side acoustic feature extraction for data preparation (a copy of
``e2e_tts_tpu/audio/features.py``): the f0 and pitch trackers, f0
quantisation, the IQR outlier filter, and the aligner's beta-binomial prior,
which an ``AcousticBatch`` carries as ``attn_prior``.

- ``extract_f0``      f0 per mel frame, 0 where unvoiced, padded/truncated
                      to exactly ``mel_len`` frames (YIN, or Praat's AC
                      method through parselmouth when that imports).
- ``extract_pitch``   f0 per frame with linear interpolation over unvoiced
                      regions (the in-framework DIO + StoneMask, or pyworld's
                      when that imports).

``backend="auto"`` resolves as in the JAX package: parselmouth and pyworld
when importable, else YIN for f0 and DIO + StoneMask for pitch;
``"praat"`` and ``"pyworld"`` raise ``ImportError`` without their library.
These run once per utterance at preparation time, in NumPy on the host (and
YIN's per-frame search in the port's C++ library, ``native/``).

A checkpoint trained on one f0 backend's statistics is served with the same
backend's statistics (``stats.json``): YIN and Praat's AC method differ in
voicing and octave decisions.
"""

from __future__ import annotations

import numpy as np

# f0 quantization constants (reference: src/tools/utils.py:15-19)
F0_BIN = 256
F0_MIN = 50.0
F0_MAX = 1100.0
F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)


def yin_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_length: int,
    fmin: float = 80.0,
    fmax: float = 750.0,
    frame_length: int = 2048,
    threshold: float = 0.2,
    use_native: bool = True,
) -> np.ndarray:
    """YIN fundamental-frequency track. Returns f0 per hop frame, 0=unvoiced.

    ``use_native=True`` runs the port's C++ library (``native/yin.cc``,
    built at first use) and raises if it cannot be built or loaded: unlike
    the JAX package, nothing swaps in the NumPy body unasked.  The NumPy
    body below is the plain version (``use_native=False``); the library
    agrees with it to float32 rounding (it reads the signal as float32 and
    sums the difference function directly, not by FFT).
    """
    if use_native:
        from ..native import native_yin_f0

        return native_yin_f0(audio, sample_rate, hop_length, fmin, fmax, frame_length,
                             threshold)
    audio = np.asarray(audio, dtype=np.float64)
    tau_min = max(2, int(sample_rate / fmax))
    tau_max = min(frame_length // 2, int(sample_rate / fmin) + 1)

    pad = frame_length // 2
    x = np.pad(audio, (pad, pad), mode="constant")
    n_frames = 1 + (len(x) - frame_length) // hop_length
    if n_frames <= 0:
        return np.zeros(0)

    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = x[idx]  # (n_frames, frame_length)

    # difference function via FFT autocorrelation:
    # d(tau) = sum_{j} (x_j - x_{j+tau})^2 over the first W/2 samples
    w = frame_length // 2
    a = frames[:, :w]
    # cumulative energy terms
    sq = frames**2
    cums = np.cumsum(sq, axis=1)
    e_a = cums[:, w - 1][:, None]  # energy of x[0:w]
    # energy of x[tau : tau+w] for each tau
    tail = np.concatenate([np.zeros((n_frames, 1)), cums], axis=1)
    e_tau = tail[:, w : w + tau_max] - tail[:, 0:tau_max]

    # cross term via FFT correlation of full frame with its first half
    nfft = 1 << int(np.ceil(np.log2(2 * frame_length)))
    fa = np.fft.rfft(frames, nfft, axis=1)
    fb = np.fft.rfft(a[:, ::-1], nfft, axis=1)
    corr = np.fft.irfft(fa * fb, nfft, axis=1)[:, w - 1 : w - 1 + tau_max]

    d = e_a + e_tau - 2 * corr  # (n_frames, tau_max)
    d = np.maximum(d, 0.0)

    # cumulative-mean-normalized difference
    taus = np.arange(1, tau_max)
    cmnd = np.ones_like(d)
    denom = np.cumsum(d[:, 1:], axis=1)
    cmnd[:, 1:] = d[:, 1:] * taus[None, :] / np.maximum(denom, 1e-12)

    f0 = np.zeros(n_frames)
    region = cmnd[:, tau_min:tau_max]
    below = region < threshold
    any_below = below.any(axis=1)
    first = np.where(any_below, below.argmax(axis=1), 0) + tau_min

    for i in range(n_frames):
        if not any_below[i]:
            continue
        tau = first[i]
        # descend to the local minimum following the first threshold crossing
        while tau + 1 < tau_max and cmnd[i, tau + 1] < cmnd[i, tau]:
            tau += 1
        # parabolic interpolation around the minimum
        if 1 <= tau < tau_max - 1:
            s0, s1, s2 = cmnd[i, tau - 1], cmnd[i, tau], cmnd[i, tau + 1]
            denom_p = 2 * (2 * s1 - s2 - s0)
            shift = (s2 - s0) / denom_p if abs(denom_p) > 1e-12 else 0.0
            tau_refined = tau + np.clip(shift, -1, 1)
        else:
            tau_refined = float(tau)
        f0[i] = sample_rate / tau_refined

    f0[(f0 < fmin) | (f0 > fmax)] = 0.0
    return f0


def ac_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_length: int,
    fmin: float = 80.0,
    fmax: float = 750.0,
    voicing_threshold: float = 0.45,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    jump_cost: float = 0.35,
    vuv_cost: float = 0.14,
    n_candidates: int = 4,
) -> np.ndarray:
    """Autocorrelation pitch in the style of Praat's AC method (Boersma
    1993): window-normalized autocorrelation -> per-frame pitch candidates
    with strengths -> Viterbi path with octave-jump and voicing-transition
    costs.  Returns f0 per hop frame, 0 = unvoiced.

    This is an in-framework *algorithmic* stand-in for the reference's
    parselmouth ``to_pitch_ac`` (reference src/tools/utils.py:46-78) when
    the library is absent — same method family, NOT bit-compatible (exact
    parity still requires parselmouth; see the module caveat above).
    """
    audio = np.asarray(audio, np.float64)
    # Boersma's AC window: 3 periods of the pitch floor, Hann-tapered
    N = int(3.0 * sample_rate / fmin)
    N += N % 2
    pad = N // 2
    x = np.pad(audio, (pad, pad))
    n_frames = 1 + (len(x) - N) // hop_length
    if n_frames <= 0:
        return np.zeros(0)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(N)[None, :]
    frames = x[idx] - x[idx].mean(axis=1, keepdims=True)

    glob_peak = np.abs(audio).max() + 1e-12
    local_peak = np.abs(frames).max(axis=1)

    lag_min = max(2, int(sample_rate / fmax))
    lag_max = min(N // 2, int(np.ceil(sample_rate / fmin)))

    # normalized autocorrelation of the windowed frame, divided by the
    # window's own autocorrelation (Boersma's r_x ~= r_xw / r_w trick)
    w = np.hanning(N)
    nfft = 1 << int(np.ceil(np.log2(2 * N)))
    fw = np.fft.rfft(frames * w, nfft, axis=1)
    r = np.fft.irfft(np.abs(fw) ** 2, nfft, axis=1)[:, : lag_max + 2]
    r /= np.maximum(r[:, :1], 1e-12)
    rw = np.fft.irfft(np.abs(np.fft.rfft(w, nfft)) ** 2, nfft)[: lag_max + 2]
    rw /= max(rw[0], 1e-12)
    rn = r / np.maximum(rw[None, :], 1e-3)

    # per-frame candidates: local maxima of rn in the lag range, parabolic
    # refinement, strength penalized slightly toward higher pitch to
    # counter AC's octave-down bias
    lags = np.arange(lag_min, lag_max)
    mid = rn[:, lag_min:lag_max]
    is_peak = (mid >= rn[:, lag_min - 1 : lag_max - 1]) & (
        mid > rn[:, lag_min + 1 : lag_max + 1]
    )
    cand_f = np.zeros((n_frames, n_candidates))  # 0 = the unvoiced slot
    cand_s = np.full((n_frames, n_candidates + 1), -np.inf)
    for t in range(n_frames):
        peaks = lags[is_peak[t]]
        if len(peaks):
            strengths = rn[t, peaks] - octave_cost * np.log2(peaks / lag_min)
            top = peaks[np.argsort(strengths)[::-1][:n_candidates]]
            for k, lag in enumerate(top):
                s0, s1, s2 = rn[t, lag - 1], rn[t, lag], rn[t, lag + 1]
                den = 2 * (2 * s1 - s0 - s2)
                shift = (s2 - s0) / den if abs(den) > 1e-12 else 0.0
                lag_ref = lag + np.clip(shift, -1, 1)
                cand_f[t, k] = sample_rate / lag_ref
                cand_s[t, k] = min(rn[t, lag], 1.0) - octave_cost * np.log2(
                    lag_ref / lag_min
                )
        # unvoiced candidate (Praat's silence/voicing tradeoff)
        rel = local_peak[t] / glob_peak
        cand_s[t, n_candidates] = voicing_threshold + max(
            0.0, 2.0 - rel / (silence_threshold / (1.0 + voicing_threshold))
        ) * 0.5
    cand_f = np.concatenate([cand_f, np.zeros((n_frames, 1))], axis=1)

    # Viterbi over (n_candidates + 1) states per frame
    K = n_candidates + 1
    score = cand_s[0].copy()
    back = np.zeros((n_frames, K), np.int64)
    for t in range(1, n_frames):
        f_prev, f_cur = cand_f[t - 1], cand_f[t]
        trans = np.zeros((K, K))
        for j in range(K):
            for k in range(K):
                pv, cv = f_prev[j] > 0, f_cur[k] > 0
                if pv and cv:
                    trans[j, k] = jump_cost * abs(
                        np.log2(f_prev[j] / f_cur[k])
                    )
                elif pv != cv:
                    trans[j, k] = vuv_cost
        total = score[:, None] - trans
        back[t] = np.argmax(total, axis=0)
        score = total[back[t], np.arange(K)] + cand_s[t]

    path = np.zeros(n_frames, np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(n_frames - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    f0 = cand_f[np.arange(n_frames), path]
    f0[(f0 < fmin) | (f0 > fmax)] = 0.0
    return f0


def _event_times(sig: np.ndarray) -> np.ndarray | None:
    """Negative-to-positive zero-crossing times (fractional samples) of
    ``sig``, linearly interpolated.  None when fewer than two events."""
    s0, s1 = sig[:-1], sig[1:]
    idx = np.nonzero((s0 < 0) & (s1 >= 0))[0]
    if len(idx) < 2:
        return None
    return idx + s0[idx] / (s0[idx] - s1[idx])


def _interval_track(
    events: np.ndarray | None, frame_t: np.ndarray, sample_rate: int
) -> np.ndarray | None:
    """Instantaneous f0 from consecutive event intervals, resampled at the
    frame positions ``frame_t`` (samples)."""
    if events is None:
        return None
    intervals = np.diff(events)
    centers = 0.5 * (events[:-1] + events[1:])
    return np.interp(frame_t, centers, sample_rate / intervals)


def dio_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_length: int,
    fmin: float = 71.0,
    fmax: float = 800.0,
    allowed_range: float = 0.1,
    channels_in_octave: float = 2.0,
) -> np.ndarray:
    """DIO-style coarse f0 (Morise 2009): per-band low-pass filtering, four
    interval-event estimators (rising/falling zero crossings, peaks, dips),
    candidate = their mean with relative deviation as the reliability score;
    the best band wins per frame; frames whose deviation exceeds
    ``allowed_range`` are unvoiced.  Native equivalent of the reference's
    ``pyworld.dio`` call (reference src/tools/utils.py:93-117) — same method
    family, NOT bit-compatible (exact parity still requires pyworld).

    Returns f0 per hop frame, 0 = unvoiced.
    """
    x = np.asarray(audio, np.float64)
    if len(x) < 4:
        return np.zeros(len(x) // hop_length + 1)
    x = x - x.mean()
    n = len(x)
    n_frames = n // hop_length + 1
    frame_t = np.arange(n_frames, dtype=np.float64) * hop_length

    # half-octave band boundaries covering (fmin, fmax]
    n_bands = int(np.ceil(np.log2(fmax / fmin) * channels_in_octave)) + 1
    boundaries = fmin * 2.0 ** (np.arange(1, n_bands + 1) / channels_in_octave)

    nfft = 1 << int(np.ceil(np.log2(n + 1)))
    spec = np.fft.rfft(x, nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / sample_rate)
    # high-pass below the pitch floor: DC drift and sub-f0 rumble otherwise
    # pollute the low bands' zero crossings (vocoder output carries both)
    hp = (freqs >= 0.75 * fmin).astype(np.float64)
    rise = (freqs > 0.5 * fmin) & (freqs < 0.75 * fmin)
    hp[rise] = 0.5 * (
        1.0 - np.cos(np.pi * (freqs[rise] - 0.5 * fmin) / (0.25 * fmin))
    )
    spec = spec * hp

    full_rms = np.sqrt(np.mean(x**2)) + 1e-300
    frame_idx = np.minimum(frame_t.astype(np.int64), n - 1)
    cands, devs, rmss = [], [], []
    for fc in boundaries:
        # cosine-rolloff low-pass at the band boundary: when true f0 is in
        # this band the filtered signal is near-sinusoidal and all four
        # event estimators agree
        H = (freqs <= fc).astype(np.float64)
        roll = (freqs > fc) & (freqs < 1.5 * fc)
        H[roll] = 0.5 * (1.0 + np.cos(np.pi * (freqs[roll] - fc) / (0.5 * fc)))
        y = np.fft.irfft(spec * H, nfft)[:n]
        dy = np.diff(y, append=y[-1])

        tracks = [
            _interval_track(_event_times(y), frame_t, sample_rate),
            _interval_track(_event_times(-y), frame_t, sample_rate),
            _interval_track(_event_times(dy), frame_t, sample_rate),   # dips
            _interval_track(_event_times(-dy), frame_t, sample_rate),  # peaks
        ]
        if any(t is None for t in tracks):
            continue
        stack = np.stack(tracks)  # (4, n_frames)
        cand = stack.mean(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            dev = np.sqrt(((stack - cand) ** 2).mean(axis=0)) / np.maximum(
                cand, 1e-12
            )
        # a band may claim any candidate at or below (just above) its
        # cutoff — components above the cutoff were filtered out
        bad = (cand < fmin) | (cand > min(fmax, 1.1 * fc))
        dev = np.where(bad, np.inf, dev)
        cands.append(cand)
        devs.append(dev)
        # frame-local RMS of the filtered signal (±23 ms) relative to the
        # whole signal: distinguishes a real weak fundamental from the
        # event-detector junk that band noise produces
        cs = np.concatenate([[0.0], np.cumsum(y**2)])
        lo = np.maximum(frame_idx - 512, 0)
        hi = np.minimum(frame_idx + 512, n)
        rmss.append(
            np.sqrt((cs[hi] - cs[lo]) / np.maximum(hi - lo, 1)) / full_rms
        )

    if not cands:
        return np.zeros(n_frames)
    cands = np.stack(cands)  # (n_bands, n_frames), frequency-ascending bands
    devs = np.stack(devs)
    rmss = np.stack(rmss)

    # Primary selection: minimum deviation across bands.  Then harmonic
    # de-locking: when the fundamental is weak (common in vocoder output) a
    # strong harmonic can win the deviation race — if another reliable
    # candidate sits at an integer subharmonic (1/2 .. 1/10) of the winner,
    # the subharmonic is the true f0 (signals have no spurious subharmonics).
    cols = np.arange(cands.shape[1])
    pick = devs.argmin(axis=0)
    best_f0 = cands[pick, cols]
    best_dev = devs[pick, cols]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = best_f0[None, :] / np.maximum(cands, 1e-12)
    k = np.rint(ratio)
    is_sub = (
        (devs < allowed_range)
        & (rmss > 0.005)
        & (k >= 2)
        & (k <= 10)
        & (np.abs(ratio - k) < 0.05 * k)
    )
    has_sub = is_sub.any(axis=0)
    sub_pick = np.where(is_sub, cands, np.inf).argmin(axis=0)
    best_f0 = np.where(has_sub, cands[sub_pick, cols], best_f0)
    best_dev = np.where(has_sub, devs[sub_pick, cols], best_dev)

    # Contour-guided second pass (WORLD FixF0Contour spirit): frames that
    # de-locked establish the utterance's fundamental register; remaining
    # frames stuck at ~k× that register adopt their own candidate nearest
    # the register even when its deviation alone was too weak — the strong
    # harmonic attests periodicity, the subharmonic candidate pins the
    # period.
    if has_sub.any() and not has_sub.all():
        m = np.median(best_f0[has_sub & (best_dev < allowed_range)])
        if m > 0:
            kk = np.rint(best_f0 / m)
            locked = (
                ~has_sub
                & (best_dev < allowed_range)
                & (kk >= 2)
                & (np.abs(best_f0 / m - kk) < 0.1 * kk)
            )
            near = np.abs(cands / m - 1.0) < 0.15
            cand_ok = near & (devs < 3.0 * allowed_range) & (rmss > 0.005)
            rescue = locked & cand_ok.any(axis=0)
            res_pick = np.where(cand_ok, devs, np.inf).argmin(axis=0)
            best_f0 = np.where(rescue, cands[res_pick, cols], best_f0)
            # voicing is attested by the harmonic's own reliability
            best_dev = np.where(rescue, np.minimum(best_dev, devs[res_pick, cols]), best_dev)

    f0 = np.where(best_dev < allowed_range, best_f0, 0.0)

    # WORLD's FixF0Contour step 2: a real pitch track is smooth at the
    # frame rate — zero frames that jump more than allowed_range relative
    # to their predecessor (kills the quasi-regular crossings that
    # low-passed noise produces)
    prev = f0[:-1]
    cur = f0[1:]
    jump = (prev > 0) & (cur > 0) & (
        np.abs(cur - prev) / np.maximum(cur, 1e-12) > allowed_range
    )
    f0[1:][jump] = 0.0

    # drop voiced runs shorter than ~45 ms (WORLD's voice_range_minimum):
    # isolated short voicings are event-detector glitches
    min_run = max(3, int(0.045 * sample_rate / hop_length))
    voiced = f0 > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], voiced, [0]])))
    for start, stop in zip(edges[::2], edges[1::2]):
        if stop - start < min_run:
            f0[start:stop] = 0.0
    return f0


def stonemask(
    audio: np.ndarray,
    f0: np.ndarray,
    sample_rate: int,
    hop_length: int,
    n_harmonics: int = 6,
) -> np.ndarray:
    """StoneMask f0 refinement (Morise 2015): for each voiced frame, the
    instantaneous frequency at harmonic spectrum bins — via Flanagan's
    derivative-window identity — is amplitude-weighted and averaged down to
    the fundamental.  Applied twice, as in WORLD.  Native equivalent of the
    reference's ``pyworld.stonemask`` (reference src/tools/utils.py:93-117).
    """
    x = np.asarray(audio, np.float64)
    out = np.asarray(f0, np.float64).copy()

    def refine(f: float, center: float) -> float:
        half = int(1.5 * sample_rate / f) + 1
        rel = np.arange(-half, half + 1)
        idx = rel + int(round(center))
        seg = np.where(
            (idx >= 0) & (idx < len(x)), x[np.clip(idx, 0, len(x) - 1)], 0.0
        )
        t = rel / sample_rate
        # Blackman window spanning three fundamental periods
        w = (
            0.42
            + 0.5 * np.cos(np.pi * t * f / 1.5)
            + 0.08 * np.cos(2.0 * np.pi * t * f / 1.5)
        )
        # WORLD's diff window: NEGATED central difference per sample
        dw = np.empty_like(w)
        dw[1:-1] = -(w[2:] - w[:-2]) / 2.0
        dw[0] = -w[1] / 2.0
        dw[-1] = w[-2] / 2.0
        m = 1 << int(np.ceil(np.log2(len(seg) + 1)))
        S = np.fft.rfft(seg * w, m)
        dS = np.fft.rfft(seg * dw, m)
        power = np.abs(S) ** 2
        bin_hz = np.fft.rfftfreq(m, 1.0 / sample_rate)
        # Flanagan: IF(k) = bin freq + (Re S·Im dS − Im S·Re dS)·fs / (2π |S|²)
        inst = bin_hz + (S.real * dS.imag - S.imag * dS.real) * sample_rate / (
            2.0 * np.pi * np.maximum(power, 1e-300)
        )
        num = den = 0.0
        kmax = min(n_harmonics, int(0.5 * sample_rate / f))
        for k in range(1, max(kmax, 1) + 1):
            b = int(round(k * f * m / sample_rate))
            if b >= len(S):
                break
            amp = np.sqrt(power[b])
            # WORLD FixF0 weighting: f0 = Σ amp·IF_k / Σ amp·k
            num += amp * inst[b]
            den += amp * k
        return num / den if den > 0 else 0.0

    for i in np.flatnonzero(out > 0):
        f = refine(float(out[i]), i * hop_length)
        if f > 0:
            f = refine(f, i * hop_length)
        # reject refinements that ran away from the coarse estimate
        if f > 0 and abs(f / out[i] - 1.0) < 0.2:
            out[i] = f
    return out


def _praat_f0(
    wav_data: np.ndarray, mel_len: int, sample_rate: int, hop_length: int
):
    """Reference-exact Praat f0 (utils.py:46-78), incl. the lpad/rpad
    alignment fix-up.  Returns None when parselmouth is not installed."""
    try:
        import parselmouth
    except ImportError:
        return None
    assert hop_length in (128, 256)
    pad_size = 4 if hop_length == 128 else 2
    f0 = (
        parselmouth.Sound(np.asarray(wav_data, np.float64), sample_rate)
        .to_pitch_ac(
            time_step=hop_length / sample_rate,
            voicing_threshold=0.5,
            pitch_floor=80,
            pitch_ceiling=750,
        )
        .selected_array["frequency"]
    )
    f0 = f0[: mel_len - 8]  # avoid negative rpad (reference comment)
    lpad = pad_size - 2
    rpad = mel_len - len(f0) - lpad
    f0 = np.pad(f0, [[lpad, rpad]], mode="constant")
    delta = mel_len - len(f0)
    if delta > 0:
        f0 = np.concatenate([f0, [f0[-1]] * delta], 0)
    return f0[:mel_len]


def _pyworld_pitch(
    wav_data: np.ndarray, sample_rate: int, hop_length: int
):
    """Reference-exact pyworld dio+stonemask pitch (utils.py:93-117).
    Returns None when pyworld is not installed."""
    try:
        import pyworld as pw
    except ImportError:
        return None
    x = np.asarray(wav_data, np.float64)
    pitch, t = pw.dio(x, sample_rate, frame_period=hop_length / sample_rate * 1000)
    return pw.stonemask(x, pitch, t, sample_rate)


def extract_f0(
    wav_data: np.ndarray,
    mel_len: int,
    sample_rate: int,
    hop_length: int,
    with_pitch: bool = False,
    backend: str = "auto",
):
    """f0 stream aligned to mel frames (reference contract utils.py:46-78):
    zero where unvoiced, length exactly ``mel_len``.

    backend: "auto" uses Praat when parselmouth is importable (numeric
    parity with reference-trained checkpoints) and falls back to YIN;
    "praat" requires parselmouth; "yin" forces the built-in estimator;
    "ac" forces the in-framework Boersma-style autocorrelation tracker
    (same method family as Praat's, library-free, not bit-compatible).
    """
    f0 = None
    if backend in ("auto", "praat"):
        f0 = _praat_f0(wav_data, mel_len, sample_rate, hop_length)
        if f0 is None and backend == "praat":
            raise ImportError("backend='praat' requires parselmouth")
    if f0 is None:
        est = ac_f0 if backend == "ac" else yin_f0
        f0 = est(wav_data, sample_rate, hop_length, fmin=80.0, fmax=750.0)
        if len(f0) >= mel_len:
            f0 = f0[:mel_len]
        else:
            f0 = np.pad(
                f0, (0, mel_len - len(f0)), mode="edge" if len(f0) else "constant"
            )
    if with_pitch:
        return f0, f0_to_coarse(f0)
    return f0


def extract_pitch(
    wav_data: np.ndarray, sample_rate: int, hop_length: int,
    backend: str = "auto",
) -> np.ndarray:
    """Pitch stream with linear interpolation over unvoiced gaps
    (reference contract utils.py:93-117).

    backend: "auto" uses pyworld dio+stonemask when importable, else the
    native DIO+StoneMask (same method family, library-free); "pyworld"
    requires pyworld; "dio" forces the native DIO+StoneMask; "yin" forces
    the YIN estimator.
    """
    pitch = None
    if backend in ("auto", "pyworld"):
        pitch = _pyworld_pitch(wav_data, sample_rate, hop_length)
        if pitch is None and backend == "pyworld":
            raise ImportError("backend='pyworld' requires pyworld")
    if pitch is None and backend in ("auto", "dio"):
        pitch = dio_f0(wav_data, sample_rate, hop_length, fmin=71.0, fmax=800.0)
        pitch = stonemask(wav_data, pitch, sample_rate, hop_length)
    if pitch is None:
        pitch = yin_f0(wav_data, sample_rate, hop_length, fmin=71.0, fmax=800.0)
    nonzero = np.nonzero(pitch)[0]
    if len(nonzero) == 0:
        return pitch
    interp = np.interp(
        np.arange(len(pitch)), nonzero, pitch[nonzero]
    )
    return interp


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize f0 (Hz) to 256 mel-spaced bins (reference utils.py:81-90)."""
    f0_mel = 1127 * np.log(1 + np.asarray(f0, dtype=np.float64) / 700)
    pos = f0_mel > 0
    f0_mel[pos] = (f0_mel[pos] - F0_MEL_MIN) * (F0_BIN - 2) / (
        F0_MEL_MAX - F0_MEL_MIN
    ) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > F0_BIN - 1] = F0_BIN - 1
    coarse = np.rint(f0_mel).astype(np.int64)
    assert coarse.max() <= 255 and coarse.min() >= 1, (coarse.max(), coarse.min())
    return coarse


def beta_binomial_prior(phoneme_count: int, mel_count: int,
                        scaling_factor: float = 1.0) -> np.ndarray:
    """Beta-binomial alignment prior, shape (mel_count, phoneme_count)
    ("One TTS Alignment To Rule Them All"): row i is the pmf over phonemes of
    BetaBinom(P, s * i, s * (M + 1 - i)), i = 1..M.  One broadcast call
    instead of the JAX package's row loop, which takes seconds at M = 768,
    and no frozen distribution (building one formats its docstrings, most of
    the call's time at a batch's sizes)."""
    from scipy.stats import betabinom

    P, M = phoneme_count, mel_count
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    return betabinom.pmf(np.arange(P)[None, :], P, scaling_factor * i,
                         scaling_factor * (M + 1 - i))


def remove_outliers(values: np.ndarray) -> np.ndarray:
    """IQR outlier filter used for corpus statistics (reference utils.py:142-150)."""
    p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[np.logical_and(values > lower, values < upper)]

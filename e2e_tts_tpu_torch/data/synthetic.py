"""Deterministic synthetic speech corpora (a copy of
``e2e_tts_tpu/data/synthetic.py`` on the port's ``text/`` and
``audio/wav.py``: the same seed writes byte-identical wavs and metadata).

The reference trains on proprietary studio recordings that cannot ship;
quality regression here instead uses a *formant-style synthetic corpus*:
every phoneme maps to a fixed spectral signature (two resonances + voicing
flag) and a fixed duration, so text -> audio is a deterministic, learnable
function.  A tiny FastSpeech2 + HiFi-GAN trained on it produces periodic,
voiced, text-dependent audio — enough to test the whole
corpus -> features -> train -> bundle -> serve loop end to end.

Audio model: per phoneme, a harmonic source at the speaker's f0 (with
sentence-level declination) shaped by two resonance peaks; unvoiced
consonants use filtered noise; 5 ms raised-cosine edge ramps avoid clicks.
All randomness is seeded; corpora regenerate bit-identically.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..audio.wav import write_wav
from ..text.g2p import phonemize

# words chosen from common Vietnamese vocabulary; all pass is_valid_syllable
VOCAB = (
    "xin chào bạn tôi yêu nước non sông núi trời đất mây gió hoa lá cây "
    "cỏ chim cá nhà cửa em anh ngày đêm vui buồn đi về trên dưới"
).split()

# unvoiced onsets/codas get noise excitation (rough VN phonology)
_UNVOICED = {"T", "TH", "K", "KH", "P", "PH", "X", "S", "H", "CH", "TR",
             "TZ", "CZ", "PZ", "KZ"}
_SILENT = {"<SILENT>", "<S>", "</S>", "<PAD>"}


def _phoneme_signature(ph: str) -> Tuple[float, float, bool]:
    """Deterministic (F1, F2, voiced) for a phoneme symbol."""
    if ph in _SILENT:
        return 0.0, 0.0, False
    digest = hashlib.md5(ph.encode()).digest()
    f1 = 300.0 + (digest[0] / 255.0) * 600.0    # 300-900 Hz
    f2 = 1000.0 + (digest[1] / 255.0) * 1600.0  # 1000-2600 Hz
    voiced = ph not in _UNVOICED
    return f1, f2, voiced


def _phoneme_frames(ph: str, hop: int = 256) -> int:
    """Deterministic duration in mel frames (vowels long, consonants short)."""
    if ph in _SILENT:
        return 6
    digest = hashlib.md5(ph.encode()).digest()
    if "_" in ph:  # toned vowel nucleus
        return 8 + digest[2] % 4
    return 4 + digest[2] % 3


# Tone-dependent f0 contours: (start, end) multiplier across the toned
# nucleus, linearly interpolated.  Indices follow the "NUCLEUS_t" symbol
# convention of the VN frontend (0 level ... 5 heavy); Burmese nuclei use
# the same "_t" shape and get deterministic contours too.  Without these,
# utterance pitch carries NO text-dependent structure, the trained pitch
# predictor regresses to the mean, and p_control has nothing to scale.
_TONE_CONTOURS = {
    "0": (1.00, 1.00),   # ngang: level
    "1": (0.96, 1.22),   # rising
    "2": (1.03, 0.82),   # falling
    "3": (0.93, 0.74),   # low dipping
    "4": (0.90, 1.14),   # broken rising
    "5": (0.96, 0.76),   # heavy falling
}


# ARPAbet stress -> f0 level (English has stress accent, not lexical
# tone): stressed syllables ride higher, unstressed reduce
_STRESS_CONTOURS = {
    "1": (1.12, 1.16),  # primary stress: high, slightly rising
    "2": (1.04, 1.06),  # secondary
    "0": (0.92, 0.90),  # unstressed: low
}


def _tone_contour(ph: str) -> Tuple[float, float]:
    if "_" in ph:
        tone = ph.rsplit("_", 1)[-1]
        if tone in _TONE_CONTOURS:
            return _TONE_CONTOURS[tone]
    if ph[-1:] in _STRESS_CONTOURS and any(c.isalpha() for c in ph):
        return _STRESS_CONTOURS[ph[-1:]]
    return (1.0, 1.0)


def synth_phonemes(
    phonemes: Sequence[str],
    f0: float = 180.0,
    sr: int = 22050,
    hop: int = 256,
    n_harmonics: int = 12,
    seed: int = 0,
) -> np.ndarray:
    """Render a phoneme sequence to a waveform (float32 in [-1, 1])."""
    rng = np.random.RandomState(seed)
    pieces: List[np.ndarray] = []
    n_total = sum(_phoneme_frames(p, hop) for p in phonemes)
    pos = 0
    phase = rng.rand(n_harmonics) * 2 * np.pi  # fixed per utterance
    for ph in phonemes:
        frames = _phoneme_frames(ph, hop)
        n = frames * hop
        f1, f2, voiced = _phoneme_signature(ph)
        if ph in _SILENT:
            pieces.append(np.zeros(n, np.float32))
            pos += frames
            continue
        # sentence-level declination: f0 slides 1.08x -> 0.92x
        frac = pos / max(n_total, 1)
        cur_f0 = f0 * (1.08 - 0.16 * frac)
        if voiced:
            # tone contour: f0 glides across the nucleus (phase-integrated
            # so the chirp is artifact-free)
            c0, c1 = _tone_contour(ph)
            f_traj = cur_f0 * np.linspace(c0, c1, n)
            base_phase = 2 * np.pi * np.cumsum(f_traj) / sr
            sig = np.zeros(n)
            for h in range(1, n_harmonics + 1):
                fh = h * cur_f0
                if h * f_traj.max() > sr / 2 - 500:
                    break
                amp = (
                    np.exp(-((fh - f1) ** 2) / (2 * 150.0**2))
                    + 0.7 * np.exp(-((fh - f2) ** 2) / (2 * 250.0**2))
                    + 0.05
                ) / h**0.3
                sig = sig + amp * np.sin(h * base_phase + phase[h - 1])
        else:
            # band-shaped noise around the resonances
            white = rng.randn(n)
            spec = np.fft.rfft(white)
            freqs = np.fft.rfftfreq(n, 1 / sr)
            shape = (
                np.exp(-((freqs - f2) ** 2) / (2 * 700.0**2)) + 0.02
            )
            sig = np.fft.irfft(spec * shape, n=n) * 3.0
        # 5 ms raised-cosine edges
        ramp = min(int(0.005 * sr), n // 2)
        env = np.ones(n)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        pieces.append((sig * env).astype(np.float32))
        pos += frames
    audio = np.concatenate(pieces) if pieces else np.zeros(hop, np.float32)
    peak = np.abs(audio).max()
    return (0.6 * audio / max(peak, 1e-6)).astype(np.float32)


def synth_text(
    text: str,
    f0: float = 180.0,
    sr: int = 22050,
    hop: int = 256,
    seed: int = 0,
    phonemize_fn=None,
) -> np.ndarray:
    """Text -> waveform through the same G2P the model trains on."""
    fn = phonemize_fn or (lambda s: phonemize(s, is_training=True)[0])
    return synth_phonemes(fn(text.lower()), f0=f0, sr=sr, hop=hop, seed=seed)


def make_sentences(
    n: int, seed: int = 0, vocab: Optional[Sequence[str]] = None
) -> List[str]:
    rng = np.random.RandomState(seed)
    vocab = list(vocab or VOCAB)
    out = []
    for _ in range(n):
        k = rng.randint(3, 7)
        out.append(" ".join(rng.choice(vocab, size=k)))
    return out


def make_synthetic_corpus(
    root: str,
    n_sentences: int = 48,
    speakers: Optional[Dict[str, float]] = None,
    seed: int = 0,
    sr: int = 22050,
    sentences: Optional[Sequence[str]] = None,
    phonemize_fn=None,
    f0_jitter: float = 0.0,
) -> List[str]:
    """Write a metadata.csv + wavs/ corpus in the layout the training CLI
    consumes (reference layout: tools_for_data.py:48-77).  Each sentence is
    rendered once per speaker at that speaker's base f0.

    ``f0_jitter`` > 0 scales each utterance's f0 by a deterministic random
    factor in [1-j, 1+j].  Without it, pitch is fully determined by the
    speaker id and a trained model can ignore its pitch-conditioning path
    entirely — p_control then has no audible effect."""
    speakers = speakers or {"nu": 220.0, "nam": 150.0}
    sents = list(sentences or make_sentences(n_sentences, seed=seed))
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    jit_rng = np.random.RandomState(seed + 12345)
    rows = []
    for i, text in enumerate(sents):
        for spk, f0 in speakers.items():
            mult = (
                1.0 + f0_jitter * (2.0 * jit_rng.rand() - 1.0)
                if f0_jitter
                else 1.0
            )
            audio = synth_text(
                text, f0=f0 * mult, sr=sr, seed=seed + i,
                phonemize_fn=phonemize_fn,
            )
            name = f"{spk}_{i:03d}.wav"
            write_wav(os.path.join(root, "wavs", name), audio, sr)
            rows.append(f"{name}|{spk}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf8") as f:
        f.write("\n".join(rows))
    return sents


def write_duration_labels(root: str, phonemize_fn=None) -> int:
    """Label a corpus that ``make_synthetic_corpus`` wrote for supervised
    (MFA-duration) training: ``metadata.lab`` (filename|speaker|phonemes)
    and ``durations/<utterance>.txt``, each phoneme's exact frame count, in
    the layout ``create_supervised_filelist`` reads.  The synthetic audio
    holds every phoneme for exactly its ``_phoneme_frames``, so these are
    the true durations, as a forced aligner's would be.  Returns the number
    of utterances labelled."""
    fn = phonemize_fn or (lambda s: phonemize(s, is_training=True)[0])
    with open(os.path.join(root, "metadata.csv"), encoding="utf8") as f:
        rows = [r.strip().split("|")[:3] for r in f if r.strip()]
    os.makedirs(os.path.join(root, "durations"), exist_ok=True)
    labels = []
    for fname, speaker, text in rows:
        phonemes = fn(text.lower())
        labels.append(f"{fname}|{speaker}|{' '.join(phonemes)}")
        with open(os.path.join(root, "durations", f"{os.path.splitext(fname)[0]}.txt"), "w",
                  encoding="utf8") as f:
            f.write(" ".join(str(_phoneme_frames(p)) for p in phonemes))
    with open(os.path.join(root, "metadata.lab"), "w", encoding="utf8") as f:
        f.write("\n".join(labels))
    return len(labels)

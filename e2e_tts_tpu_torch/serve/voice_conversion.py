"""Voice conversion (port of ``e2e_tts_tpu/serve/voice_conversion.py``).

``convert(src, target, out)`` with two backends:

- ``KnnVoiceConverter``: kNN-VC-style any-to-any conversion.  Every source
  mel frame is replaced by a similarity-weighted average of its k nearest
  frames of the target utterance, matched on content features
  (phoneme posteriorgrams from the engine's trained aligner, or
  per-utterance-normalized log-mels, both stacked with +-``context``
  neighbour frames), and the converted mel is rendered by the engine's
  vocoder.  The matching is one (Ts, D) @ (D, Tt) product and a top-k on
  the engine's device (``_knn_match``).
- ``SpectralVoiceConverter``: spectral-envelope transfer in NumPy, the
  fallback without an engine or at a sample rate the engine does not serve.
  Its output is bit-equal to the JAX package's.

The features, the prosody tracks and the buckets are the JAX package's, so
a conversion picks the same target frames.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..audio.filters import hann_window
from ..audio.wav import read_wav, write_wav
from ..device import resolve_device


def _stft(x, n_fft=1024, hop=256):
    w = hann_window(n_fft)
    n = 1 + (len(x) - n_fft) // hop if len(x) >= n_fft else 0
    if n <= 0:
        x = np.pad(x, (0, n_fft - len(x) + 1))
        n = 1
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(x[idx] * w, axis=1)


def _istft(spec, n_fft=1024, hop=256):
    w = hann_window(n_fft)
    frames = np.fft.irfft(spec, n=n_fft, axis=1) * w
    out_len = n_fft + hop * (len(frames) - 1)
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    for i, f in enumerate(frames):
        out[i * hop : i * hop + n_fft] += f
        norm[i * hop : i * hop + n_fft] += w**2
    return (out / np.maximum(norm, 1e-8)).astype(np.float32)


def _smooth_envelope(mag: np.ndarray, width: int = 31) -> np.ndarray:
    """Moving average of the mean log magnitude spectrum over frequency."""
    log_avg = np.log(np.maximum(mag, 1e-8)).mean(axis=0)
    kernel = np.ones(width) / width
    return np.convolve(log_avg, kernel, mode="same")


class SpectralVoiceConverter:
    """Moves the source's smoothed log spectrum toward the target speaker's
    average envelope, keeping the source's fine structure and phase."""

    def __init__(self, n_fft: int = 1024, hop: int = 256, strength: float = 1.0):
        self.n_fft = n_fft
        self.hop = hop
        self.strength = strength

    def convert(self, source_path: str, target_path: str, out_path: str) -> str:
        src, sr = read_wav(source_path)
        tgt, sr_t = read_wav(target_path)
        if sr_t != sr:
            # resample the reference to the source rate, so that both STFTs put
            # the same Hz in the same bin
            n_out = int(round(len(tgt) * sr / sr_t))
            tgt = np.interp(
                np.arange(n_out) * (len(tgt) - 1) / max(n_out - 1, 1),
                np.arange(len(tgt)),
                tgt,
            ).astype(tgt.dtype)

        S = _stft(src, self.n_fft, self.hop)
        T = _stft(tgt, self.n_fft, self.hop)
        env_src = _smooth_envelope(np.abs(S))
        env_tgt = _smooth_envelope(np.abs(T))
        correction = np.exp(self.strength * (env_tgt - env_src))
        audio = _istft(S * correction[None, :], self.n_fft, self.hop)
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio / peak
        write_wav(out_path, audio, sr)
        return out_path


def _bucket_up(n: int, step: int = 256) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _knn_match(src_feat: torch.Tensor, tgt_feat: torch.Tensor, tgt_mel: torch.Tensor,
               tgt_mask: torch.Tensor, k: int = 4, temperature: float = 10.0):
    """Each source frame -> the softmax-weighted mean of its k nearest target
    mel frames by cosine similarity.  Returns the mel (Ts, n_mels) and the
    chosen target frames (Ts, k)."""

    def norm(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)

    sim = norm(src_feat) @ norm(tgt_feat).T  # (Ts, Tt)
    sim = torch.where(tgt_mask[None, :], sim, torch.full_like(sim, -1e9))
    vals, idx = torch.topk(sim, k, dim=-1)  # (Ts, k)
    w = torch.softmax(vals * temperature, dim=-1)
    return (tgt_mel[idx] * w[..., None]).sum(dim=1), idx


class KnnVoiceConverter:
    """kNN-VC (Baas et al. 2023) over the engine's own features, rendered by
    the engine's vocoder.

    ``engine``: a ``SynthesisEngine`` whose vocoder renders the converted
    mel; without one ``convert`` goes to ``fallback`` (by default a
    ``SpectralVoiceConverter``), as it does when a file's sample rate is not
    the engine's.  The matching runs on the engine's device, or without an
    engine on ``device`` (CUDA unless ``device="cpu"``).

    ``feature_mode``: "ppg" matches phoneme posteriorgrams from the engine's
    aligner (``engine.mel_content_features``), "cmvn" per-utterance
    normalized log-mels, "auto" the first when the engine has the aligner.

    ``prosody_weight`` > 0 adds each frame's normalized log-f0 and voicing
    flag to the matching features, so the matched target frames follow the
    source's intonation; weight 1 makes that block count about as much as
    the content block; 0 leaves plain content matching.
    """

    def __init__(
        self,
        engine=None,
        k: int = 4,
        context: int = 2,
        temperature: float = 10.0,
        fallback: Optional[object] = None,
        feature_mode: str = "auto",
        prosody_weight: float = 0.0,
        device=None,
    ):
        self.engine = engine
        self.k = k
        self.context = context
        self.temperature = temperature
        self.prosody_weight = prosody_weight
        self.fallback = fallback or SpectralVoiceConverter()
        if engine is not None:
            if device is not None and torch.device(device) != engine.device:
                raise ValueError(f"device {device} is not the engine's {engine.device}")
            self.device = engine.device
        else:
            self.device = resolve_device(device)
        if feature_mode == "auto":
            feature_mode = "ppg" if self._engine_has_aligner() else "cmvn"
        if feature_mode == "ppg" and not self._engine_has_aligner():
            raise ValueError("feature_mode='ppg' needs an engine with the aligner")
        self.feature_mode = feature_mode

    def _engine_has_aligner(self) -> bool:
        if self.engine is None:
            return False
        fs2 = self.engine.config.models.fastspeech2
        return bool(fs2.variance.duration_modelling.learn_alignment)

    # --- features ----------------------------------------------------------

    @torch.no_grad()
    def _mel(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """(T, n_mels) log-mel of a waveform on the engine's device."""
        from ..audio.mel import MelParams, mel_spectrogram, num_frames

        p = MelParams.from_config(self.engine.config.audio)
        assert sr == self.engine.sample_rate, (sr, self.engine.sample_rate)
        # the JAX package pads to a sample bucket; its last frames read the padding
        bucket = 16 * p.hop_length * 4
        n_pad = -len(audio) % bucket
        padded = np.pad(audio, (0, n_pad)) if n_pad else audio
        T = num_frames(len(audio), p)
        x = torch.from_numpy(np.ascontiguousarray(padded, np.float32)[None]).to(self.device)
        mel = mel_spectrogram(x, p)[0].cpu().numpy().astype(np.float32)
        return mel.T[:T]

    def _stack_context(self, z: np.ndarray) -> np.ndarray:
        """Stack +-context neighbour frames: (T, D) -> (T, (2c+1) * D)."""
        c = self.context
        padded = np.pad(z, ((c, c), (0, 0)), mode="edge")
        return np.concatenate([padded[i : i + len(z)] for i in range(2 * c + 1)], axis=1)

    def _features(
        self,
        mel: np.ndarray,
        prosody: Optional[np.ndarray] = None,
        prosody_norm: Optional[float] = None,
    ) -> np.ndarray:
        """Matching features for one utterance's mel (T, n_mels).

        ``prosody``: an optional (T, 2) ``prosody_track``, appended to each
        frame before the context stacking and scaled so that
        ``prosody_weight`` means the same in both feature modes (ppg frames
        have norm 1 after the square root, cmvn frames about sqrt(n_mels)).
        ``prosody_norm``: the RMS frame norm the block is divided by
        (``convert_mel`` passes the one over both tracks); sqrt(2), the
        fully voiced value, by default."""
        if self.feature_mode == "ppg":
            # the square root puts the posteriors on the unit sphere: the
            # cosine similarity becomes the Bhattacharyya affinity
            ppg = self.engine.mel_content_features(mel)
            base, frame_norm = np.sqrt(np.maximum(ppg, 0.0)), 1.0
        else:
            mu, sd = mel.mean(axis=0), mel.std(axis=0) + 1e-5
            base = (mel - mu) / sd
            frame_norm = float(np.sqrt(mel.shape[1]))
        if prosody is not None and self.prosody_weight > 0.0:
            norm = prosody_norm if prosody_norm else float(np.sqrt(2.0))
            scale = self.prosody_weight * frame_norm / norm
            base = np.concatenate([base, scale * prosody.astype(base.dtype)], axis=1)
        return self._stack_context(base)

    @staticmethod
    def _prosody_rms_norm(*tracks: np.ndarray) -> float:
        """RMS frame norm over all frames of the (T, 2) tracks; sqrt(2) when
        every frame is silent."""
        sq = np.concatenate([np.sum(np.square(t.astype(np.float64)), axis=1) for t in tracks])
        rms = float(np.sqrt(sq.mean())) if sq.size else 0.0
        return rms if rms > 1e-6 else float(np.sqrt(2.0))

    def prosody_track(self, audio: np.ndarray, mel_len: int, sample_rate: int,
                      hop_length: int) -> np.ndarray:
        """(T, 2) [log-f0 z-normalized over the voiced frames, voicing flag]
        on the mel frames, from the autocorrelation tracker."""
        from ..audio.features import extract_f0

        f0 = extract_f0(np.asarray(audio, np.float32), mel_len, sample_rate, hop_length,
                        backend="ac")
        voiced = f0 > 0
        z = np.zeros(mel_len, np.float32)
        if int(voiced.sum()) >= 2:
            lf = np.log(f0[voiced])
            z[voiced] = (lf - lf.mean()) / (lf.std() + 1e-5)
        return np.stack([z, voiced.astype(np.float32)], axis=1)

    # --- conversion --------------------------------------------------------

    @torch.no_grad()
    def convert_mel(
        self,
        src_mel: np.ndarray,
        tgt_mel: np.ndarray,
        src_prosody: Optional[np.ndarray] = None,
        tgt_prosody: Optional[np.ndarray] = None,
        return_indices: bool = False,
    ):
        """(Ts, n_mels), (Tt, n_mels) -> converted (Ts, n_mels) float32, and
        with ``return_indices`` the matched target frames (Ts, k) too.

        The prosody tracks are read only when ``prosody_weight`` > 0, and
        must be given together."""
        if (src_prosody is None) != (tgt_prosody is None):
            raise ValueError("src_prosody and tgt_prosody must be given together")
        if src_prosody is not None and self.prosody_weight <= 0.0:
            raise ValueError(
                "prosody tracks were supplied but prosody_weight is 0 — "
                "construct KnnVoiceConverter(prosody_weight=...) > 0 to "
                "enable prosody transfer")
        if self.prosody_weight > 0.0 and src_prosody is None:
            warnings.warn(
                "prosody_weight > 0 but convert_mel received no prosody "
                "tracks; running plain content matching (pass "
                "prosody_track outputs, or call convert() which extracts "
                "them)", stacklevel=2)
        pn = (self._prosody_rms_norm(src_prosody, tgt_prosody)
              if src_prosody is not None else None)
        src_feat = self._features(src_mel, src_prosody, prosody_norm=pn)
        tgt_feat = self._features(tgt_mel, tgt_prosody, prosody_norm=pn)
        Ts, Tt = len(src_feat), len(tgt_feat)
        Tsb, Ttb = _bucket_up(Ts), _bucket_up(Tt)
        sf = np.zeros((Tsb, src_feat.shape[1]), np.float32)
        sf[:Ts] = src_feat
        tf = np.zeros((Ttb, tgt_feat.shape[1]), np.float32)
        tf[:Tt] = tgt_feat
        tm = np.zeros((Ttb, tgt_mel.shape[1]), np.float32)
        tm[:Tt] = tgt_mel
        put = lambda a: torch.from_numpy(a).to(self.device)
        out, idx = _knn_match(put(sf), put(tf), put(tm), put(np.arange(Ttb) < Tt),
                              k=min(self.k, Tt), temperature=self.temperature)
        mel = out[:Ts].cpu().numpy()
        return (mel, idx[:Ts].cpu().numpy()) if return_indices else mel

    def convert(self, source_path: str, target_path: str, out_path: str) -> str:
        if self.engine is None:
            return self.fallback.convert(source_path, target_path, out_path)
        src, sr_s = read_wav(source_path)
        tgt, sr_t = read_wav(target_path)
        if sr_s != self.engine.sample_rate or sr_t != self.engine.sample_rate:
            return self.fallback.convert(source_path, target_path, out_path)
        src_mel, tgt_mel = self._mel(src, sr_s), self._mel(tgt, sr_t)
        sp = tp = None
        if self.prosody_weight > 0.0:
            hop = self.engine.hop_length
            sp = self.prosody_track(src, len(src_mel), sr_s, hop)
            tp = self.prosody_track(tgt, len(tgt_mel), sr_t, hop)
        converted = self.convert_mel(src_mel, tgt_mel, sp, tp)
        audio = self.engine.vocode_mel(converted)
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio / peak
        write_wav(out_path, audio, self.engine.sample_rate)
        return out_path

"""Audio post-processing, speed change and export (a copy of
``e2e_tts_tpu/serve/audio_post.py``, host-side NumPy).

Speed change is a phase-vocoder time-stretch (FFT-based) that keeps the
pitch, as ffmpeg's ``atempo`` does; where an ffmpeg binary is on the path,
``audio_speed_change`` and the compressed formats of ``export_audio`` use it.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import numpy as np

from ..audio.wav import read_wav, write_wav


def _phase_vocoder_stretch(audio: np.ndarray, rate: float, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Time-stretch by ``rate`` (>1 = faster/shorter), constant pitch."""
    if rate == 1.0 or len(audio) < n_fft * 2:
        return audio
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    # analysis frames
    n_frames = 1 + (len(audio) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    stft = np.fft.rfft(audio[idx] * window, axis=1)

    # synthesis frame positions sampled at `rate`
    steps = np.arange(0, n_frames - 1, rate)
    mag = np.abs(stft)
    phase = np.angle(stft)

    expected = 2 * np.pi * hop * np.arange(stft.shape[1]) / n_fft
    out_frames = np.zeros((len(steps), stft.shape[1]), np.complex128)
    acc_phase = phase[0].astype(np.float64)
    for k, s in enumerate(steps):
        i = int(s)
        frac = s - i
        m = (1 - frac) * mag[i] + frac * mag[min(i + 1, n_frames - 1)]
        out_frames[k] = m * np.exp(1j * acc_phase)
        dphase = phase[min(i + 1, n_frames - 1)] - phase[i] - expected
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        acc_phase = acc_phase + expected + dphase

    frames = np.fft.irfft(out_frames, n=n_fft, axis=1) * window
    out_len = n_fft + hop * (len(steps) - 1)
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    for k in range(len(steps)):
        out[k * hop : k * hop + n_fft] += frames[k]
        norm[k * hop : k * hop + n_fft] += window**2
    out /= np.maximum(norm, 1e-8)
    return out.astype(np.float32)


def change_speed_array(audio: np.ndarray, rate: float, sample_rate: int = 22050) -> np.ndarray:
    if audio.dtype == np.int16:
        x = audio.astype(np.float32) / 32768.0
        return np.clip(
            _phase_vocoder_stretch(x, rate) * 32768.0, -32768, 32767
        ).astype(np.int16)
    return _phase_vocoder_stretch(audio, rate)


def audio_speed_change(
    input_path: str, output_path: Optional[str] = None, speed_rate: float = 1.0
) -> str:
    """File-level speed change (reference signature, utils.py:163-172)."""
    if output_path is None:
        ext = input_path.split(".")[-1]
        output_path = f"{input_path[: -len(ext) - 1]}_{round(speed_rate, 2)}.{ext}"
    if speed_rate == 1.0:
        if input_path != output_path:
            shutil.copy(input_path, output_path)
        return output_path

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        subprocess.run(
            [ffmpeg, "-i", input_path, "-filter:a", f"atempo={speed_rate}", "-y", output_path],
            check=True, capture_output=True,
        )
        return output_path

    audio, sr = read_wav(input_path)
    write_wav(output_path, change_speed_array(audio, speed_rate, sr), sr)
    return output_path


def export_audio(
    audio: np.ndarray,
    path: str,
    sample_rate: int = 22050,
    audio_format: Optional[str] = None,
) -> str:
    """Write int16/float audio to ``path`` in wav or a compressed format.

    wav is native; m4a (AAC, the reference's "ipod" codec via pydub,
    reference src/api/utils.py:175-188), mp3 and ogg transcode through an
    ffmpeg binary when one is present.  Without ffmpeg, non-wav formats
    raise — no silent format substitution."""
    fmt = (audio_format or path.split(".")[-1]).lower()
    if fmt == "wav":
        write_wav(path, audio, sample_rate)
        return path
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError(
            f"exporting {fmt!r} requires an ffmpeg binary (wav is native)"
        )
    tmp = path + ".tmp.wav"
    write_wav(tmp, audio, sample_rate)
    try:
        codec = ["-c:a", "aac", "-strict", "-2"] if fmt == "m4a" else []
        subprocess.run(
            [ffmpeg, "-i", tmp, *codec, "-y", path],
            check=True, capture_output=True,
        )
    finally:
        import os

        os.unlink(tmp)
    return path


def save_wav(
    datas: np.ndarray,
    rate: int = 22050,
    speed: float = 1.0,
    audio_format: str = "wav",
    path_audio: Optional[str] = None,
    return_binary: int = 0,
    storage=None,
):
    """Reference surface ``save_wav`` (src/api/utils.py:175-188): export the
    waveform, apply speed change, and upload via the storage backend (or
    return the local path with ``return_binary=1``).  Timestamps name the
    file exactly like the reference."""
    import os
    import time
    from datetime import datetime

    if path_audio is None:
        stamp = datetime.today().strftime("%Y_%m_%d_%H_%M_%S")
        path_audio = os.path.join(
            "audio_generated", f"audio_{stamp}_{time.time()}.{audio_format}"
        )
    os.makedirs(os.path.dirname(path_audio) or ".", exist_ok=True)
    export_audio(datas, path_audio, sample_rate=rate, audio_format=audio_format)
    final_path = (
        audio_speed_change(input_path=path_audio, speed_rate=speed)
        if speed != 1.0
        else path_audio
    )
    if return_binary:
        return final_path
    if storage is None:
        from ..utils.storage import default_storage

        storage = default_storage()
    return storage.upload(final_path)

"""WAV I/O through ``scipy.io.wavfile``: a copy of
``e2e_tts_tpu/audio/wav.py``, with float <-> int16 conversion at the
max_wav_value = 32768 convention.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def read_wav(path: str):
    """Read a wav file -> (float32 array in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 22050):
    """Write float [-1,1] or int16 audio to a wav file."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = np.clip(audio, -1.0, 1.0)
        audio = (audio * (MAX_WAV_VALUE - 1)).astype(np.int16)
    wavfile.write(path, sample_rate, audio)


def float_to_int16(audio: np.ndarray) -> np.ndarray:
    return np.clip(audio * MAX_WAV_VALUE, -32768, 32767).astype(np.int16)

"""Host C++ components of the port, loaded through ctypes: the YIN pitch
extractor's per-frame search (``yin.cc``, a copy of the JAX package's).

The library is built from this directory's source at first use
(``build.library``).  The port never loads the JAX package's library, and
``native_yin_f0`` raises when its own cannot be built or loaded.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import library


def native_yin_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_length: int,
    fmin: float = 80.0,
    fmax: float = 750.0,
    frame_length: int = 2048,
    threshold: float = 0.2,
) -> np.ndarray:
    """C++ YIN: f0 per hop frame (float64), 0 where unvoiced.  The signal is
    read as float32."""
    fn = library("yin").yin_f0
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_float),
    ]
    x = np.ascontiguousarray(audio, np.float32)
    padded = len(x) + frame_length  # the library pads frame_length // 2 on each side
    n_frames = max(0, 1 + (padded - frame_length) // hop_length)
    out = np.zeros(n_frames, np.float32)
    written = fn(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(x)),
        sample_rate, hop_length, fmin, fmax, frame_length, threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:written].astype(np.float64)

"""Build the port's host C++ sources into shared libraries, at first use.

Each ``<name>.cc`` beside this file compiles with ``g++ -O3 -march=native
-shared -fPIC`` (the JAX package's flags) into ``_build/lib<name>-<hash>.so``
(``.gitignore`` lists ``_build/``), keyed by a hash of the source and the
flags, and is loaded with ``ctypes``.  Threads of one process build a
library once (a lock); processes build into a temporary name of their own,
renamed into place.  A failed compile raises with the compiler's output:
nothing falls back.  Nothing here runs at import.

    python -m e2e_tts_tpu_torch.native.build   # build every source now
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = {"yin": "yin.cc"}
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def lib_path(name: str) -> str:
    """The library's path, keyed by its source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(HERE, SOURCES[name]), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``SOURCES[name]``, compiled first if missing."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        out = lib_path(name)
        if not os.path.exists(out):
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: the native {name!r} library needs it")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, os.path.join(HERE, SOURCES[name])],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCES[name]}:\n{proc.stdout}")
            os.replace(tmp, out)
        _LIBS[name] = ctypes.CDLL(out)
        return _LIBS[name]


if __name__ == "__main__":
    for lib in SOURCES:
        library(lib)
        print(f"built {lib}: {lib_path(lib)}")

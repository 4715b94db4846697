"""Build the port's CUDA sources into plain-C shared libraries, at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/<name>-<hash>.so`` (``.gitignore`` lists ``_build/``), keyed by a hash
of the source, the ``.cuh`` headers beside it and the flags, and is loaded
with ``ctypes``; what the compiler printed (``ptxas -v``: registers,
spills) is kept beside it as ``.log``.
Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# serving threads (the batching queue's worker, callers of the engine) may
# reach a kernel's first use together: one of them builds it, the rest wait
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _output(name: str) -> str:
    """The library's path, keyed by the source, the headers beside it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def compiler_log(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` (after ``library``)."""
    with open(_output(name) + ".log") as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled first if its
    hashed ``.so`` is missing.  A failed compile prints the compiler's
    output and raises.  Threads of one process build a kernel once (a
    lock); other processes may build the same file beside it, each into a
    temporary name of its own, renamed into place."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC, f"{name}.cu")
        out = _output(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                print(proc.stdout, end="", flush=True)
                raise RuntimeError(f"nvcc failed for {src}")
            with open(f"{out}.log", "w") as f:
                f.write(proc.stdout)
            os.replace(tmp, out)
        _LIBS[name] = ctypes.CDLL(out)
        return _LIBS[name]

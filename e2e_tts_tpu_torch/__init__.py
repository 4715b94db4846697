"""e2e_tts_tpu_torch — the PyTorch/CUDA port of ``e2e_tts_tpu`` for NVIDIA Hopper.

It mirrors the JAX package's module names (``text``, ``config``, ``ops``,
``nn``, ``models``, ``kernels``, ``serve``) and imports nothing of it: the
JAX-free modules it needs are copied here.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.  Every Pallas kernel of the JAX package
becomes a hand-written Hopper kernel under ``kernels/``.
"""

__version__ = "0.1.0"

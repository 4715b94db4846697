"""The port's ``stream_synthesize`` against the JAX package's on a chunk
predicted past the largest mel bucket (``MAX_MEL_LEN``), on the CPU: the
re-split path.  It has a file of its own because the JAX streamer compiles
its programs for long mel buckets here (about two and a half minutes), and
the test runner hands each file to one worker.  Bar: the JAX streamer's
length and mean |diff| < 1 LSB.
"""

import os

import numpy as np
import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu.serve.streaming import stream_synthesize as jax_stream_synthesize
from e2e_tts_tpu_torch.serve import SynthesisEngine, stream_synthesize

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")


def _lsb(a, b):
    assert a.dtype == b.dtype == np.int16 and len(a) == len(b) > 0, (len(a), len(b))
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def _vie_tiny():
    return JaxEngine.from_checkpoint(VIE_TINY), SynthesisEngine.from_checkpoint(VIE_TINY,
                                                                                device="cpu")


def test_stream_synthesize_splits_past_the_largest_mel_bucket():
    """A chunk predicted past MAX_MEL_LEN is re-split (or duration-split), as
    the JAX streamer does: the same length as the JAX package's."""
    jeng, peng = _vie_tiny()
    text = "xin chào việt nam hôm nay trời đẹp quá"
    splits = []
    real = peng._split_sequence
    peng._split_sequence = lambda seq, total: splits.append(total) or real(seq, total)
    try:
        got = np.concatenate(list(stream_synthesize(peng, text, duration_control=16.0)))
    finally:
        del peng._split_sequence
    want = np.concatenate(list(jax_stream_synthesize(jeng, text, duration_control=16.0)))
    assert _lsb(got, want).mean() < 1.0
    assert splits and splits[0] > 2048 and len(got) > 2048 * peng.hop_length

"""The port's long-short transformer family
(``e2e_tts_tpu_torch/nn/lstransformer.py``) against the JAX package's, on
the CPU: encoder and decoder in the default mode and in ``reference_compat``
(r = 1, interleaved rotary pairs, inverted mask, no pre-zero), at lengths
that are no multiple of the window (16) and one shorter than a window, the
full FastSpeech2's serving stages and ``to_jax`` round trip, one train step
and ``remat_blocks``.  The checks and their bars are in
``_torch_families.py``."""

import pytest

from _torch_one_thread import one_thread  # noqa: F401
from _torch_families import (check_blocks_match_jax, check_remat_same_math,
                             check_serving_matches_jax, check_train_step_matches_jax)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("reference_compat,T", [(False, 37), (True, 37), (False, 11)])
def test_lstransformer_blocks_match_jax(reference_compat, T):
    check_blocks_match_jax("lstransformer", {"reference_compat": reference_compat}, T)


def test_lstransformer_serving_and_to_jax_match_jax():
    check_serving_matches_jax("lstransformer")


def test_lstransformer_train_step_matches_jax():
    check_train_step_matches_jax("lstransformer")


def test_lstransformer_remat_same_math_and_params():
    check_remat_same_math("lstransformer")

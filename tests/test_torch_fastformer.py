"""The port's fastformer family (``e2e_tts_tpu_torch/nn/fastformer.py``)
against the JAX package's, on the CPU: encoder and decoder in the default
mode and in ``reference_compat`` (hidden // head heads, inverted mask, no
pre-zero), the full FastSpeech2's serving stages and ``to_jax`` round trip
(the tied pooling projections stored once), one train step and
``remat_blocks``.  The checks and their bars are in
``_torch_families.py``."""

import pytest

from _torch_families import (check_blocks_match_jax, check_remat_same_math,
                             check_serving_matches_jax, check_train_step_matches_jax, models)


@pytest.mark.parametrize("reference_compat", [False, True])
def test_fastformer_blocks_match_jax(reference_compat):
    check_blocks_match_jax("fastformer", {"reference_compat": reference_compat}, 37,
                           ill_conditioned=reference_compat)


def test_fastformer_serving_and_to_jax_match_jax():
    check_serving_matches_jax("fastformer")
    port = models("fastformer")[3]
    names = list(port.state_dict())
    for side in ("encoder", "decoder"):  # tied across layers: one module each
        assert f"{side}.stack.to_q_attn_logits.weight" in names
        assert not any(n.startswith(f"{side}.stack.attn_0.to_") for n in names)


def test_fastformer_train_step_matches_jax():
    check_train_step_matches_jax("fastformer")


def test_fastformer_remat_same_math_and_params():
    check_remat_same_math("fastformer")

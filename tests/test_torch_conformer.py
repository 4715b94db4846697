"""The port's conformer family (``e2e_tts_tpu_torch/nn/conformer.py``)
against the JAX package's, on the CPU: encoder and decoder with key masking
on and off (``mask_attention``), the full FastSpeech2's serving stages and
``to_jax`` round trip, one train step (the conv module's BatchNorm on batch
statistics, its running statistics after the step), a bfloat16 forward and
``remat_blocks``.  The checks and their bars are in ``_torch_families.py``;
this file also holds the transformer's ``remat_blocks`` check."""

import pytest

from _torch_one_thread import one_thread  # noqa: F401
from _torch_families import (check_bf16_matches_jax, check_blocks_match_jax,
                             check_bundle_round_trip,
                             check_remat_same_math, check_serving_matches_jax,
                             check_train_step_matches_jax)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("mask_attention", [True, False])
def test_conformer_blocks_match_jax(mask_attention):
    check_blocks_match_jax("conformer", {"mask_attention": mask_attention}, 37)


def test_conformer_serving_and_to_jax_match_jax():
    check_serving_matches_jax("conformer")


def test_conformer_train_step_matches_jax():
    check_train_step_matches_jax("conformer")


def test_conformer_bf16_blocks_match_jax():
    check_bf16_matches_jax("conformer", 37)


@pytest.mark.parametrize("block_type", ["conformer", "transformer"])
def test_remat_same_math_and_params(block_type):
    check_remat_same_math(block_type)


def test_conformer_bundle_round_trip(tmp_path):
    check_bundle_round_trip("conformer", tmp_path)

"""The port's reformer family (``e2e_tts_tpu_torch/nn/reformer.py``) and its
rotation sampler (``e2e_tts_tpu_torch/ops/jax_random.py``) against the JAX
package's, on the CPU.

- The sampler against ``jax.random`` from ``PRNGKey(0)``, the key the JAX
  reformer hashes with, at several shapes: the 32- and 8-bit random bits
  and the float32 and bfloat16 uniforms bit-equal; the normals bit-equal
  in bfloat16 and within one float32 ulp in float32 (XLA's erfinv and
  log1p round their last bit otherwise than torch's ops); the bucket ids
  that the key-0 rotations give equal to JAX's.
- ``lsh_attention`` on given rotations, at T = 64 (bucket 8) and T = 1024
  (bucket 64), with the soft cross-bucket penalty and with
  ``attend_across_buckets`` True and False, padding in the batch: max
  |diff| <= 1e-5.
- Encoder and decoder (T padded to a multiple of 2 x bucket), the full
  FastSpeech2, one train step, a bfloat16 forward and ``remat_blocks``:
  ``_torch_families.py`` holds those checks and their bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (check_bf16_matches_jax, check_blocks_match_jax,
                             check_bundle_round_trip,
                             check_remat_same_math, check_serving_matches_jax,
                             check_train_step_matches_jax, models)
from e2e_tts_tpu.nn.reformer import lsh_attention as jax_lsh_attention
from e2e_tts_tpu_torch.nn.reformer import lsh_attention
from e2e_tts_tpu_torch.ops import jax_random

LSH_TOL = 1e-5
SHAPES = [(48, 4, 8), (16, 2, 3), (64, 4, 1), (7, 5), (1000,)]
KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("shape", SHAPES)
def test_sampler_bits_and_uniform_bit_equal(shape):
    key = jax_random.key_data(0)
    for width, jdt in ((32, jnp.uint32), (8, jnp.uint8)):
        want = np.asarray(jax.random.bits(KEY, shape, jdt)).astype(np.int64)
        np.testing.assert_array_equal(jax_random.random_bits(key, width, shape).numpy(), want)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.random.uniform(KEY, shape, jdt, -1.0, 1.0).astype(jnp.float32))
        got = jax_random.uniform(key, shape, tdt, -1.0, 1.0)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_sampler_normal_matches_jax(shape):
    key = jax_random.key_data(0)
    want16 = np.asarray(jax.random.normal(KEY, shape, jnp.bfloat16).astype(jnp.float32))
    got16 = jax_random.normal(key, shape, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16)  # bit-equal in bfloat16
    want = np.asarray(jax.random.normal(KEY, shape, jnp.float32))
    got = jax_random.normal(key, shape, torch.float32).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()  # one float32 ulp


def test_sampler_refuses_other_dtypes():
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 and bfloat16"):
            jax_random.normal(jax_random.key_data(0), (4, 2), dt)


def _qkv(B, T, D, seed):
    rng = np.random.RandomState(seed)
    qk = rng.randn(B, T, D).astype(np.float32)
    v = rng.randn(B, T, D).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, T - T // 3 - 1][:B])[:, None]
    return qk, v, mask


@pytest.mark.parametrize("T,bucket", [(64, 8), (1024, 64)])
def test_lsh_bucket_ids_from_key0_match_jax(T, bucket):
    """The rotations the port draws (key 0) hash every position into the
    bucket JAX's rotations do, in both dtypes."""
    D, n_hashes = 16, 4
    n_buckets = T // bucket
    qk, _, _ = _qkv(2, T, D, 3)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jrot = jax.random.normal(KEY, (D, n_hashes, n_buckets // 2), jdt)
        jr = jnp.einsum("btd,dhr->bhtr", jnp.asarray(qk, jdt), jrot)
        want = np.asarray(jnp.argmax(jnp.concatenate([jr, -jr], -1), -1))
        rot = jax_random.lsh_rotations((D, n_hashes, n_buckets // 2), tdt, "cpu")
        r = torch.einsum("btd,dhr->bhtr", torch.from_numpy(qk).to(tdt), rot)
        np.testing.assert_array_equal(torch.cat([r, -r], -1).argmax(-1).numpy(), want)


@pytest.mark.parametrize("attend_across_buckets", [None, True, False])
@pytest.mark.parametrize("T,bucket", [(64, 8), (1024, 64)])
def test_lsh_attention_matches_jax(T, bucket, attend_across_buckets):
    D, n_hashes = 16, 4
    qk, v, mask = _qkv(2, T, D, T)
    rot = np.random.RandomState(1).randn(D, n_hashes, max(T // bucket, 2) // 2).astype(np.float32)
    want = np.asarray(jax_lsh_attention(
        jnp.asarray(qk), jnp.asarray(v), jnp.asarray(mask), None, n_hashes, bucket, True,
        rotations=jnp.asarray(rot), attend_across_buckets=attend_across_buckets))
    got = lsh_attention(torch.from_numpy(qk), torch.from_numpy(v), torch.from_numpy(mask),
                        n_hashes, bucket, rotations=torch.from_numpy(rot),
                        attend_across_buckets=attend_across_buckets).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LSH_TOL, np.abs(got - want).max()
    if T == 1024 and attend_across_buckets is None:  # key 0 on both sides too
        want0 = np.asarray(jax_lsh_attention(jnp.asarray(qk), jnp.asarray(v), jnp.asarray(mask),
                                             KEY, n_hashes, bucket, True))
        got0 = lsh_attention(torch.from_numpy(qk), torch.from_numpy(v),
                             torch.from_numpy(mask), n_hashes, bucket).numpy()
        assert np.abs(got0 - want0).max() <= LSH_TOL


@pytest.mark.parametrize("T", [37, 80])
def test_reformer_blocks_match_jax(T):
    check_blocks_match_jax("reformer", {}, T)


def test_reformer_serving_and_to_jax_match_jax():
    check_serving_matches_jax("reformer")
    names = list(models("reformer")[3].state_dict())
    for side in ("encoder", "decoder"):  # weight-tied: one layer's weights, stored once
        assert f"{side}.stack.attn_0.to_qk.weight" in names
        assert not any(n.startswith(f"{side}.stack.attn_1.") for n in names)


def test_reformer_train_step_matches_jax():
    check_train_step_matches_jax("reformer")


def test_reformer_bf16_blocks_match_jax():
    check_bf16_matches_jax("reformer", 37)


def test_reformer_remat_same_math_and_params():
    check_remat_same_math("reformer")


def test_reformer_bundle_round_trip(tmp_path):
    check_bundle_round_trip("reformer", tmp_path)

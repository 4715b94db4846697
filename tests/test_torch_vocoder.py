"""The PyTorch port's HiFi-GAN against the JAX package's ``.apply``, same
weights (carried across by ``convert.py``, weight norm fused), same numpy
mel, on the CPU.  Bar: waveform MAE < 1e-5 (the HiFi-GAN parity bar of
BASELINE.md); the max error is held to 1e-4."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.models.vocoder import build_generator as jax_build_generator
from e2e_tts_tpu.models.vocoder import fuse_weight_norm as jax_fuse_weight_norm
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu_torch.config import load_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.models.vocoder import build_generator, fuse_weight_norm
from e2e_tts_tpu_torch.nn.hifigan import HifiGanGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")

MAE_TOL = 1e-5
MAX_TOL = 1e-4

# a ResBlock2 generator: two upsamplings, odd and even kernels
RESBLOCK2 = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 3), (1, 3)), resblock_type=2)


def _vie_tiny():
    with open(os.path.join(VIE_TINY, "vocoder.msgpack"), "rb") as f:
        params = serialization.msgpack_restore(f.read())
    jax_gen = jax_build_generator(jax_load_config(os.path.join(VIE_TINY, "config.yaml")))
    port = build_generator(load_config(os.path.join(VIE_TINY, "config.yaml")), device="cpu")
    return jax_gen, params, port


def _resblock2():
    jax_gen = JaxHifiGan(**RESBLOCK2)
    params = jax.jit(functools.partial(jax_gen.init, mel=jnp.zeros((1, 8, 80))))(
        jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    # random weight norm: g away from ||v|| so that fusing matters
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 1.7 if getattr(p[-1], "key", None) == "g" else x, params)
    return jax_gen, params, HifiGanGenerator(**RESBLOCK2, device="cpu")


@pytest.mark.parametrize("build", [_vie_tiny, _resblock2], ids=["vie_tiny", "resblock2"])
def test_hifigan_matches_jax(build):
    jax_gen, params, port = build()
    load_into(port, params)
    mel = np.random.RandomState(0).randn(2, 24, 80).astype(np.float32)
    want = np.asarray(jax.jit(jax_gen.apply)(params, jnp.asarray(mel)))
    got = port(torch.from_numpy(mel)).numpy()
    hop = int(np.prod([up.stride for up in port.trunk.ups]))
    assert got.shape == want.shape == (2, 24 * hop)
    err = np.abs(got - want)
    assert err.mean() < MAE_TOL and err.max() < MAX_TOL, (err.mean(), err.max())


def test_fuse_weight_norm_matches_jax():
    rng = np.random.RandomState(1)
    tree = {"a": {"v": rng.randn(7, 5, 3).astype(np.float32),
                  "g": rng.rand(3).astype(np.float32) + 0.5},
            "b": {"kernel": rng.randn(2, 2).astype(np.float32)}}
    want = jax.tree_util.tree_map(np.asarray, jax_fuse_weight_norm(tree))
    got = fuse_weight_norm(tree)
    for k in ("v", "g"):
        np.testing.assert_allclose(got["a"][k], want["a"][k], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["b"]["kernel"], want["b"]["kernel"])

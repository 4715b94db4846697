"""The PyTorch port's HiFi-GAN and iSTFTNet against the JAX package's
``.apply``, same weights (carried across by ``convert.py``, weight norm
fused), same numpy mel, on the CPU.  Bar: waveform MAE < 1e-5 (the HiFi-GAN
parity bar of BASELINE.md); the max error is held to 1e-4, and so are the
iSTFTNet head's spectrum and phase.  The bias denoiser (``mode="zeros"``)
against the JAX one: max |diff| < 1e-4."""

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
from e2e_tts_tpu.models.denoiser import Denoiser as JaxDenoiser
from e2e_tts_tpu.models.vocoder import istft_to_audio as jax_istft_to_audio
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.nn.hifigan import IstftNetGenerator as JaxIstftNet
from e2e_tts_tpu_torch.config import default_config, load_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.models.denoiser import Denoiser
from e2e_tts_tpu_torch.models.vocoder import (build_generator, fuse_weight_norm, istft_to_audio,
                                              vocode)
from e2e_tts_tpu_torch.nn.hifigan import (HifiGanGenerator, IstftNetGenerator, TrainableIstftNet,
                                           fuse_generator)

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


# a narrow iSTFTNet: the default head (n_fft 16, hop 4) on a 32-channel trunk
ISTFT = dict(gen_istft_n_fft=16, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
             upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
             resblock_dilation_sizes=((1, 3), (1, 3)))


def _perturbed(params, seed):
    """Weight norm away from ||v|| (g * 1.7) and nonzero biases, so that the
    fuse and the biases matter and the output is no near-silent init."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) == "g":
            return x * 1.7
        if getattr(path[-1], "key", None) == "bias":
            return x + 0.05 * rng.randn(*x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _istft_pair():
    jax_gen = JaxIstftNet(**ISTFT)
    params = jax.jit(functools.partial(jax_gen.init, mel=jnp.zeros((1, 8, 80))))(
        jax.random.PRNGKey(4))
    params = _perturbed(params, 4)
    port = IstftNetGenerator(**ISTFT, device="cpu")
    # every array placed, nothing left over (load_into raises otherwise)
    assert load_into(port, params) == len(port.state_dict())
    return jax_gen, params, port


def test_istftnet_matches_jax():
    jax_gen, params, port = _istft_pair()
    cfg = default_config().models.istft
    mel = np.random.RandomState(1).randn(2, 24, 80).astype(np.float32)
    want_spec, want_phase = (np.asarray(a) for a in jax.jit(jax_gen.apply)(params, jnp.asarray(mel)))
    spec, phase = port(torch.from_numpy(mel))
    assert spec.shape == phase.shape == want_spec.shape == (2, 9, 24 * 64 + 1)
    assert np.abs(spec.numpy() - want_spec).max() < MAX_TOL
    assert np.abs(phase.numpy() - want_phase).max() < MAX_TOL
    want = np.asarray(jax_istft_to_audio(jnp.asarray(want_spec), jnp.asarray(want_phase), cfg))
    got = istft_to_audio(spec, phase, cfg).numpy()
    assert got.shape == want.shape == (2, 24 * 256)
    assert np.abs(want).mean() > 1e-3  # a real signal, not a silent init
    err = np.abs(got - want)
    assert err.mean() < MAE_TOL and err.max() < MAX_TOL, (err.mean(), err.max())
    # vocode() is the same two steps; build_generator("istft") the same module
    config = default_config()
    config = config.replace(models=config.models.replace(istft=config.models.istft.replace(
        **{k: v for k, v in ISTFT.items() if k != "gen_istft_n_fft"})))
    built = build_generator(config, "istft", device="cpu")
    load_into(built, params)
    np.testing.assert_array_equal(vocode(built, torch.from_numpy(mel), config, "istft").numpy(), got)


def test_bundle_vocoder_into_the_training_form():
    """``convert`` on ``vie_tiny/vocoder.msgpack``: into the training form
    every array lands as it is, 38 convolutions x (v, g, bias); into the
    serving form each (v, g) fuses, 38 x (weight, bias).  v takes the
    kernel's layout, transposed convolutions (in, out, k).  The training
    form's waveform equals JAX's, and fused it is the serving form's."""
    jax_gen, params, port = _vie_tiny()
    cfg = load_config(os.path.join(VIE_TINY, "config.yaml"))
    trained = build_generator(cfg, train=True, device="cpu")
    assert load_into(trained, params) == len(trained.state_dict()) == 114
    assert load_into(port, params) == len(port.state_dict()) == 76
    tree = params["params"]
    np.testing.assert_array_equal(trained.trunk.ups[1].v.detach().numpy(),
                                  tree["trunk"]["up_1"]["v"].transpose(1, 2, 0))
    np.testing.assert_array_equal(trained.conv_post.v.detach().numpy(),
                                  tree["conv_post"]["v"].transpose(2, 1, 0))
    np.testing.assert_array_equal(trained.trunk.conv_pre.g.detach().numpy(),
                                  tree["trunk"]["conv_pre"]["g"])
    mel = np.random.RandomState(3).randn(2, 24, 80).astype(np.float32)
    want = np.asarray(jax.jit(jax_gen.apply)(params, jnp.asarray(mel)))
    got = trained(torch.from_numpy(mel))
    assert got.requires_grad
    err = np.abs(got.detach().numpy() - want)
    assert err.mean() < MAE_TOL and err.max() < MAX_TOL, (err.mean(), err.max())
    fused = fuse_generator(trained)
    assert type(fused) is HifiGanGenerator
    for name, value in port.state_dict().items():  # the norms summed in another order
        torch.testing.assert_close(fused.state_dict()[name], value, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused(torch.from_numpy(mel)).numpy(),
                               port(torch.from_numpy(mel)).numpy(), rtol=0, atol=1e-6)


def test_istftnet_training_form_matches_jax_and_fuses():
    """The iSTFTNet training form on JAX's (v, g): spectrum and phase against
    JAX (the reflection pad (1, 0) included), and fused it is the serving
    form that ``convert`` fills."""
    jax_gen, params, port = _istft_pair()
    trained = TrainableIstftNet(**ISTFT, device="cpu")
    assert load_into(trained, params) == len(trained.state_dict())
    mel = np.random.RandomState(1).randn(2, 24, 80).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jax_gen.apply)(params, jnp.asarray(mel))]
    got = trained(torch.from_numpy(mel))
    for g, w in zip(got, want):
        assert g.requires_grad and g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() < MAX_TOL
    fused = fuse_generator(trained)
    assert type(fused) is IstftNetGenerator
    for g, w in zip(fused(torch.from_numpy(mel)), port(torch.from_numpy(mel))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def _bias_vocoder():
    """The JAX test's small HiFi-GAN with perturbed biases, on both sides."""
    kw = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 3)))
    jax_gen = JaxHifiGan(**kw)
    params = jax.jit(jax_gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)))
    keys = jax.random.split(jax.random.PRNGKey(7), len(jax.tree_util.tree_leaves(params)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [x + 0.05 * jax.random.normal(k, x.shape) if x.ndim == 1 else x
              for x, k in zip(leaves, keys)]
    params = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(treedef, leaves))
    port = HifiGanGenerator(**kw, device="cpu")
    load_into(port, params)
    return jax.jit(lambda mel: jax_gen.apply(params, mel)), port


def test_denoiser_matches_jax():
    jax_vocode, port = _bias_vocoder()
    jd = JaxDenoiser(jax_vocode, n_mel_channels=80, bias_frames=32)
    pd = Denoiser(port, n_mel_channels=80, bias_frames=32)
    assert pd.bias_spec.shape == tuple(jd.bias_spec.shape)
    assert np.abs(pd.bias_spec.numpy() - np.asarray(jd.bias_spec)).max() < MAX_TOL
    audio = (0.3 * np.random.RandomState(2).randn(2, 9000)).astype(np.float32)
    for strength in (0.1, 1.0):
        want = np.asarray(jd(jnp.asarray(audio), strength))
        got = pd(torch.from_numpy(audio), strength).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < MAX_TOL
    with pytest.raises(ValueError):
        Denoiser(port, mode="loud")
    # mode="normal" draws from a torch generator seeded 0: repeatable
    a, b = (Denoiser(port, mode="normal", bias_frames=32).bias_spec for _ in range(2))
    assert torch.equal(a, b)


def test_denoiser_reduces_bias():
    """The JAX package's check (tests/test_streaming.py): the bias signal
    itself is strongly attenuated."""
    _, port = _bias_vocoder()
    den = Denoiser(port, n_mel_channels=80, bias_frames=32)
    bias_audio = port(torch.zeros(1, 32, 80))
    out = den(bias_audio, strength=1.0)
    n = min(out.shape[-1], bias_audio.shape[-1]) - 512
    before = float(bias_audio[0, 256:n].abs().mean())
    after = float(out[0, 256:n].abs().mean())
    assert after < before * 0.5, (before, after)

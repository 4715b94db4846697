"""The port's reference-checkpoint import (``e2e_tts_tpu_torch/compat``)
against the JAX package's ``compat/torch_import.py``, on the CPU.

No reference checkpoint is in the repo, so each case writes a seeded random
``state_dict`` in the reference's layout
(``compat/reference_layout.random_reference_state_dict``: the inverse of
the converter, at the shapes of a port model at narrow widths) and feeds
both converters the same one:

- for each family (transformer with unsupervised and with supervised
  durations, conformer, fastformer, long-short) and each vocoder (HiFi-GAN
  ResBlock 1 and 2, iSTFTNet with two upsamplings): the port's tree
  ``array_equal`` to JAX's, every key the converter reads present, and the
  port's loader assigning every parameter and buffer of its model;
- forward parity through a ``torch.save`` -> ``load_torch_state_dict``
  round trip: the transformer acoustic model (durations bit-equal, postnet
  mel max |diff| < 1e-3) and HiFi-GAN (waveform MAE < 1e-5);
- the reformer refused on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from _torch_families import family_fs2
from e2e_tts_tpu.compat import torch_import as jti
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models import build_generator as jax_build_generator
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu_torch.compat import (convert_acoustic, convert_hifigan, load_acoustic,
                                      load_torch_state_dict, load_vocoder)
from e2e_tts_tpu_torch.compat.reference_layout import random_reference_state_dict
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.nn.variance import FeatureStats

pytestmark = pytest.mark.usefixtures("one_thread")

N_SYMBOLS, N_SPEAKERS = 40, 3
MEL_MAX_TOL, WAV_MAE_TOL = 1e-3, 1e-5
FAMILIES = [("transformer", True), ("transformer", False), ("conformer", True),
            ("fastformer", True), ("lstransformer", True)]
VOCODERS = {
    "hifigan_v1": ("hifigan", dict(upsample_initial_channel=32)),
    "hifigan_v2": ("hifigan", dict(resblock=2, upsample_initial_channel=32,
                                   resblock_dilation_sizes=((1, 3), (1, 3), (1, 3)))),
    "istft": ("istft", dict(upsample_initial_channel=32)),
}


def _acoustic_config(cfg, block_type, learn_alignment):
    """Either package's ``Config`` at the family tests' widths."""
    fs2 = family_fs2(cfg, block_type)
    v = fs2.variance
    fs2 = fs2.replace(variance=v.replace(
        variance_predictor=v.variance_predictor.replace(filter_size=24),
        duration_modelling=v.duration_modelling.replace(learn_alignment=learn_alignment)))
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2))


def _vocoder_config(cfg, name):
    kind, kw = VOCODERS[name]
    sub = "hifigan" if kind == "hifigan" else "istft"
    return kind, cfg.replace(models=cfg.models.replace(
        **{sub: getattr(cfg.models, sub).replace(**kw)}))


def _acoustic_kw(cfg):
    fs2 = cfg.models.fastspeech2
    vp = fs2.variance.variance_predictor
    return dict(encoder_layers=fs2.encoder_layers, decoder_layers=fs2.decoder_layers,
                dur_layers=vp.dur_predictor_layers, pit_layers=vp.pit_predictor_layers,
                ener_layers=vp.ener_predictor_layers, postnet_layers=fs2.postnet.conv_layers,
                learn_alignment=fs2.variance.duration_modelling.learn_alignment,
                block_type=fs2.building_block.block_type)


def _vocoder_kw(cfg, kind):
    vc = cfg.models.hifigan if kind == "hifigan" else cfg.models.istft
    return dict(n_upsamples=len(vc.upsample_rates), n_kernels=len(vc.resblock_kernel_sizes),
                n_res_convs=len(vc.resblock_dilation_sizes[0]), resblock_type=int(vc.resblock))


class _Reads(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _assert_same_tree(got, want):
    want = jax.tree_util.tree_map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


def _random_acoustic(block_type, learn_alignment, seed=0):
    cfg = _acoustic_config(default_config(), block_type, learn_alignment)
    template = FastSpeech2(cfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, 80, FeatureStats(),
                           device="cpu")
    return cfg, random_reference_state_dict(template, seed, block_type, learn_alignment)


@pytest.mark.parametrize("block_type,learn_alignment", FAMILIES)
def test_acoustic_tree_equals_jax(block_type, learn_alignment):
    cfg, sd = _random_acoustic(block_type, learn_alignment)
    kw = _acoustic_kw(cfg)
    reads = _Reads(sd)
    got = convert_acoustic(reads, **kw)
    assert reads.read == set(sd)  # every array of the state dict is read
    _assert_same_tree(got, jti.convert_acoustic(sd, **kw))
    model = load_acoustic(sd, cfg, N_SYMBOLS, N_SPEAKERS, device="cpu")
    state = model.state_dict()
    arrays = convert(got, state)
    assert set(arrays) == set(state)  # every parameter and buffer assigned
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), arrays[name])


@pytest.mark.parametrize("name", sorted(VOCODERS))
def test_vocoder_tree_equals_jax(name):
    kind, cfg = _vocoder_config(default_config(), name)
    sd = random_reference_state_dict(build_generator(cfg, kind, device="cpu"), seed=1)
    assert any(k.endswith(".weight_g") for k in sd)
    kw = _vocoder_kw(cfg, kind)
    reads = _Reads(sd)
    got = convert_hifigan(reads, **kw)
    assert reads.read == set(sd)
    _assert_same_tree(got, jti.convert_hifigan(sd, **kw))
    gen = load_vocoder(sd, cfg, kind, device="cpu")
    state = gen.state_dict()
    arrays = convert(got, state)
    assert set(arrays) == set(state)
    for key, t in state.items():
        np.testing.assert_array_equal(t.numpy(), arrays[key])


def test_reformer_is_refused():
    sd = {"encoder.src_word_emb.weight": np.zeros((4, 8), np.float32)}
    for fn in (convert_acoustic, jti.convert_acoustic):
        with pytest.raises(ValueError, match="no converter for block_type 'reformer'"):
            fn(sd, block_type="reformer")


def _round_trip(sd, tmp_path, name):
    """``torch.save`` in the reference's checkpoint format, read back by each
    package's ``load_torch_state_dict``."""
    path = str(tmp_path / f"{name}.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
    port, jax_sd = load_torch_state_dict(path), jti.load_torch_state_dict(path)
    assert set(port) == set(jax_sd) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(port[k], sd[k])
    return port, jax_sd


def test_transformer_forward_matches_jax(tmp_path):
    cfg, sd = _random_acoustic("transformer", True, seed=2)
    port_sd, jax_sd = _round_trip(sd, tmp_path, "acoustic")
    model = load_acoustic(port_sd, cfg, N_SYMBOLS, N_SPEAKERS, device="cpu")
    jcfg = _acoustic_config(jax_default_config(), "transformer", True)
    jm = JaxFastSpeech2(jcfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, 80, JaxFeatureStats())
    variables = jti.convert_acoustic(jax_sd, **_acoustic_kw(cfg))
    rng = np.random.RandomState(5)
    lens = np.array([17, 11], np.int32)
    texts = np.zeros((2, 17), np.int32)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, N_SYMBOLS, n)
    spk = np.array([1, 2], np.int32)
    x_j, d_j = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage1))(
        variables, jnp.asarray(spk), jnp.asarray(texts), jnp.asarray(lens))
    d_j = np.array(d_j)
    with torch.no_grad():
        x_t, d_t = model.synthesize_stage1(*(torch.from_numpy(a).long()
                                             for a in (spk, texts, lens)))
    np.testing.assert_array_equal(d_t.numpy(), d_j)  # bit-equal durations
    assert d_j.sum() > 0
    T = int(d_j.sum(-1).max())
    mel_j, lens_j = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage2),
                            static_argnums=(3,))(variables, x_j, jnp.asarray(d_j), T)
    with torch.no_grad():
        mel_t, lens_t = model.synthesize_stage2(torch.from_numpy(np.array(x_j)),
                                                torch.from_numpy(d_j), T)
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    assert np.abs(mel_t.numpy() - np.asarray(mel_j)).max() < MEL_MAX_TOL


def test_hifigan_forward_matches_jax(tmp_path):
    kind, cfg = _vocoder_config(default_config(), "hifigan_v1")
    sd = random_reference_state_dict(build_generator(cfg, kind, device="cpu"), seed=3)
    port_sd, jax_sd = _round_trip(sd, tmp_path, "generator")
    gen = load_vocoder(port_sd, cfg, kind, device="cpu")
    _, jcfg = _vocoder_config(jax_default_config(), "hifigan_v1")
    params = jti.convert_hifigan(jax_sd, **_vocoder_kw(cfg, kind))
    mel = (np.random.RandomState(1).randn(1, 24, 80) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jax_build_generator(jcfg, kind).apply)(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < WAV_MAE_TOL
    assert np.abs(want).mean() > 1e-3  # a waveform that the bar can see

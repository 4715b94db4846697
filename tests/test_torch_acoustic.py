"""The PyTorch port's FastSpeech2 serving stages against the JAX package's
``FastSpeech2.apply(method=synthesize_stage1/2)``, same weights (carried
across by ``convert.py``), same numpy inputs, on the CPU.

Two models: the shipped ``vie_tiny`` bundle on its golden texts, and a small
random one (hidden 48) at a 256-phoneme text bucket and a mel bucket >= 256,
so the encoder's and the decoder's flash branches run.  The JAX side runs
``use_flash=False`` (its compiled Pallas kernel cannot run on the CPU; the
XLA attention is the same function); the port runs ``use_flash=True``, which
on CPU tensors is the kernel's plain version.

Bars: durations bit-equal; postnet mel max |diff| < 1e-3 and MAE < 1e-4
(float32 on both sides, sums taken in another order).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.text import text_to_sequence as jax_text_to_sequence
from e2e_tts_tpu_torch.config import default_config, load_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.nn import transformer as port_transformer
from e2e_tts_tpu_torch.nn.variance import FeatureStats
from e2e_tts_tpu_torch.text.symbols import symbols

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")

MEL_MAX_TOL = 1e-3
MEL_MAE_TOL = 1e-4
CONTROLS = [(1.0, 1.0, 1.0), (1.2, 0.8, 1.3)]  # (pitch, energy, duration)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small(cfg):
    """Hidden 48, two layers each side, narrow predictors and postnet."""
    fs2 = cfg.models.fastspeech2
    return fs2.replace(
        encoder_layers=2, decoder_layers=2, encoder_hidden=48, decoder_hidden=48,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=96)),
        variance=fs2.variance.replace(
            variance_predictor=fs2.variance.variance_predictor.replace(filter_size=32)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=3),
    )


def _vie_tiny():
    """The bundle's weights as the JAX package restores them (flax msgpack);
    ``test_torch_engine.py`` holds the port's bundle reader to JAX's."""
    cfg = jax_load_config(os.path.join(VIE_TINY, "config.yaml"))
    with open(os.path.join(VIE_TINY, "acoustic.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    with open(os.path.join(VIE_TINY, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(VIE_TINY, "speakers.json")) as f:
        n_spk = max(len(json.load(f)), 1)
    n_mels = cfg.audio.mel.channels
    jax_model = JaxFastSpeech2(cfg.models.fastspeech2, len(symbols), n_spk, n_mels,
                               JaxFeatureStats.from_dict(stats))
    seqs = [jax_text_to_sequence(t) for t in ("xin chào việt nam", "em yêu hoa lá trên núi")]
    texts = np.zeros((2, 32), np.int32)
    for b, s in enumerate(seqs):
        texts[b, :len(s)] = s
    inputs = (np.array([0, n_spk - 1], np.int32), texts, np.array([len(s) for s in seqs], np.int32))
    port_cfg = load_config(os.path.join(VIE_TINY, "config.yaml")).models.fastspeech2
    port = FastSpeech2(port_cfg, len(symbols), n_spk, n_mels, FeatureStats.from_dict(stats),
                       use_flash=True, device="cpu")
    return jax_model, variables, port, inputs, 0


def _small_random():
    jcfg = _small(jax_default_config())
    n_mels, n_spk = 80, 3
    jax_model = JaxFastSpeech2(jcfg, len(symbols), n_spk, n_mels, JaxFeatureStats())
    variables = jax.jit(lambda: init_acoustic_variables(jax_model, 7))()
    rng = np.random.RandomState(0)
    lens = np.array([256, 181, 40], np.int32)
    texts = np.zeros((3, 256), np.int32)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, len(symbols), n)
    inputs = (np.array([2, 0, 1], np.int32), texts, lens)
    port = FastSpeech2(_small(default_config()), len(symbols), n_spk, n_mels, FeatureStats(),
                       use_flash=True, device="cpu")
    return jax_model, variables, port, inputs, 256


MODELS = {"vie_tiny": _vie_tiny, "small_random": _small_random}
_BUILT = {}


def _model(name):
    if name not in _BUILT:
        jax_model, variables, port, inputs, min_T = MODELS[name]()
        # every array placed, the aligner's included (load_into raises on a leftover)
        placed = load_into(port, _numpy_tree(variables))
        assert placed == len(port.state_dict())
        assert any(n.startswith("variance_adaptor.aligner.") for n in port.state_dict())
        stage1 = jax.jit(functools.partial(jax_model.apply, method=JaxFastSpeech2.synthesize_stage1))
        stage2 = jax.jit(functools.partial(jax_model.apply, method=JaxFastSpeech2.synthesize_stage2),
                         static_argnums=(3,))
        _BUILT[name] = (stage1, stage2, variables, port, inputs, min_T)
    return _BUILT[name]


@pytest.mark.parametrize("controls", CONTROLS, ids=["controls_1", "controls_1.2_0.8_1.3"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_stages_match_jax(name, controls, monkeypatch):
    stage1, stage2, variables, port, (spk, texts, lens), min_T = _model(name)
    p, e, d = controls

    x_j, d_j = stage1(variables, jnp.asarray(spk), jnp.asarray(texts), jnp.asarray(lens), p, e, d)
    d_j = np.array(d_j)
    T = max(min_T, -(-int(d_j.sum(-1).max()) // 128) * 128)
    mel_j, mel_lens_j = stage2(variables, x_j, jnp.asarray(d_j), T, p, e)

    calls = []
    real = port_transformer.flash_attention
    monkeypatch.setattr(port_transformer, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x_t, d_t = port.synthesize_stage1(*(torch.from_numpy(a).long() for a in (spk, texts, lens)),
                                      p_control=p, e_control=e, d_control=d)
    assert d_t.dtype == torch.int32
    np.testing.assert_array_equal(d_t.numpy(), d_j)  # bit-equal durations
    assert np.abs(x_t.numpy() - np.asarray(x_j)).max() < MEL_MAX_TOL

    # the same durations and stage-1 output into both stage-2 runs
    mel_t, mel_lens_t = port.synthesize_stage2(torch.from_numpy(np.array(x_j)),
                                               torch.from_numpy(d_j), T, p, e)
    np.testing.assert_array_equal(mel_lens_t.numpy(), np.asarray(mel_lens_j))
    diff = np.abs(mel_t.numpy() - np.asarray(mel_j))
    assert diff.max() < MEL_MAX_TOL and diff.mean() < MEL_MAE_TOL, (diff.max(), diff.mean())
    if min_T >= 256:  # the flash branch ran in the encoder and the decoder
        assert (texts.shape[0] * 2, texts.shape[1], 24) in calls
        assert (texts.shape[0] * 2, T, 24) in calls


@pytest.mark.parametrize("k,dilation", [(9, 1), (5, 1), (3, 1), (1, 1), (3, 2)])
def test_conv1d_unfold_is_the_convolution(k, dilation):
    """``nn/common.conv1d_unfold`` (the float32 training form's convolution on
    the card, ROADMAP C1) against ``F.conv1d``: the output and the gradients
    of the input, the weight and the bias, in float64 to rounding."""
    import torch.nn.functional as F

    from e2e_tts_tpu_torch.nn.common import conv1d_unfold

    g = torch.Generator().manual_seed(k * 10 + dilation)
    x = torch.randn(3, 6, 40, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(5, 6, k, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, generator=g, dtype=torch.float64, requires_grad=True)
    got, want = conv1d_unfold(x, w, b, dilation), F.conv1d(x, w, b, dilation=dilation)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    dy = torch.randn(want.shape, generator=g, dtype=torch.float64)
    for a, c in zip(torch.autograd.grad(got, (x, w, b), dy),
                    torch.autograd.grad(want, (x, w, b), dy)):
        assert torch.allclose(a, c, rtol=1e-12, atol=1e-12)

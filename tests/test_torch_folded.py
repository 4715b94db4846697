"""The engine's remaining one-card serving options against the JAX
package's, on the CPU: the folded HiFi-GAN tail (``kernels/folded_tail.py``,
``use_folded_vocoder``), the mu-law transfer codec (``transfer_codec``) and
the flash switch (``use_flash``).

Bars:
- the fold functions (``fold_conv_weight``, ``fold_convT_weight``,
  ``fold_head_weight``, ``_fuse_wn``) equal to JAX's, element for element;
- ``FoldedHifiGan`` at float32 on a tiny ResBlock1 generator whose kernels
  sit at a trained norm: waveform MAE < 1e-5 against JAX's folded tail on
  the same weights and against the port's own unfolded generator;
- the engine's int16 with ``use_folded_vocoder=True`` within 1 LSB mean of
  JAX's engine with the same argument (``vie_tiny``, every stage folded);
- the codec: ``mulaw8`` bytes equal to JAX's ``_encode_transfer`` on the
  same float waveform, the decode table equal to JAX's, and an engine's
  ``mulaw8`` output one of the table's values within a code of its int16;
- ``use_flash=False``: no attention module asks for the kernel, and the
  audio within 1 LSB mean of the default's.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.kernels import folded_tail as jax_folded
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.kernels import folded_tail
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.nn.transformer import MultiHeadAttention
from e2e_tts_tpu_torch.serve import SynthesisEngine

pytestmark = pytest.mark.usefixtures("one_thread")

VIE_TINY = os.path.join(os.path.dirname(__file__), "..", "assets", "bundles", "vie_tiny")
TEXT = "xin chào việt nam, hôm nay trời đẹp quá"
WAVE_MAE = 1e-5
# a tiny ResBlock1 generator: 128 channels in, so that every stage folds
# (64, 32, 16 and 8 channels), two resblocks a stage
TINY = dict(upsample_initial_channel=128, resblock_kernel_sizes=(3, 7),
            resblock_dilation_sizes=((1, 3), (1, 3)))


def _lsb(a, b):
    assert a.dtype == b.dtype == np.int16 and len(a) == len(b) > 0
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


# --- the fold functions --------------------------------------------------------------------

@pytest.mark.parametrize("k, c, d, f",
                         [(3, 8, 1, 16), (7, 16, 3, 8), (11, 32, 5, 4), (3, 64, 1, 2)])
def test_fold_conv_weight_equals_jax(k, c, d, f):
    w = np.random.RandomState(k * c).randn(k, c, c).astype(np.float32)
    np.testing.assert_array_equal(folded_tail.fold_conv_weight(w, d, f),
                                  jax_folded.fold_conv_weight(w, d, f))


@pytest.mark.parametrize("k, s, f", [(16, 8, 1), (4, 2, 2), (4, 2, 8), (16, 8, 2)])
def test_fold_convT_weight_equals_jax(k, s, f):
    w = np.random.RandomState(k + s).randn(k, 8, 4).astype(np.float32)
    got, want = folded_tail.fold_convT_weight(w, s, f), jax_folded.fold_convT_weight(w, s, f)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_fold_head_and_fuse_equal_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(7, 8, 1).astype(np.float32)
    got, want = folded_tail.fold_head_weight(w, 16), jax_folded.fold_head_weight(w, 16)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    p = {"v": rng.randn(7, 8, 4).astype(np.float32), "g": rng.rand(4).astype(np.float32),
         "bias": rng.randn(4).astype(np.float32)}
    for a, b in zip(folded_tail._fuse_wn(p), jax_folded._fuse_wn(p)):
        np.testing.assert_array_equal(a, b)


# --- the folded generator ------------------------------------------------------------------

def _trained_scale(params, seed):
    """Each kernel's g drawn U(0.5, 1.5), biases nonzero: a waveform well above
    float noise (at the init's g the tiny generator's output is near 0)."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        key = getattr(path[-1], "key", None)
        if key == "g":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key == "bias":
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


_GEN = {}


def _generators():
    """(JAX generator config, its parameters at a trained scale, the port's
    serving generator with those weights, a mel (1, 24, 80))."""
    if not _GEN:
        cfg = jax_default_config().models.hifigan.replace(**TINY)
        mel = (np.random.RandomState(1).randn(1, 24, 80) * 1.5 - 5.0).astype(np.float32)
        params = jax.jit(JaxHifiGan.from_config(cfg).init)(jax.random.PRNGKey(0), jnp.asarray(mel))
        params = _trained_scale(jax.tree_util.tree_map(np.asarray, params), 2)
        pcfg = default_config()
        pcfg = pcfg.replace(models=pcfg.models.replace(hifigan=pcfg.models.hifigan.replace(**TINY)))
        gen = build_generator(pcfg, "hifigan", device="cpu")
        load_into(gen, params)
        _GEN.update(cfg=cfg, params=params, gen=gen, mel=mel)
    return _GEN["cfg"], _GEN["params"], _GEN["gen"], _GEN["mel"]


def test_folded_generator_matches_jax_folded_tail():
    cfg, params, gen, mel = _generators()
    jf = jax_folded.FoldedHifiGan(cfg, params)
    want = np.asarray(jf(jf.weights, jnp.asarray(mel)))
    folded = folded_tail.FoldedHifiGan(gen)
    assert folded.final_fold == 16 and all(st["f"] > 1 for st in folded.plan)
    got = folded(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    assert np.abs(want).mean() > 1e-2  # a waveform that tests something
    assert np.abs(got - want).mean() < WAVE_MAE


def test_folded_generator_matches_the_unfolded_generator():
    _, _, gen, mel = _generators()
    x = torch.from_numpy(mel)
    want = gen(x).numpy()
    got = folded_tail.FoldedHifiGan(gen)(x).numpy()
    assert np.abs(got - want).mean() < WAVE_MAE
    # a high-channel stage keeps its width (F = 1) and only its transposed
    # convolution takes the polyphase form
    cfg = default_config()
    wide = build_generator(cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(
        upsample_initial_channel=256, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),)))), "hifigan", device="cpu")
    f = folded_tail.FoldedHifiGan(wide)
    assert [st["f"] for st in f.plan] == [1, 2, 4, 8]
    x = x[:, :8]
    assert np.abs(f(x).numpy() - wide(x).numpy()).mean() < WAVE_MAE


def test_folded_tail_refuses_resblock2():
    cfg = default_config()
    gen = build_generator(cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(
        resblock=2, upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),)))), "hifigan", device="cpu")
    with pytest.raises(ValueError, match="ResBlock1"):
        folded_tail.FoldedHifiGan(gen)


# --- the engine ----------------------------------------------------------------------------

_ENGINES = {}


def _jax_folded_engine():
    """JAX's vie_tiny engine with the folded tail, compiled once a file."""
    if "jax" not in _ENGINES:
        _ENGINES["jax"] = JaxEngine.from_checkpoint(VIE_TINY, use_folded_vocoder=True,
                                                    transfer_codec="int16")
    return _ENGINES["jax"]


def test_engine_folded_vocoder_matches_jax_engine():
    jeng = _jax_folded_engine()
    assert jeng.use_folded_vocoder
    peng = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", use_folded_vocoder=True)
    assert peng.use_folded_vocoder and isinstance(peng._folded, folded_tail.FoldedHifiGan)
    d = _lsb(peng.synthesize(TEXT), jeng.synthesize(TEXT))
    assert d.mean() < 1.0, (d.mean(), d.max())
    # the unfolded engine of the same bundle: the fold is exact algebra
    plain = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    assert not plain.use_folded_vocoder
    assert _lsb(peng.synthesize(TEXT), plain.synthesize(TEXT)).mean() < 1.0


def test_folded_vocoder_default_and_scope():
    """Off unless asked for (JAX's default is on only on a TPU backend); the
    flag does nothing for iSTFTNet, as JAX's."""
    assert not SynthesisEngine.from_random(
        seed=0, config=_tiny_engine_config(), device="cpu").use_folded_vocoder
    istft = SynthesisEngine.from_random(seed=0, config=_tiny_engine_config(), device="cpu",
                                        vocoder_kind="istft", use_folded_vocoder=True)
    assert not istft.use_folded_vocoder and istft._folded is None


def _tiny_engine_config():
    cfg = default_config()
    fs2 = cfg.models.fastspeech2.replace(encoder_layers=1, decoder_layers=1, encoder_hidden=32,
                                         decoder_hidden=32)
    return cfg.replace(models=cfg.models.replace(
        fastspeech2=fs2, hifigan=cfg.models.hifigan.replace(**TINY),
        istft=cfg.models.istft.replace(upsample_initial_channel=32)))


# --- the transfer codec --------------------------------------------------------------------

def _waveform():
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.uniform(-1, 1, 4096), rng.randn(4096) * 0.05,
                        np.linspace(-1.2, 1.2, 2049), [0.0, -0.0, 1.0, -1.0]])
    return x.astype(np.float32)[None]


def test_mulaw8_bytes_equal_jax():
    x = _waveform()
    jax_self = types.SimpleNamespace(transfer_codec="mulaw8", _MU=JaxEngine._MU)
    want = np.asarray(JaxEngine._encode_transfer(jax_self, jnp.asarray(x)))
    peng = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", transfer_codec="mulaw8")
    assert peng.transfer_codec == "mulaw8"
    got = peng._encode_transfer(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(SynthesisEngine._mulaw_lut(), JaxEngine._mulaw_lut())
    np.testing.assert_array_equal(peng._decode_transfer(got.numpy()), JaxEngine._mulaw_lut()[want])
    # int16, the port's default: the JAX engine's lossless encoding
    jax_self.transfer_codec = None
    plain = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    np.testing.assert_array_equal(plain._encode_transfer(torch.from_numpy(x)).numpy(),
                                  np.asarray(JaxEngine._encode_transfer(jax_self, jnp.asarray(x))))


def test_engine_mulaw8_serves_table_values_near_its_int16():
    lut = SynthesisEngine._mulaw_lut().astype(np.int32)
    plain = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    mulaw = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", transfer_codec="mulaw8")
    a, m = plain.synthesize(TEXT), mulaw.synthesize(TEXT)
    assert m.dtype == np.int16 and len(m) == len(a)
    # the silence between chunks is zeros in both; 0 is no code of the table
    assert (a[m == 0] == 0).all() and np.isin(m[m != 0], lut).all()
    # each sample within one code of the lossless one: the gap between the
    # table's neighbours around it
    idx = np.clip(np.searchsorted(lut, a.astype(np.int32)), 1, 255)
    gap = lut[idx] - lut[idx - 1]
    coded = m != 0
    assert (np.abs(m.astype(np.int32) - a)[coded] <= gap[coded]).all()
    with pytest.raises(ValueError):
        SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", transfer_codec="alaw8")


# --- the flash switch ----------------------------------------------------------------------

def test_use_flash_false_serves_the_plain_attention():
    default = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    plain = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", use_flash=False)
    attn = lambda e: [m.use_flash for m in e.acoustic.modules()  # noqa: E731
                      if isinstance(m, MultiHeadAttention)]
    assert attn(default) and all(attn(default))  # None keeps the kernel at T >= 256
    assert not any(attn(plain))
    long = TEXT + ", " + TEXT + ", " + TEXT  # a mel bucket >= 256: the flash branch's reach
    d = _lsb(plain.synthesize(long), default.synthesize(long))
    assert d.mean() < 1.0, d.mean()

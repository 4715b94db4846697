"""The port's serving in a 16-bit compute dtype against the JAX package's at
``dtype=bfloat16, use_flash=True``, on the CPU; and the float64 runs that
the GAN gradients' oracle takes.

The JAX side runs its Pallas kernel in interpret mode: ``e2e_tts_tpu/nn/
transformer.py`` imports ``e2e_tts_tpu.kernels.flash_attention`` inside the
call, so a fixture swaps in ``functools.partial(..., interpret=True)``.  The
port runs ``use_flash=True`` too; on CPU tensors its kernel is the plain
version (float32 on the upcast inputs, rounded once).  Weights are carried
across by ``convert.py`` and inputs come from numpy seeds.

Bars:
- the kernel's plain version against the Pallas kernel in bfloat16 and
  float16: every valid element within one ulp of the 16-bit output
  (``ulp_error``: near 0, float32's ulp at the head's largest |v|);
- every stage, both vocoders and the engine: max and mean
  |port_bf16 - jax_bf16| <= 2 x |jax_bf16 - jax_f32| on the same inputs;
- durations equal, except where JAX's own pre-rounding value
  exp(log_d) - 1 lies within what one bfloat16 ulp of its log_d moves it,
  (value + 1) * ulp(log_d), of x.5 (log_d is a bfloat16: one ulp of it at
  log_d ~ 3.5 moves a 31-frame phoneme by half a frame, far more than one
  ulp of the value); stage 2 then runs from JAX's durations and stage-1
  output;
- float64 against float32 (``.double()``): within 1e-5 relative.
"""

import copy
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
import e2e_tts_tpu.kernels as jax_kernels
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.models.vocoder import build_generator as jax_build_generator
from e2e_tts_tpu.models.vocoder import istft_to_audio as jax_istft_to_audio
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.transformer import FFTBlock as JaxFFTBlock
from e2e_tts_tpu.ops import sequence_mask as jax_sequence_mask
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu.text import text_to_sequence as jax_text_to_sequence
from e2e_tts_tpu_torch.config import default_config, load_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention, ulp_error
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.models.vocoder import build_generator, istft_to_audio
from e2e_tts_tpu_torch.nn import transformer as port_transformer
from e2e_tts_tpu_torch.nn.transformer import FFTBlock
from e2e_tts_tpu_torch.nn.variance import FeatureStats
from e2e_tts_tpu_torch.serve import BatchingServer, SynthesisEngine, Synthesizer, stream_synthesize
from e2e_tts_tpu_torch.text.symbols import symbols

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
GOLDEN = "xin chào việt nam"
F64_RTOL = 1e-5
_JAX_FLASH = jax_kernels.flash_attention


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernel in interpret mode (it compiles for a TPU only)."""
    monkeypatch.setattr(jax_kernels, "flash_attention", functools.partial(_JAX_FLASH, interpret=True))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _within_twice_jax(got, jax_bf16, jax_f32, what):
    """max and mean |port - jax_bf16| <= 2 x the same of |jax_bf16 - jax_f32|."""
    got, jb, jf = (_f32(a) for a in (got, jax_bf16, jax_f32))
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert theirs.max() > 0, what  # the JAX side did run in 16 bits
    assert ours.max() <= 2 * theirs.max() and ours.mean() <= 2 * theirs.mean(), (
        what, float(ours.max()), float(theirs.max()), float(ours.mean()), float(theirs.mean()))


def _to_port(x, dtype=torch.bfloat16):
    """A JAX 16-bit array as the same values in a torch tensor."""
    return torch.from_numpy(np.array(_f32(x))).to(dtype)


# --- the kernel -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("BH,T,D,lens", [(4, 256, 192, (256, 200, 129, 64)), (2, 100, 64, (100, 37))],
                         ids=["4x256x192", "2x100x64"])
def test_flash_plain_16bit_matches_pallas(dtype, BH, T, D, lens):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(BH, T, D) * s for s in (0.3, 0.3, 1.0))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = _JAX_FLASH(jq, jk, jv, jnp.asarray(lens, jnp.int32), interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_to_port(a, tdt) for a in (jq, jk, jv))
    kv = torch.tensor(lens, dtype=torch.int32)
    before = (flash_attention.launches, flash_attention.launches_16)
    got = flash_attention(tq, tk, tv, kv)
    assert got.dtype == tdt and torch.equal(got, attention_plain(tq, tk, tv, kv))
    assert (flash_attention.launches, flash_attention.launches_16) == before  # CPU: no launch
    assert ulp_error(got, _to_port(want, tdt), tv, kv) <= 1.0


# --- one FFT block in each attention branch ------------------------------------------------

@pytest.mark.parametrize("T,lens", [(256, (256, 190)), (100, (100, 61))], ids=["flash", "plain"])
def test_fft_block_matches_jax(interpret, monkeypatch, T, lens):
    B, d, H = 2, 48, 2
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, d).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array(lens)[:, None]
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        block = JaxFFTBlock(d, H, 96, (9, 1), 0.0, True, dt)
        params = block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
        outs[dt] = jax.jit(block.apply)(params, jnp.asarray(x, dt), jnp.asarray(mask))
    port = FFTBlock(d, H, 96, (9, 1), True, 0.0, generator=torch.Generator(), device="cpu",
                    dtype=torch.bfloat16)
    load_into(port, jax.tree_util.tree_map(np.asarray, params))
    calls = []
    real = port_transformer.flash_attention
    monkeypatch.setattr(port_transformer, "flash_attention",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    with torch.no_grad():
        got = port(_to_port(jnp.asarray(x, jnp.bfloat16)), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert calls == ([torch.bfloat16] if T >= 256 else [])
    _within_twice_jax(got, outs[jnp.bfloat16], outs[jnp.float32], f"FFT block at T={T}")


# --- stage 1, stage 2 ---------------------------------------------------------------------

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


def _vie_tiny_acoustic():
    cfg = jax_load_config(os.path.join(VIE_TINY, "config.yaml")).models.fastspeech2
    with open(os.path.join(VIE_TINY, "acoustic.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    with open(os.path.join(VIE_TINY, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(VIE_TINY, "speakers.json")) as f:
        n_spk = max(len(json.load(f)), 1)
    seqs = [jax_text_to_sequence(t) for t in (GOLDEN, "em yêu hoa lá trên núi")]
    texts = np.zeros((2, 32), np.int32)
    for b, s in enumerate(seqs):
        texts[b, :len(s)] = s
    inputs = (np.array([0, n_spk - 1], np.int32), texts, np.array([len(s) for s in seqs], np.int32))
    port_cfg = load_config(os.path.join(VIE_TINY, "config.yaml")).models.fastspeech2

    def jax_model(dt):
        return JaxFastSpeech2(cfg, len(symbols), n_spk, 80, JaxFeatureStats.from_dict(stats),
                              use_flash=True, dtype=dt)

    def port_model(dt):
        return FastSpeech2(port_cfg, len(symbols), n_spk, 80, FeatureStats.from_dict(stats),
                           use_flash=True, device="cpu", dtype=dt)

    return jax_model, port_model, variables, inputs, 0


def _small_random_acoustic():
    cfg = _small(jax_default_config())

    def jax_model(dt):
        return JaxFastSpeech2(cfg, len(symbols), 3, 80, JaxFeatureStats(), use_flash=True, dtype=dt)

    def port_model(dt):
        return FastSpeech2(_small(default_config()), len(symbols), 3, 80, FeatureStats(),
                           use_flash=True, device="cpu", dtype=dt)

    variables = jax.jit(lambda: init_acoustic_variables(jax_model(jnp.float32), 7))()
    rng = np.random.RandomState(0)
    lens = np.array([256, 181, 40], np.int32)
    texts = np.zeros((3, 256), np.int32)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, len(symbols), n)
    return jax_model, port_model, variables, (np.array([2, 0, 1], np.int32), texts, lens), 256


def _log_durations(module, speakers, texts, txt_lens):
    """JAX's stage 1 up to the durations: (log_d, exp(log_d) - 1), in its dtype."""
    mask = jax_sequence_mask(txt_lens, texts.shape[1])
    x, _ = module.encoder(texts, mask, deterministic=True)
    x = x + module.speaker_emb(speakers).astype(module.dtype)[:, None, :]
    log_d = module.variance_adaptor.duration_predictor(x, mask, True)
    return log_d, jnp.exp(log_d) - 1.0


def _ulp_bf16(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("build", [_vie_tiny_acoustic, _small_random_acoustic],
                         ids=["vie_tiny", "small_random"])
def test_stages_match_jax(interpret, monkeypatch, build):
    jax_model, port_model, variables, (spk, texts, lens), min_T = build()
    args = tuple(jnp.asarray(a) for a in (spk, texts, lens))
    stage1, stage2 = {}, {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = jax_model(dt)
        stage1[dt] = jax.jit(functools.partial(m.apply, method=JaxFastSpeech2.synthesize_stage1))(
            variables, *args, 1.0, 1.0, 1.0)
    x_j, d_j = stage1[jnp.bfloat16]
    d_j = np.array(d_j)

    port = port_model(torch.bfloat16)
    load_into(port, jax.tree_util.tree_map(np.asarray, variables))
    calls = []
    real = port_transformer.flash_attention
    monkeypatch.setattr(port_transformer, "flash_attention",
                        lambda *a: calls.append((a[0].dtype, a[0].shape[1])) or real(*a))
    x_t, d_t = port.synthesize_stage1(*(torch.from_numpy(a).long() for a in (spk, texts, lens)))
    assert x_t.dtype == torch.bfloat16 and d_t.dtype == torch.int32
    _within_twice_jax(x_t, x_j, stage1[jnp.float32][0], "stage 1 x")

    differ = np.argwhere(d_t.numpy() != d_j)
    if len(differ):
        log_d, value = jax.jit(functools.partial(jax_model(jnp.bfloat16).apply, method=_log_durations))(
            variables, *args)
        log_d, value = _f32(log_d), _f32(value)
        for b, i in differ:
            v = value[b, i]
            reach = (v + 1.0) * _ulp_bf16(log_d[b, i])  # what one ulp of log_d moves v by
            assert abs(v - np.floor(v) - 0.5) <= reach, (b, i, v, reach)
    assert len(differ) <= 0.05 * lens.sum()

    # stage 2 from JAX's stage-1 output and durations
    T = max(min_T, -(-int(d_j.sum(-1).max()) // 128) * 128)
    for dt in (jnp.float32, jnp.bfloat16):
        m = jax_model(dt)
        stage2[dt] = jax.jit(functools.partial(m.apply, method=JaxFastSpeech2.synthesize_stage2),
                             static_argnums=(3,))(variables, x_j.astype(dt), jnp.asarray(d_j), T,
                                                  1.0, 1.0)
    mel_t, lens_t = port.synthesize_stage2(_to_port(x_j), torch.from_numpy(d_j), T)
    assert mel_t.dtype == torch.float32  # mel_linear and the postnet: float32 islands
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(stage2[jnp.bfloat16][1]))
    _within_twice_jax(mel_t, stage2[jnp.bfloat16][0], stage2[jnp.float32][0], "postnet mel")
    if min_T >= 256:  # both flash branches ran, in 16 bits
        assert (torch.bfloat16, texts.shape[1]) in calls and (torch.bfloat16, T) in calls


# --- the vocoders ----------------------------------------------------------------------

ISTFT = dict(gen_istft_n_fft=16, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
             upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
             resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _vocoder(kind):
    if kind == "hifigan":
        with open(os.path.join(VIE_TINY, "vocoder.msgpack"), "rb") as f:
            params = serialization.msgpack_restore(f.read())
        jcfg = jax_load_config(os.path.join(VIE_TINY, "config.yaml"))
        pcfg = load_config(os.path.join(VIE_TINY, "config.yaml"))
    else:
        jcfg, pcfg = jax_default_config(), default_config()
        jcfg = jcfg.replace(models=jcfg.models.replace(istft=jcfg.models.istft.replace(**ISTFT)))
        pcfg = pcfg.replace(models=pcfg.models.replace(istft=pcfg.models.istft.replace(**ISTFT)))
        gen = jax_build_generator(jcfg, "istft")
        params = jax.jit(gen.init)(jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)))
        # kernel norms at a trained scale, so that the spectrum is not flat
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x * 8.0 if getattr(p[-1], "key", None) == "g" else x, params)
    return jcfg, pcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_vocoders_match_jax(kind):
    jcfg, pcfg, params = _vocoder(kind)
    mel = (np.random.RandomState(0).randn(2, 24, 80) - 4.0).astype(np.float32)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        gen = jax_build_generator(jcfg, kind, dtype=dt)
        out = jax.jit(gen.apply)(params, jnp.asarray(mel))
        outs[dt] = out if kind == "hifigan" else jax_istft_to_audio(*out, jcfg.models.istft)
    port = build_generator(pcfg, kind, device="cpu", dtype=torch.bfloat16)
    load_into(port, params)
    out = port(torch.from_numpy(mel))
    got = out if kind == "hifigan" else istft_to_audio(*out, pcfg.models.istft)
    assert got.dtype == torch.float32  # conv_post onward: a float32 island
    _within_twice_jax(got, outs[jnp.bfloat16], outs[jnp.float32], f"{kind} waveform")


# --- the engine ----------------------------------------------------------------------------

_ENGINES = {}


def _engine(side, dtype):
    key = (side, dtype)
    if key not in _ENGINES:
        if side == "jax":
            _ENGINES[key] = JaxEngine.from_checkpoint(VIE_TINY, dtype=getattr(jnp, dtype),
                                                      use_flash=True)
        else:
            _ENGINES[key] = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu",
                                                            dtype=getattr(torch, dtype))
    return _ENGINES[key]


def test_engine_matches_jax_on_golden_text(interpret):
    want = _engine("jax", "bfloat16").synthesize(GOLDEN)
    ref = _engine("jax", "float32").synthesize(GOLDEN)
    got = _engine("port", "bfloat16").synthesize(GOLDEN)
    assert got.dtype == want.dtype == np.int16 and len(got) == len(want) == len(ref)
    ours = np.abs(got.astype(np.int32) - want)
    theirs = np.abs(want.astype(np.int32) - ref)
    assert ours.max() <= 2 * theirs.max() and ours.mean() <= 2 * theirs.mean(), (
        ours.max(), theirs.max(), ours.mean(), theirs.mean())


def test_bf16_engine_streams_queues_writes_and_denoises(tmp_path):
    """A bfloat16 engine through the serving surfaces: the streamed chunks
    are the engine's waveform (but for the last 16 frames, which the
    streamer's final segment renders over its zero halo, the engine over its
    bucket's padding), the queue's result equals a solo request,
    the Synthesizer's wav reads back as the engine's int16, and the
    denoiser (float32, as in JAX) runs on its vocoder."""
    from scipy.io import wavfile

    eng = _engine("port", "bfloat16")
    solo = eng.synthesize(GOLDEN)
    streamed = np.concatenate(list(stream_synthesize(eng, GOLDEN)))
    assert len(solo) == len(streamed) + eng.sample_rate // 2
    body = len(streamed) - 16 * eng.hop_length
    assert np.abs(solo[:body].astype(np.int32) - streamed[:body]).mean() < 1.0
    with BatchingServer(eng, max_wait_ms=5.0) as srv:
        queued = srv.submit(GOLDEN).result(timeout=300)
    assert np.array_equal(queued, solo)
    path = Synthesizer(eng, output_dir=str(tmp_path)).synthesis(GOLDEN)
    sr, wav = wavfile.read(path)
    assert sr == eng.sample_rate and np.array_equal(wav, eng.synthesize(GOLDEN))
    den = eng.synthesize_denoised(GOLDEN)
    assert den.dtype == np.int16 and 0 <= len(solo) - len(den) < eng.hop_length  # whole STFT frames


def test_engine_dtype_is_the_models():
    eng = _engine("port", "bfloat16")
    assert eng.dtype == torch.bfloat16
    assert eng.acoustic.dtype == eng.vocoder.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in eng.acoustic.parameters())  # as flax keeps them
    f32 = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        SynthesisEngine(f32.config, f32.acoustic, f32.vocoder, f32.speakers, f32.stats,
                        device="cpu", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        FastSpeech2(f32.acoustic.config, len(symbols), 1, 80, FeatureStats(), device="cpu",
                    dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="A14"):
        build_generator(f32.config, train=True, device="cpu", dtype=torch.bfloat16)


# --- float64 (the GAN gradients' oracle) -------------------------------------------------

def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_acoustic_float64_matches_float32():
    """Serving stages and the training pass in float64 (``.double()``): the
    float islands follow the input instead of pinning float32."""
    _, port_model, variables, (spk, texts, lens), _ = _vie_tiny_acoustic()
    f32 = port_model(torch.float32)
    load_into(f32, jax.tree_util.tree_map(np.asarray, variables))
    f64 = copy.deepcopy(f32).double()
    ins = [torch.from_numpy(a).long() for a in (spk, texts, lens)]
    x32, d32 = f32.synthesize_stage1(*ins)
    x64, d64 = f64.synthesize_stage1(*ins)
    assert x64.dtype == torch.float64 and torch.equal(d32, d64) and _rel(x32, x64) < F64_RTOL
    T = -(-int(d32.sum(-1).max()) // 128) * 128
    m32, _ = f32.synthesize_stage2(x32, d32, T)
    m64, _ = f64.synthesize_stage2(x32.double(), d32, T)
    assert m64.dtype == torch.float64 and _rel(m32, m64) < F64_RTOL

    # the training pass (dropout off), with MAS and the forward-sum CTC
    from e2e_tts_tpu_torch.audio import beta_binomial_prior
    from e2e_tts_tpu_torch.models.acoustic_loss import fastspeech2_loss

    rng = np.random.RandomState(3)
    B, L, Tm = 2, 32, 96
    tl, ml = np.array([20, 12]), np.array([96, 60])
    mel = np.zeros((B, Tm, 80))
    prior = np.zeros((B, Tm, L))
    for b in range(B):
        mel[b, :ml[b]] = rng.randn(ml[b], 80) - 4.0
        prior[b, :ml[b], :tl[b]] = beta_binomial_prior(tl[b], ml[b])
    f0 = rng.randn(B, Tm) * (rng.rand(B, Tm) > 0.3)
    outs = {}
    for name, model, dt in (("f32", f32, torch.float32), ("f64", f64, torch.float64)):
        model.train()
        for m in model.modules():
            if isinstance(getattr(m, "dropout", None), float):
                m.dropout = 0.0
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
        out = model(torch.zeros(B, dtype=torch.long), torch.from_numpy(texts[:, :L]).long(),
                    torch.from_numpy(tl), t(mel), torch.from_numpy(ml), t(prior),
                    {"f0": t(f0), "uv": t(f0 == 0)}, t(rng.randn(B, Tm) * 0), 30000,
                    torch.Generator())
        loss = fastspeech2_loss(out, t(mel), torch.from_numpy(tl), torch.from_numpy(ml),
                                torch.zeros(B, L, dtype=torch.long), 64, 30000,
                                default_config().train.fastspeech2_loss)
        outs[name] = (out, loss)
    (o32, l32), (o64, l64) = outs["f32"], outs["f64"]
    assert o64["postnet_mel"].dtype == torch.float64
    assert torch.equal(o32["duration_rounded"], o64["duration_rounded"])
    assert _rel(o32["postnet_mel"], o64["postnet_mel"]) < F64_RTOL
    for k in l32:
        assert abs(l32[k].item() - l64[k].item()) <= F64_RTOL * max(abs(l64[k].item()), 1e-3), k


@pytest.mark.parametrize("train", [False, True], ids=["serving", "training"])
@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_generators_float64_match_float32(kind, train):
    _, pcfg, params = _vocoder(kind)
    f32 = build_generator(pcfg, kind, train=train, device="cpu")
    load_into(f32, params)
    f64 = copy.deepcopy(f32).double()
    mel = torch.from_numpy((np.random.RandomState(4).randn(2, 16, 80) - 4.0).astype(np.float32))
    out32, out64 = f32(mel), f64(mel.double())
    if kind == "istft":
        out32, out64 = (istft_to_audio(*o, pcfg.models.istft) for o in (out32, out64))
    assert out64.dtype == torch.float64 and _rel(out32, out64) < F64_RTOL

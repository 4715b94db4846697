"""The port's supervised-duration FastSpeech2 (``learn_alignment: false``:
the ming024 duration predictor, no aligner, durations from the batch)
against the JAX package's, on the CPU, with the same weights (carried by
``convert.py``) and the same numpy inputs.

A small model (hidden 32, 2 + 2 transformer layers, predictors of 24
channels), at each predictor padding: "SAME" and "CAUSAL" (the JAX package
maps any ``ffn_padding`` but "SAME" to a causal duration-predictor
convolution).  Dropout is off on both sides for parity (config rates 0, the
postnet's hard-coded 0.5 through ``functools.partial`` on the JAX side and
the attribute on the port's).

Bars (float32 on both sides, sums in another order):
- the causal and SAME ``Conv1d`` within 1e-6 of JAX's; a causal output does
  not see later inputs;
- serving stages: durations bit-equal, postnet mel max |diff| < 1e-3 and
  MAE < 1e-4;
- the training forward: durations equal to the target; each output and loss
  term within 1e-5 relative; no ``ctc`` or ``bin`` term on either side;
- gradients within 1e-4 relative norm per tensor, the update of one
  ``make_train_step`` step within 1e-3.  Adam's first step is
  g / (|g| + eps) per element, which turns the float noise of a gradient
  near 0 into a step of up to the learning rate either way: elements whose
  JAX gradient is below 1e-5 of their tensor's largest (float32 sums lose
  that much) are held within the learning rate instead, as the tensors
  whose gradient is 0 by construction are;
- a bundle the port writes from a supervised model: the JAX engine serves it
  within 1 LSB mean of the port's engine, and the port reads it back.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
import e2e_tts_tpu.models.acoustic as jax_acoustic
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.models.acoustic_loss import fastspeech2_loss as jax_fastspeech2_loss
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.common import Conv1d as JaxConv1d
from e2e_tts_tpu.nn.postnet import Postnet as JaxPostnet
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu.train import AcousticBatch as JaxBatch
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import make_train_step as jax_make_train_step
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.models.acoustic_loss import fastspeech2_loss
from e2e_tts_tpu_torch.nn.common import Conv1d
from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                     init_train_state, make_train_step)
from e2e_tts_tpu_torch.train.acoustic_step import forward_inputs

pytestmark = pytest.mark.usefixtures("one_thread")

N_SYMBOLS, N_SPEAKERS, N_MELS, N_WORDS = 40, 3, 80, 16
CONV_TOL = 1e-6
MEL_MAX_TOL, MEL_MAE_TOL = 1e-3, 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
PADDINGS = ["SAME", "CAUSAL"]
# 0 by construction on both sides (float noise): attention key biases (a
# softmax does not see a shift common to all keys) and the biases of the
# convolutions before the postnet's training-mode BatchNorm
ZERO_BY_CONSTRUCTION = re.compile(r"slf_attn\.w_k\.bias$|^postnet\.convs\.\d+\.bias$")


def _supervised(cfg, padding):
    """Either package's ``Config``, small and supervised, dropout off."""
    fs2 = cfg.models.fastspeech2
    v = fs2.variance
    fs2 = fs2.replace(
        encoder_layers=2, decoder_layers=2, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(transformer=fs2.building_block.transformer.replace(
            conv_filter_size=48, encoder_dropout=0.0, decoder_dropout=0.0)),
        variance=v.replace(
            variance_predictor=v.variance_predictor.replace(filter_size=24, dropout=0.0,
                                                            ffn_padding=padding),
            duration_modelling=v.duration_modelling.replace(learn_alignment=False)),
        postnet=fs2.postnet.replace(embedding_dim=24, conv_layers=3))
    train = cfg.train.replace(fastspeech2_optimizer=(
        cfg.train.fastspeech2_optimizer.replace(warm_up_step=100)))
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2), train=train)


def _jax_apply(fn, *args, **kw):
    """Run ``fn`` with the JAX postnet's dropout off."""
    jax_acoustic.Postnet = functools.partial(JaxPostnet, dropout=0.0)
    try:
        return fn(*args, **kw)
    finally:
        jax_acoustic.Postnet = JaxPostnet


def _batch(B=4, L=16, T=48, seed=0):
    """numpy arrays in the JAX ``_collate`` layout of a supervised batch:
    given durations (each row's mel one frame longer than their sum in one
    row, as MFA's may be), one word a phoneme, no prior."""
    rng = np.random.RandomState(seed)
    tl = np.array([16, 11, 7, 13][:B], np.int32)
    a = dict(speakers=np.arange(B, dtype=np.int32) % N_SPEAKERS,
             texts=np.zeros((B, L), np.int32), txt_lens=tl, word_ids=np.zeros((B, L), np.int32),
             mel=np.zeros((B, T, N_MELS), np.float32), mel_lens=np.zeros(B, np.int32),
             attn_prior=np.zeros((B, T, L), np.float32),
             duration_target=np.zeros((B, L), np.float32), f0=np.zeros((B, T), np.float32),
             uv=np.zeros((B, T), np.float32), pitch=np.zeros((B, T), np.float32),
             energy=np.zeros((B, T), np.float32))
    for b in range(B):
        n = tl[b]
        d = rng.randint(1, 4, n)
        m = int(d.sum()) + (b == 1)
        a["duration_target"][b, :n] = d
        a["mel_lens"][b] = m
        a["texts"][b, :n] = rng.randint(1, N_SYMBOLS, n)
        a["word_ids"][b, :n] = np.arange(n)
        a["mel"][b, :m] = rng.randn(m, N_MELS) * 0.5 - 4.0
        a["f0"][b, :m] = rng.randn(m)
        a["uv"][b, :m] = rng.rand(m) < 0.3
        a["pitch"][b, :m] = rng.randn(m)
        a["energy"][b, :m] = rng.randn(m)
    return JaxBatch(**a)


_BUILT = {}


def _models(padding):
    """(JAX model, its variables as numpy, port model with those weights, port config)."""
    if padding not in _BUILT:
        jcfg = _supervised(jax_default_config(), padding)
        jm = JaxFastSpeech2(jcfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, N_MELS,
                            JaxFeatureStats())
        variables = _jax_apply(jax.jit(lambda: init_acoustic_variables(jm, 3)))
        _BUILT[padding] = (jm, jcfg, jax.tree_util.tree_map(np.asarray, variables))
    jm, jcfg, variables = _BUILT[padding]
    cfg = _supervised(default_config(), padding)
    port = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu")
    assert load_into(port, variables) == len(port.state_dict())  # every array, none left over
    return jm, jcfg, variables, port, cfg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("padding", ["SAME", "CAUSAL"])
@pytest.mark.parametrize("kernel_size,dilation", [(3, 1), (4, 1), (3, 2), (5, 3), (8, 2)])
def test_conv1d_padding_matches_jax(padding, kernel_size, dilation):
    rng = np.random.RandomState(kernel_size * 10 + dilation)
    x = rng.randn(2, 20, 6).astype(np.float32)
    jconv = JaxConv1d(5, kernel_size, dilation=dilation, padding=padding)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = Conv1d(6, 5, kernel_size, dilation, padding=padding,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    load_into(conv, jax.tree_util.tree_map(np.asarray, dict(params)))
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < CONV_TOL
    if padding == "CAUSAL":  # an output sees no later input
        later = x.copy()
        later[:, 12:] += 1.0
        moved = conv(torch.from_numpy(later)).detach().numpy()
        np.testing.assert_array_equal(moved[:, :12], got[:, :12])
        assert np.abs(moved[:, 12:] - got[:, 12:]).max() > 0


def test_conv1d_refuses_an_unknown_padding():
    with pytest.raises(ValueError, match="CAUSAL"):
        Conv1d(2, 2, 3, padding="REFLECT", generator=torch.Generator(), device="cpu")


@pytest.mark.parametrize("padding", PADDINGS)
def test_supervised_model_tree(padding):
    """The supervised tree: the ming024 predictor (filter_size channels, 2
    layers, LayerNorm eps 1e-5, head bias log 6, causal convolutions unless
    SAME) and no aligner."""
    _, _, variables, port, cfg = _models(padding)
    va = port.variance_adaptor
    assert va.aligner is None and "aligner" not in variables["params"]["variance_adaptor"]
    stack = va.duration_predictor.stack
    assert len(stack.convs) == 2 and all(c.weight.shape[0] == 24 for c in stack.convs)
    assert all(n.eps == 1e-5 for n in stack.norms)
    k = cfg.models.fastspeech2.variance.variance_predictor.dur_predictor_kernel
    assert all(c.pad == ((k - 1, 0) if padding == "CAUSAL" else ((k - 1) // 2, k // 2))
               for c in stack.convs)
    # the pitch and energy predictors stay SAME, as JAX's
    assert va.pitch_predictor.stack.convs[0].pad[0] == va.pitch_predictor.stack.convs[0].pad[1]
    with pytest.raises(ValueError, match="aligner"):
        port.content_features(torch.zeros(1, 8, N_MELS))


@pytest.mark.parametrize("padding", PADDINGS)
def test_supervised_serving_stages_match_jax(padding):
    jm, _, variables, port, _ = _models(padding)
    rng = np.random.RandomState(5)
    lens = np.array([16, 9, 12], np.int32)
    texts = np.zeros((3, 16), np.int32)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, N_SYMBOLS, n)
    spk = np.array([2, 0, 1], np.int32)
    stage1 = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage1))
    stage2 = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage2),
                     static_argnums=(3,))
    x_j, d_j = stage1(variables, jnp.asarray(spk), jnp.asarray(texts), jnp.asarray(lens))
    d_j = np.array(d_j)
    assert d_j.sum() > 0
    T = -(-int(d_j.sum(-1).max()) // 128) * 128
    mel_j, mel_lens_j = stage2(variables, x_j, jnp.asarray(d_j), T)

    x_t, d_t = port.synthesize_stage1(*(torch.from_numpy(a).long() for a in (spk, texts, lens)))
    np.testing.assert_array_equal(d_t.numpy(), d_j)  # bit-equal durations
    mel_t, mel_lens_t = port.synthesize_stage2(torch.from_numpy(np.array(x_j)),
                                               torch.from_numpy(d_j), T)
    np.testing.assert_array_equal(mel_lens_t.numpy(), np.asarray(mel_lens_j))
    diff = np.abs(mel_t.numpy() - np.asarray(mel_j))
    assert diff.max() < MEL_MAX_TOL and diff.mean() < MEL_MAE_TOL, (diff.max(), diff.mean())


def _jax_loss_fn(jm, cfg, batch):
    T = batch.mel.shape[1]

    def loss_fn(params, bs):
        out, mut = jm.apply(
            {"params": params, "batch_stats": bs}, batch.speakers, batch.texts, batch.txt_lens, T,
            mel=batch.mel, mel_lens=batch.mel_lens, duration_target=batch.duration_target,
            pitch_target={"f0": batch.f0, "uv": batch.uv}, energy_target=batch.energy,
            step=jnp.asarray(0), train=True, mutable=["batch_stats"])
        losses = jax_fastspeech2_loss(out, batch.mel, batch.txt_lens, batch.mel_lens,
                                      batch.word_ids, N_WORDS, jnp.asarray(0),
                                      cfg.train.fastspeech2_loss, learn_alignment=False,
                                      duration_target=batch.duration_target)
        return losses["total"], (losses, out)

    return loss_fn


@pytest.mark.parametrize("padding", PADDINGS)
def test_supervised_forward_losses_and_grads_match_jax(padding):
    jm, jcfg, variables, port, cfg = _models(padding)
    batch = _batch()
    (_, (jl, jout)), jgrads = _jax_apply(jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, jcfg, batch), has_aux=True)), variables["params"],
        variables["batch_stats"])

    port.train()
    b = AcousticBatch.from_numpy(batch, "cpu")
    out = port(b.speakers, b.texts, b.txt_lens, b.mel, b.mel_lens, step=0,
               rng=torch.Generator(), **forward_inputs(cfg, b))
    losses = fastspeech2_loss(out, b.mel, b.txt_lens, b.mel_lens, b.word_ids, N_WORDS, 0,
                              cfg.train.fastspeech2_loss, learn_alignment=False,
                              duration_target=b.duration_target)
    losses["total"].backward()

    np.testing.assert_array_equal(out["duration_rounded"].numpy(), batch.duration_target)
    np.testing.assert_array_equal(np.asarray(jout["duration_rounded"]), batch.duration_target)
    for key in ("attn_soft", "attn_hard", "attn_logprob"):
        assert out[key] is None and jout[key] is None, key
    for key in ("mel", "postnet_mel", "log_duration_prediction", "pitch_prediction",
                "energy_prediction"):
        assert _rel(out[key].detach().numpy(), jout[key]) < LOSS_TOL, key
    for key in ("f0", "uv"):
        assert _rel(out["pitch_target"][key].numpy(), jout["pitch_target"][key]) < LOSS_TOL, key
    np.testing.assert_array_equal(out["mel_lens"].numpy(), batch.mel_lens)
    assert sorted(losses) == sorted(jl) and not {"ctc", "bin"} & set(losses)
    for key in jl:
        want = float(jl[key])
        assert abs(losses[key].item() - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, want)
    assert losses["pdur"].item() > 0

    want = convert({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = np.sqrt(sum((g ** 2).sum() for g in want.values()))
    for name in want:
        if ZERO_BY_CONSTRUCTION.search(name):
            assert np.linalg.norm(want[name]) < 1e-6 * scale, name
            assert np.linalg.norm(got[name]) < 1e-6 * scale, name
        else:
            assert _rel(got[name], want[name]) < GRAD_TOL, (name, _rel(got[name], want[name]))
    dur = [n for n in got if n.startswith("variance_adaptor.duration_predictor.")]
    assert dur and all(np.abs(got[n]).max() > 0 for n in dur)  # the duration loss trains it


@pytest.mark.parametrize("padding", PADDINGS)
def test_supervised_train_step_matches_jax(padding):
    jm, jcfg, variables, port, cfg = _models(padding)
    batch = _batch(seed=1)
    jopt = jax_acoustic_optimizer(jcfg.train.fastspeech2_optimizer, 32)
    jstate = JaxState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=jopt.init(variables["params"]))
    jstate, jmetrics = _jax_apply(jax.jit(jax_make_train_step(jm, jcfg, jopt, N_WORDS)), jstate,
                                  batch, jax.random.PRNGKey(0))

    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    state = init_train_state(port, opt)
    state, metrics = make_train_step(port, cfg, opt, N_WORDS)(state, AcousticBatch.from_numpy(
        batch, "cpu"))
    assert state.step == 1
    assert sorted(metrics) == sorted(jmetrics) and "ctc" not in metrics
    for key in jmetrics:
        want = float(jmetrics[key])
        assert abs(metrics[key].item() - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, want)

    after = convert({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    grads = convert({"params": jax.tree_util.tree_map(np.asarray, _jax_apply(jax.jit(jax.grad(
        lambda p, bs: _jax_loss_fn(jm, jcfg, batch)(p, bs)[0])), variables["params"],
        variables["batch_stats"]))})
    lr = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32).schedule(0)
    for name, p in port.named_parameters():
        got, want = p.detach().numpy() - before[name], after[name] - before[name]
        # Adam scales noise up to the learning rate
        noise = np.abs(grads[name]) < 1e-5 * np.abs(grads[name]).max()
        if ZERO_BY_CONSTRUCTION.search(name):
            noise[...] = True
        assert np.abs(got[noise]).max(initial=0) <= 1.01 * lr, name
        assert np.abs(want[noise]).max(initial=0) <= 1.01 * lr, name
        if not noise.all():
            assert _rel(got[~noise], want[~noise]) < UPDATE_TOL, (name, _rel(got, want))
    stats = convert({"batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)})
    for name, value in stats.items():
        assert np.abs(port.state_dict()[name].numpy() - value).max() < LOSS_TOL, name


def test_supervised_model_needs_durations():
    _, _, _, port, cfg = _models("SAME")
    b = AcousticBatch.from_numpy(_batch(B=2), "cpu")
    with pytest.raises(ValueError, match="duration_target"):
        port(b.speakers, b.texts, b.txt_lens, b.mel, b.mel_lens, None,
             {"f0": b.f0, "uv": b.uv}, b.energy, 0)


def test_supervised_bundle_served_by_jax(tmp_path):
    """A supervised model the port made from a seed (``vie_tiny``'s config
    with ``learn_alignment: false`` and causal predictor padding; the
    training-form generator at a trained norm so that the waveform is at a
    speaking level) written by ``save_bundle``: the JAX engine serves it
    within 1 LSB mean of the port's, and the port reads it back."""
    import os

    from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.serve.bundle import load_bundle, save_bundle
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine
    from e2e_tts_tpu_torch.text.symbols import symbols

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    b = load_bundle(os.path.join(repo, "assets", "bundles", "vie_tiny"))
    fs2 = b.config.models.fastspeech2
    v = fs2.variance
    cfg = b.config.replace(models=b.config.models.replace(fastspeech2=fs2.replace(
        variance=v.replace(
            variance_predictor=v.variance_predictor.replace(ffn_padding="CAUSAL"),
            duration_modelling=v.duration_modelling.replace(learn_alignment=False)))))
    g = torch.Generator().manual_seed(7)
    acoustic = FastSpeech2(cfg.models.fastspeech2, len(symbols), 2, cfg.audio.mel.channels,
                           b.stats, device="cpu", generator=g)
    vocoder = build_generator(cfg, "hifigan", train=True, device="cpu", generator=g)
    with torch.no_grad():
        for name, p in vocoder.named_parameters():
            if name.endswith(".g"):
                p.uniform_(0.5, 1.5, generator=g)
    speakers = {"a": 0, "b": 1}
    path = str(tmp_path / "supervised")
    save_bundle(path, cfg, acoustic, vocoder, speakers, b.stats)
    jeng = JaxEngine.from_checkpoint(path)
    peng = SynthesisEngine.from_checkpoint(path, device="cpu")
    assert peng.acoustic.variance_adaptor.aligner is None
    assert not peng.config.models.fastspeech2.variance.duration_modelling.learn_alignment
    text = "em yêu hoa lá trên núi"
    for spk in speakers:
        got, want = peng.synthesize(text, speaker_id=spk), jeng.synthesize(text, speaker_id=spk)
        assert want.dtype == got.dtype == np.int16 and len(got) == len(want) > 0
        assert np.abs(want.astype(np.int32)).max() > 1000  # audible, so 1 LSB tests something
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.mean() < 1.0, (d.mean(), d.max())

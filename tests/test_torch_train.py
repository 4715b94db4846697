"""The port's acoustic training against the JAX package's, on the CPU: a small
FastSpeech2 (hidden 32, 2 + 2 transformer layers, the aligner, phoneme-level
pitch with uv and energy) with the same weights (carried by ``convert.py``)
and the same numpy batch, laid out as the JAX ``_collate`` lays it out.

Dropout is off on both sides for parity: the config's transformer and
predictor rates are 0, and the postnet's hard-coded 0.5 is 0 (the JAX
``Postnet`` through ``functools.partial``, the port's through its attribute).

Bars (float32 on both sides, sums in another order):
- the forward dict and each loss term: relative error < 1e-5; durations equal;
- each parameter's gradient, mapped through ``convert``: relative norm error
  < 1e-4, at step 0 (soft expansion, no bin term) and at step 30000 (hard
  expansion, the bin term at full weight);
- after 3 ``make_train_step`` steps: each tensor's update (after - before)
  within 1e-3 relative norm, the BatchNorm statistics within 1e-5;
- ``grad_acc_step = 2`` against JAX's, and against the full batch where the
  two halves are the same rows; ``make_eval_step`` equal to JAX's and to itself.

Two kinds of tensor have a gradient that is 0 by construction, so both sides
give float noise there: the attention key biases (a softmax over keys does
not see a shift common to all keys) and the biases of the postnet
convolutions (each feeds a training-mode BatchNorm, which subtracts the batch
mean).  Their JAX gradient is checked to be below 1e-6 of the global norm,
and the port's too, instead of the relative bar.  Adam scales even that
noise to a step of up to the learning rate (noise / (|noise| + 1e-9)), so
their updates are only held within the summed learning rates.
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
import e2e_tts_tpu.models.acoustic as jax_acoustic
from e2e_tts_tpu.audio.features import beta_binomial_prior
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.models.acoustic_loss import fastspeech2_loss as jax_fastspeech2_loss
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.postnet import Postnet as JaxPostnet
from e2e_tts_tpu.train import AcousticBatch as JaxBatch
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import make_eval_step as jax_make_eval_step
from e2e_tts_tpu.train import make_train_step as jax_make_train_step
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.models.acoustic_loss import fastspeech2_loss
from e2e_tts_tpu_torch.nn.common import dropout
from e2e_tts_tpu_torch.nn.variance import FeatureStats
from e2e_tts_tpu_torch.train import (
    AcousticBatch,
    acoustic_optimizer,
    build_acoustic_model,
    init_train_state,
    make_eval_step,
    make_train_step,
)

pytestmark = pytest.mark.usefixtures("one_thread")

N_SYMBOLS, N_SPEAKERS, N_MELS, N_WORDS = 40, 3, 80, 16
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
STATS_TOL = 1e-5
ZERO_BY_CONSTRUCTION = re.compile(r"slf_attn\.w_k\.bias$|^postnet\.convs\.\d+\.bias$")


def _small(cfg, rate=0.0, grad_acc=1):
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(
        encoder_layers=2, decoder_layers=2, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(transformer=fs2.building_block.transformer.replace(
            conv_filter_size=48, encoder_dropout=rate, decoder_dropout=rate)),
        variance=fs2.variance.replace(variance_predictor=fs2.variance.variance_predictor.replace(
            filter_size=24, dropout=rate)),
        postnet=fs2.postnet.replace(embedding_dim=24, conv_layers=3))
    # a short warm-up: updates far above float32 rounding of the weights
    train = cfg.train.replace(grad_acc_step=grad_acc, fastspeech2_optimizer=(
        cfg.train.fastspeech2_optimizer.replace(warm_up_step=100)))
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2), train=train)


def _batch(B=4, L=16, T=48, seed=0):
    """numpy arrays in the JAX ``_collate`` layout."""
    rng = np.random.RandomState(seed)
    tl = np.array([16, 11, 7, 13, 9, 16, 5, 12][:B], np.int32)
    ml = np.array([48, 40, 21, 35, 30, 44, 12, 39][:B], np.int32)
    a = dict(speakers=np.arange(B, dtype=np.int32) % N_SPEAKERS,
             texts=np.zeros((B, L), np.int32), txt_lens=tl, word_ids=np.zeros((B, L), np.int32),
             mel=np.zeros((B, T, N_MELS), np.float32), mel_lens=ml,
             attn_prior=np.zeros((B, T, L), np.float32),
             duration_target=np.zeros((B, L), np.float32), f0=np.zeros((B, T), np.float32),
             uv=np.zeros((B, T), np.float32), pitch=np.zeros((B, T), np.float32),
             energy=np.zeros((B, T), np.float32))
    for b in range(B):
        n, m = tl[b], ml[b]
        a["texts"][b, :n] = rng.randint(1, N_SYMBOLS, n)
        a["word_ids"][b, :n] = np.arange(n) // 3
        a["mel"][b, :m] = rng.randn(m, N_MELS) * 0.5 - 4.0
        a["attn_prior"][b, :m, :n] = beta_binomial_prior(n, m)
        a["f0"][b, :m] = rng.randn(m)
        a["uv"][b, :m] = rng.rand(m) < 0.3
        a["pitch"][b, :m] = rng.randn(m)
        a["energy"][b, :m] = rng.randn(m)
    return JaxBatch(**a)


_BUILT = {}


def _models():
    """(JAX model, its variables as numpy, port model with those weights)."""
    if not _BUILT:
        jax_acoustic.Postnet = functools.partial(JaxPostnet, dropout=0.0)
        try:
            jm = JaxFastSpeech2(_small(jax_default_config()).models.fastspeech2, N_SYMBOLS,
                                N_SPEAKERS, N_MELS, JaxFeatureStats())
            variables = jax.jit(lambda: init_acoustic_variables(jm, 3))()
        finally:
            jax_acoustic.Postnet = JaxPostnet
        _BUILT["models"] = (jm, jax.tree_util.tree_map(np.asarray, variables))
    jm, variables = _BUILT["models"]
    return jm, variables, _port(variables)


def _port(variables, rate=0.0, grad_acc=1):
    cfg = _small(default_config(), rate, grad_acc)
    port = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=rate > 0, device="cpu")
    load_into(port, variables)
    return port, cfg


def _jax_apply(jm, fn, *args, **kw):
    """Run ``fn`` (which applies ``jm``) with the JAX postnet's dropout off."""
    jax_acoustic.Postnet = functools.partial(JaxPostnet, dropout=0.0)
    try:
        return fn(*args, **kw)
    finally:
        jax_acoustic.Postnet = JaxPostnet


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30)


def _check_tensors(got, want, tol, scale=None, noise_bound=None):
    """Each named tensor of ``got`` against ``want`` at relative norm ``tol``;
    a tensor whose value is 0 by construction (``ZERO_BY_CONSTRUCTION``) is
    held below ``noise_bound`` (max |x|) instead, and ``want``'s below 1e-6 of
    ``scale`` in norm when a scale is given."""
    assert sorted(got) == sorted(want)
    for name in want:
        if ZERO_BY_CONSTRUCTION.search(name):
            if scale is not None:
                assert np.linalg.norm(want[name]) < 1e-6 * scale, name
                assert np.linalg.norm(got[name]) < 1e-6 * scale, name
            else:
                assert np.abs(got[name]).max() < noise_bound, name
                assert np.abs(want[name]).max() < noise_bound, name
            continue
        assert _rel(got[name], want[name]) < tol, (name, _rel(got[name], want[name]))


def _port_inputs(batch, step):
    b = AcousticBatch.from_numpy(batch, "cpu")
    return b, dict(mel=b.mel, mel_lens=b.mel_lens, attn_prior=b.attn_prior,
                   pitch_target={"f0": b.f0, "uv": b.uv}, energy_target=b.energy, step=step)


@pytest.mark.parametrize("step", [0, 30000], ids=["step_0", "step_30000"])
def test_forward_losses_and_grads_match_jax(step):
    jm, variables, (port, cfg) = _models()
    batch = _batch()
    T = batch.mel.shape[1]
    loss_cfg = cfg.train.fastspeech2_loss

    def loss_fn(params, bs, step):
        out, mut = jm.apply(
            {"params": params, "batch_stats": bs}, batch.speakers, batch.texts, batch.txt_lens, T,
            mel=batch.mel, mel_lens=batch.mel_lens, attn_prior=batch.attn_prior,
            pitch_target={"f0": batch.f0, "uv": batch.uv}, energy_target=batch.energy, step=step,
            train=True, mutable=["batch_stats"])
        losses = jax_fastspeech2_loss(out, batch.mel, batch.txt_lens, batch.mel_lens,
                                      batch.word_ids, N_WORDS, step, loss_cfg)
        return losses["total"], (losses, out, mut)

    if "grad" not in _BUILT:
        _BUILT["grad"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (jl, jout, jmut)), jgrads = _jax_apply(jm, _BUILT["grad"], variables["params"],
                                               variables["batch_stats"], jnp.asarray(step))

    port.train()
    b, kw = _port_inputs(batch, step)
    out = port(b.speakers, b.texts, b.txt_lens, rng=torch.Generator(), **kw)
    losses = fastspeech2_loss(out, b.mel, b.txt_lens, b.mel_lens, b.word_ids, N_WORDS, step,
                              loss_cfg)
    losses["total"].backward()

    np.testing.assert_array_equal(out["duration_rounded"].numpy(), np.asarray(jout["duration_rounded"]))
    for key in ("mel", "postnet_mel", "log_duration_prediction", "pitch_prediction",
                "energy_prediction", "attn_soft", "attn_logprob", "attn_hard"):
        assert _rel(out[key].detach().numpy(), jout[key]) < LOSS_TOL, key
    for key in ("f0", "uv"):
        assert _rel(out["pitch_target"][key].numpy(), jout["pitch_target"][key]) < LOSS_TOL, key
    assert _rel(out["energy_target"].numpy(), jout["energy_target"]) < LOSS_TOL
    np.testing.assert_array_equal(out["mel_mask"].numpy(), np.asarray(jout["mel_mask"]))
    assert sorted(losses) == sorted(jl)
    for key in jl:
        want = float(jl[key])
        assert abs(losses[key].item() - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, want)
    assert (losses["bin"].item() == 0) == (step == 0)

    want = convert({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    scale = np.sqrt(sum((g ** 2).sum() for g in want.values()))
    _check_tensors(got, want, GRAD_TOL, scale=scale)
    stats = convert({"batch_stats": jax.tree_util.tree_map(np.asarray, jmut["batch_stats"])})
    for name, value in stats.items():
        assert np.abs(port.state_dict()[name].numpy() - value).max() < STATS_TOL, name


def _jax_steps(jm, variables, cfg, batch, step, n):
    """n JAX train steps from ``variables`` at ``step``: (params, batch_stats)."""
    opt = jax_acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                 cfg.models.fastspeech2.encoder_hidden)
    key = ("train", cfg.train.grad_acc_step)
    if key not in _BUILT:
        _BUILT[key] = jax.jit(jax_make_train_step(jm, cfg, opt, N_WORDS))
    state = JaxState(step=jnp.asarray(step, jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"], opt_state=opt.init(variables["params"]))
    for i in range(n):
        state, _ = _jax_apply(jm, _BUILT[key], state, batch, jax.random.PRNGKey(i))
    return state.params, state.batch_stats


def _port_steps(port, cfg, batch, step, n, seed=0):
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(port, opt, seed)
    state.step = step
    train_step = make_train_step(port, cfg, opt, N_WORDS)
    b = AcousticBatch.from_numpy(batch, "cpu")
    metrics = [train_step(state, b)[1] for _ in range(n)]
    assert state.step == step + n
    return metrics


def _updates(port, before):
    return {n: p.detach().numpy() - before[n] for n, p in port.named_parameters()}


def _check_steps(port, before, jparams, jstats, variables, lr_sum):
    want_p = convert({"params": jax.tree_util.tree_map(np.asarray, jparams)})
    want = {n: want_p[n] - before[n] for n in want_p}
    _check_tensors(_updates(port, before), want, UPDATE_TOL, noise_bound=lr_sum)
    stats = convert({"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    for name, value in stats.items():
        assert np.abs(port.state_dict()[name].numpy() - value).max() < STATS_TOL, name


def _lr_sum(cfg, n):
    from e2e_tts_tpu_torch.train import noam_schedule

    o = cfg.train.fastspeech2_optimizer
    sched = noam_schedule(cfg.models.fastspeech2.encoder_hidden, o.warm_up_step)
    return sum(sched(i) for i in range(n))


@pytest.mark.parametrize("step", [0, 30000], ids=["step_0", "step_30000"])
def test_three_train_steps_match_jax(step):
    jm, variables, (port, cfg) = _models()
    batch = _batch()
    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    metrics = _port_steps(port, cfg, batch, step, 3)
    jparams, jstats = _jax_steps(jm, variables, cfg, batch, step, 3)
    _check_steps(port, before, jparams, jstats, variables, _lr_sum(cfg, 3))
    for m in metrics:
        assert all(torch.isfinite(v) for v in m.values())
        assert m["grad_norm"] > 0


def test_grad_accumulation_matches_jax_and_the_full_batch():
    jm, variables, _ = _models()
    port, cfg = _port(variables, grad_acc=2)
    batch = _batch()
    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    _port_steps(port, cfg, batch, 0, 1)
    jparams, jstats = _jax_steps(jm, variables, cfg, batch, 0, 1)
    _check_steps(port, before, jparams, jstats, variables, _lr_sum(cfg, 1))

    # two halves of the same two rows: the one update equals the full batch's
    pair = _batch(B=2)
    twice = JaxBatch(*(np.concatenate([a, a]) for a in pair))
    full, full_cfg = _port(variables)
    halves, _ = _port(variables, grad_acc=2)
    m_full = _port_steps(full, full_cfg, twice, 0, 1)[0]
    m_half = _port_steps(halves, cfg, twice, 0, 1)[0]
    for key in m_full:
        assert abs(m_half[key].item() - m_full[key].item()) <= LOSS_TOL * abs(m_full[key].item())
    got, want = _updates(halves, before), _updates(full, before)
    _check_tensors(got, want, UPDATE_TOL, noise_bound=_lr_sum(cfg, 1))


def test_eval_step_matches_jax_and_repeats():
    jm, variables, (port, cfg) = _models()
    batch = _batch(seed=1)
    jax_eval = jax.jit(jax_make_eval_step(jm, cfg, N_WORDS))
    state = JaxState(step=jnp.asarray(30000, jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"], opt_state=None)
    want = _jax_apply(jm, jax_eval, state, batch)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    pstate = init_train_state(port, opt)
    pstate.step = 30000
    eval_step = make_eval_step(port, cfg, N_WORDS)
    b = AcousticBatch.from_numpy(batch, "cpu")
    first, again = eval_step(pstate, b), eval_step(pstate, b)
    assert sorted(first) == sorted(want)
    for key in want:
        assert first[key].item() == again[key].item(), key
        w = float(want[key])
        assert abs(first[key].item() - w) <= LOSS_TOL * max(abs(w), 1e-12), (key, w)
    assert not port.training and not first["total"].requires_grad


def test_dropout_rate_is_honoured():
    x = torch.ones(200_000)
    for rate in (0.1, 0.5):
        y = dropout(x, rate, torch.Generator().manual_seed(3))
        kept = y != 0
        assert abs(1.0 - kept.float().mean().item() - rate) < 0.005
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - rate)))
    assert dropout(x, 0.5, None) is x  # no generator: deterministic

    _, variables, _ = _models()
    port, cfg = _port(variables, rate=0.2)
    b, kw = _port_inputs(_batch(), 0)
    port.train()
    with pytest.raises(ValueError, match="generator"):
        port(b.speakers, b.texts, b.txt_lens, **kw)
    outs = [port(b.speakers, b.texts, b.txt_lens, rng=torch.Generator().manual_seed(s), **kw)
            for s in (1, 2)]
    assert not torch.equal(outs[0]["mel"], outs[1]["mel"])
    port.eval()
    with torch.no_grad():
        evals = [port(b.speakers, b.texts, b.txt_lens, rng=torch.Generator().manual_seed(s),
                      **kw)["postnet_mel"] for s in (1, 2)]
    assert torch.equal(*evals)  # eval mode ignores the generator


def test_same_seed_gives_identical_steps():
    _, variables, _ = _models()
    port, cfg = _port(variables, rate=0.2)
    twin = copy.deepcopy(port)
    batch = _batch()
    a = _port_steps(port, cfg, batch, 0, 2, seed=11)
    b = _port_steps(twin, cfg, batch, 0, 2, seed=11)
    for ma, mb in zip(a, b):
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (n, p), q in zip(port.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n
    c = _port_steps(copy.deepcopy(twin), cfg, batch, 0, 1, seed=12)
    assert c[0]["total"].item() != b[-1]["total"].item()


def test_unported_training_options_raise():
    """Both options are ported now.  ``mixed_precision`` builds a train step
    (the model's compute dtype carries it: ``tests/test_torch_mixed_precision.py``);
    ``remat_blocks``: a model built with it takes a train step with dropout on
    whose metrics and updated weights equal the model's without it."""
    _, variables, _ = _models()
    port, cfg = _port(variables)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    assert callable(make_train_step(
        port, cfg.replace(train=cfg.train.replace(mixed_precision=True)), opt, N_WORDS))
    cfg = _small(default_config(), rate=0.3)
    remat = cfg.replace(models=cfg.models.replace(
        fastspeech2=cfg.models.fastspeech2.replace(remat_blocks=True)))
    runs = []
    for c in (cfg, remat):
        model = build_acoustic_model(c, N_SYMBOLS, N_SPEAKERS, device="cpu")
        load_into(model, variables)
        assert model.encoder.remat == c.models.fastspeech2.remat_blocks
        runs.append((_port_steps(model, c, _batch(), 0, 1, seed=3)[0], model))
    (m_plain, plain), (m_remat, recomputed) = runs
    for k in m_plain:
        assert abs(m_remat[k].item() - m_plain[k].item()) <= 1e-6 * max(abs(m_plain[k].item()),
                                                                           1.0), k
    for (n, p), q in zip(plain.named_parameters(), recomputed.parameters()):
        assert (p - q).abs().max().item() <= 1e-6, n


def test_training_model_builder(monkeypatch):
    """``build_acoustic_model`` trains as JAX does (plain attention); without
    dropout every rate is 0, the postnet's too; with no device and no CUDA it
    raises, as ``FastSpeech2`` does, instead of training on the CPU."""
    cfg = _small(default_config(), rate=0.3)
    kept = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, device="cpu")
    off = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu")
    rates = lambda m: sorted({x.dropout for x in m.modules()  # noqa: E731
                              if isinstance(getattr(x, "dropout", None), float)})
    assert rates(kept) == [0.3, 0.5] and rates(off) == [0.0]
    assert not any(getattr(x, "use_flash", False) for x in kept.modules())
    for (n, p), q in zip(kept.named_parameters(), off.parameters()):
        assert p.device.type == "cpu" and torch.equal(p, q), n  # one seed, one init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastSpeech2(cfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, N_MELS, FeatureStats())


def test_flash_kernel_refuses_autograd():
    """Asking for the forward-only flash kernel while autograd records raises,
    as the JAX package's does; under ``no_grad`` it runs."""
    from e2e_tts_tpu_torch.nn.transformer import MultiHeadAttention

    att = MultiHeadAttention(16, 2, use_flash=True, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 256, 16)
    mask = torch.ones(1, 256, 256, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="forward only"):
        att(x, mask, torch.tensor([256]))
    with torch.no_grad():
        assert att(x, mask, torch.tensor([256])).shape == x.shape


def test_frame_level_prosody_forward_matches_jax():
    """Pitch and energy at frame level: the targets are not pooled and the
    embeddings are added after the expansion.  The forward dict against JAX's
    at step 0 (soft expansion).  Its losses are not compared: the JAX
    package's ``fastspeech2_loss`` masks the pitch and energy terms by the
    text mask unless given frame masks, which its train step does not give."""
    ve_set = dict(pitch_feature="frame_level", energy_feature="frame_level")

    def frame_level(cfg):
        cfg = _small(cfg)
        fs2 = cfg.models.fastspeech2
        ve = fs2.variance.variance_embedding.replace(**ve_set)
        return cfg.replace(models=cfg.models.replace(fastspeech2=fs2.replace(
            variance=fs2.variance.replace(variance_embedding=ve))))

    jcfg, cfg = frame_level(jax_default_config()), frame_level(default_config())
    jm = JaxFastSpeech2(jcfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, N_MELS, JaxFeatureStats())
    variables = jax.tree_util.tree_map(
        np.asarray, _jax_apply(jm, jax.jit(lambda: init_acoustic_variables(jm, 5))))
    port = FastSpeech2(cfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, N_MELS, FeatureStats(),
                       device="cpu")
    load_into(port, variables)
    port.postnet.dropout = 0.0
    batch = _batch(seed=2)

    def run(v):
        out, _ = jm.apply(v, batch.speakers, batch.texts, batch.txt_lens, batch.mel.shape[1],
                          mel=batch.mel, mel_lens=batch.mel_lens, attn_prior=batch.attn_prior,
                          pitch_target={"f0": batch.f0, "uv": batch.uv},
                          energy_target=batch.energy, step=0, train=True,
                          mutable=["batch_stats"])
        return out

    jout = _jax_apply(jm, jax.jit(run), variables)
    port.train()
    b, kw = _port_inputs(batch, 0)
    out = port(b.speakers, b.texts, b.txt_lens, rng=torch.Generator(), **kw)
    assert out["pitch_prediction"].shape == (4, 48, 2)  # one prediction a frame
    np.testing.assert_array_equal(out["duration_rounded"].numpy(), np.asarray(jout["duration_rounded"]))
    for key in ("mel", "postnet_mel", "pitch_prediction", "energy_prediction"):
        assert _rel(out[key].detach().numpy(), jout[key]) < LOSS_TOL, key

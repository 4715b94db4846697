"""Mixed-precision training on the port against the JAX package's, on the
CPU: a FastSpeech2 built in bfloat16 (``train.mixed_precision``) and a
HiFi-GAN training form in bfloat16, their float32 master parameters,
gradients and Adam moments; the e2e and eval steps on such a config; and
the training CLI, whose ``acoustic`` alone builds in bfloat16 while
``e2e`` builds in float32 whatever the flag says, as JAX's CLI does.

The bar for a 16-bit step is a float64 oracle, the port's own step in
float64 (``.double()`` of the float32 model, the same batch in float64):
for each loss term and each gradient tensor,

    relL2(port - f64) <= max(2 x relL2(jax - f64), 2**-8),

relL2 being the L2 distance over the oracle's L2 norm.  All three runs
take one alignment (the port's bfloat16 run's MAS output), after the
port's durations were held equal to JAX's, or shown to differ only where
the two MAS inputs lie within one bfloat16 ulp of each other.  Tensors
whose gradient is 0 by construction (``ZERO_BY_CONSTRUCTION``) are float
noise on every side: each 16-bit side is held below 2**-8 of the oracle's
global norm there instead.  Dropout is off (rates 0, the postnet's 0.5 on
both sides) so that the three runs compute one function.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from test_torch_train import (N_SPEAKERS, N_SYMBOLS, N_WORDS, ZERO_BY_CONSTRUCTION, _batch,
                              _jax_apply, _models, _small)
import e2e_tts_tpu.nn.variance as jax_variance
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic_loss import fastspeech2_loss as jax_fastspeech2_loss
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn import discriminators as jax_disc
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import VocoderBatch as JaxVocoderBatch
from e2e_tts_tpu.train import gan_optimizer as jax_gan_optimizer
from e2e_tts_tpu.train import init_vocoder_train_state as jax_init_vocoder_state
from e2e_tts_tpu.train import make_eval_step as jax_make_eval_step
from e2e_tts_tpu.train import make_vocoder_train_step as jax_make_vocoder_step
import e2e_tts_tpu_torch.nn.variance as port_variance
import e2e_tts_tpu_torch.train.acoustic_step as acoustic_step
import e2e_tts_tpu_torch.ops.ctc as port_ctc
import e2e_tts_tpu_torch.ops.mas as port_mas
from e2e_tts_tpu_torch.config import default_config, load_config, save_config
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.data import synthetic
from e2e_tts_tpu_torch.models.acoustic_loss import fastspeech2_loss
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.nn import discriminators
from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan
from e2e_tts_tpu_torch.train import (AcousticBatch, E2EBatch, VocoderBatch, acoustic_optimizer,
                                     build_acoustic_model, cli, gan_optimizer, init_e2e_state,
                                     init_train_state, init_vocoder_train_state,
                                     make_e2e_train_step, make_eval_step, make_train_step,
                                     make_vocoder_train_step)
from e2e_tts_tpu_torch.train.checkpoint import CheckpointManager

pytestmark = pytest.mark.usefixtures("one_thread")

FLOOR = 2.0 ** -8  # the oracle bar's floor
BF16 = torch.bfloat16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _oracle(what, port, jax_, exact, zero=None):
    """The bar for each name of ``exact``: relL2(port - f64) <= max(2 x
    relL2(jax - f64), FLOOR); names matching ``zero`` are noise on both
    16-bit sides, each held below FLOOR of the oracle's global norm.
    Returns the worst tensor's share of its bar."""
    assert sorted(port) == sorted(jax_) == sorted(exact), what
    scale = np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2) for v in exact.values()))
    worst, over = 0.0, []
    for name in exact:
        if zero is not None and zero.search(name):
            for side in (port, jax_):
                assert np.linalg.norm(np.asarray(side[name], np.float64)) < FLOOR * scale, name
            continue
        p, j = _rel(port[name], exact[name]), _rel(jax_[name], exact[name])
        share = p / max(2.0 * j, FLOOR)
        worst = max(worst, share)
        if share > 1.0:
            over.append((name, float(f"{p:.3g}"), float(f"{j:.3g}")))
    assert not over, f"{what}: port vs float64 past max(2 x JAX's, 2**-8): {over}"
    return worst


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (x a float32 array)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _check_durations(port_out, jax_out):
    """Durations equal to JAX's, or apart only at cells of the alignment
    where the two runs' MAS inputs lie within one bfloat16 ulp."""
    got, want = port_out["duration_rounded"].numpy(), np.asarray(jax_out["duration_rounded"])
    if np.array_equal(got, want):
        return
    hard_p, hard_j = port_out["attn_hard"].numpy(), np.asarray(jax_out["attn_hard"])
    lp, lj = port_out["attn_logprob"].detach().float().numpy(), np.asarray(jax_out["attn_logprob"])
    cells = np.nonzero(hard_p != hard_j)
    assert np.all(np.abs(lp[cells] - lj[cells]) <= _bf16_ulp(lj[cells])), \
        "durations differ from JAX's off a bfloat16 tie"


# --- the acoustic step ---------------------------------------------------------------------

_JAX = {}


def _jax_bf16():
    """JAX's FastSpeech2 of the small config in bfloat16, the same variables
    as ``test_torch_train``'s float32 model."""
    if "model" not in _JAX:
        _JAX["model"] = JaxFastSpeech2(_small(jax_default_config()).models.fastspeech2, N_SYMBOLS,
                                       N_SPEAKERS, 80, JaxFeatureStats(), dtype=jnp.bfloat16)
    return _JAX["model"]


def _jax_bf16_grads(variables, batch, step, hard):
    """JAX's bfloat16 losses, outputs and gradients at ``step``, its MAS
    replaced by the alignment ``hard`` (None: its own)."""
    jm, cfg = _jax_bf16(), _small(jax_default_config())
    T = batch.mel.shape[1]

    def loss_fn(params, bs, step, hard):
        if hard is not None:  # traced: the alignment is an argument of the program
            jax_variance.monotonic_align = lambda *a: hard
        out, _ = jm.apply(
            {"params": params, "batch_stats": bs}, batch.speakers, batch.texts, batch.txt_lens, T,
            mel=batch.mel, mel_lens=batch.mel_lens, attn_prior=batch.attn_prior,
            pitch_target={"f0": batch.f0, "uv": batch.uv}, energy_target=batch.energy, step=step,
            train=True, mutable=["batch_stats"])
        losses = jax_fastspeech2_loss(out, batch.mel, batch.txt_lens, batch.mel_lens,
                                      batch.word_ids, N_WORDS, step, cfg.train.fastspeech2_loss)
        return losses["total"], (losses, out)

    real = jax_variance.monotonic_align
    key = ("grad", hard is None)
    try:
        if key not in _JAX:
            _JAX[key] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, (losses, out)), grads = _jax_apply(jm, _JAX[key], variables["params"],
                                               variables["batch_stats"], jnp.asarray(step),
                                               None if hard is None else jnp.asarray(hard))
    finally:
        jax_variance.monotonic_align = real
    return ({k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, out),
            convert({"params": jax.tree_util.tree_map(np.asarray, grads)}))


def _port_run(variables, batch, step, dtype, hard=None):
    """The port's losses, outputs and gradients: a model built in ``dtype``
    (bfloat16 or float32), or float64 as ``.double()`` of the float32 one;
    its MAS replaced by ``hard`` where given."""
    cfg = _small(default_config())
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu",
                                 dtype=BF16 if dtype == BF16 else torch.float32)
    load_into(model, variables)
    b = AcousticBatch.from_numpy(batch, "cpu")
    if dtype == torch.float64:
        model = model.double()
        b = AcousticBatch(*(t.double() if t.is_floating_point() else t for t in b))
    model.train()
    real = port_variance.monotonic_align
    if hard is not None:
        port_variance.monotonic_align = lambda *a: hard.to(a[0].dtype)
    try:
        out = model(b.speakers, b.texts, b.txt_lens, b.mel, b.mel_lens, b.attn_prior,
                    {"f0": b.f0, "uv": b.uv}, b.energy, step, torch.Generator())
        losses = fastspeech2_loss(out, b.mel, b.txt_lens, b.mel_lens, b.word_ids, N_WORDS, step,
                                  cfg.train.fastspeech2_loss)
    finally:
        port_variance.monotonic_align = real
    losses["total"].backward()
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return {k: v.item() for k, v in losses.items()}, out, grads


_RUNS = {}


def _acoustic_runs(step):
    """(port bf16, JAX bf16, port float64) losses and gradients at ``step``,
    made once a step: durations checked against JAX's first, then all three
    on the port's alignment."""
    if step not in _RUNS:
        _, variables, _ = _models()
        batch = _batch()
        losses, out, grads = _port_run(variables, batch, step, BF16)
        floats = [v for k, v in out.items() if isinstance(v, torch.Tensor)
                  and v.is_floating_point()]
        # the predictions in the dtype, as JAX's; the rest float32
        assert {k for k, v in out.items() if isinstance(v, torch.Tensor) and v.dtype == BF16} \
            == {"log_duration_prediction", "pitch_prediction", "energy_prediction"}
        assert all(v.dtype in (BF16, torch.float32) for v in floats)
        _, jout, _ = _jax_bf16_grads(variables, batch, step, None)
        _check_durations(out, jout)
        hard = out["attn_hard"].detach()
        jlosses, _, jgrads = _jax_bf16_grads(variables, batch, step, hard.numpy())
        xlosses, _, xgrads = _port_run(variables, batch, step, torch.float64, hard)
        _RUNS[step] = ((losses, jlosses, xlosses), (grads, jgrads, xgrads))
    return _RUNS[step]


@pytest.mark.parametrize("step", [0, 30000], ids=["step_0", "step_30000"])
def test_bf16_acoustic_losses_meet_the_float64_oracle(step):
    """Each loss term of a bfloat16 step, the port's and JAX's against the
    port's float64 step, all on one alignment."""
    _oracle("losses", *_acoustic_runs(step)[0])


@pytest.mark.parametrize("step", [0, 30000], ids=["step_0", "step_30000"])
def test_bf16_acoustic_gradients_meet_the_float64_oracle(step):
    """Each parameter's gradient of the same bfloat16 step, by the same rule."""
    _oracle("gradients", *_acoustic_runs(step)[1], ZERO_BY_CONSTRUCTION)


def _hooked_kernels(seen):
    """Wrap the MAS and CTC entry points of ``ops`` to record their inputs' dtypes."""
    real = (port_mas.mas, port_ctc.ctc_fwd, port_ctc.ctc_bwd)

    def hook(name, fn):
        def call(*args):
            seen.setdefault(name, set()).add(args[0].dtype if name != "ctc_bwd" else args[1].dtype)
            return fn(*args)
        return call

    port_mas.mas = hook("mas", real[0])
    port_ctc.ctc_fwd, port_ctc.ctc_bwd = hook("ctc_fwd", real[1]), hook("ctc_bwd", real[2])
    return real


def test_bf16_train_step_keeps_float32_master_state_and_float32_kernel_inputs():
    """``make_train_step`` on a bfloat16 model: the parameters, their update
    and the Adam moments stay float32; MAS and the CTC forward and backward
    get float32 inputs (the prior promotes the aligner's attention), as
    their kernels take; ``grad_acc_step = 2`` over two copies of two rows
    gives the update of one step on those rows, exactly."""
    _, variables, _ = _models()
    cfg = _small(default_config())
    seen = {}

    def run(batch, grad_acc=1):
        model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu",
                                     dtype=BF16)
        load_into(model, variables)
        c = cfg.replace(train=cfg.train.replace(grad_acc_step=grad_acc))
        opt = acoustic_optimizer(c.train.fastspeech2_optimizer, 32)
        state = init_train_state(model, opt)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, metrics = make_train_step(model, c, opt, N_WORDS)(
            state, AcousticBatch.from_numpy(batch, "cpu"))
        return model, state, metrics, before

    real = _hooked_kernels(seen)
    try:
        model, state, metrics, before = run(_batch())
    finally:
        port_mas.mas, port_ctc.ctc_fwd, port_ctc.ctc_bwd = real
    assert seen == {"mas": {torch.float32}, "ctc_fwd": {torch.float32},
                    "ctc_bwd": {torch.float32}}, seen
    assert model.dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu + state.opt_state.nu)
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) > 0.9 * len(before)

    pair = _batch(B=2)
    twice = type(pair)(*(np.concatenate([a, a]) for a in pair))
    one, _, m_one, b_one = run(pair)
    two, _, m_two, _ = run(twice, grad_acc=2)
    for key in m_one:
        assert m_two[key].item() == m_one[key].item(), key
    for (n, p), q in zip(one.named_parameters(), two.parameters()):
        assert torch.equal(p, q), n


def test_bf16_eval_step_meets_the_float64_oracle():
    """``make_eval_step`` runs a bfloat16 model (JAX's eval takes it as it
    comes): each loss term held to the float64 eval by the oracle rule
    against JAX's bfloat16 eval, all three on the port's alignment."""
    _, variables, _ = _models()
    cfg = _small(default_config())
    batch = _batch(seed=1)
    hard = []

    def port(dtype):
        model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu",
                                     dtype=BF16 if dtype == BF16 else torch.float32)
        load_into(model, variables)
        b = AcousticBatch.from_numpy(batch, "cpu")
        if dtype == torch.float64:
            model = model.double()
            b = AcousticBatch(*(t.double() if t.is_floating_point() else t for t in b))
        s = init_train_state(model, acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32))
        s.step = 30000
        real = port_variance.monotonic_align
        port_variance.monotonic_align = (lambda *a: hard.append(real(*a)) or hard[0]) if not hard \
            else (lambda *a: hard[0].to(a[0].dtype))
        try:
            losses = make_eval_step(model, cfg, N_WORDS)(s, b)
        finally:
            port_variance.monotonic_align = real
        return model, {k: v.item() for k, v in losses.items()}

    model, got = port(BF16)
    assert model.dtype == BF16
    _, exact = port(torch.float64)
    jm = _jax_bf16()
    state = JaxState(step=jnp.asarray(30000, jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"], opt_state=None)
    eval_step = jax_make_eval_step(jm, _small(jax_default_config()), N_WORDS)

    def replayed(state, batch, aligned):
        jax_variance.monotonic_align = lambda *a: aligned
        return eval_step(state, batch)

    real = jax_variance.monotonic_align
    try:
        want = _jax_apply(jm, jax.jit(replayed), state, batch, jnp.asarray(hard[0].numpy()))
    finally:
        jax_variance.monotonic_align = real
    _oracle("eval losses", got, {k: float(v) for k, v in want.items()}, exact)


# --- the vocoder GAN step ------------------------------------------------------------------

TINY_GEN = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))
SEG = 8


def _tiny_vocoder_config(cfg):
    return cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(**TINY_GEN)))


def _trained_scale(params, seed):
    """Each kernel's g drawn U(0.5, 1.5) and nonzero biases, as
    ``test_torch_gan`` sets them (at the init's g the tiny generator's
    gradients are float noise)."""
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


def _vocoder_batch(B=2):
    rng = np.random.RandomState(7)
    mel = (rng.randn(B, SEG, 80) * 1.5 - 5.0).astype(np.float32)
    t = np.arange(SEG * 256) / 22050.0
    audio = sum(0.2 * np.sin(2 * np.pi * f * t + rng.rand() * 6) for f in (140.0, 290.0, 610.0))
    return mel, (audio[None] + 0.02 * rng.randn(B, SEG * 256)).astype(np.float32)


def _mu(opt_state):
    """The first moments of an optax state (the first ``mu`` it holds)."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no Adam moments in the state")


_VOC = {}


def _vocoder_runs():
    """One ``make_vocoder_train_step`` step of a bfloat16 HiFi-GAN training
    form (the discriminators float32, as JAX's) on the port, on JAX and, the
    oracle, on the port in float64: ((metrics), (gradients read from Adam's
    first moments after the step)) of each, made once."""
    if not _VOC:
        _VOC["runs"] = _vocoder_step_runs()
    return _VOC["runs"]


def _vocoder_step_runs():
    jcfg = _tiny_vocoder_config(jax_default_config())
    gen = JaxHifiGan.from_config(jcfg.models.hifigan, dtype=jnp.bfloat16)
    jmpd = jax_disc.MultiPeriodDiscriminator(periods=(2, 3), channels=(4, 8))
    jmsd = jax_disc.MultiScaleDiscriminator(n_scales=2, specs=jax_disc.TINY_MSD_SPECS)
    opt = jax_gan_optimizer(jcfg.train.hifigan_optimizer)
    state = jax.jit(functools.partial(jax_init_vocoder_state, gen, jcfg, opt, opt,
                                      segment_frames=SEG, mpd=jmpd, msd=jmsd))(
        jax.random.PRNGKey(0))
    g0 = _trained_scale(jax.tree_util.tree_map(np.asarray, state.g_params), 5)
    d0 = _trained_scale(jax.tree_util.tree_map(np.asarray, state.d_params), 6)
    state = state._replace(g_params=g0, d_params=d0)
    step = jax.jit(jax_make_vocoder_step(gen, jcfg, opt, opt, "hifigan", mpd=jmpd, msd=jmsd))
    state, jm = step(state, JaxVocoderBatch(*(jnp.asarray(a) for a in _vocoder_batch())))
    jmetrics = {k: float(v) for k, v in jm.items()}

    cfg = _tiny_vocoder_config(default_config())

    def port(dtype):
        g = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu",
                                         dtype=BF16 if dtype == BF16 else torch.float32)
        mpd, msd = discriminators.build_discriminators(
            device="cpu", periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
            msd_specs=discriminators.TINY_MSD_SPECS)
        load_into(g, g0)
        load_into(mpd, d0["mpd"])
        load_into(msd, d0["msd"])
        batch = VocoderBatch.from_numpy(_vocoder_batch(), "cpu")
        if dtype == torch.float64:
            g, mpd, msd = g.double(), mpd.double(), msd.double()
            batch = VocoderBatch(*(t.double() for t in batch))
        g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
        s = init_vocoder_train_state(g, g_opt, d_opt, mpd, msd)
        s, metrics = make_vocoder_train_step(g, cfg, g_opt, d_opt, "hifigan", mpd=mpd,
                                             msd=msd)(s, batch)
        names = ([f"g.{n}" for n, _ in g.named_parameters()]
                 + [f"d.{i}.{n}" for i, m in enumerate((mpd, msd))
                    for n, _ in m.named_parameters()])
        mus = [m.double().numpy() for m in s.g_opt_state.mu + s.d_opt_state.mu]
        assert all(p.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
                   for p in g.parameters())
        return g, dict(zip(names, mus)), {k: v.item() for k, v in metrics.items()}

    g, grads, metrics = port(BF16)
    assert g.dtype == BF16 and g.conv_post.dtype is None  # conv_post a float32 island
    _, xgrads, xmetrics = port(torch.float64)
    g_ref = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu")
    jg = convert(jax.tree_util.tree_map(np.asarray, _mu(state.g_opt_state)), g_ref.state_dict())
    mpd_ref, msd_ref = discriminators.build_discriminators(
        device="cpu", periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
        msd_specs=discriminators.TINY_MSD_SPECS)
    jd_mu = jax.tree_util.tree_map(np.asarray, _mu(state.d_opt_state))
    jgrads = {f"g.{n}": v for n, v in jg.items()}
    for i, (m, key) in enumerate(((mpd_ref, "mpd"), (msd_ref, "msd"))):
        jgrads.update({f"d.{i}.{n}": v for n, v in convert(jd_mu[key], m.state_dict()).items()})
    return (metrics, jmetrics, xmetrics), (grads, jgrads, xgrads)


def test_bf16_vocoder_metrics_meet_the_float64_oracle():
    """The step's metrics by the oracle rule."""
    _oracle("vocoder metrics", *_vocoder_runs()[0])


def test_bf16_vocoder_gradients_meet_the_float64_oracle():
    """The generator's and the discriminators' gradients by the oracle rule."""
    _oracle("vocoder gradients", *_vocoder_runs()[1])


# --- the e2e step and the CLI --------------------------------------------------------------

def test_e2e_step_runs_a_mixed_precision_config():
    """``make_e2e_train_step`` no longer refuses ``train.mixed_precision``:
    a step runs on the config's float32 models with finite metrics."""
    _, variables, _ = _models()
    cfg = _tiny_vocoder_config(_small(default_config()))
    cfg = cfg.replace(train=cfg.train.replace(mixed_precision=True))
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu")
    load_into(model, variables)
    gen = build_generator(cfg, "hifigan", train=True, device="cpu")
    mpd, msd = discriminators.build_discriminators(
        device="cpu", periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
        msd_specs=discriminators.TINY_MSD_SPECS)
    am, g_opt, d_opt = (acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32),
                        gan_optimizer(cfg.train.hifigan_optimizer),
                        gan_optimizer(cfg.train.hifigan_optimizer))
    state = init_e2e_state(model, gen, am, g_opt, d_opt, mpd, msd)
    step = make_e2e_train_step(model, gen, cfg, am, g_opt, d_opt, N_WORDS, segment_frames=8,
                               mpd=mpd, msd=msd)
    batch = _batch()
    audio = np.zeros((4, batch.mel.shape[1] * 256), np.float32)
    state, metrics = step(state, E2EBatch.from_numpy(batch, audio, "cpu"))
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny config in float32 and with ``mixed_precision: true``, and a
    prepared synthetic corpus (4 sentences x 2 speakers)."""
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=32)),
        variance=fs2.variance.replace(variance_predictor=fs2.variance.variance_predictor.replace(
            filter_size=16)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=2))
    cfg = _tiny_vocoder_config(cfg.replace(models=cfg.models.replace(fastspeech2=fs2),
                                           train=cfg.train.replace(batch_size=2, log_step=1)))
    root = tmp_path_factory.mktemp("mp")
    paths = {}
    for name, mp in (("f32", False), ("mixed", True)):
        paths[name] = str(root / f"{name}.yaml")
        save_config(cfg.replace(train=cfg.train.replace(mixed_precision=mp)), paths[name])
    corpus, work = str(root / "corpus"), str(root / "work")
    synthetic.make_synthetic_corpus(corpus, n_sentences=4, f0_jitter=0.1, seed=0)
    cli.main(["prepare", "--corpus", corpus, "--workdir", work, "--config", paths["f32"],
              "--device", "cpu"])
    return paths, work


@pytest.fixture()
def narrow_discriminators(monkeypatch):
    """MPD and MSD at narrow widths wherever the CLI builds them."""
    real = discriminators.build_discriminators
    specs = ((8, 15, 1, 1, 7), (8, 41, 4, 4, 20), (8, 5, 1, 1, 2))
    monkeypatch.setattr(discriminators, "build_discriminators", functools.partial(
        real, mpd_channels=(4, 8, 8, 8), msd_specs=specs))


def test_cli_trains_acoustic_in_bf16_and_e2e_in_float32(cli_setup, narrow_discriminators,
                                                        monkeypatch, tmp_path):
    """``acoustic`` with ``mixed_precision: true`` trains a bfloat16 model
    whose checkpoint holds float32 parameters; ``e2e`` builds in float32
    whatever the flag says, so its first step's losses equal the float32
    config's exactly."""
    paths, work = cli_setup
    built = []
    real = acoustic_step.build_acoustic_model

    def spy(*a, **k):
        model = real(*a, **k)
        built.append(model.dtype)
        return model
    monkeypatch.setattr(acoustic_step, "build_acoustic_model", spy)

    firsts = {}
    for name in ("f32", "mixed"):
        w = str(tmp_path / name)
        os.makedirs(w)
        for f in ("file_list.txt", "stats.json", "speakers.json"):
            with open(os.path.join(work, f)) as src, open(os.path.join(w, f), "w") as dst:
                dst.write(src.read())
        metrics = []
        cli.main(["e2e", "--workdir", w, "--config", paths[name], "--steps", "1",
                  "--device", "cpu"], on_step=lambda s, m: metrics.append(
                      {k: v.item() for k, v in m.items()}))
        firsts[name] = metrics[0]
    assert built == [None, None]  # float32 both times
    assert firsts["mixed"] == firsts["f32"]

    w = str(tmp_path / "acoustic")
    os.makedirs(w)
    for f in ("file_list.txt", "stats.json", "speakers.json"):
        with open(os.path.join(work, f)) as src, open(os.path.join(w, f), "w") as dst:
            dst.write(src.read())
    seen = []
    cli.main(["acoustic", "--workdir", w, "--config", paths["mixed"], "--steps", "2",
              "--ckpt-every", "2", "--device", "cpu"],
             on_step=lambda s, m: seen.append(all(torch.isfinite(v) for v in m.values())))
    assert built[-1] == BF16 and seen == [True, True]
    template = real(load_config(paths["mixed"]), cli._lang_symbols("vie")[0], 2, device="cpu")
    tree = CheckpointManager(os.path.join(w, "acoustic_ckpt")).restore(
        {"step": 0, "model": template})
    assert tree["step"] == 2
    assert all(p.dtype == torch.float32 for p in tree["model"].parameters())

"""The port's joint acoustic + vocoder fine-tune step against the JAX
package's, on the CPU: the small FastSpeech2 of ``test_torch_train`` (its
aligner, dropout off on both sides), a tiny HiFi-GAN and the tiny
discriminators of ``test_torch_gan``, the same weights on both sides
(carried by ``convert.py``), the same numpy batch, and JAX's crop starts
handed to the port's step.

Each of 2 steps starts both sides from the same state: before the second,
the port takes JAX's parameters, BatchNorm statistics and Adam moments after
the first.  Otherwise the float noise of one step's updates (below) would
grow into the next step's losses.  Bars (float32 on both sides, sums in
another order), for each step:
- each metric: relative error < 1e-5;
- the acoustic model's gradient in each tensor, read from Adam's first
  moment (g = (mu_after - b1 mu_before) / (1 - b1), clipped): relative
  norm < 1e-4;
- the update of each tensor: relative norm < 1e-3 (acoustic tensors over
  the entries whose gradient is not float noise, see below);
- the BatchNorm statistics after the step within 1e-5.

Adam's first steps move an entry by about the learning rate whatever its
gradient's size, so an entry whose gradient is float noise moves by up to
the learning rate either way (the most |m_hat| / sqrt(v_hat) can be,
``_adam_bound``).  In the acoustic model these are the attention key biases
and the postnet biases, whose gradient is 0 by construction
(``test_torch_train``; held below 1e-6 of the global norm on both sides),
and single entries elsewhere whose gradient is a sum that cancels almost to
0: a few in the key weights and the FFN's first layer, with gradients near
1e-6 of their tensor's largest, flip sign between the two sides.  So each
acoustic tensor's update is held at 1e-3 over its entries whose gradient
(JAX's sqrt(v_hat)) is at least 1e-5 of the tensor's largest, and the other
entries, like the noise leaves, within that bound of the learning rate.  No
leaf of the generator or the discriminators is 0 by construction, and no
entry of theirs is exempt.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import gan_optimizer as jax_gan_optimizer
from e2e_tts_tpu.train import init_vocoder_train_state as jax_init_vocoder_state
from e2e_tts_tpu.train.e2e_step import E2EBatch as JaxE2EBatch
from e2e_tts_tpu.train.e2e_step import E2EState as JaxE2EState
from e2e_tts_tpu.train.e2e_step import make_e2e_train_step as jax_make_e2e_step
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan
from e2e_tts_tpu_torch.train import (E2EBatch, ScheduledAdam, acoustic_optimizer, gan_optimizer,
                                     init_e2e_state, make_e2e_train_step, noam_schedule)
from e2e_tts_tpu_torch.train.e2e_step import crop_starts
from test_torch_gan import (SEG, TINY_GEN, _np, _rel, _snapshot, _speech, _tiny_jax_discriminators,
                            _tiny_port_discriminators, _trained_scale)
from test_torch_train import (N_WORDS, STATS_TOL, ZERO_BY_CONSTRUCTION, _batch, _jax_apply, _models,
                              _small)
from test_torch_train import _port as _port_acoustic

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
NOISE = 1e-5  # an entry whose gradient is below this share of its tensor's largest
HOP = 256
STEPS = 2


def _config(cfg):
    cfg = _small(cfg)
    return cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(**TINY_GEN)))


def _audio(batch):
    return _speech(batch.mel.shape[0], batch.mel.shape[1] * HOP, 9)


def _jax_crop_starts(rng, mel_lens):
    """The starts JAX's step draws from ``rng``: its crop key is the second
    half of the split, u * (max(mel_len - SEG, 0) + 1) in float32, truncated."""
    u = jax.random.uniform(jax.random.split(rng)[1], (len(mel_lens),))
    return np.asarray((u * jnp.asarray(np.maximum(mel_lens - SEG, 0) + 1, jnp.float32))
                      .astype(jnp.int32))


def _record(state):
    """A JAX e2e state as numpy: the (acoustic, generator, MPD, MSD)
    parameter trees, the BatchNorm statistics, and the (mu, nu) of the
    acoustic, generator and discriminator Adam states."""
    s = _np(state)
    adam = {k: (o[1].mu, o[1].nu)  # each chain's scale_by_adam
            for k, o in (("am", s.am_opt_state), ("g", s.g_opt_state), ("d", s.d_opt_state))}
    return dict(trees=(s.acoustic_params, s.g_params, s.d_params["mpd"], s.d_params["msd"]),
                stats=s.acoustic_batch_stats, adam=adam)


_JAX = {}


def _jax_steps(start):
    """STEPS JAX e2e steps from ``start``: (the record of the state before
    each step and after the last, and of each step the metrics and the crop
    starts); the step is compiled once for the module."""
    if start in _JAX:
        return _JAX[start]
    jm, variables, _ = _models()
    cfg = _config(jax_default_config())
    gen = JaxHifiGan.from_config(cfg.models.hifigan)
    jmpd, jmsd = _tiny_jax_discriminators()
    am_opt = jax_acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                    cfg.models.fastspeech2.encoder_hidden)
    g_opt = d_opt = jax_gan_optimizer(cfg.train.hifigan_optimizer)
    if "init" not in _JAX:
        v = jax_init_vocoder_state(gen, cfg, g_opt, d_opt, jax.random.PRNGKey(0), SEG,
                                   mpd=jmpd, msd=jmsd)
        _JAX["init"] = (_trained_scale(_np(v.g_params), 5), _trained_scale(_np(v.d_params), 6))
        _JAX["step"] = jax.jit(jax_make_e2e_step(jm, gen, cfg, am_opt, g_opt, d_opt, N_WORDS, SEG,
                                                 mpd=jmpd, msd=jmsd))
    g, d = _JAX["init"]
    p = variables["params"]
    state = JaxE2EState(step=jnp.asarray(start, jnp.int32), acoustic_params=p,
                        acoustic_batch_stats=variables["batch_stats"], g_params=g, d_params=d,
                        am_opt_state=am_opt.init(p), g_opt_state=g_opt.init(g),
                        d_opt_state=d_opt.init(d))
    batch = _batch()
    jbatch = JaxE2EBatch(batch, jnp.asarray(_audio(batch)))
    records, metrics, starts = [_record(state)], [], []
    for i in range(STEPS):
        rng = jax.random.PRNGKey(10 + i)
        state, m = _jax_apply(jm, _JAX["step"], state, jbatch, rng)
        records.append(_record(state))
        metrics.append({k: float(v) for k, v in m.items()})
        starts.append(_jax_crop_starts(rng, batch.mel_lens))
    _JAX[start] = (records, metrics, starts)
    return _JAX[start]


def _frozen(opt):
    """``opt`` with a learning rate of 0."""
    return ScheduledAdam(lambda count: 0.0, opt.b1, opt.b2, opt.eps, opt.max_norm)


def _port(record, cfg, frozen=(), **kw):
    """The port's model, generator and discriminators with the weights of a
    JAX ``record``, its optimizers (those named in ``frozen``, of "am", "g"
    and "d", at a learning rate of 0), state and step."""
    model, _ = _port_acoustic({"params": record["trees"][0], "batch_stats": record["stats"]})
    gen = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu")
    mpd, msd = _tiny_port_discriminators()
    for module, tree in zip((gen, mpd, msd), record["trees"][1:]):
        load_into(module, tree)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                cfg.models.fastspeech2.encoder_hidden)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    am_opt, g_opt, d_opt = (_frozen(o) if name in frozen else o
                            for name, o in (("am", am_opt), ("g", g_opt), ("d", d_opt)))
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd)
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, N_WORDS, SEG, mpd=mpd,
                               msd=msd, **kw)
    return (model, gen, mpd, msd), state, step


def _moments(modules, record):
    """A record's Adam (mu, nu) of the acoustic model, the generator and the
    discriminators, each as {port name: array}."""
    am, g, d = (record["adam"][k] for k in ("am", "g", "d"))
    model, gen, mpd, msd = modules
    out = {}
    for key, trees, targets in (("am", [{"params": t} for t in am], [model]),
                                ("g", list(g), [gen])):
        out[key] = [convert(t, targets[0].state_dict()) for t in trees]
    out["d"] = [{**convert(t["mpd"], mpd.state_dict()),
                 **{f"msd.{n}": a for n, a in convert(t["msd"], msd.state_dict()).items()}}
                for t in d]
    return out


def _d_names(mpd, msd):
    return [n for n, _ in mpd.named_parameters()] + [f"msd.{n}" for n, _ in msd.named_parameters()]


def _sync(modules, state, record, count):
    """The port's parameters, BatchNorm statistics and Adam state set to a
    JAX ``record``'s, after ``count`` updates."""
    model, gen, mpd, msd = modules
    load_into(model, {"params": record["trees"][0], "batch_stats": record["stats"]})
    for module, tree in zip((gen, mpd, msd), record["trees"][1:]):
        load_into(module, tree)
    moments = _moments(modules, record)
    for key, adam, names in (("am", state.am_opt_state, [n for n, _ in model.named_parameters()]),
                             ("g", state.g_opt_state, [n for n, _ in gen.named_parameters()]),
                             ("d", state.d_opt_state, _d_names(mpd, msd))):
        mu, nu = moments[key]
        adam.mu = [torch.from_numpy(mu[n].copy()) for n in names]
        adam.nu = [torch.from_numpy(nu[n].copy()) for n in names]
        adam.count = count


def _adam_bound(b1, b2, t):
    """The most |m_hat| / sqrt(v_hat) can be at Adam's step t (Cauchy-Schwarz
    over the two moments' weights of the t gradients)."""
    a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    c = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(x * x / y for x, y in zip(a, c)))


def _check_step(modules, before, after, jax_before, jax_after, jax_nu, noise_bound):
    """One step's update of each tensor; the acoustic model's (first of
    ``modules``) over the entries that are not noise (``jax_nu``, JAX's
    second moment), the others within ``noise_bound``."""
    for i, (module, b, a, jb, ja) in enumerate(zip(modules, before, after, jax_before, jax_after)):
        if i == 0:
            jb, ja = {"params": jb}, {"params": ja}
        jb, ja = convert(jb, module.state_dict()), convert(ja, module.state_dict())
        for n in a:
            got, want = a[n] - b[n], ja[n] - jb[n]
            if i == 0:
                rms = np.sqrt(jax_nu[n])
                signal = (np.zeros_like(rms, bool) if ZERO_BY_CONSTRUCTION.search(n)
                          else rms >= NOISE * rms.max())
                assert np.abs(got[~signal]).max(initial=0) <= noise_bound, n
                assert np.abs(want[~signal]).max(initial=0) <= noise_bound, n
                got, want = got[signal], want[signal]
            assert _rel(got, want) < UPDATE_TOL, (n, _rel(got, want))


def _check_grads(names, mu, mu_before, jmu, b1):
    """The acoustic model's clipped gradient of one step, port and JAX, from
    their first moments after it and the one moment before it (``mu_before``,
    the same on both sides)."""
    got = {n: (m.numpy() - b1 * mu_before[n]) / (1 - b1) for n, m in zip(names, mu)}
    want = {n: (jmu[n] - b1 * mu_before[n]) / (1 - b1) for n in names}
    scale = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in want.values()))
    for n in names:
        if ZERO_BY_CONSTRUCTION.search(n):
            assert np.linalg.norm(got[n]) < 1e-6 * scale and np.linalg.norm(want[n]) < 1e-6 * scale
        else:
            assert _rel(got[n], want[n]) < GRAD_TOL, (n, _rel(got[n], want[n]))


@pytest.mark.parametrize("start", [0, 30000], ids=["step_0", "step_30000"])
def test_e2e_step_matches_jax(start):
    """Two steps from ``start`` (0: soft expansion, no bin term; 30000: hard
    expansion, the bin term at full weight) with JAX's crop starts, each from
    JAX's state: the metrics, the acoustic gradients, the updates and the
    BatchNorm statistics of each step."""
    records, jmetrics, starts = _jax_steps(start)
    cfg = _config(default_config())
    modules, state, step = _port(records[0], cfg)
    batch = _batch()
    pbatch = E2EBatch.from_numpy(batch, _audio(batch), "cpu")
    o = cfg.train.fastspeech2_optimizer
    sched = noam_schedule(cfg.models.fastspeech2.encoder_hidden, o.warm_up_step, o.anneal_steps,
                          o.anneal_rate)
    names = [n for n, _ in modules[0].named_parameters()]
    for i, (want, s) in enumerate(zip(jmetrics, starts)):
        _sync(modules, state, records[i], i)
        state.step = start + i
        before = _snapshot(modules)
        state, got = step(state, pbatch, torch.tensor(s, dtype=torch.long))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert abs(got[k].item() - w) <= LOSS_TOL * max(abs(w), 1e-12), (k, got[k].item(), w)
        jmu, jnu = _moments(modules, records[i + 1])["am"]
        _check_grads(names, state.am_opt_state.mu, _moments(modules, records[i])["am"][0], jmu,
                     o.betas[0])
        _check_step(modules, before, _snapshot(modules), records[i]["trees"],
                    records[i + 1]["trees"], jnu, sched(start + i) * _adam_bound(*o.betas, i + 1))
        stats = convert({"batch_stats": records[i + 1]["stats"]})
        for name, value in stats.items():
            assert np.abs(modules[0].state_dict()[name].numpy() - value).max() < STATS_TOL, name
    assert state.step == start + STEPS
    assert (got["bin"].item() == 0) == (start == 0)
    # autograd.grad: no .grad left anywhere, D's parameters included
    assert all(p.grad is None for m in modules for p in m.parameters())


def test_e2e_step_order_ramp_and_crop():
    """The reverse of the vocoder step's order.  The acoustic model and the
    generator are updated against the discriminators as they were: the first
    step's generator terms do not change with D's learning rate.  D is
    updated on the pair from before their update: its first losses do not
    change when they are frozen.  The adversarial ramp: at step 2 of 4 the
    GAN terms count half.  Starts drawn by the step fall in each row."""
    record = _jax_steps(0)[0][0]
    batch = _batch()
    pbatch = E2EBatch.from_numpy(batch, _audio(batch), "cpu")
    starts = torch.tensor([3, 0, 13, 27])
    cfg = _config(default_config())
    out = {}
    for frozen in ((), ("d",), ("am", "g")):
        _, state, step = _port(record, cfg, frozen)
        out[frozen] = step(state, pbatch, starts)[1]
    for k in ("generator", "fm", "mel", "total"):
        assert out[("d",)][k].item() == out[()][k].item(), k
    for k in ("discriminator", "mpd", "msd"):
        assert out[("am", "g")][k].item() == out[()][k].item(), k

    _, state, step = _port(record, cfg, adv_warmup_steps=4)
    state.step = 2
    m = step(state, pbatch, starts)[1]
    want = 0.5 * (m["generator"] + m["fm"]) + 45.0 * m["mel"] + m["variance"]
    assert abs(m["total"].item() - want.item()) <= 1e-6 * abs(want.item())

    ml = torch.from_numpy(batch.mel_lens).long()
    s = crop_starts(ml, SEG, torch.Generator().manual_seed(0))
    assert ((s >= 0) & (s <= torch.clamp(ml - SEG, min=0))).all()


@pytest.mark.parametrize("field", ["mixed_precision", "remat_blocks"])
def test_e2e_step_refuses_what_is_not_ported(field):
    """``mixed_precision`` is not ported (A14) and raises; ``remat_blocks``
    is ported and builds an e2e step."""
    cfg = _config(default_config())
    if field == "mixed_precision":
        cfg = cfg.replace(train=cfg.train.replace(mixed_precision=True))
        with pytest.raises(NotImplementedError, match="A14"):
            _port(_jax_steps(0)[0][0], cfg)
    else:
        cfg = cfg.replace(models=cfg.models.replace(
            fastspeech2=cfg.models.fastspeech2.replace(remat_blocks=True)))
        assert callable(_port(_jax_steps(0)[0][0], cfg)[2])

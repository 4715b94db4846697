"""The port's data-parallel training and serving on two gloo ranks on the
CPU: the acoustic and e2e steps against the JAX package's step on the same
global batch, the vocoder GAN step against the port's one-process step
(which ``test_torch_gan.py`` holds to JAX's at the same bars; the e2e step
runs the same GAN terms against JAX here).

Both ranks start once for the module (``tests/_torch_parallel_worker.py``,
subprocesses on 127.0.0.1 with a hard timeout, killed on expiry) and run, in
turn: one acoustic step, one vocoder GAN step and one e2e step on their rows
of a global batch; ``shard_params`` on a (1, 2) mesh; a ``global_mesh``
engine; the training CLI's ``acoustic`` for three steps and its restart.
The main process computes the JAX side and hands arrays over through files.

Bars (PERF.md section 2, the CPU's): loss terms 1e-5 relative, gradients
(Adam's first moments) 1e-4 relative norm, updated parameters (the update's
relative norm) and batch statistics 1e-3.  The acoustic batch has ragged
``mel_lens`` (rank 0 holds the two longer rows, rank 1 two shorter) and the
postnet's BatchNorm runs in train mode, so that the global normalisers and
the global batch statistics are what the match tests.  Dropout is off.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from _torch_parallel_worker import run_ranks
from test_torch_e2e import _adam_bound
from test_torch_engine import LONG
from test_torch_e2e import _audio as _e2e_audio
from test_torch_e2e import _config as _e2e_config
from test_torch_e2e import _jax_steps as _jax_e2e_steps
from test_torch_e2e import _port as _e2e_port
from test_torch_gan import SEG, _port_vocoder, _rel, _vocoder_batch
from test_torch_train import (GRAD_TOL, LOSS_TOL, N_SPEAKERS, N_SYMBOLS, N_WORDS, UPDATE_TOL,
                              _batch, _check_tensors, _jax_apply, _models, _small)
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import make_train_step as jax_make_train_step
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert
from e2e_tts_tpu_torch.train import noam_schedule

pytestmark = pytest.mark.usefixtures("one_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
VIE_TINY = os.path.join(ROOT, "assets", "bundles", "vie_tiny")
WORLD = 2
TIMEOUT_S = 240
STATS_TOL = 1e-3


# --- the JAX side ----------------------------------------------------------------------------

def _adam_mu(opt_state):
    """The first moment of an optax chain's ``scale_by_adam``."""
    return next(s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


def _jax_acoustic_step(step):
    """JAX's acoustic step on the global batch sharded over a (data 2) mesh:
    (metrics, params, batch_stats, Adam's mu), as numpy."""
    jm, variables, _ = _models()
    jcfg = _small(jax_default_config())
    opt = jax_acoustic_optimizer(jcfg.train.fastspeech2_optimizer,
                                 jcfg.models.fastspeech2.encoder_hidden)
    mesh = jax_make_mesh(WORLD)
    batch = jax.device_put(_batch(), batch_sharding(mesh))
    state = JaxState(step=jnp.asarray(step, jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=opt.init(variables["params"]))
    fn = jax.jit(jax_make_train_step(jm, jcfg, opt, N_WORDS))
    with mesh:
        state, metrics = _jax_apply(jm, fn, state, batch, jax.random.PRNGKey(0))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ({k: float(v) for k, v in metrics.items()}, np_(state.params), np_(state.batch_stats),
            np_(_adam_mu(state.opt_state)))


# --- the two ranks ---------------------------------------------------------------------------

ACOUSTIC_STEP = 30000  # hard expansion, the bin term at full weight


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, with the inputs that made them."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    _, _, (port, cfg) = _models()
    spec = {"tasks": ["acoustic", "vocoder", "e2e"]}
    spec["acoustic"] = dict(config=cfg, state_dict=port.state_dict(), n_symbols=N_SYMBOLS,
                            n_speakers=N_SPEAKERS, n_words=N_WORDS, step=ACOUSTIC_STEP,
                            batch=list(_batch()), global_batch=4)

    vcfg, gen, mpd, msd = _port_vocoder("hifigan", _vocoder_init())
    disc = dict(device="cpu", periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
                msd_specs=_tiny_msd_specs())
    spec["vocoder"] = dict(config=vcfg, disc=disc, batch=list(_vocoder_batch()),
                           state_dicts=[m.state_dict() for m in (gen, mpd, msd)], global_batch=2)

    records, _, starts = _jax_e2e_steps(0)
    ecfg = _e2e_config(default_config())
    modules, _, _ = _e2e_port(records[0], ecfg)
    batch = _batch()
    spec["e2e"] = dict(config=ecfg, disc=disc, state_dicts=[m.state_dict() for m in modules],
                       n_symbols=N_SYMBOLS, n_speakers=N_SPEAKERS, n_words=N_WORDS, step=0,
                       segment=SEG, batch=list(batch), audio=_e2e_audio(batch),
                       starts=np.asarray(starts[0], np.int64), global_batch=4)
    spec["shard"] = dict(module=port)
    spec["serve"] = dict(bundle=VIE_TINY, batch_size=8, texts=SERVE_TEXTS)
    spec["cli"] = _cli_inputs(tmp)
    spec["tasks"] += ["shard", "serve", "cli"]
    return run_ranks(spec, tmp, WORLD, TIMEOUT_S)


def _vocoder_init():
    """A tiny generator and discriminators at a trained scale (the
    vocoder GAN tests' init), as JAX trees, without compiling JAX's step."""
    from test_torch_gan import (_np, _tiny_config, _tiny_jax_discriminators, _trained_scale)
    from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
    from e2e_tts_tpu.train import gan_optimizer as jax_gan_optimizer
    from e2e_tts_tpu.train import init_vocoder_train_state as jax_init_vocoder_state

    cfg = _tiny_config(jax_default_config())
    gen = JaxHifiGan.from_config(cfg.models.hifigan)
    jmpd, jmsd = _tiny_jax_discriminators()
    opt = jax_gan_optimizer(cfg.train.hifigan_optimizer)
    state = jax_init_vocoder_state(gen, cfg, opt, opt, jax.random.PRNGKey(0), SEG, mpd=jmpd,
                                   msd=jmsd)
    return _trained_scale(_np(state.g_params), 5), _trained_scale(_np(state.d_params), 6)


def _first_update_bound(cfg, step):
    """The most a first Adam update at ``step`` moves an entry: the learning
    rate there times |m_hat| / sqrt(v_hat) (1 at Adam's first step)."""
    o = cfg.train.fastspeech2_optimizer
    sched = noam_schedule(cfg.models.fastspeech2.encoder_hidden, o.warm_up_step,
                          o.anneal_steps, o.anneal_rate)
    return sched(step) * _adam_bound(*o.betas, 1)


def _tiny_msd_specs():
    from e2e_tts_tpu_torch.nn import discriminators

    return discriminators.TINY_MSD_SPECS


def test_data_parallel_acoustic_step_matches_jax_on_the_global_batch(ranks):
    """One acoustic step at step 30000 on two ranks: each rank's metrics are
    the global ones, equal to JAX's; the gradients (Adam's mu), the updated
    parameters and the BatchNorm statistics match JAX's and are bit-equal on
    the two ranks."""
    _, _, (port, cfg) = _models()
    r0, r1 = (r["acoustic"] for r in ranks)
    assert (r0["rows"], r1["rows"]) == (2, 2)
    jmetrics, jparams, jstats, jmu = _jax_acoustic_step(ACOUSTIC_STEP)
    for key, want in jmetrics.items():
        got = r0["metrics"][key]
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, got, want)
        assert r1["metrics"][key] == got, key
    want_mu = convert({"params": jmu})
    got_mu = {n: m.numpy() for n, m in r0["mu"].items()}
    scale = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in want_mu.values()))
    _check_tensors(got_mu, want_mu, GRAD_TOL, scale=scale)
    before = {n: p.detach().numpy() for n, p in port.named_parameters()}
    want = convert({"params": jparams})
    got = {n: r0["state_dict"][n].numpy() - before[n] for n in before}
    _check_tensors(got, {n: want[n] - before[n] for n in before}, UPDATE_TOL,
                   noise_bound=_first_update_bound(cfg, ACOUSTIC_STEP))
    for name, value in convert({"batch_stats": jstats}).items():
        assert np.abs(r0["state_dict"][name].numpy() - value).max() < STATS_TOL, name
    for name, t in r0["state_dict"].items():
        assert torch.equal(t, r1["state_dict"][name]), name


def test_data_parallel_vocoder_step_matches_the_one_process_step(ranks):
    """One vocoder GAN step on two ranks of one row each: the metrics and
    every parameter's update against the port's one-process step on both
    rows (which ``test_torch_gan.py`` holds to JAX's step at these bars);
    the two ranks bit-equal.  Every loss of the step is a mean over rows,
    and the e2e test below runs the same GAN terms against JAX's step."""
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    cfg, gen, mpd, msd = _port_vocoder("hifigan", _vocoder_init())
    modules = (gen, mpd, msd)
    before = [{n: p.detach().numpy().copy() for n, p in m.named_parameters()} for m in modules]
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd)
    _, want = step(state, VocoderBatch.from_numpy(_vocoder_batch(), "cpu"))
    r0, r1 = (r["vocoder"] for r in ranks)
    assert (r0["rows"], r1["rows"]) == (1, 1)
    for key, w in want.items():
        assert abs(r0["metrics"][key] - w.item()) <= LOSS_TOL * abs(w.item()), key
        assert r1["metrics"][key] == r0["metrics"][key], key
    for m, b, sd in zip(modules, before, r0["state_dicts"]):
        for n, p in m.named_parameters():
            assert _rel(sd[n].numpy() - b[n], p.detach().numpy() - b[n]) < UPDATE_TOL, n
    for a, b in zip(r0["state_dicts"], r1["state_dicts"]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_data_parallel_e2e_step_matches_jax(ranks):
    """One joint e2e step (step 0, JAX's crop starts) on two ranks: the
    metrics, the acoustic gradients, the updates of all four modules and the
    BatchNorm statistics against JAX's step on the global batch."""
    from test_torch_e2e import _check_grads, _check_step, _moments

    records, jmetrics, _ = _jax_e2e_steps(0)
    ecfg = _e2e_config(default_config())
    modules, state, _ = _e2e_port(records[0], ecfg)
    r0, r1 = (r["e2e"] for r in ranks)
    for key, want in jmetrics[0].items():
        assert abs(r0["metrics"][key] - want) <= LOSS_TOL * max(abs(want), 1e-12), key
        assert r1["metrics"][key] == r0["metrics"][key], key
    names = [n for n, _ in modules[0].named_parameters()]
    mu_before = {n: np.zeros(p.shape, np.float32) for n, p in modules[0].named_parameters()}
    jmu = _moments(modules, records[1])["am"][0]
    _check_grads(names, [r0["mu"][n] for n in names], mu_before, jmu, 0.9)
    snap = lambda sds: [{n: sd[n].numpy() for n, _ in m.named_parameters()}  # noqa: E731
                        for m, sd in zip(modules, sds)]
    before = snap([m.state_dict() for m in modules])
    jnu = _moments(modules, records[1])["am"][1]
    _check_step(modules, before, snap(r0["state_dicts"]), records[0]["trees"],
                records[1]["trees"], jnu, _first_update_bound(ecfg, 0))
    stats = convert({"batch_stats": records[1]["stats"]})
    for name, value in stats.items():
        assert np.abs(r0["state_dicts"][0][name].numpy() - value).max() < STATS_TOL, name
    for a, b in zip(r0["state_dicts"], r1["state_dicts"]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_shard_params_gives_each_rank_its_slice(ranks):
    """``shard_params`` on a (1, 2) mesh: each rank's local shard is its
    half of the full tensor along the rule's dim, the rest replicated."""
    _, _, (port, _) = _models()
    full = dict(port.named_parameters())
    split = 0
    for rank, r in enumerate(ranks):
        local = r["shard"]["local"]
        assert sorted(local) == sorted(full)
        for n, t in local.items():
            dims = r["shard"]["dims"][n]
            want = full[n].detach() if not dims else full[n].detach().chunk(WORLD, dims[0])[rank]
            assert torch.equal(t, want), n
            split += bool(dims)
    assert split > 0


SERVE_TEXTS = ["xin chào việt nam hôm nay trời đẹp", ["xin chào bạn"] * 10, LONG]


def test_global_mesh_serving_gathers_every_row(ranks):
    """A ``global_mesh`` engine on two ranks: both return the same int16,
    within 1 LSB mean of the port's one-process engine; the batch and its
    row buckets round to the two ranks."""
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    r0, r1 = (r["serve"] for r in ranks)
    assert r0["n_devices"] == 2 and r0["batch_size"] == 8 and r0["row_buckets"] == [2, 4, 8]
    single = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", batch_size=8)
    for text, a, b in zip(SERVE_TEXTS, r0["audio"], r1["audio"]):
        np.testing.assert_array_equal(a, b)
        want = single.synthesize(text)
        assert a.dtype == np.int16 and a.shape == want.shape
        assert np.abs(a.astype(np.int64) - want.astype(np.int64)).mean() < 1.0


def _cli_inputs(tmp):
    """A prepared workdir of the synthetic corpus and the CLI's ``acoustic``
    argument lists: three steps (a checkpoint at 2, validation), then a
    restart to four."""
    from e2e_tts_tpu_torch.config import save_config
    from e2e_tts_tpu_torch.data import synthetic
    from e2e_tts_tpu_torch.train import cli

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(transformer=fs2.building_block.transformer.replace(
            conv_filter_size=32)),
        variance=fs2.variance.replace(variance_predictor=fs2.variance.variance_predictor.replace(
            filter_size=16)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=2))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2),
                      train=cfg.train.replace(batch_size=4, log_step=1))
    config = os.path.join(tmp, "config.yaml")
    save_config(cfg, config)
    corpus, work = os.path.join(tmp, "corpus"), os.path.join(tmp, "work")
    synthetic.make_synthetic_corpus(corpus, n_sentences=4, f0_jitter=0.1, seed=0)
    common = ["--workdir", work, "--config", config, "--device", "cpu"]
    cli.main(["prepare", "--corpus", corpus] + common)
    return dict(work=work, argvs=[["acoustic", "--steps", "3", "--ckpt-every", "2"] + common,
                                  ["acoustic", "--steps", "4", "--ckpt-every", "2"] + common])


def test_cli_trains_on_two_ranks_writes_once_and_resumes(ranks):
    """``acoustic`` on two ranks: parameters bit-equal on both; the logs and
    checkpoints written once (by rank 0: one record a step and tag); the
    restart resumes both ranks at step 3 and ends at 4."""
    import json

    r0, r1 = (r["cli"] for r in ranks)
    assert r0["steps"] == r1["steps"] == [3, 4]
    for name, t in r0["state_dict"].items():
        assert torch.equal(t, r1["state_dict"][name]), name
    for r in (r0, r1):
        assert "resumed from step 3" in r["printed"]
    assert "[acoustic] step 1" in r0["printed"] and "[acoustic] step" not in r1["printed"]
    work = r0["work"]
    assert sorted(os.listdir(os.path.join(work, "acoustic_ckpt"))) == ["2", "3", "4"]
    with open(os.path.join(work, "logs", "acoustic", "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    totals = [r["step"] for r in records if r["tag"] == "acoustic/total"]
    assert totals == [1, 2, 3, 4], totals

"""The port's tensor parallelism (``parallel/tensor_parallel.py``) on gloo
ranks on the CPU: the model axis of a (data, model) mesh in the acoustic,
vocoder GAN and e2e steps, and the split eval forward.

Two ranks at (data 1, model 2) start once for the module, and four at
(2, 2) once more (``tests/_torch_parallel_worker.py``, subprocesses on
127.0.0.1 with a hard timeout, killed on expiry).  They run:

- (a) the acoustic step against JAX's sharded step: ``make_train_step``
  jitted over ``make_mesh(2, model_parallel=2)``, the parameters and Adam's
  moments placed by ``param_sharding_rules`` as JAX's dry run places them,
  on the same global batch and converted weights; each rank's shards against
  JAX's matching slices;
- (b) the acoustic step with dropout 0.1 against the port's one-process step
  from the same seed: the model ranks draw one mask; and the same with
  ``remat_blocks``, whose recompute runs each layer's collectives again;
- (c) the acoustic step with one head and an FFN of 49 channels against the
  one-process step: the head is cut across the ranks, and the divisibility
  guard keeps ``w_1`` and ``w_2`` whole while the attention splits;
- (d) the vocoder GAN step and (e) the e2e step against the port's
  one-process steps (which ``test_torch_gan.py`` and ``test_torch_e2e.py``
  hold to JAX's);
- (f) ``vie_tiny``'s eval forward, split, against its unsplit forward, the
  decoder at T = 256 through the flash wrapper (its plain version here) on
  each rank's one head;
- (g) the acoustic step at (2, 2) on four ranks, the layout of JAX's dry
  run, against JAX's step over ``make_mesh(4, model_parallel=2)``;

and the dry run's entry point on four ranks.  The JAX step is jitted once
for the file.

Bars (PR 13's, the CPU's): loss terms 1e-5 relative; gradients (Adam's first
moments) 1e-4 relative norm; each tensor's update 1e-3 relative norm; batch
statistics 1e-3.  Replicated parameters are bit-equal on every rank, and a
split parameter on the ranks of one model coordinate.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from _torch_parallel_worker import ROOT, run_ranks
from test_torch_gan import SEG, TINY_GEN, _speech, _vocoder_batch
from test_torch_parallel_steps import _adam_mu, _first_update_bound
from test_torch_train import (GRAD_TOL, LOSS_TOL, N_SPEAKERS, N_SYMBOLS, N_WORDS, UPDATE_TOL,
                              ZERO_BY_CONSTRUCTION, _batch, _check_tensors, _jax_apply, _models,
                              _port, _rel, _small)
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh
from e2e_tts_tpu.parallel import param_sharding_rules as jax_param_sharding_rules
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import make_train_step as jax_make_train_step
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert
from e2e_tts_tpu_torch.nn import discriminators
from e2e_tts_tpu_torch.nn.common import _WeightNorm
from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan
from e2e_tts_tpu_torch.parallel.sharding import split_dim
from e2e_tts_tpu_torch.parallel.tensor_parallel import local_shard, parallelize, role
from e2e_tts_tpu_torch.train import (AcousticBatch, E2EBatch, VocoderBatch, acoustic_optimizer,
                                     build_acoustic_model, gan_optimizer, init_e2e_state,
                                     init_train_state, init_vocoder_train_state,
                                     make_e2e_train_step, make_train_step,
                                     make_vocoder_train_step)

pytestmark = pytest.mark.usefixtures("one_thread")

VIE_TINY = os.path.join(ROOT, "assets", "bundles", "vie_tiny")
TIMEOUT_S = 240
STATS_TOL = 1e-3
ACOUSTIC_STEP = 30000  # hard expansion, the bin term at full weight
TP = {"data": 1, "model": 2}
NOISE = 1e-5  # an entry whose first moment is below this share of its tensor's largest


# --- the JAX side ----------------------------------------------------------------------------

_JAX = {}


def _jax_sharded_step(n_devices):
    """JAX's acoustic step over ``make_mesh(n_devices, model_parallel=2)``,
    the parameters and Adam's moments placed by ``param_sharding_rules``:
    (metrics, params, batch_stats, Adam's mu), as numpy.  One jitted step
    for the file."""
    jm, variables, _ = _models()
    jcfg = _small(jax_default_config())
    opt = jax_acoustic_optimizer(jcfg.train.fastspeech2_optimizer,
                                 jcfg.models.fastspeech2.encoder_hidden)
    if "fn" not in _JAX:
        _JAX["fn"] = jax.jit(jax_make_train_step(jm, jcfg, opt, N_WORDS))
    mesh = jax_make_mesh(n_devices, model_parallel=2)
    shardings = jax_param_sharding_rules(variables["params"], mesh)
    params = jax.device_put(variables["params"], shardings)
    pdef = jax.tree_util.tree_structure(params)

    def is_param_tree(x):
        try:
            return jax.tree_util.tree_structure(x) == pdef
        except Exception:
            return False

    opt_state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, shardings) if is_param_tree(x) else x,
        opt.init(variables["params"]), is_leaf=is_param_tree)
    state = JaxState(step=jnp.asarray(ACOUSTIC_STEP, jnp.int32), params=params,
                     batch_stats=variables["batch_stats"], opt_state=opt_state)
    batch = jax.device_put(_batch(), batch_sharding(mesh))
    with mesh:
        state, metrics = _jax_apply(jm, _JAX["fn"], state, batch, jax.random.PRNGKey(0))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ({k: float(v) for k, v in metrics.items()}, np_(state.params), np_(state.batch_stats),
            np_(_adam_mu(state.opt_state)))


# --- the port's one-process references -------------------------------------------------------

def _cut_head_config():
    cfg = _small(default_config())
    fs2 = cfg.models.fastspeech2
    tr = fs2.building_block.transformer.replace(encoder_head=1, decoder_head=1,
                                                conv_filter_size=49)
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2.replace(
        building_block=fs2.building_block.replace(transformer=tr))))


def _remat(cfg):
    fs2 = cfg.models.fastspeech2
    return cfg.replace(models=cfg.models.replace(fastspeech2=fs2.replace(remat_blocks=True)))


def _trained_scale(modules, seed):
    """Each weight-normalised kernel's g drawn U(0.5, 1.5) and its bias
    moved off 0 (``test_torch_gan._trained_scale`` on the port's modules)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for module in modules:
            for m in module.modules():
                if isinstance(m, _WeightNorm):
                    m.g.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.g.shape)))
                    m.bias.add_(torch.from_numpy(0.05 * rng.randn(*m.bias.shape)))


def _gan_modules():
    cfg = default_config()
    cfg = cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(**TINY_GEN)))
    gen = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu")
    mpd, msd = discriminators.build_discriminators(**DISC)
    _trained_scale((gen, mpd, msd), 5)
    return cfg, gen, mpd, msd


DISC = dict(device="cpu", periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
            msd_specs=discriminators.TINY_MSD_SPECS)


def _e2e_modules():
    gcfg, gen, mpd, msd = _gan_modules()
    cfg = _small(default_config())
    cfg = cfg.replace(models=cfg.models.replace(hifigan=gcfg.models.hifigan))
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu", seed=4)
    return cfg, (model, gen, mpd, msd)


def _e2e_inputs():
    batch = _batch()
    audio = _speech(batch.mel.shape[0], batch.mel.shape[1] * 256, 9)
    starts = np.random.RandomState(1).randint(0, np.maximum(batch.mel_lens - SEG, 0) + 1)
    return batch, audio, starts.astype(np.int64)


def _forward_inputs():
    rng = np.random.RandomState(3)
    lens = np.array([40, 23], np.int64)
    texts = np.zeros((2, 48), np.int64)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, 60, n)
    return dict(speakers=np.zeros(2, np.int64), texts=texts, txt_lens=lens, T=256)


# --- the ranks -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two (1, 2) ranks' results, with the inputs that made them."""
    tmp = str(tmp_path_factory.mktemp("tp_ranks"))
    _, variables, (port, cfg) = _models()
    common = dict(n_symbols=N_SYMBOLS, n_speakers=N_SPEAKERS, n_words=N_WORDS, model_parallel=2,
                  global_batch=4, batch=list(_batch()))
    spec = {"tasks": ["acoustic", "acoustic_dropout", "acoustic_remat", "acoustic_cut",
                      "vocoder", "e2e", "forward"]}
    spec["acoustic"] = dict(common, config=cfg, state_dict=port.state_dict(), step=ACOUSTIC_STEP)
    drop, dcfg = _port(variables, rate=0.1)
    spec["acoustic_dropout"] = dict(common, task="acoustic", config=dcfg, dropout=True,
                                    state_dict=drop.state_dict(), step=ACOUSTIC_STEP)
    spec["acoustic_remat"] = dict(spec["acoustic_dropout"], config=_remat(dcfg))
    ccfg = _cut_head_config()
    cut = build_acoustic_model(ccfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu", seed=3)
    spec["acoustic_cut"] = dict(common, task="acoustic", config=ccfg,
                                state_dict=cut.state_dict(), step=ACOUSTIC_STEP)
    vcfg, *gan = _gan_modules()
    spec["vocoder"] = dict(config=vcfg, disc=DISC, batch=list(_vocoder_batch()), model_parallel=2,
                           state_dicts=[m.state_dict() for m in gan], global_batch=2)
    ecfg, modules = _e2e_modules()
    batch, audio, starts = _e2e_inputs()
    spec["e2e"] = dict(common, config=ecfg, disc=DISC, step=0, segment=SEG, audio=audio,
                       starts=starts, state_dicts=[m.state_dict() for m in modules])
    spec["forward"] = dict(_forward_inputs(), bundle=VIE_TINY, model_parallel=2)
    return run_ranks(spec, tmp, 2, TIMEOUT_S)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four (2, 2) ranks' acoustic step."""
    tmp = str(tmp_path_factory.mktemp("tp_four"))
    _, _, (port, cfg) = _models()
    spec = {"tasks": ["acoustic"], "acoustic": dict(
        config=cfg, state_dict=port.state_dict(), n_symbols=N_SYMBOLS, n_speakers=N_SPEAKERS,
        n_words=N_WORDS, step=ACOUSTIC_STEP, batch=list(_batch()), global_batch=4,
        model_parallel=2)}
    return run_ranks(spec, tmp, 4, TIMEOUT_S)


def _shards(full: dict, index: int) -> dict:
    """Each tensor of ``full`` cut to model coordinate ``index``'s shard."""
    return {n: local_shard(n, torch.as_tensor(t), TP, index).numpy() for n, t in full.items()}


def _same_where_replicated(results, coords, shapes):
    """Every replicated tensor bit-equal on every rank; a split one on the
    ranks of one model coordinate (``coords[r]``)."""
    for name, shape in shapes.items():
        split = split_dim(name, shape, TP) is not None
        for r, res in enumerate(results[1:], 1):
            if not split or coords[r] == coords[0]:
                assert torch.equal(res[name], results[0][name]), (name, r)


def _check_jax_step(results, coords):
    """The ranks' acoustic step against JAX's sharded step on as many
    devices: metrics, each rank's shards of the gradients and the update,
    the batch statistics; the ranks' replicas bit-equal."""
    _, _, (port, cfg) = _models()
    jmetrics, jparams, jstats, jmu = _jax_sharded_step(len(results))
    for r in results:
        for key, want in jmetrics.items():
            got = r["metrics"][key]
            assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, got, want)
            assert got == results[0]["metrics"][key], key
    want_mu = convert({"params": jmu})
    scale = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in want_mu.values()))
    before = {n: p.detach() for n, p in port.named_parameters()}
    want_after = convert({"params": jparams})
    bound = _first_update_bound(cfg, ACOUSTIC_STEP)
    for r, c in zip(results, coords):
        _check_tensors({n: m.numpy() for n, m in r["mu"].items()}, _shards(want_mu, c),
                       GRAD_TOL, scale=scale)
        mine = _shards({n: t.numpy() for n, t in before.items()}, c)
        got = {n: r["state_dict"][n].numpy() - mine[n] for n in mine}
        want = {n: w - mine[n] for n, w in _shards(want_after, c).items()}
        _check_tensors(got, want, UPDATE_TOL, noise_bound=bound)
    for name, value in convert({"batch_stats": jstats}).items():
        assert np.abs(results[0]["state_dict"][name].numpy() - value).max() < STATS_TOL, name
    _same_where_replicated([r["state_dict"] for r in results], coords,
                           {n: tuple(p.shape) for n, p in port.named_parameters()})


def test_acoustic_step_at_1x2_matches_jax_sharded_step(ranks):
    """(a) Two model ranks: each rank's shards of the gradient and the update
    are JAX's matching slices; w_q holds half the rows on each."""
    results = [r["acoustic"] for r in ranks]
    assert results[0]["state_dict"]["decoder.layers.0.slf_attn.w_q.weight"].shape == (16, 32)
    assert results[0]["mu"]["encoder.src_word_emb.weight"].shape == (N_SYMBOLS + 1, 16)
    _check_jax_step(results, [0, 1])


def test_acoustic_step_at_2x2_matches_jax_sharded_step(four_ranks):
    """(g) JAX's dry-run layout, (data 2, model 2): rank r at data r // 2,
    model r % 2, two rows each, against JAX's step on four devices."""
    results = [r["acoustic"] for r in four_ranks]
    assert [r["rows"] for r in results] == [2, 2, 2, 2]
    _check_jax_step(results, [0, 1, 0, 1])


def _one_process_acoustic(state_dict, cfg, dropout=False):
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=dropout, device="cpu")
    model.load_state_dict(state_dict)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                             cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt)
    state.step = ACOUSTIC_STEP
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, metrics = make_train_step(model, cfg, opt, N_WORDS)(
        state, AcousticBatch.from_numpy(_batch(), "cpu"))
    names = [n for n, _ in model.named_parameters()]
    return ({k: v.item() for k, v in metrics.items()}, dict(zip(names, state.opt_state.mu)),
            before, dict(model.named_parameters()))


def _check_against_one_process(results, one):
    metrics, mu, before, after = one
    for r in results:
        for key, want in metrics.items():
            assert abs(r["metrics"][key] - want) <= LOSS_TOL * max(abs(want), 1e-12), key
    full = {n: m.numpy() for n, m in mu.items()}
    scale = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in full.values()))
    for c, r in enumerate(results):
        _check_tensors({n: m.numpy() for n, m in r["mu"].items()}, _shards(full, c), GRAD_TOL,
                       scale=scale)
        b = _shards({n: t.numpy() for n, t in before.items()}, c)
        want = {n: a - b[n] for n, a in _shards({n: p.detach().numpy() for n, p in after.items()},
                                                c).items()}
        _check_tensors({n: r["state_dict"][n].numpy() - b[n] for n in b}, want, UPDATE_TOL,
                       noise_bound=_first_update_bound(_small(default_config()), ACOUSTIC_STEP))
    _same_where_replicated([r["state_dict"] for r in results], [0, 1],
                           {n: tuple(t.shape) for n, t in before.items()})


def test_acoustic_step_with_dropout_draws_one_mask_on_the_model_ranks(ranks):
    """(b) Dropout 0.1 (the transformer's, the predictors' and the postnet's
    0.5): the split step equals the one-process step from the same seed, so
    both model ranks drew the one-process masks."""
    _, variables, _ = _models()
    model, cfg = _port(variables, rate=0.1)
    results = [r["acoustic_dropout"] for r in ranks]
    one = _one_process_acoustic(model.state_dict(), cfg, dropout=True)
    assert one[0]["total"] != _one_process_acoustic(model.state_dict(), _small(
        default_config()))[0]["total"]  # the masks matter
    _check_against_one_process(results, one)


def test_acoustic_step_with_dropout_and_remat_blocks(ranks):
    """(b) with ``remat_blocks``: each layer recomputed in the backward pass
    runs its collectives again, with the dropout generator's state restored,
    and the split step still equals the one-process step."""
    _, variables, _ = _models()
    model, cfg = _port(variables, rate=0.1)
    results = [r["acoustic_remat"] for r in ranks]
    _check_against_one_process(results, _one_process_acoustic(model.state_dict(), _remat(cfg),
                                                               dropout=True))


def test_acoustic_step_with_a_cut_head_and_a_guarded_ffn(ranks):
    """(c) One head of 32 over two ranks (16 columns each: a head cut
    across them) and an FFN of 49 channels, which the divisibility guard
    keeps whole (``w_1``, ``w_2`` replicated, run unsplit) while the
    attention splits."""
    cfg = _cut_head_config()
    cut = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu", seed=3)
    results = [r["acoustic_cut"] for r in ranks]
    sd = results[0]["state_dict"]
    assert sd["encoder.layers.0.slf_attn.w_q.weight"].shape == (16, 32)
    assert sd["encoder.layers.0.pos_ffn.w_1.weight"].shape == (49, 32, 9)
    _check_against_one_process(results, _one_process_acoustic(cut.state_dict(), cfg))


def _check_updates(modules, before, after_one, results, key):
    """Each parameter's update on every rank against the one-process
    step's, at the rank's shard; the replicas bit-equal."""
    for i, (m, b, a) in enumerate(zip(modules, before, after_one)):
        for c, r in enumerate(results):
            got = r[key][i]
            bs, as_ = _shards(b, c), _shards(a, c)
            for n in bs:
                assert _rel(got[n].numpy() - bs[n], as_[n] - bs[n]) < UPDATE_TOL, (n, c)
        _same_where_replicated([r[key][i] for r in results], [0, 1], {n: t.shape for n, t in
                                                                      b.items()})


def _snap(modules):
    return [{n: p.detach().numpy().copy() for n, p in m.named_parameters()} for m in modules]


def test_vocoder_step_at_1x2_matches_the_one_process_step(ranks):
    """(d) The generator's ``conv_pre`` and upsampling convolutions split on
    their output channels (the last, of one channel, kept whole by the
    guard), MPD and MSD replicated: metrics and every update."""
    cfg, gen, mpd, msd = _gan_modules()
    modules = (gen, mpd, msd)
    before = _snap(modules)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    _, want = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd)(
        state, VocoderBatch.from_numpy(_vocoder_batch(), "cpu"))
    results = [r["vocoder"] for r in ranks]
    assert results[0]["state_dicts"][0]["trunk.conv_pre.v"].shape == (8, 80, 7)
    assert results[0]["state_dicts"][0]["trunk.ups.3.v"].shape == (2, 1, 4)
    for r in results:
        for key, w in want.items():
            assert abs(r["metrics"][key] - w.item()) <= LOSS_TOL * abs(w.item()), key
    _check_updates(modules, before, _snap(modules), results, "state_dicts")


def test_e2e_step_at_1x2_matches_the_one_process_step(ranks):
    """(e) The joint step with the acoustic model and the generator split:
    metrics, the acoustic gradients (Adam's first moments, each rank's
    shards), and the update of all four modules over the entries whose
    gradient is not float noise."""
    cfg, modules = _e2e_modules()
    before = _snap(modules)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                cfg.models.fastspeech2.encoder_hidden)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    model, gen, mpd, msd = modules
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd)
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, N_WORDS, SEG, mpd=mpd,
                               msd=msd)
    batch, audio, starts = _e2e_inputs()
    _, want = step(state, E2EBatch.from_numpy(batch, audio, "cpu"), torch.from_numpy(starts))
    results = [r["e2e"] for r in ranks]
    for r in results:
        for key, w in want.items():
            assert abs(r["metrics"][key] - w.item()) <= LOSS_TOL * max(abs(w.item()), 1e-12), key
    names = [n for n, _ in model.named_parameters()]
    full = {n: m.numpy() for n, m in zip(names, state.am_opt_state.mu)}
    scale = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in full.values()))
    for c, r in enumerate(results):
        _check_tensors({n: m.numpy() for n, m in r["mu"].items()}, _shards(full, c), GRAD_TOL,
                       scale=scale)
    mus = [full] + [{n: m.numpy() for n, m in zip([n for n, _ in mod.named_parameters()], mu)}
                    for mod, mu in ((gen, state.g_opt_state.mu),
                                    (mpd, state.d_opt_state.mu[:len(list(mpd.parameters()))]),
                                    (msd, state.d_opt_state.mu[len(list(mpd.parameters())):]))]
    after = _snap(modules)
    for i, (b, a, mu) in enumerate(zip(before, after, mus)):
        for c, r in enumerate(results):
            got, bs, as_, ms = r["state_dicts"][i], _shards(b, c), _shards(a, c), _shards(mu, c)
            for n in bs:
                if i == 0 and ZERO_BY_CONSTRUCTION.search(n):
                    continue
                signal = np.abs(ms[n]) >= NOISE * np.abs(ms[n]).max()
                g, w = got[n].numpy() - bs[n], as_[n] - bs[n]
                assert _rel(g[signal], w[signal]) < UPDATE_TOL, (i, n, c)
        _same_where_replicated([r["state_dicts"][i] for r in results], [0, 1],
                               {n: t.shape for n, t in b.items()})


def test_split_eval_forward_matches_the_unsplit_forward(ranks):
    """(f) ``vie_tiny`` (2 heads of 24) split over two ranks: the durations
    equal and the postnet mel within 1e-3 of the unsplit forward; each
    decoder layer's attention at T = 256 reached the flash wrapper with one
    local head a row (B * 1, 256, 24)."""
    for r in (r["forward"] for r in ranks):
        assert r["wq_rows"] == 24
        assert torch.equal(r["split"]["durations"], r["single"]["durations"])
        assert torch.equal(r["split"]["mel_lens"], r["single"]["mel_lens"])
        gap = (r["split"]["mel"] - r["single"]["mel"]).abs().max().item()
        assert gap < 1e-3, gap
        assert r["flash_shapes"] == [(2, 256, 24)] * 2
    assert torch.equal(ranks[0]["forward"]["split"]["mel"], ranks[1]["forward"]["split"]["mel"])


def test_dryrun_runs_the_three_steps_on_four_ranks():
    """``python -m e2e_tts_tpu_torch.parallel.dryrun --ranks 4 --device
    cpu``: the three steps over (data 2, model 2), one line each."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "e2e_tts_tpu_torch.parallel.dryrun", "--ranks",
                          "4", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("dryrun")]
    mesh = "mesh={'data': 2, 'model': 2}"
    assert [ln.split(":")[0] for ln in lines] == [
        "dryrun acoustic OK", "dryrun vocoder-GAN OK", "dryrun e2e OK", "dryrun OK"]
    assert all(mesh in ln for ln in lines)


def test_parallelize_is_the_identity_without_a_model_axis():
    """One process (a 1 x 1 mesh): nothing is split or marked, and the
    step is bit-equal to the plain one."""
    import torch.distributed as dist

    from e2e_tts_tpu_torch.parallel import make_mesh
    from e2e_tts_tpu_torch.parallel.mesh import model_group

    started = not dist.is_initialized()
    try:
        mesh = make_mesh()
        assert model_group(mesh) is None
        _, _, (port, cfg) = _models()
        shapes = {n: p.shape for n, p in port.named_parameters()}
        parallelize(port, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    assert {n: p.shape for n, p in port.named_parameters()} == shapes
    assert all(role(p) == "whole" for p in port.parameters())
    assert local_shard("encoder.layers.0.slf_attn.w_q.weight", torch.zeros(32, 32), TP, 1).shape \
        == (16, 32)

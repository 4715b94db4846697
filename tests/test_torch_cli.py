"""The port's training command line (``python -m e2e_tts_tpu_torch.train.cli``)
against the JAX package's, on the CPU (``--device cpu``), on a synthetic
corpus (4 sentences x 2 speakers) at a tiny config: the port's twin of
``tests/test_cli.py::test_full_cli_pipeline``.

- ``prepare``: ``file_list.txt`` and ``speakers.json`` equal to the JAX
  ``cmd_prepare``'s on a copy of the corpus; ``stats.json``'s pitch and f0
  equal, its energy within 1e-4 relative (each package's energy comes from
  its own STFT: ``tests/test_torch_data.py`` holds the features);
- the pipeline ``prepare`` -> ``acoustic`` -> ``vocoder`` -> ``acoustic``
  (resumed) -> ``e2e`` -> ``generate-mels`` -> ``vocoder --predicted-mels``
  (resumed) -> ``export`` (the e2e weights) and ``export --no-e2e``;
- ``generate-mels``' mels against JAX's teacher-forced forward of the
  exported acoustic weights on the same batches: max |diff| < 1e-3 (dropout
  off on both sides for this: config rates 0 and the postnet's 0.5);
- the exported bundle served by the port's engine and by the JAX engine
  within 1 LSB mean, as exported and with its generator at a trained norm
  (each kernel's g drawn U(0.5, 1.5), so that 1 LSB tests something);
- the supervised pipeline on a labelled copy of the corpus (``metadata.lab``,
  ``durations/*.txt``): ``prepare --supervised`` -> ``acoustic --supervised``
  -> ``vocoder`` -> ``export --supervised``, served by the port;
- the parser's flags and defaults (``tests/test_cli_args.py``'s
  expectations, and ``--device``); ``export`` refuses random weights; a
  command refuses to start without CUDA unless given ``--device cpu``;
- ``e2e_optimizers``' updates against optax's ``chain(..., scale(s))`` on the
  same gradients: within 1e-6;
- ``prefetch_iterator`` re-raises a worker's error; the loggers write the
  JAX package's JSONL records.

The discriminators run at narrow widths here (the CLI builds them at the
reference widths, as JAX's does: too slow for the CPU tier).
"""

import argparse
import contextlib
import functools
import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from _torch_one_thread import one_thread  # noqa: F401
import e2e_tts_tpu.models.acoustic as jax_acoustic
from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.data import AcousticDataset as JaxAcousticDataset
from e2e_tts_tpu.data import make_acoustic_batches as jax_make_acoustic_batches
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.postnet import Postnet as JaxPostnet
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu.train import cli as jax_cli
from e2e_tts_tpu.train.cli import e2e_optimizers as jax_e2e_optimizers
from e2e_tts_tpu.utils import logging as jax_logging
from e2e_tts_tpu.utils.prefetch import prefetch_iterator as jax_prefetch_iterator
from e2e_tts_tpu_torch.config import default_config, save_config
from e2e_tts_tpu_torch.data import synthetic
from e2e_tts_tpu_torch.nn import discriminators
from e2e_tts_tpu_torch.serve.bundle import read_msgpack, write_msgpack
from e2e_tts_tpu_torch.serve.engine import SynthesisEngine
from e2e_tts_tpu_torch.train import cli
from e2e_tts_tpu_torch.train.optim import e2e_optimizers
from e2e_tts_tpu_torch.utils import logging as port_logging
from e2e_tts_tpu_torch.utils.prefetch import prefetch_iterator

pytestmark = pytest.mark.usefixtures("one_thread")

MEL_TOL = 1e-3
STATS_RTOL = 1e-4
OPT_TOL = 1e-6
TEXT = "xin chào bạn"
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_config_path(tmp_path_factory):
    """A tiny config both packages read, dropout off (the rates; the postnet's
    hard-coded 0.5 is patched where a test compares dropout-free graphs)."""
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(transformer=fs2.building_block.transformer.replace(
            conv_filter_size=32, encoder_dropout=0.0, decoder_dropout=0.0)),
        variance=fs2.variance.replace(variance_predictor=fs2.variance.variance_predictor.replace(
            filter_size=16, dropout=0.0)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=2))
    hifi = cfg.models.hifigan.replace(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2, hifigan=hifi),
                      train=cfg.train.replace(batch_size=2, log_step=2))
    path = str(tmp_path_factory.mktemp("cfg") / "config.yaml")
    save_config(cfg, path)
    return path


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same synthetic corpus three times: the port's, JAX's and a copy
    labelled with its durations."""
    roots = {}
    for name in ("port", "jax", "supervised"):
        roots[name] = str(tmp_path_factory.mktemp(f"corpus_{name}"))
        synthetic.make_synthetic_corpus(roots[name], n_sentences=4, f0_jitter=0.1, seed=0)
    assert synthetic.write_duration_labels(roots["supervised"]) == 8
    return roots


@pytest.fixture()
def narrow_discriminators(monkeypatch):
    """MPD and MSD at narrow widths wherever the CLI builds them."""
    real = discriminators.build_discriminators
    specs = ((8, 15, 1, 1, 7), (8, 41, 4, 4, 20), (8, 5, 1, 1, 2))
    monkeypatch.setattr(discriminators, "build_discriminators", functools.partial(
        real, mpd_channels=(4, 8, 8, 8), msd_specs=specs))


def _run(argv):
    """``cli.main(argv + --device cpu)``, its printed lines and its result."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = cli.main(argv + CPU)
    return out.getvalue(), result


def _same_audio(got, want):
    assert got.dtype == want.dtype == np.int16 and len(got) == len(want) > 0
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.mean() < 1.0, (d.mean(), d.max())


def _audible(bundle, out):
    """A copy of ``bundle`` whose generator kernels have g drawn U(0.5, 1.5)."""
    import shutil

    shutil.copytree(bundle, out)
    tree = read_msgpack(os.path.join(out, "vocoder.msgpack"))
    rng = np.random.RandomState(0)

    def scale(node):
        for k, v in node.items():
            if isinstance(v, dict):
                scale(v)
            elif k == "g":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    scale(tree)
    write_msgpack(os.path.join(out, "vocoder.msgpack"), tree)
    return out


def _jax_teacher_forced(bundle, workdir, cfg_path):
    """JAX's teacher-forced forward (``cmd_generate_mels``' graph, postnet
    dropout off) of the bundle's acoustic weights on the workdir's batches:
    {utterance: (n_mels, T)}."""
    cfg = jax_load_config(cfg_path)
    entries, stats, speakers = jax_cli._load_workdir(workdir)
    ds = JaxAcousticDataset(entries, speakers, stats, cfg)
    model = JaxFastSpeech2(cfg.models.fastspeech2, jax_cli._lang_symbols("vie")[0], len(speakers),
                           cfg.audio.mel.channels, JaxFeatureStats.from_dict(stats))
    with open(os.path.join(bundle, "acoustic.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())

    @jax.jit
    def infer(b):
        out, _ = model.apply(variables, b.speakers, b.texts, b.txt_lens, b.mel.shape[1],
                             mel=b.mel, mel_lens=b.mel_lens, attn_prior=b.attn_prior,
                             pitch_target={"f0": b.f0, "uv": b.uv}, energy_target=b.energy,
                             step=jnp.asarray(10 ** 9), train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return out["postnet_mel"], out["mel_lens"]

    mels = {}
    jax_acoustic.Postnet = functools.partial(JaxPostnet, dropout=0.0)
    try:
        for batch, paths in jax_make_acoustic_batches(ds, cfg.train.batch_size, shuffle=False,
                                                      with_paths=True):
            m, lens = infer(jax.tree_util.tree_map(jnp.asarray, batch))
            for row, wav in enumerate(paths):
                mels[os.path.basename(wav)[:-4]] = np.asarray(m)[row, : int(lens[row])].T
    finally:
        jax_acoustic.Postnet = JaxPostnet
    return mels


def test_cli_pipeline_matches_jax(corpora, tiny_config_path, tmp_path, monkeypatch,
                                  narrow_discriminators):
    cfg = ["--config", tiny_config_path]
    w, jw = str(tmp_path / "work"), str(tmp_path / "jax_work")

    # prepare, against the JAX command on a copy of the corpus
    _run(["prepare", "--corpus", corpora["port"], "--workdir", w] + cfg)
    jax_cli.cmd_prepare(argparse.Namespace(corpus=[corpora["jax"]], workdir=jw,
                                           config=tiny_config_path, lang="vie",
                                           supervised=False, overwrite=False))
    with open(os.path.join(w, "file_list.txt")) as f, open(os.path.join(jw, "file_list.txt")) as g:
        assert f.read() == g.read().replace(corpora["jax"], corpora["port"])
    for name in ("speakers.json", "stats.json"):
        with open(os.path.join(w, name)) as f, open(os.path.join(jw, name)) as g:
            got, want = json.load(f), json.load(g)
        if name == "speakers.json":
            assert got == want == {"nam": 0, "nu": 1}
            continue
        assert got["pitch"] == want["pitch"] and got["f0"] == want["f0"]
        for k, v in want["energy"].items():
            assert abs(got["energy"][k] - v) <= STATS_RTOL * max(abs(v), 1.0), (k, v)

    # train, resume, fine-tune
    out, step = _run(["acoustic", "--workdir", w, "--steps", "4", "--ckpt-every", "2"] + cfg)
    assert step == 4 and "valid_total=" in out and "resumed" not in out
    assert sorted(os.listdir(os.path.join(w, "acoustic_ckpt"))) == ["2", "4"]
    records = [json.loads(r) for r in open(os.path.join(w, "logs", "acoustic", "scalars.jsonl"))]
    assert {"acoustic/total", "acoustic/ctc", "acoustic/lr", "acoustic/valid_total"} <= {
        r["tag"] for r in records}
    _, step = _run(["vocoder", "--workdir", w, "--steps", "2", "--ckpt-every", "2"] + cfg)
    assert step == 2
    out, step = _run(["acoustic", "--workdir", w, "--steps", "6", "--ckpt-every", "2"] + cfg)
    assert "[acoustic] resumed from step 4" in out and step == 6
    out, step = _run(["e2e", "--workdir", w, "--steps", "2", "--ckpt-every", "2",
                      "--am-lr-scale", "0.5", "--adv-warmup", "2"] + cfg)
    assert "acoustic seeded from step 6" in out and "vocoder seeded from step 2" in out
    assert step == 2 and os.listdir(os.path.join(w, "e2e_ckpt")) == ["2"]

    # predicted mels, and the vocoder's fine-tune on them (resumed at step 2)
    from e2e_tts_tpu_torch.train import build_acoustic_model

    def dropout_free(config, args, speakers, stats, device):
        from e2e_tts_tpu_torch.nn.variance import FeatureStats

        return build_acoustic_model(config, cli._lang_symbols(args.lang)[0], len(speakers),
                                    FeatureStats.from_dict(stats), dropout=False, device=device)

    with monkeypatch.context() as m:
        m.setattr(cli, "_acoustic_model", dropout_free)
        _, count = _run(["generate-mels", "--workdir", w] + cfg)
    written = sorted(glob.glob(os.path.join(corpora["port"], "predicted_mels", "*.npy")))
    assert count == 8 and len(written) == 8
    out, step = _run(["vocoder", "--workdir", w, "--steps", "3", "--predicted-mels"] + cfg)
    assert "[vocoder] resumed from step 2" in out and step == 3

    # export: the e2e weights by default, the stages with --no-e2e
    bundle, stages = str(tmp_path / "bundle"), str(tmp_path / "stages")
    out, _ = _run(["export", "--workdir", w, "--output", bundle] + cfg)
    assert "using e2e fine-tune step 2" in out
    out, _ = _run(["export", "--workdir", w, "--output", stages, "--no-e2e"] + cfg)
    assert "e2e" not in out
    a, b = read_msgpack(os.path.join(bundle, "acoustic.msgpack")), read_msgpack(
        os.path.join(stages, "acoustic.msgpack"))
    assert not np.array_equal(a["params"]["mel_linear"]["kernel"],
                              b["params"]["mel_linear"]["kernel"])

    # generate-mels against JAX's teacher-forced forward of the same weights
    want = _jax_teacher_forced(stages, w, tiny_config_path)
    assert sorted(want) == sorted(os.path.basename(p)[:-4] for p in written)
    for path in written:
        got = np.load(path)
        ref = want[os.path.basename(path)[:-4]]
        assert got.shape == ref.shape and got.shape[0] == 80
        assert np.abs(got - ref).max() < MEL_TOL, (path, np.abs(got - ref).max())

    # the exported voice, served by both packages
    for path in (bundle, _audible(bundle, str(tmp_path / "audible"))):
        jeng = JaxEngine.from_checkpoint(path)
        peng = SynthesisEngine.from_checkpoint(path, device="cpu")
        for spk in ("nam", "nu"):
            got, want = peng.synthesize(TEXT, speaker_id=spk), jeng.synthesize(TEXT, speaker_id=spk)
            _same_audio(got, want)
    assert np.abs(want.astype(np.int32)).max() > 1000  # the audible copy: 1 LSB tests something


def test_supervised_cli_pipeline(corpora, tiny_config_path, tmp_path, narrow_discriminators):
    cfg = ["--config", tiny_config_path]
    w = str(tmp_path / "work")
    _run(["prepare", "--corpus", corpora["supervised"], "--workdir", w, "--supervised"] + cfg)
    with open(os.path.join(w, "file_list.txt")) as f:
        rows = [r.split("|") for r in f.read().splitlines()]
    for wav, _, phonemes, durations in rows:  # the true durations, one a phoneme
        assert len(phonemes.split()) == len(durations.split())
        n_frames = np.load(wav.replace("/wavs/", "/mels/").replace(".wav", ".npy")).shape[1]
        assert abs(sum(map(int, durations.split())) - n_frames) <= 1
    out, step = _run(["acoustic", "--workdir", w, "--steps", "2", "--ckpt-every", "2",
                      "--supervised"] + cfg)
    assert step == 2
    records = {json.loads(r)["tag"] for r in open(os.path.join(w, "logs", "acoustic",
                                                               "scalars.jsonl"))}
    assert "acoustic/pdur" in records and "acoustic/ctc" not in records
    _run(["vocoder", "--workdir", w, "--steps", "1"] + cfg)
    bundle = str(tmp_path / "bundle")
    _run(["export", "--workdir", w, "--output", bundle, "--supervised"] + cfg)
    eng = SynthesisEngine.from_checkpoint(bundle, device="cpu")
    assert eng.acoustic.variance_adaptor.aligner is None
    audio = eng.synthesize(TEXT, speaker_id="nu")
    assert audio.dtype == np.int16 and len(audio) > 0
    # the unsupervised tree does not restore from a supervised checkpoint
    with pytest.raises(RuntimeError):
        _run(["export", "--workdir", w, "--output", str(tmp_path / "x")] + cfg)

    # a new voice warm-started from the bundle: each stage, and the joint fine-tune
    w2 = tmp_path / "fine_tune"
    w2.mkdir()
    for name in ("file_list.txt", "stats.json", "speakers.json"):
        (w2 / name).write_bytes(open(os.path.join(w, name), "rb").read())
    w2 = str(w2)
    out, _ = _run(["acoustic", "--workdir", w2, "--steps", "1", "--supervised", "--init-from",
                   bundle] + cfg)
    assert f"warm-started from bundle {bundle}" in out
    out, _ = _run(["vocoder", "--workdir", w2, "--steps", "1", "--init-from", bundle] + cfg)
    assert f"warm-started generator from {bundle}" in out
    out, step = _run(["e2e", "--workdir", w2, "--steps", "1", "--supervised", "--init-from",
                      bundle] + cfg)
    assert f"[e2e] warm-started from bundle {bundle}" in out and step == 1
    assert os.listdir(os.path.join(w2, "e2e_ckpt")) == ["1"]


@pytest.fixture()
def captured(monkeypatch):
    """Every cmd_* replaced by a recorder; the parser binds them when built."""
    seen = {}
    for name in ("cmd_prepare", "cmd_acoustic", "cmd_vocoder", "cmd_e2e", "cmd_generate_mels",
                 "cmd_export"):
        monkeypatch.setattr(cli, name, functools.partial(
            lambda name, a, on_step=None: seen.__setitem__(name, a), name))
    return seen


ARG_CASES = {
    "prepare": (["prepare", "--corpus", "c1", "c2", "--workdir", "w", "--lang", "eng",
                 "--supervised", "--overwrite"], "cmd_prepare",
                dict(corpus=["c1", "c2"], workdir="w", lang="eng", supervised=True,
                     overwrite=True, device="cuda", config=None)),
    "acoustic_defaults": (["acoustic", "--workdir", "w"], "cmd_acoustic",
                          dict(steps=600000, ckpt_every=5000, lang="vie", supervised=False,
                               init_from=None, device="cuda")),
    "acoustic": (["acoustic", "--workdir", "w", "--steps", "7", "--ckpt-every", "2",
                  "--supervised", "--init-from", "/b", "--lang", "mya", "--device", "cpu"],
                 "cmd_acoustic", dict(steps=7, ckpt_every=2, supervised=True, init_from="/b",
                                      lang="mya", device="cpu")),
    "vocoder_defaults": (["vocoder", "--workdir", "w"], "cmd_vocoder",
                         dict(steps=400000, ckpt_every=5000, istft=False, predicted_mels=False,
                              init_from=None)),
    "vocoder": (["vocoder", "--workdir", "w", "--istft", "--predicted-mels", "--init-from",
                 "/b"], "cmd_vocoder", dict(istft=True, predicted_mels=True, init_from="/b")),
    "e2e_defaults": (["e2e", "--workdir", "w"], "cmd_e2e",
                     dict(steps=100000, ckpt_every=5000, adv_warmup=0, am_lr_scale=1.0,
                          d_lr_scale=1.0, supervised=False, init_from=None, lang="vie")),
    "e2e_recipe": (["e2e", "--workdir", "w", "--steps", "2000", "--adv-warmup", "999999",
                    "--am-lr-scale", "0.0", "--d-lr-scale", "0.5"], "cmd_e2e",
                   dict(steps=2000, adv_warmup=999999, am_lr_scale=0.0, d_lr_scale=0.5)),
    "generate_mels": (["generate-mels", "--workdir", "w", "--supervised", "--lang", "eng"],
                      "cmd_generate_mels", dict(supervised=True, lang="eng", device="cuda")),
    "export": (["export", "--workdir", "w", "--output", "/out", "--no-e2e", "--istft"],
               "cmd_export", dict(output="/out", no_e2e=True, istft=True, supervised=False,
                                  lang="vie")),
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_parser_flags_and_defaults(captured, case):
    argv, cmd, want = ARG_CASES[case]
    cli.main(argv)
    got = vars(captured[cmd])
    assert {k: got[k] for k in want} == want
    # the JAX parser takes the same command line, less --device, to the same values
    jax_seen = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_cli, cmd, lambda a: jax_seen.__setitem__(cmd, a))
        jax_cli.main([a for i, a in enumerate(argv)
                      if "--device" not in (a, argv[i - 1] if i else None)])
    theirs = {k: v for k, v in vars(jax_seen[cmd]).items() if k != "fn"}
    ours = {k: v for k, v in got.items() if k not in ("fn", "device")}
    assert ours == theirs


@pytest.mark.parametrize("argv", [["acoustic", "--workdir", "w", "--lang", "fra"], []],
                         ids=["unknown_language", "no_subcommand"])
def test_parser_rejects(captured, argv):
    with pytest.raises(SystemExit):
        cli.main(argv)


def _minimal_workdir(tmp_path):
    """A workdir that ``_load_workdir`` reads, with no checkpoints."""
    w = tmp_path / "work"
    w.mkdir()
    (w / "file_list.txt").write_text("", encoding="utf8")
    stats = {k: {"min": -1.0, "max": 1.0, "mean": 0.0, "std": 1.0} for k in ("pitch", "energy")}
    (w / "stats.json").write_text(json.dumps(stats), encoding="utf8")
    (w / "speakers.json").write_text(json.dumps({"spk": 0}), encoding="utf8")
    return str(w)


def test_export_refuses_random_weights(tmp_path, tiny_config_path):
    w = _minimal_workdir(tmp_path)
    with pytest.raises(SystemExit, match="RANDOM weights"):
        cli.main(["export", "--workdir", w, "--output", str(tmp_path / "b"), "--config",
                  tiny_config_path] + CPU)
    assert not os.path.exists(tmp_path / "b")


@pytest.mark.parametrize("cmd", ["acoustic", "export"])
def test_refuses_to_start_without_cuda(tmp_path, tiny_config_path, monkeypatch, cmd):
    """The default ``--device cuda`` raises without a card, before any work;
    ``--device cpu`` runs (here: as far as the missing checkpoint)."""
    w = _minimal_workdir(tmp_path)
    argv = [cmd, "--workdir", w, "--config", tiny_config_path] + (
        ["--output", str(tmp_path / "b")] if cmd == "export" else ["--steps", "0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert not os.path.exists(os.path.join(w, "acoustic_ckpt"))
    if cmd == "export":
        with pytest.raises(SystemExit, match="RANDOM"):
            cli.main(argv + CPU)


def _params(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("which", ["acoustic", "generator", "discriminator"])
@pytest.mark.parametrize("am_scale,d_scale", [(1.0, 1.0), (0.1, 0.5), (0.0, 2.0)])
def test_e2e_optimizers_match_optax(which, am_scale, d_scale):
    """Three updates of each optimizer of ``e2e_optimizers`` from the same
    parameters and gradients as the JAX package's optax chains (the scale
    stage last): the parameters within 1e-6, and the same tree of state
    whatever the scales."""
    i = ("acoustic", "generator", "discriminator").index(which)
    cfg = default_config()
    shapes = [(6, 5), (7,), (3, 4, 2)]
    params = _params(1, shapes)
    tx = jax_e2e_optimizers(cfg, am_scale, d_scale)[i]
    opt = e2e_optimizers(cfg, am_scale, d_scale)[i]
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for k in range(3):
        grads = [g * (0.1 + k) for g in _params(10 + k, shapes)]
        updates, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply(tp, [torch.from_numpy(g) for g in grads], ts)
    for got, want, p0 in zip(tp, jp, params):
        assert np.abs(got.numpy() - np.asarray(want)).max() < OPT_TOL
    if (which == "acoustic" and am_scale == 0.0):
        assert all(np.array_equal(t.numpy(), p) for t, p in zip(tp, params))
    assert sorted(vars(ts)) == ["count", "mu", "nu"] and ts.count == 3


def test_prefetch_iterator_reraises_the_worker_error():
    def items():
        yield 1
        yield 2
        raise ValueError("bad utterance")

    for fn in (prefetch_iterator, jax_prefetch_iterator):
        got = []
        with pytest.raises(ValueError, match="bad utterance"):
            for x in fn(items(), size=1):
                got.append(x)
        assert got == [1, 2]
    assert list(prefetch_iterator(iter(range(5)), size=2)) == list(range(5))


def test_loggers_write_the_jax_records(tmp_path, monkeypatch):
    """The same calls give JSONL records equal to the JAX loggers' (all but
    the timestamps), with and without tensorboardX."""
    def records(mod, d):
        a = mod.AcousticLogger(str(d / "acoustic"))
        a.log(3, {"total": 1.5, "mel": 0.25}, lr=1e-3)
        a.writer.histogram("acoustic/params/x", np.arange(6.0), 3)
        e = mod.E2ELogger(str(d / "e2e"))
        e.log(4, {"total": 2.0, "mpd": 0.5, "grad_norm": 7.0})
        a.writer.flush(), e.writer.flush()
        out = []
        for sub in ("acoustic", "e2e"):
            for line in open(d / sub / "scalars.jsonl"):
                r = json.loads(line)
                r.pop("ts")
                out.append(r)
        return out

    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("tensorboardX"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    want = records(jax_logging, tmp_path / "jax")
    got = records(port_logging, tmp_path / "port")
    assert got == want and any(r.get("kind") == "histogram" for r in got)

    model = torch.nn.Sequential(torch.nn.Linear(2, 3))
    logger = port_logging.AcousticLogger(str(tmp_path / "params"))
    logger.log_params(5, model)
    logger.writer.flush()
    tags = [json.loads(r)["tag"] for r in open(tmp_path / "params" / "scalars.jsonl")]
    assert tags == ["acoustic/params/0/weight", "acoustic/params/0/bias"]

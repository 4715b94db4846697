"""The port's train checkpoints, bundle writing and warm start
(``train/checkpoint.py``, ``serve/bundle.save_bundle``, ``convert.to_jax``),
on the CPU.

Bars: a state restored from a checkpoint into a template built from another
seed equals the saved one bit for bit (parameters, BatchNorm statistics,
Adam moments and count, the step, the dropout generator), and the step run
from it equals the step run from the saved state bit for bit, for the
acoustic, vocoder GAN and joint e2e states (small models, dropout on, no
JAX step); ``max_to_keep``, ``latest_step`` and ``scan_checkpoint`` as the
JAX package's; ``to_jax`` of a port module gives the JAX package's names,
shapes and dtypes and ``convert`` takes it back exactly; a port-written
``.msgpack`` is byte-equal to flax's ``to_bytes`` of the same tree and has
the keys, shapes and dtypes of JAX's ``save_bundle``; ``warm_start_params``
equals JAX's on ``vie_tiny`` into a model with more speakers.  The JAX
engine serving port-written bundles is in ``tests/test_torch_engine.py``,
beside the JAX engine it already builds.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from flax import serialization

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.serve.bundle import save_bundle as jax_save_bundle
from e2e_tts_tpu.train.checkpoint import scan_checkpoint as jax_scan_checkpoint
from e2e_tts_tpu.train.cli import warm_start_params as jax_warm_start_params
from e2e_tts_tpu_torch.config import default_config, load_config
from e2e_tts_tpu_torch.convert import _flatten, convert, load_into, to_jax
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.nn import discriminators
from e2e_tts_tpu_torch.nn.hifigan import fuse_generator
from e2e_tts_tpu_torch.nn.variance import FeatureStats
from e2e_tts_tpu_torch.serve.bundle import load_bundle, read_msgpack, save_bundle, write_msgpack
from e2e_tts_tpu_torch.text.symbols import symbols
from e2e_tts_tpu_torch.train import (AcousticBatch, CheckpointManager, E2EBatch, VocoderBatch,
                                     acoustic_optimizer, build_acoustic_model, gan_optimizer,
                                     init_e2e_state, init_train_state, init_vocoder_train_state,
                                     make_e2e_train_step, make_train_step,
                                     make_vocoder_train_step, scan_checkpoint, warm_start_params)
from e2e_tts_tpu_torch.train.checkpoint import _snapshot
from test_torch_gan import SEG, TINY_GEN, _speech
from test_torch_train import N_SPEAKERS, N_SYMBOLS, N_WORDS, _batch, _small

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
HOP = 256


def _config():
    cfg = _small(default_config(), rate=0.1)  # dropout on: the generator's state matters
    return cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(**TINY_GEN)))


def _discriminators(seed):
    return discriminators.build_discriminators(
        device="cpu", seed=seed, periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
        msd_specs=discriminators.TINY_MSD_SPECS)


def _acoustic(seed):
    cfg = _config()
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, device="cpu", seed=seed)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    state = init_train_state(model, opt, seed=seed)
    step = make_train_step(model, cfg, opt, N_WORDS)
    batch = AcousticBatch.from_numpy(_batch(), "cpu")
    return state, lambda: step(state, batch)[1]


def _vocoder(seed):
    cfg = _config()
    gen = build_generator(cfg, "hifigan", train=True, device="cpu", seed=seed)
    mpd, msd = _discriminators(seed)
    g_opt, d_opt = gan_optimizer(cfg.train.hifigan_optimizer), gan_optimizer(
        cfg.train.hifigan_optimizer)
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, mpd=mpd, msd=msd)
    rng = np.random.RandomState(4)
    batch = VocoderBatch.from_numpy((rng.randn(2, SEG, 80) - 4.0, _speech(2, SEG * HOP, 5)), "cpu")
    tree = {"state": state, "generator": gen, "mpd": mpd, "msd": msd}
    return tree, lambda: step(state, batch)[1]


def _e2e(seed):
    cfg = _config()
    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, device="cpu", seed=seed)
    gen = build_generator(cfg, "hifigan", train=True, device="cpu", seed=seed)
    mpd, msd = _discriminators(seed)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    g_opt, d_opt = gan_optimizer(cfg.train.hifigan_optimizer), gan_optimizer(
        cfg.train.hifigan_optimizer)
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, seed=seed)
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, N_WORDS,
                               segment_frames=SEG, mpd=mpd, msd=msd)
    jb = _batch()
    batch = E2EBatch.from_numpy(jb, _speech(4, jb.mel.shape[1] * HOP, 9), "cpu")
    tree = {"state": state, "acoustic": model, "generator": gen, "mpd": mpd, "msd": msd}
    return tree, lambda: step(state, batch)[1]  # crop starts from the state's generator


def _leaves(tree, prefix=""):
    """Every tensor and number of a snapshot, by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _assert_bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("make", [_acoustic, _vocoder, _e2e], ids=["acoustic", "vocoder", "e2e"])
def test_resumed_step_bit_equal(make, tmp_path):
    tree, step = make(0)
    step()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, tree)  # written in the background
    saved = _snapshot(tree)
    want_metrics = step()
    want = _snapshot(tree)
    assert mgr.latest_step() == 1

    other, other_step = make(1)  # another init, dropout generator and crop draws
    restored = mgr.restore(other)
    assert restored is other
    _assert_bit_equal(_snapshot(other), saved)
    got_metrics = other_step()
    assert sorted(got_metrics) == sorted(want_metrics)
    for k in want_metrics:
        assert torch.equal(got_metrics[k], want_metrics[k]), k
    _assert_bit_equal(_snapshot(other), want)
    mgr.close()


def test_manager_keeps_the_newest_and_scans_like_jax(tmp_path):
    state, step = _acoustic(0)
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(state) is state  # nothing to restore: the template as it is
    counts = {}
    for s in (1, 2, 3, 4):
        state.opt_state.count = 10 * s
        mgr.save(s, state, wait=(s == 2))
        counts[s] = _snapshot(state)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "c")) == ["3", "4"]
    assert mgr.latest_step() == 4
    assert scan_checkpoint(str(tmp_path / "c")) == jax_scan_checkpoint(str(tmp_path / "c")) == 4
    mgr.restore(state, step=3)
    assert state.opt_state.count == 30
    _assert_bit_equal(_snapshot(state), counts[3])
    # a directory of orbax's numbered steps is scanned alike
    for name in ("7", "12", "tmp", "12.orbax-checkpoint-tmp-3"):
        os.makedirs(tmp_path / "o" / name)
    assert scan_checkpoint(str(tmp_path / "o")) == jax_scan_checkpoint(str(tmp_path / "o")) == 12
    assert scan_checkpoint(str(tmp_path / "none")) is None


def _vie_tiny_modules():
    b = load_bundle(VIE_TINY)
    acoustic = FastSpeech2(b.config.models.fastspeech2, len(symbols), len(b.speakers),
                           b.config.audio.mel.channels, b.stats, device="cpu")
    load_into(acoustic, b.acoustic_variables)
    vocoder = build_generator(b.config, b.vocoder_kind, device="cpu")
    load_into(vocoder, b.vocoder_variables)
    return b, acoustic, vocoder


def _shapes(tree):
    return {k: (v.shape, v.dtype) for k, v in _flatten(tree).items()}


def test_save_bundle_trees_match_jax(tmp_path):
    """The port writes vie_tiny's weights from its modules (the serving
    vocoder: v = w, g = ||w||); JAX's save_bundle writes the bundle's own
    trees: the same files, keys, shapes and dtypes, and the same weights
    once weight norm is applied."""
    b, acoustic, vocoder = _vie_tiny_modules()
    save_bundle(str(tmp_path / "p"), b.config, acoustic, vocoder, b.speakers, b.stats,
                b.vocoder_kind, foreign_dict={"wifi": "oai phai"}, language=b.language)
    raw = {}
    for name in ("acoustic", "vocoder"):
        with open(os.path.join(VIE_TINY, f"{name}.msgpack"), "rb") as f:
            raw[name] = serialization.msgpack_restore(f.read())
    from e2e_tts_tpu.config import load_config as jax_load_config
    from e2e_tts_tpu.nn.variance import FeatureStats as JaxStats

    jax_save_bundle(str(tmp_path / "j"), jax_load_config(os.path.join(VIE_TINY, "config.yaml")),
                    raw["acoustic"], raw["vocoder"], b.speakers,
                    JaxStats.from_dict(b.stats.to_dict()), b.vocoder_kind,
                    foreign_dict={"wifi": "oai phai"}, language=b.language)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    for name in ("speakers.json", "stats.json", "meta.json", "foreign_words.json"):
        assert json.loads((tmp_path / "p" / name).read_text(encoding="utf8")) == json.loads(
            (tmp_path / "j" / name).read_text(encoding="utf8")), name
    assert load_config(str(tmp_path / "p" / "config.yaml")).to_dict() == b.config.to_dict()
    for name in ("acoustic", "vocoder"):
        got = read_msgpack(str(tmp_path / "p" / f"{name}.msgpack"))
        want = read_msgpack(str(tmp_path / "j" / f"{name}.msgpack"))
        assert _shapes(got) == _shapes(want)
        fused_got, fused_want = convert(got), convert(want)
        for k in fused_want:
            np.testing.assert_allclose(fused_got[k], fused_want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    # the acoustic tree holds no weight norm: its arrays are the bundle's exactly
    for k, v in _flatten(read_msgpack(str(tmp_path / "p" / "acoustic.msgpack"))).items():
        np.testing.assert_array_equal(v, _flatten(b.acoustic_variables)[k])


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_to_jax_of_fresh_models(kind, tmp_path):
    """A port model with no bundle behind it: the training generator writes
    its (v, g); the serving form from ``fuse_generator`` writes (w, ||w||),
    which JAX's weight norm takes back to w; the acoustic model's tree
    round-trips exactly; the file is flax's encoding byte for byte."""
    cfg = _config().replace(models=_config().models.replace(
        istft=_config().models.istft.replace(**TINY_GEN)))
    trainable = build_generator(cfg, kind, train=True, device="cpu", seed=3)
    tree = to_jax(trainable)
    state = trainable.state_dict()
    back = convert(tree, list(state))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k].numpy(), err_msg=k)
    serving = fuse_generator(trainable)
    fused = convert(to_jax(serving))
    assert _shapes(to_jax(serving)) == _shapes(tree)
    for k, v in serving.state_dict().items():
        np.testing.assert_allclose(fused[k], v.numpy(), rtol=1e-5, atol=1e-8, err_msg=k)

    model = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, device="cpu", seed=3)
    atree = to_jax(model)
    assert set(atree) == {"params", "batch_stats"}
    for k, v in convert(atree, model.state_dict()).items():
        np.testing.assert_array_equal(v, model.state_dict()[k].numpy(), err_msg=k)
    write_msgpack(str(tmp_path / "a.msgpack"), atree)
    assert (tmp_path / "a.msgpack").read_bytes() == serialization.to_bytes(_sorted(atree))
    assert _shapes(read_msgpack(str(tmp_path / "a.msgpack"))) == _shapes(atree)


def test_warm_start_matches_jax():
    """vie_tiny's acoustic weights grafted onto a fresh model with 5
    speakers (the bundle has 2): the port's result equals JAX's graft of the
    same fresh weights."""
    b = load_bundle(VIE_TINY)
    fresh = FastSpeech2(b.config.models.fastspeech2, len(symbols), 5,
                        b.config.audio.mel.channels, FeatureStats(), device="cpu",
                        generator=torch.Generator().manual_seed(7))
    dst = to_jax(fresh)["params"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # every parameter has a source here
        warm_start_params(fresh, VIE_TINY)
    want = jax_warm_start_params(dst, VIE_TINY)
    want = convert({"params": jax_tree_to_numpy(want)})
    got = fresh.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    emb = got["speaker_emb.weight"].numpy()
    src = b.acoustic_variables["params"]["speaker_emb"]["embedding"]
    np.testing.assert_array_equal(emb[:2], src)
    np.testing.assert_array_equal(emb[2:], np.broadcast_to(src.mean(axis=0), (3, src.shape[1])))


def jax_tree_to_numpy(tree):
    return {k: jax_tree_to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_warm_start_warns_on_a_mismatch(tmp_path):
    b = load_bundle(VIE_TINY)
    fs2 = b.config.models.fastspeech2
    wider = fs2.replace(variance=fs2.variance.replace(
        variance_predictor=fs2.variance.variance_predictor.replace(filter_size=32)))
    model = FastSpeech2(wider, len(symbols), 2, 80, FeatureStats(), device="cpu")
    before = model.variance_adaptor.pitch_predictor.stack.linear.weight.clone()
    with pytest.warns(UserWarning, match="shape mismatch"):
        warm_start_params(model, VIE_TINY)
    assert torch.equal(model.variance_adaptor.pitch_predictor.stack.linear.weight, before)
    np.testing.assert_array_equal(
        model.encoder.src_word_emb.weight.detach().numpy(),
        b.acoustic_variables["params"]["encoder"]["src_word_emb"]["embedding"])

"""Shared checks of the port's four other encoder/decoder families
(conformer, fastformer, long-short transformer, reformer) against the JAX
package's, on the CPU; each family's test file (``test_torch_<family>.py``)
calls them, so that ``--dist loadfile`` spreads the families over workers.

Widths are ``tests/test_blocks.py::_cfg``'s (2 + 2 layers, hidden 64;
conformer and reformer 4 heads, reformer bucket 8 and 2 hashes, long-short
window 16 and r 1).  Weights come from the JAX ``init`` and are carried
across by ``convert.py``; inputs come from numpy seeds, with ragged masks
and lengths that are no multiple of a window, a segment or a bucket, so
the padding paths run.  The JAX side runs as the JAX package's own tests
run it on the CPU; none of the four families reaches a Pallas kernel.

Bars (float32 on both sides, sums in another order):
- encoder and decoder: max |diff| <= 1e-5;
- the full FastSpeech2 (supervised durations, so no aligner: the families
  differ in the encoder and decoder only): durations bit-equal, postnet mel
  max |diff| < 1e-3 and MAE < 1e-4; ``to_jax`` of the port gives back JAX's
  tree, names, shapes and values;
- one ``make_train_step`` against JAX's with dropout off: each metric
  within 1e-5 relative; each gradient, read from Adam's first moment after
  the step (mu = (1 - b1) g, g clipped), within 1e-4 relative norm; each
  update as ``tests/test_torch_supervised.py`` bars it (1e-3 relative, and
  within the learning rate where the gradient is float noise); the
  BatchNorm statistics (the postnet's and the conformer's) within 1e-5;
- bfloat16: max and mean |port - JAX bf16| <= 2 x |JAX bf16 - JAX f32| on
  the same inputs, as ``tests/test_torch_bf16.py`` bars serving;
- ``remat_blocks`` (port only, dropout on, one seeded generator): the same
  parameter names, outputs within 1e-6, gradients within 1e-5, and each
  layer run twice (forward and recompute).

Tensors whose gradient is 0 by construction give float noise on both
sides and are held below 1e-6 of the global norm instead: the conformer's
attention key bias and the fastformer's pooling-logit biases (a softmax
does not see a shift common to all its entries), and the postnet
convolutions' biases (each feeds a training-mode BatchNorm).
"""

from __future__ import annotations

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

import e2e_tts_tpu.models.acoustic as jax_acoustic
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.models.blocks import build_decoder as jax_build_decoder
from e2e_tts_tpu.models.blocks import build_encoder as jax_build_encoder
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.postnet import Postnet as JaxPostnet
from e2e_tts_tpu.train import AcousticBatch as JaxBatch
from e2e_tts_tpu.train import AcousticTrainState as JaxState
from e2e_tts_tpu.train import acoustic_optimizer as jax_acoustic_optimizer
from e2e_tts_tpu.train import make_train_step as jax_make_train_step
from e2e_tts_tpu_torch.config import default_config, load_config
from e2e_tts_tpu_torch.convert import convert, load_into, to_jax
from e2e_tts_tpu_torch.models.blocks import build_decoder, build_encoder
from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                     init_train_state, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SYMBOLS, N_SPEAKERS, N_MELS, N_WORDS, HIDDEN = 40, 3, 80, 16, 64
BLOCK_TOL = 1e-5
MEL_MAX_TOL, MEL_MAE_TOL = 1e-3, 1e-4
LOSS_TOL, GRAD_TOL, UPDATE_TOL, STATS_TOL = 1e-5, 1e-4, 1e-3, 1e-5
REMAT_OUT_TOL, REMAT_GRAD_TOL = 1e-6, 1e-5
ZERO_BY_CONSTRUCTION = re.compile(
    r"mhsa\.key_proj\.bias$|to_[qk]_attn_logits\.bias$|^postnet\.convs\.\d+\.bias$")


def family_fs2(cfg, block_type: str, rate=None, remat: bool = False, **family):
    """Either package's FastSpeech2 config at ``_cfg``'s widths for
    ``block_type``; ``family`` overrides that family's settings and ``rate``
    (when given) sets its dropout rates."""
    fs2 = cfg.models.fastspeech2
    bb = fs2.building_block
    small = dict(
        transformer=dict(conv_filter_size=64),
        conformer=dict(encoder_head=4, decoder_head=4),
        fastformer=dict(conv_filter_size=64),
        lstransformer=dict(conv_filter_size=64, window_size=16, r=1),
        reformer=dict(encoder_head=4, decoder_head=4, bucket_size=8, n_hashes=2),
    )
    kw = dict(small[block_type], **family)
    if rate is not None:
        kw.update(encoder_dropout=rate, decoder_dropout=rate)
    bb = bb.replace(block_type=block_type, **{block_type: getattr(bb, block_type).replace(**kw)})
    return fs2.replace(encoder_layers=2, decoder_layers=2, encoder_hidden=HIDDEN,
                       decoder_hidden=HIDDEN, building_block=bb, remat_blocks=remat,
                       postnet=fs2.postnet.replace(embedding_dim=HIDDEN, conv_layers=2))


def _ragged(B: int, T: int, seed: int):
    rng = np.random.RandomState(seed)
    lens = np.array([T, T - 9, max(T // 2, 1)][:B])
    mask = np.arange(T)[None] < lens[:, None]
    return rng, mask


def _block_outputs(block_type, family, T, dtype=None, seed=0):
    """Each side's encoder and decoder outputs (float32 numpy) on one input,
    JAX's weights in both, at ``dtype`` (None: float32, "bf16"):
    [(name, port, jax)]."""
    jkw = {} if dtype is None else {"dtype": jnp.bfloat16}
    pkw = {} if dtype is None else {"dtype": torch.bfloat16}
    jcfg = family_fs2(jax_default_config(), block_type, **family)
    cfg = family_fs2(default_config(), block_type, **family)
    jenc = jax_build_encoder(jcfg, N_SYMBOLS, **jkw)
    jdec = jax_build_decoder(jcfg, **jkw)
    g = torch.Generator().manual_seed(0)
    enc = build_encoder(cfg, N_SYMBOLS, generator=g, device="cpu", **pkw)
    dec = build_decoder(cfg, generator=g, device="cpu", **pkw)
    rng, mask = _ragged(3, T, seed)
    ids = rng.randint(1, N_SYMBOLS + 1, mask.shape) * mask
    x = (rng.randn(*mask.shape, HIDDEN)).astype(np.float32)
    ve = jax.tree_util.tree_map(np.asarray, jenc.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(ids), jnp.asarray(mask)))
    vd = jax.tree_util.tree_map(np.asarray, jdec.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x), jnp.asarray(mask)))
    assert load_into(enc, ve) == len(enc.state_dict())
    assert load_into(dec, vd) == len(dec.state_dict())
    je, _ = jenc.apply(ve, jnp.asarray(ids), jnp.asarray(mask))
    jd, _ = jdec.apply(vd, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        pe, _ = enc(torch.from_numpy(ids), torch.from_numpy(mask))
        pd, _ = dec(torch.from_numpy(x), torch.from_numpy(mask))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return [("encoder", pe.float().numpy(), f32(je)), ("decoder", pd.float().numpy(), f32(jd))]


def _jax_encoder_ulp_sensitivity(block_type, family, T, seed=0) -> float:
    """How far JAX's own encoder output in the unpadded row (row 0 of
    ``_ragged``) moves when its embedding table moves by one float32 ulp
    (up, then down; the larger)."""
    jenc = jax_build_encoder(family_fs2(jax_default_config(), block_type, **family), N_SYMBOLS)
    rng, mask = _ragged(3, T, seed)
    ids = jnp.asarray(rng.randint(1, N_SYMBOLS + 1, mask.shape) * mask)
    ve = jax.tree_util.tree_map(np.asarray, jenc.init({"params": jax.random.PRNGKey(0)}, ids,
                                                      jnp.asarray(mask)))
    base = np.asarray(jenc.apply(ve, ids, jnp.asarray(mask))[0])
    moves = []
    for to in (np.inf, -np.inf):
        emb = ve["params"]["src_word_emb"]
        moved = {**ve, "params": {**ve["params"], "src_word_emb": {
            "embedding": np.nextafter(emb["embedding"], np.float32(to))}}}
        moved_out = np.asarray(jenc.apply(moved, ids, jnp.asarray(mask))[0])
        moves.append(np.abs(moved_out[0] - base[0]).max())
    return float(max(moves))


def check_blocks_match_jax(block_type: str, family: dict, T: int,
                           ill_conditioned: bool = False) -> None:
    """Every row of the encoder and decoder within BLOCK_TOL of JAX's.
    ``ill_conditioned``: the fastformer's ``reference_compat`` penalises
    every valid position by -1e4, so in the row with no padding (row 0)
    each pooling score is rounded next to -1e4 (float32 ulp 2^-10) and a
    last-bit change of a logit moves a pooling weight by 1e-3: that one
    row of the encoder is held within max(1e-5, 2 x how far JAX's own
    output there moves for a one-ulp move of its embeddings)."""
    for name, got, want in _block_outputs(block_type, family, T):
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        err = np.abs(got - want).max(axis=(1, 2))  # per row
        bar = np.full(len(err), BLOCK_TOL)
        if ill_conditioned and name == "encoder":
            bar[0] = max(BLOCK_TOL, 2 * _jax_encoder_ulp_sensitivity(block_type, family, T))
        assert (err <= bar).all(), (name, err, bar)


def check_bf16_matches_jax(block_type: str, T: int) -> None:
    ref = _block_outputs(block_type, {}, T)
    for (name, got, want), (_, _, want32) in zip(_block_outputs(block_type, {}, T, "bf16"), ref):
        assert np.isfinite(got).all(), name
        d, base = np.abs(got - want), np.abs(want - want32)
        assert d.max() <= 2 * base.max() and d.mean() <= 2 * base.mean(), (
            name, d.max(), base.max(), d.mean(), base.mean())


# --- the full model ---------------------------------------------------------


def family_config(cfg, block_type: str, rate: float = 0.0):
    """Either package's ``Config``: ``family_fs2`` with supervised durations
    (no aligner), small predictors, dropout at ``rate``, a short warm-up."""
    fs2 = family_fs2(cfg, block_type, rate=rate)
    v = fs2.variance
    fs2 = fs2.replace(variance=v.replace(
        variance_predictor=v.variance_predictor.replace(filter_size=24, dropout=rate),
        duration_modelling=v.duration_modelling.replace(learn_alignment=False)))
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


_BUILT = {}


def models(block_type: str):
    """(JAX model, JAX config, its variables as numpy, port model with those
    weights, port config)."""
    if block_type not in _BUILT:
        jcfg = family_config(jax_default_config(), block_type)
        jm = JaxFastSpeech2(jcfg.models.fastspeech2, N_SYMBOLS, N_SPEAKERS, N_MELS,
                            JaxFeatureStats())
        variables = _jax_apply(jax.jit(lambda: init_acoustic_variables(jm, 3)))
        _BUILT[block_type] = (jm, jcfg, jax.tree_util.tree_map(np.asarray, variables))
    jm, jcfg, variables = _BUILT[block_type]
    cfg = family_config(default_config(), block_type)
    port = build_acoustic_model(cfg, N_SYMBOLS, N_SPEAKERS, dropout=False, device="cpu")
    assert load_into(port, variables) == len(port.state_dict())
    return jm, jcfg, variables, port, cfg


def check_serving_matches_jax(block_type: str) -> None:
    """The serving stages on JAX's weights; then ``to_jax`` of the port gives
    back JAX's tree, and JAX's stages on it give the port's output."""
    jm, _, variables, port, _ = models(block_type)
    rng = np.random.RandomState(5)
    lens = np.array([13, 9, 11], np.int32)
    texts = np.zeros((3, 13), np.int32)
    for b, n in enumerate(lens):
        texts[b, :n] = rng.randint(1, N_SYMBOLS, n)
    spk = np.array([2, 0, 1], np.int32)
    stage1 = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage1))
    stage2 = jax.jit(functools.partial(jm.apply, method=JaxFastSpeech2.synthesize_stage2),
                     static_argnums=(3,))
    x_t, d_t = port.synthesize_stage1(*(torch.from_numpy(a).long() for a in (spk, texts, lens)))
    tree = to_jax(port)
    for vs in (variables, tree):  # JAX's weights, then the port-written tree
        x_j, d_j = stage1(vs, jnp.asarray(spk), jnp.asarray(texts), jnp.asarray(lens))
        d_j = np.array(d_j)
        np.testing.assert_array_equal(d_t.numpy(), d_j)  # bit-equal durations
        assert d_j.sum() > 0
        T = int(d_j.sum(-1).max()) + 3  # no multiple of a window or a bucket
        mel_j, mel_lens_j = stage2(vs, x_j, jnp.asarray(d_j), T)
        mel_t, mel_lens_t = port.synthesize_stage2(torch.from_numpy(np.array(x_j)),
                                                   torch.from_numpy(d_j), T)
        np.testing.assert_array_equal(mel_lens_t.numpy(), np.asarray(mel_lens_j))
        diff = np.abs(mel_t.numpy() - np.asarray(mel_j))
        assert diff.max() < MEL_MAX_TOL and diff.mean() < MEL_MAE_TOL, (diff.max(), diff.mean())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(variables)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, variables)


def batch(B=4, L=14, T=45, seed=0):
    """numpy arrays in the JAX ``_collate`` layout of a supervised batch."""
    rng = np.random.RandomState(seed)
    tl = np.array([14, 11, 7, 13][:B], np.int32)
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
        m = int(d.sum())
        a["duration_target"][b, :n] = d
        a["mel_lens"][b] = m
        a["texts"][b, :n] = rng.randint(1, N_SYMBOLS, n)
        a["word_ids"][b, :n] = np.arange(n) // 2
        a["mel"][b, :m] = rng.randn(m, N_MELS) * 0.5 - 4.0
        a["f0"][b, :m] = rng.randn(m)
        a["uv"][b, :m] = rng.rand(m) < 0.3
        a["pitch"][b, :m] = rng.randn(m)
        a["energy"][b, :m] = rng.randn(m)
    return JaxBatch(**a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def check_train_step_matches_jax(block_type: str) -> None:
    jm, jcfg, variables, port, cfg = models(block_type)
    data = batch(seed=1)
    jopt = jax_acoustic_optimizer(jcfg.train.fastspeech2_optimizer, HIDDEN)
    jstate = JaxState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=jopt.init(variables["params"]))
    jstate, jmetrics = _jax_apply(jax.jit(jax_make_train_step(jm, jcfg, jopt, N_WORDS)), jstate,
                                  data, jax.random.PRNGKey(0))

    before = {n: p.detach().numpy().copy() for n, p in port.named_parameters()}
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, HIDDEN)
    state = init_train_state(port, opt)
    state, metrics = make_train_step(port, cfg, opt, N_WORDS)(
        state, AcousticBatch.from_numpy(data, "cpu"))
    assert sorted(metrics) == sorted(jmetrics)
    for key in jmetrics:
        want = float(jmetrics[key])
        assert abs(metrics[key].item() - want) <= LOSS_TOL * max(abs(want), 1e-12), (key, want)

    names = [n for n, _ in port.named_parameters()]
    got_mu = dict(zip(names, (m.numpy() for m in state.opt_state.mu)))
    want_mu = convert({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state[1].mu)})
    assert sorted(got_mu) == sorted(want_mu)
    scale = np.sqrt(sum((g ** 2).sum() for g in want_mu.values()))
    after = convert({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    lr = opt.schedule(0)
    for name, p in port.named_parameters():
        g, jg = got_mu[name], want_mu[name]
        if ZERO_BY_CONSTRUCTION.search(name):
            assert np.linalg.norm(jg) < 1e-6 * scale and np.linalg.norm(g) < 1e-6 * scale, name
            noise = np.ones(jg.shape, bool)
        else:
            assert _rel(g, jg) < GRAD_TOL, (name, _rel(g, jg))
            # Adam turns float noise in a near-0 gradient into a step of up to lr
            noise = np.abs(jg) < 1e-5 * np.abs(jg).max()
        upd, jupd = p.detach().numpy() - before[name], after[name] - before[name]
        assert np.abs(upd[noise]).max(initial=0) <= 1.01 * lr, name
        assert np.abs(jupd[noise]).max(initial=0) <= 1.01 * lr, name
        if not noise.all():
            assert _rel(upd[~noise], jupd[~noise]) < UPDATE_TOL, (name, _rel(upd, jupd))
    stats = convert({"batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)})
    assert any(".postnet." in f".{n}" for n in stats)
    for name, value in stats.items():
        assert np.abs(port.state_dict()[name].numpy() - value).max() < STATS_TOL, name


# --- remat ------------------------------------------------------------------


def check_remat_same_math(block_type: str) -> None:
    """``remat_blocks`` on and off, dropout on (rate 0.3), the same seeded
    generator: the same parameters, outputs and gradients; the layers run
    again in the backward pass."""
    rng, mask = _ragged(2, 33, 1)
    ids = torch.from_numpy(rng.randint(1, 20, mask.shape) * mask)
    x = torch.from_numpy(rng.randn(*mask.shape, HIDDEN).astype(np.float32))
    m = torch.from_numpy(mask)
    # a fixed random projection of the outputs: sums of a LayerNorm's output
    # (or of its squares) barely depend on its input
    pe, pd = torch.from_numpy(rng.randn(2, *mask.shape, HIDDEN).astype(np.float32))
    runs = []
    for recompute in (False, True):
        fs2 = family_fs2(default_config(), block_type, rate=0.3, remat=recompute)
        g = torch.Generator().manual_seed(0)
        enc = build_encoder(fs2, N_SYMBOLS, generator=g, device="cpu")
        dec = build_decoder(fs2, generator=g, device="cpu")
        calls = [0]
        for mod in list(enc.modules()) + list(dec.modules()):
            if type(mod).__name__.endswith("Attention"):
                mod.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        drop = torch.Generator().manual_seed(7)
        ye, _ = enc(ids, m, drop, True)
        yd, _ = dec(x, m, drop, True)
        n_forward = calls[0]
        ((ye * pe).sum() + (yd * pd).sum()).backward()
        grads = {f"enc.{n}": p.grad.clone() for n, p in enc.named_parameters()}
        grads.update({f"dec.{n}": p.grad.clone() for n, p in dec.named_parameters()})
        runs.append((ye.detach(), yd.detach(), grads, n_forward, calls[0],
                     {**enc.state_dict(), **{f"dec.{k}": v for k, v in dec.state_dict().items()}}))
    (ye0, yd0, g0, f0, c0, s0), (ye1, yd1, g1, f1, c1, s1) = runs
    assert list(s0) == list(s1)  # the same parameter and buffer names
    for name in s0:  # the BatchNorm statistics moved once, as without remat
        torch.testing.assert_close(s0[name], s1[name], rtol=0, atol=REMAT_OUT_TOL)
    # no recompute without remat, except in the reformer, which always recomputes
    assert f0 == f1 > 0 and c0 == (2 * f0 if block_type == "reformer" else f0)
    assert c1 == 2 * f1, (block_type, f1, c1)  # every layer recomputed once
    assert (ye0 - ye1).abs().max() <= REMAT_OUT_TOL and (yd0 - yd1).abs().max() <= REMAT_OUT_TOL
    for name in g0:
        assert (g0[name] - g1[name]).abs().max() <= REMAT_GRAD_TOL, name


def check_bundle_round_trip(block_type: str, tmp_path) -> None:
    """A random-weight engine of the family (``from_random(config=...)``)
    written by ``save_checkpoint`` and read back by ``from_checkpoint``
    serves the same int16 samples, with no flash launch."""
    from e2e_tts_tpu_torch.kernels.flash_attention import flash_attention
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    base = load_config(os.path.join(REPO, "assets", "bundles", "vie_tiny", "config.yaml"))
    fs2 = family_config(base, block_type).models.fastspeech2
    # vie_tiny's vocoder, narrower still: the bundle's trees are what is tested
    voc = base.models.hifigan.replace(upsample_initial_channel=32)
    cfg = base.replace(models=base.models.replace(fastspeech2=fs2, hifigan=voc))
    eng = SynthesisEngine.from_random(seed=1, config=cfg, device="cpu")
    eng.save_checkpoint(str(tmp_path / "bundle"))
    back = SynthesisEngine.from_checkpoint(str(tmp_path / "bundle"), device="cpu")
    assert back.config.models.fastspeech2.building_block.block_type == block_type
    before = flash_attention.launches
    text = "xin chào"
    got, want = back.synthesize(text), eng.synthesize(text)
    assert got.dtype == np.int16 and len(got) == len(want) > 0
    np.testing.assert_array_equal(got, want)
    assert flash_attention.launches == before

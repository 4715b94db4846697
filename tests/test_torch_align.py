"""The port's alignment pieces against the JAX package, on the CPU, from the
same numpy inputs: monotonic alignment search, the forward-sum CTC loss and
its gradient, the frame/word pools, the beta-binomial prior, the Noam
schedule and the aligner's phoneme posteriorgram.

On CPU tensors the kernels' wrappers run their plain versions, which are what
the card's kernels are held to (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Bars:
- MAS bit-equal to JAX's ``monotonic_align`` and to ``mas_numpy`` (each step
  is one float add and an exact max);
- CTC loss relative error < 1e-5 against JAX and ``F.ctc_loss``; gradient
  max |diff| < 1e-5 x max |grad| against ``jax.grad`` (the same function,
  exp/log and sums in another order); ``gradcheck`` in float64;
- pools and the posteriorgram max |diff| < 1e-5; the prior bit-equal; the
  schedule relative error < 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from e2e_tts_tpu.audio.features import beta_binomial_prior as jax_prior
from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.ops import average_by_segments as jax_average_by_segments
from e2e_tts_tpu.ops import sum_by_words as jax_sum_by_words
from e2e_tts_tpu.ops.ctc import forward_sum_loss as jax_forward_sum_loss
from e2e_tts_tpu.ops.mas import mas_numpy
from e2e_tts_tpu.ops.mas import monotonic_align as jax_monotonic_align
from e2e_tts_tpu.train.optim import noam_schedule as jax_noam_schedule
from e2e_tts_tpu_torch.audio import beta_binomial_prior
from e2e_tts_tpu_torch.config import load_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.kernels.ctc import ctc_fwd
from e2e_tts_tpu_torch.kernels.mas import mas, mas_plain
from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
from e2e_tts_tpu_torch.nn.variance import FeatureStats
from e2e_tts_tpu_torch.ops import (
    average_by_segments,
    forward_sum_loss,
    monotonic_align,
    sum_by_words,
)
from e2e_tts_tpu_torch.ops.ctc import ForwardSumCTC
from e2e_tts_tpu_torch.text.symbols import symbols
from e2e_tts_tpu_torch.train import noam_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")

CTC_LOSS_TOL = 1e-5
CTC_GRAD_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- monotonic alignment search ------------------------------------------------------

def _mas_case(name):
    """(attn (B, T, L) probabilities, text_lens, mel_lens)."""
    rng = np.random.RandomState({"ragged": 0, "tied": 1, "edge": 2}[name])
    if name == "ragged":
        B, T, L = 5, 57, 19
        tl = np.array([19, 12, 5, 17, 1], np.int32)
        ml = np.array([57, 40, 9, 33, 3], np.int32)
        attn = rng.dirichlet(np.ones(L), size=(B, T)).astype(np.float32)
    elif name == "tied":  # flat rows and repeated values: every choice is a tie
        B, T, L = 3, 30, 8
        tl = np.array([8, 6, 3], np.int32)
        ml = np.array([30, 17, 11], np.int32)
        attn = np.full((B, T, L), 1.0 / L, np.float32)
        attn[1] = np.round(rng.rand(T, L) * 2) / 4
    else:  # text_len 0 and 1, mel_len 0, mel_len < text_len, a zero probability
        B, T, L = 6, 20, 10
        tl = np.array([0, 1, 10, 7, 10, 3], np.int32)
        ml = np.array([12, 20, 0, 4, 20, 20], np.int32)
        attn = rng.dirichlet(np.ones(L), size=(B, T)).astype(np.float32)
        attn[4, 5, :] = 0.0
    return attn, tl, ml


@pytest.mark.parametrize("name", ["ragged", "tied", "edge"])
def test_mas_matches_jax_bit_for_bit(name):
    attn, tl, ml = _mas_case(name)
    want = np.asarray(jax_monotonic_align(jnp.asarray(attn), jnp.asarray(tl), jnp.asarray(ml)))
    got = monotonic_align(_t(attn), _t(tl), _t(ml))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain version on log-attention is what the kernel is held to
    log_attn = torch.log(torch.clamp(_t(attn), min=1e-30))
    np.testing.assert_array_equal(mas_plain(log_attn, _t(tl), _t(ml)).numpy(), want)
    for b in range(len(tl)):
        if name == "edge" and (tl[b] == 0 or ml[b] == 0):
            assert not want[b].any()  # rows with no text or no frames are all zero
        elif ml[b] >= tl[b] > 0:  # the numpy oracle assumes a feasible path
            np.testing.assert_array_equal(
                got[b].numpy(), mas_numpy(np.log(np.maximum(attn[b], 1e-30)), tl[b], ml[b]))
            # a monotonic path: every frame one phoneme, durations sum to mel_len
            assert (got[b, :ml[b]].sum(-1) == 1).all()
            assert int(got[b].sum()) == ml[b]


def test_mas_wrapper_checks_its_inputs():
    x = torch.zeros(2, 5, 3)
    lens = torch.tensor([3, 2])
    with pytest.raises(TypeError):
        mas(x.double(), lens, lens)
    with pytest.raises(ValueError):
        mas(x, lens[:1], lens)
    with pytest.raises(ValueError):  # neither the CPU nor CUDA
        mas(x.to("meta"), lens.to("meta"), lens.to("meta"))
    assert mas.launches == 0  # the CPU runs the plain version: no launch counted


# --- forward-sum CTC --------------------------------------------------------------------

def _ctc_case(seed, B=5, T=37, K=11):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, K) * 2.0).astype(np.float32)
    tl = rng.randint(1, K + 1, B).astype(np.int32)
    ml = np.maximum(tl + rng.randint(0, T - K, B), 1).astype(np.int32)
    tl[0], ml[0] = K, T  # a full row
    return logits, tl, ml


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_grad_match_jax(seed):
    logits, tl, ml = _ctc_case(seed)
    if seed == 2:
        ml[1] = tl[1] - 1  # infeasible (fewer frames than phonemes): loss 0, no gradient
        ml[2] = 0           # no frames: frame 0 is read all the same, as JAX reads it
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jax_forward_sum_loss(x, jnp.asarray(tl), jnp.asarray(ml)))(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    loss = forward_sum_loss(x, _t(tl), _t(ml))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < CTC_LOSS_TOL * abs(float(loss_j))
    grad_j = np.asarray(grad_j)
    assert np.abs(x.grad.numpy() - grad_j).max() < CTC_GRAD_TOL * np.abs(grad_j).max()
    if seed == 2:
        assert not x.grad[1].any()


def test_ctc_loss_matches_torch_ctc_loss():
    """``F.ctc_loss(zero_infinity=True, reduction="mean")`` on targets 1..k is a
    second oracle (the port never calls it)."""
    logits, tl, ml = _ctc_case(3)
    ml[2] = tl[2] - 1  # infeasible: zeroed by both
    x = _t(logits)
    B, T, K = x.shape
    classes = torch.cat([torch.full((B, T, 1), -1.0), x], -1)
    valid = torch.arange(K + 1)[None, None, :] <= _t(tl).long()[:, None, None]
    lp = torch.log_softmax(torch.where(valid, classes, torch.tensor(-1e30)), -1)
    targets = torch.cat([torch.arange(1, n + 1) for n in tl])
    want = torch.nn.functional.ctc_loss(lp.transpose(0, 1), targets, _t(ml).long(), _t(tl).long(),
                                        blank=0, reduction="mean", zero_infinity=True)
    got = forward_sum_loss(x, _t(tl), _t(ml))
    assert abs(got.item() - want.item()) < CTC_LOSS_TOL * abs(want.item())


def test_ctc_function_gradcheck_float64():
    """The plain alpha/beta Function's gradient against finite differences."""
    rng = np.random.RandomState(4)
    B, T, C = 3, 9, 5
    lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C)), -1).requires_grad_()
    kl = torch.tensor([4, 2, 1])
    ql = torch.tensor([9, 6, 3])
    assert torch.autograd.gradcheck(lambda x: ForwardSumCTC.apply(x, kl, ql), (lp,),
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


def test_ctc_rows_without_text_give_zero():
    """k = 0: the loss is 0 and, unlike JAX's autodiff (which divides a zero
    cotangent by k = 0 and gives NaN), so is the gradient."""
    logits, tl, ml = _ctc_case(5)
    tl[3] = 0
    x = _t(logits).requires_grad_()
    loss = forward_sum_loss(x, _t(tl), _t(ml))
    loss.backward()
    assert torch.isfinite(x.grad).all() and not x.grad[3].any()
    per_item, _, _ = ctc_fwd(torch.log_softmax(torch.cat([torch.full((5, 37, 1), -1.0), x.detach()],
                                                         -1), -1), _t(tl), _t(ml))
    assert per_item[3] == 0
    want = float(jax_forward_sum_loss(jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(ml)))
    assert abs(loss.item() - want) < CTC_LOSS_TOL * abs(want)


# --- pools, prior, schedule ---------------------------------------------------------------

def test_average_by_segments_and_sum_by_words_match_jax():
    rng = np.random.RandomState(6)
    B, T, L, W = 3, 40, 12, 9
    dur = rng.randint(0, 6, (B, L)).astype(np.int32)
    mel2ph = np.stack([np.minimum(np.searchsorted(np.cumsum(d), np.arange(T), side="right"), L - 1)
                       for d in dur]).astype(np.int32)
    ml = np.array([40, 25, 3], np.int32)
    feat = rng.randn(B, T).astype(np.float32)
    want = np.asarray(jax_average_by_segments(jnp.asarray(feat), jnp.asarray(mel2ph),
                                              jnp.asarray(ml), L))
    got = average_by_segments(_t(feat), _t(mel2ph), _t(ml), L).numpy()
    assert np.abs(got - want).max() < 1e-5
    vals = rng.rand(B, L).astype(np.float32)
    words = np.sort(rng.randint(0, W, (B, L)), axis=1).astype(np.int32)
    want = np.asarray(jax_sum_by_words(jnp.asarray(vals), jnp.asarray(words), W))
    got = sum_by_words(_t(vals), _t(words), W).numpy()
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("P,M", [(1, 4), (9, 30), (128, 768)])
def test_beta_binomial_prior_matches_jax(P, M):
    want = jax_prior(P, M)
    got = beta_binomial_prior(P, M)
    assert got.shape == (M, P)
    np.testing.assert_array_equal(got, want)


def test_noam_schedule_matches_jax():
    for args in ((384, 4000, (300000, 400000, 500000), 0.3), (32, 100, (10,), 0.5)):
        want, got = jax_noam_schedule(*args), noam_schedule(*args)
        for s in (0, 1, 2, 7, 99, 100, 101, 4000, 4001, 350000, 450000, 600000):
            w = float(want(s))
            assert abs(got(s) - w) < 1e-6 * w, (args, s)


# --- the aligner's posteriorgram ----------------------------------------------------------

def test_content_features_match_jax_on_vie_tiny():
    cfg = jax_load_config(os.path.join(VIE_TINY, "config.yaml"))
    with open(os.path.join(VIE_TINY, "acoustic.msgpack"), "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    with open(os.path.join(VIE_TINY, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(VIE_TINY, "speakers.json")) as f:
        n_spk = max(len(json.load(f)), 1)
    n_mels = cfg.audio.mel.channels
    jax_model = JaxFastSpeech2(cfg.models.fastspeech2, len(symbols), n_spk, n_mels,
                               JaxFeatureStats.from_dict(stats))
    port = FastSpeech2(load_config(os.path.join(VIE_TINY, "config.yaml")).models.fastspeech2,
                       len(symbols), n_spk, n_mels, FeatureStats.from_dict(stats), device="cpu")
    load_into(port, jax.tree_util.tree_map(np.asarray, variables))
    mel = (np.random.RandomState(7).randn(2, 64, n_mels) * 0.8 - 4.0).astype(np.float32)
    spk = np.array([0, n_spk - 1], np.int32)
    want = np.asarray(jax.jit(lambda v, m, s: jax_model.apply(
        v, m, s, method=JaxFastSpeech2.content_features))(variables, mel, spk))
    with torch.no_grad():
        got = port.content_features(_t(mel), _t(spk).long()).numpy()
    assert got.shape == want.shape == (2, 64, len(symbols))
    assert np.abs(got - want).max() < 1e-5

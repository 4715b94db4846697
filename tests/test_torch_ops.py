"""The PyTorch port's ops (masking, pitch, length regulator) and positional
tables against ``e2e_tts_tpu``'s, on the same numpy inputs.  Integer outputs
must be equal; float outputs within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu import ops as jops
from e2e_tts_tpu.nn import common as jcommon
from e2e_tts_tpu_torch import ops as tops
from e2e_tts_tpu_torch.nn import common as tcommon

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-6


def _durations(seed, B=3, L=17, hi=9):
    rng = np.random.RandomState(seed)
    d = rng.randint(0, hi, (B, L)).astype(np.int32)
    d[1, 11:] = 0  # a padded row
    return d


def test_sequence_mask():
    lens = np.array([0, 1, 5, 9], np.int32)
    ours = tops.sequence_mask(torch.from_numpy(lens), 9).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jops.sequence_mask(jnp.asarray(lens), 9)))


def test_f0_to_coarse():
    rng = np.random.RandomState(0)
    f0 = np.concatenate([rng.uniform(-20, 1300, 4000), [0.0, 50.0, 1100.0, -1.0]]).astype(np.float32)
    ours = tops.f0_to_coarse(torch.from_numpy(f0)).numpy()
    theirs = np.asarray(jops.f0_to_coarse(jnp.asarray(f0)))
    assert ours.dtype == np.int32 and ours.min() >= 1 and ours.max() <= 255
    np.testing.assert_array_equal(ours, theirs)


def test_bucketize_is_side_left():
    bins = np.linspace(0.0, 10.0, 11).astype(np.float32)
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-2, 12, 500), bins]).astype(np.float32)  # values ON boundaries
    ours = tops.bucketize(torch.from_numpy(x), torch.from_numpy(bins)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jops.bucketize(jnp.asarray(x), jnp.asarray(bins))))


@pytest.mark.parametrize("T", [64, 128, 40])  # 40 truncates the longest row
def test_durations_to_mel2ph(T):
    d = _durations(2)
    ours = tops.durations_to_mel2ph(torch.from_numpy(d), T).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jops.durations_to_mel2ph(jnp.asarray(d), T)))


@pytest.mark.parametrize("T", [128, 40])
def test_regulate_length(T):
    d = _durations(3)
    x = np.random.RandomState(4).randn(3, 17, 6).astype(np.float32)
    xo, lo, mo = tops.regulate_length(torch.from_numpy(x), torch.from_numpy(d), T)
    xj, lj, mj = jops.regulate_length(jnp.asarray(x), jnp.asarray(d), T)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(mj))
    assert np.abs(xo.numpy() - np.asarray(xj)).max() <= TOL
    assert not xo.numpy()[np.arange(T)[None, :] >= lo.numpy()[:, None]].any()


@pytest.mark.parametrize("n,d", [(300, 384), (65, 48), (10, 7)])
def test_positional_tables(n, d):
    np.testing.assert_array_equal(tcommon.sinusoid_table(n, d), jcommon.sinusoid_table(n, d))
    np.testing.assert_array_equal(tcommon.t2t_sinusoid(n, d), jcommon.t2t_sinusoid(n, d))


def test_conv1d_same_padding_is_asymmetric():
    """k=4 SAME pads (1, 2), as flax's Conv1d does for an even kernel."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, 3).astype(np.float32)
    w = rng.randn(4, 3, 5).astype(np.float32)  # (k, in, out)
    b = rng.randn(5).astype(np.float32)
    theirs = jcommon.Conv1d(5, 4).apply({"params": {"Conv_0": {"kernel": w, "bias": b}}}, x)
    conv = tcommon.Conv1d(3, 5, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(2, 1, 0)))
        conv.bias.copy_(torch.from_numpy(b))
    assert conv.pad == (1, 2)
    assert np.abs(conv(torch.from_numpy(x)).detach().numpy() - np.asarray(theirs)).max() < 1e-5

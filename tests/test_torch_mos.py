"""The port's scoring utilities (``e2e_tts_tpu_torch/models/mos.py``,
``e2e_tts_tpu_torch/utils/metrics.py``) against the JAX package's, on the
CPU.

- ``MosPredictor`` on the shipped weights (``assets/mos/mos.msgpack``):
  within 1e-5 of JAX's on seeded windows;
- ``mel_windows``: mean |diff| < 1e-5 and max |diff| < 1e-3 (padding and
  several windows; the max lies at bins near the log floor, log(1e-5),
  where the two FFTs' absolute rounding is a large part of the value);
- ``score_audio`` and ``LearnedMosScorer`` on every anchor in
  ``assets/mos/anchors/``: within 1e-5;
- ``degrade`` bit-equal for every kind (and the random pick) at the same
  ``RandomState``; ``DspProxyScorer`` equal;
- ``evaluate_directory`` and the ``main`` command line; ``make_scorer``
  gives the learned scorer here (``speechmetrics`` is absent).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.models import mos as jmos
from e2e_tts_tpu.utils import metrics as jmetrics
from e2e_tts_tpu_torch.audio.wav import read_wav, write_wav
from e2e_tts_tpu_torch.data.synthetic import synth_text
from e2e_tts_tpu_torch.models import mos
from e2e_tts_tpu_torch.utils import metrics

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHORS = sorted(glob.glob(os.path.join(REPO, "assets", "mos", "anchors", "*.wav")))
TOL = 1e-5
MEL_MAX_TOL = 1e-3


@pytest.fixture(scope="module")
def scorers():
    return jmetrics.LearnedMosScorer(), metrics.LearnedMosScorer(device="cpu")


def test_predictor_matches_jax(scorers):
    import torch

    jax_scorer, port = scorers
    wins = (np.random.RandomState(0).randn(3, mos.MOS_WINDOW, 80) - 6.0).astype(np.float32)
    want = np.asarray(jmos.MosPredictor().apply(jax_scorer._params, jnp.asarray(wins)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(wins)).numpy()
    assert got.shape == want.shape == (3,)
    assert np.abs(got - want).max() < TOL, np.abs(got - want).max()


@pytest.mark.parametrize("n", [1000, mos.MOS_WINDOW * 256 * 2 + 5])
def test_mel_windows_match_jax(n):
    audio = synth_text("xin chào bạn tôi yêu nước non xa xôi", f0=180.0, seed=n)
    audio = np.resize(audio, n).astype(np.float32)
    want = jmos.mel_windows(audio, 22050)
    got = mos.mel_windows(audio, 22050, device="cpu").numpy()
    assert got.shape == want.shape == (max(1, n // (mos.MOS_WINDOW * 256)), mos.MOS_WINDOW, 80)
    diff = np.abs(got - want)
    assert diff.mean() < TOL and diff.max() < MEL_MAX_TOL, (diff.mean(), diff.max())


@pytest.mark.parametrize("path", ANCHORS, ids=os.path.basename)
def test_anchor_scores_match_jax(scorers, path):
    jax_scorer, port = scorers
    audio, sr = read_wav(path)
    want = jax_scorer(audio, sr)
    assert abs(port(audio, sr) - want) < TOL
    assert abs(mos.score_audio(port.model, audio, sr) - want) < TOL
    assert 1.0 <= want <= 5.0


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, None])
def test_degrade_bit_equal(kind):
    clean = synth_text("xin chào bạn tôi", f0=180.0, seed=0)
    for severity in (0.2, 0.9):
        want = jmos.degrade(clean, severity, np.random.RandomState(7), kind=kind)
        got = mos.degrade(clean, severity, np.random.RandomState(7), kind=kind)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert mos.severity_to_score(0.25) == jmos.severity_to_score(0.25) == 4.0


def test_dsp_proxy_scorer_equal():
    cases = [read_wav(p) for p in ANCHORS[:3]] + [
        (np.zeros(0, np.float32), 22050), (np.zeros(4000, np.float32), 22050),
        (np.clip(np.random.RandomState(1).randn(22050), -1, 1).astype(np.float32), 16000)]
    for audio, sr in cases:
        assert metrics.DspProxyScorer()(audio, sr) == jmetrics.DspProxyScorer()(audio, sr)


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for spk, paths in (("spk_a", ANCHORS[:2]), ("spk_b", ANCHORS[6:9])):
        os.makedirs(root / spk)
        for p in paths:
            audio, sr = read_wav(p)
            write_wav(str(root / spk / os.path.basename(p)), audio, sr)
    return str(root)


def test_evaluate_directory(scorers, wav_tree):
    jax_scorer, port = scorers
    for j, p in ((jmetrics.DspProxyScorer(), metrics.DspProxyScorer()), (jax_scorer, port)):
        want = jmetrics.evaluate_directory(wav_tree, j)
        got = metrics.evaluate_directory(wav_tree, p)
        assert set(got) == set(want) == {"spk_a", "spk_b"}
        for spk in want:
            assert abs(got[spk] - want[spk]) < TOL


def test_make_scorer_and_main(scorers, wav_tree, tmp_path, capsys):
    assert isinstance(metrics.make_scorer(device="cpu"), metrics.LearnedMosScorer)
    out = str(tmp_path / "scores.json")
    metrics.main(["--wav-dir", wav_tree, "--output", out, "--device", "cpu"])
    with open(out) as f:
        scores = json.load(f)
    want = jmetrics.evaluate_directory(wav_tree, scorers[0])
    assert set(scores) == set(want)
    assert all(abs(scores[s] - want[s]) < TOL for s in want)
    assert json.loads(capsys.readouterr().out) == scores

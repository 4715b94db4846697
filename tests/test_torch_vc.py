"""The port's voice conversion (``e2e_tts_tpu_torch/serve/voice_conversion.py``)
against the JAX package's, on the CPU, on the same numpy inputs.

- ``SpectralVoiceConverter``: the output wav bit-equal, the rate-mismatch
  resample included.
- ``convert_mel`` in cmvn mode without an engine on seeded random mels:
  the matched target frames equal to JAX's ``lax.top_k`` on JAX's own
  features, the mel within 1e-5.
- ppg and prosody modes through one stub engine that both sides share (the
  config of ``vie_tiny``, a fixed posteriorgram, a deterministic vocoder):
  the prosody tracks equal, the mel within 1e-5, ``convert`` end to end
  within 1 LSB.
- The argument checks, on both sides.
- On the port alone, on its CPU ``vie_tiny`` engine: identity recovers the
  source, the output frames come from the target, ``convert`` writes a wav
  through the engine's vocoder, the fallback without an engine.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.config import load_config as jax_load_config
from e2e_tts_tpu.serve import voice_conversion as jvc
from e2e_tts_tpu_torch.audio.wav import read_wav, write_wav
from e2e_tts_tpu_torch.config import load_config
from e2e_tts_tpu_torch.data.synthetic import synth_text
from e2e_tts_tpu_torch.serve import SynthesisEngine
from e2e_tts_tpu_torch.serve import voice_conversion as pvc

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
SR = 22050
MEL_TOL = 1e-5


def _random_mels(Ts, Tt, seed=0, n_mels=80):
    rng = np.random.RandomState(seed)
    return ((rng.randn(Ts, n_mels) - 5.0).astype(np.float32),
            (rng.randn(Tt, n_mels) - 5.0).astype(np.float32))


def _jax_indices(conv, src_feat, tgt_feat, k):
    """JAX's ``_knn_match`` top-k on JAX's features (the bucket padding and
    the mask as ``convert_mel`` makes them)."""
    Tt = len(tgt_feat)
    Ttb = jvc._bucket_up(Tt)
    tf = np.zeros((Ttb, tgt_feat.shape[1]), np.float32)
    tf[:Tt] = tgt_feat

    def norm(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-6)

    sim = norm(jnp.asarray(src_feat, jnp.float32)) @ norm(jnp.asarray(tf)).T
    sim = jnp.where(jnp.arange(Ttb)[None, :] < Tt, sim, -1e9)
    return np.asarray(jax.lax.top_k(sim, min(k, Tt))[1])


def _write_pair(tmp_path, sr_t=SR):
    src = synth_text("xin chào bạn tôi", f0=150.0, seed=0)
    tgt = synth_text("em yêu hoa lá trên núi", f0=220.0, seed=1)
    if sr_t != SR:
        tgt = tgt[: len(tgt) * sr_t // SR]
    paths = str(tmp_path / "src.wav"), str(tmp_path / "tgt.wav")
    write_wav(paths[0], src, SR)
    write_wav(paths[1], tgt, sr_t)
    return paths


@pytest.mark.parametrize("sr_t", [SR, 16000])
def test_spectral_converter_bit_equal(tmp_path, sr_t):
    src, tgt = _write_pair(tmp_path, sr_t)
    want = jvc.SpectralVoiceConverter().convert(src, tgt, str(tmp_path / "jax.wav"))
    got = pvc.SpectralVoiceConverter().convert(src, tgt, str(tmp_path / "port.wav"))
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("k,context,Ts,Tt", [(4, 2, 150, 200), (1, 0, 90, 300), (8, 3, 260, 5)])
def test_convert_mel_cmvn_matches_jax(k, context, Ts, Tt):
    src, tgt = _random_mels(Ts, Tt, seed=k)
    j = jvc.KnnVoiceConverter(k=k, context=context)
    p = pvc.KnnVoiceConverter(k=k, context=context, device="cpu")
    assert j.feature_mode == p.feature_mode == "cmvn"
    want = np.asarray(j.convert_mel(src, tgt))
    got, idx = p.convert_mel(src, tgt, return_indices=True)
    np.testing.assert_array_equal(idx, _jax_indices(j, j._features(src), j._features(tgt), k))
    assert got.shape == want.shape == src.shape
    assert np.abs(got - want).max() < MEL_TOL


class _StubEngine:
    """What the converter reads of an engine, with the same numbers on both
    sides: a fixed posteriorgram (softmax of a fixed projection of the mel)
    and a deterministic vocoder, in NumPy."""

    def __init__(self, config, device=None):
        self.config = config
        self.sample_rate = config.audio.signal.sampling_rate
        self.hop_length = config.audio.stft.hop_length
        self.device = device
        self.proj = np.random.RandomState(3).randn(80, 40).astype(np.float32) * 0.3
        self.vocoded = 0

    def mel_content_features(self, mel):
        z = mel @ self.proj
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    def vocode_mel(self, mel):
        self.vocoded += 1
        t = np.arange(len(mel) * self.hop_length, dtype=np.float32)
        env = np.repeat(np.exp(mel.mean(axis=1) / 4.0), self.hop_length)
        return (0.5 * env * np.sin(0.05 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def stubs():
    import torch

    cfg = os.path.join(VIE_TINY, "config.yaml")
    return (_StubEngine(jax_load_config(cfg)),
            _StubEngine(load_config(cfg), torch.device("cpu")))


@pytest.mark.parametrize("weight", [0.0, 1.0])
def test_convert_mel_ppg_and_prosody_match_jax(stubs, weight):
    jeng, peng = stubs
    j = jvc.KnnVoiceConverter(engine=jeng, prosody_weight=weight)
    p = pvc.KnnVoiceConverter(engine=peng, prosody_weight=weight)
    assert j.feature_mode == p.feature_mode == "ppg"
    src_audio = synth_text("xin chào bạn tôi yêu nước non", f0=150.0, seed=0)
    tgt_audio = synth_text("em yêu hoa lá trên núi cao", f0=220.0, seed=1)
    src, tgt = _random_mels(len(src_audio) // 256, len(tgt_audio) // 256, seed=5)
    sp = tp = None
    if weight:
        sp = p.prosody_track(src_audio, len(src), SR, 256)
        tp = p.prosody_track(tgt_audio, len(tgt), SR, 256)
        np.testing.assert_array_equal(sp, j.prosody_track(src_audio, len(src), SR, 256))
        np.testing.assert_array_equal(tp, j.prosody_track(tgt_audio, len(tgt), SR, 256))
        assert sp[:, 1].any() and tp[:, 1].any()
    want = np.asarray(j.convert_mel(src, tgt, sp, tp))
    got, idx = p.convert_mel(src, tgt, sp, tp, return_indices=True)
    pn = j._prosody_rms_norm(sp, tp) if weight else None
    want_idx = _jax_indices(j, j._features(src, sp, pn), j._features(tgt, tp, pn), j.k)
    np.testing.assert_array_equal(idx, want_idx)
    assert np.abs(got - want).max() < MEL_TOL


@pytest.mark.parametrize("weight", [0.0, 1.0])
def test_convert_through_stub_within_one_lsb(tmp_path, stubs, weight):
    jeng, peng = stubs
    src, tgt = _write_pair(tmp_path)
    n = peng.vocoded
    want = jvc.KnnVoiceConverter(engine=jeng, prosody_weight=weight).convert(
        src, tgt, str(tmp_path / "jax.wav"))
    got = pvc.KnnVoiceConverter(engine=peng, prosody_weight=weight).convert(
        src, tgt, str(tmp_path / "port.wav"))
    assert peng.vocoded == n + 1  # the kNN path ran, not the fallback
    (a, sa), (b, sb) = read_wav(want), read_wav(got)
    assert sa == sb == SR and a.shape == b.shape and len(a) > 1000
    assert np.abs(a - b).mean() * 32768 < 1.0


def test_argument_checks_match_jax(stubs):
    jeng, peng = stubs
    src, tgt = _random_mels(40, 50)
    track = np.zeros((40, 2), np.float32), np.zeros((50, 2), np.float32)
    for mod, eng in ((jvc, jeng), (pvc, peng)):
        with pytest.raises(ValueError, match="given together"):
            mod.KnnVoiceConverter(engine=eng, prosody_weight=1.0).convert_mel(
                src, tgt, track[0], None)
        with pytest.raises(ValueError, match="prosody_weight is 0"):
            mod.KnnVoiceConverter(engine=eng).convert_mel(src, tgt, *track)
        with pytest.warns(UserWarning, match="no prosody"):
            mod.KnnVoiceConverter(engine=eng, prosody_weight=1.0).convert_mel(src, tgt)
    with pytest.raises(ValueError, match="needs an engine"):
        jvc.KnnVoiceConverter(feature_mode="ppg")
    with pytest.raises(ValueError, match="needs an engine"):
        pvc.KnnVoiceConverter(feature_mode="ppg", device="cpu")
    with pytest.raises(ValueError, match="not the engine's"):
        pvc.KnnVoiceConverter(engine=peng, device="meta")


@pytest.fixture(scope="module")
def vie_tiny():
    return SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", batch_size=2)


def _mel_of(engine, audio):
    return pvc.KnnVoiceConverter(engine=engine)._mel(audio, SR)


def test_identity_recovers_source(vie_tiny):
    """source == target: every frame's nearest neighbour is itself."""
    mel = _mel_of(vie_tiny, synth_text("xin chào bạn", f0=180.0, seed=0))
    out = pvc.KnnVoiceConverter(k=1, device="cpu").convert_mel(mel, mel)
    assert out.shape == mel.shape
    assert np.abs(out - mel).mean() < 1e-3


def test_output_frames_come_from_target(vie_tiny):
    src = _mel_of(vie_tiny, synth_text("xin chào bạn", f0=150.0, seed=0))
    tgt = _mel_of(vie_tiny, synth_text("em yêu hoa lá", f0=220.0, seed=1))
    vc = pvc.KnnVoiceConverter(engine=vie_tiny, k=4)
    assert vc.feature_mode == "ppg"
    out = vc.convert_mel(src, tgt)
    assert out.shape == src.shape
    # a convex combination of target frames lies in the target's range
    lo, hi = tgt.min(axis=0) - 1e-4, tgt.max(axis=0) + 1e-4
    assert (out >= lo[None, :]).all() and (out <= hi[None, :]).all()


def test_convert_with_engine_writes_wav(tmp_path, vie_tiny, monkeypatch):
    src, tgt = _write_pair(tmp_path)
    calls = []
    vocode = vie_tiny.vocode_mel
    monkeypatch.setattr(vie_tiny, "vocode_mel", lambda mel: calls.append(len(mel)) or vocode(mel))
    out = pvc.KnnVoiceConverter(engine=vie_tiny).convert(src, tgt, str(tmp_path / "out.wav"))
    audio, sr = read_wav(out)
    assert sr == SR and calls and len(audio) == calls[0] * vie_tiny.hop_length
    assert np.isfinite(audio).all()


def test_fallback_without_engine(tmp_path):
    src, tgt = _write_pair(tmp_path)
    vc = pvc.KnnVoiceConverter(device="cpu")
    assert isinstance(vc.fallback, pvc.SpectralVoiceConverter)
    out = vc.convert(src, tgt, str(tmp_path / "out.wav"))
    want = pvc.SpectralVoiceConverter().convert(src, tgt, str(tmp_path / "spectral.wav"))
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()

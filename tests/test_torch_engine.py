"""The PyTorch port's bundle reader and serving engine against the JAX
package's, on the CPU.

- ``load_bundle``: every array of the three tiny bundles equal to what the
  JAX reader restores, none left over, and everything else of the bundle
  equal too.
- ``SynthesisEngine.synthesize`` on ``vie_tiny``: the same int16 waveform
  length as the JAX engine, mean |diff| < 1 LSB.  The max |diff| measured
  on the golden texts and the long text is 1 LSB (float32 on both sides,
  sums in another order, so a sample on a rounding edge may move by one).
  The bucket decisions must be the JAX engine's, since they change the
  output: a long text that chunks, a forced stage-2 overflow re-render and
  an overflow re-split all take the same path on both sides.
- ``device=None`` without CUDA raises; the port imports no JAX.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from e2e_tts_tpu.serve.bundle import load_bundle as jax_load_bundle
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu_torch.serve.bundle import load_bundle
from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = os.path.join(REPO, "assets", "bundles")
VIE_TINY = os.path.join(BUNDLES, "vie_tiny")

GOLDEN = ("xin chào việt nam", "em yêu hoa lá trên núi")
LONG = (  # 343 characters: two chunks at the 300-character budget
    "Hôm nay trời đẹp, chúng tôi đi dạo quanh hồ Hoàn Kiếm và ngắm nhìn những hàng cây xanh "
    "mát; sau đó cả nhóm ghé vào một quán cà phê nhỏ bên đường để nghỉ ngơi, trò chuyện về "
    "công việc, về gia đình và những dự định cho mùa hè sắp tới, rồi chúng tôi cùng nhau đi "
    "bộ về nhà khi trời đã tối hẳn, lòng nhẹ nhàng và vui vẻ sau một ngày dài."
)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ["vie_tiny", "eng_tiny", "mya_tiny"])
def test_load_bundle_matches_jax(name):
    (cfg, aparams, vparams, speakers, stats, vocoder_kind, foreign_dict,
     language) = jax_load_bundle(os.path.join(BUNDLES, name))
    b = load_bundle(os.path.join(BUNDLES, name))
    for theirs, ours in ((aparams, b.acoustic_variables), (vparams, b.vocoder_variables)):
        want = _leaves(jax.tree_util.tree_map(np.asarray, theirs))
        got = _leaves(ours)
        assert sorted(got) == sorted(want)  # none missing, none left over
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert b.speakers == speakers and b.stats.to_dict() == stats.to_dict()
    assert (b.vocoder_kind, b.foreign_dict, b.language) == (vocoder_kind, foreign_dict, language)
    assert json.dumps(b.config.to_dict(), sort_keys=True) == json.dumps(cfg.to_dict(), sort_keys=True)
    if name == "vie_tiny":  # the counts recorded in ROADMAP.md (A1)
        a, v = _leaves(b.acoustic_variables), _leaves(b.vocoder_variables)
        assert (len(a), sum(x.size for x in a.values())) == (132, 560_262)
        assert (len(v), sum(x.size for x in v.values())) == (114, 458_154)


_ENGINES = {}


def _engines():
    if not _ENGINES:
        _ENGINES["jax"] = JaxEngine.from_checkpoint(VIE_TINY)
        _ENGINES["port"] = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    return _ENGINES["jax"], _ENGINES["port"]


def _same_audio(a, b):
    assert a.dtype == b.dtype == np.int16
    assert len(a) == len(b) > 0
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.mean() < 1.0 and d.max() <= 1, (d.mean(), d.max())


@pytest.mark.parametrize("text", GOLDEN)
def test_engine_matches_jax_on_golden_texts(text):
    jeng, peng = _engines()
    for spk in sorted(peng.speakers):
        _same_audio(peng.synthesize(text, speaker_id=spk), jeng.synthesize(text, speaker_id=spk))
    assert peng._fpp == jeng._fpp


def test_engine_matches_jax_on_long_text_overflow_and_resplit():
    jeng, peng = _engines()
    seqs, _ = peng.prepare_request(LONG)
    jseqs, _ = jeng.prepare_request(LONG)
    assert len(LONG) > 300 and len(seqs) >= 2
    assert [s.tolist() for s in seqs] == [list(s) for s in jseqs]
    _same_audio(peng.synthesize(LONG), jeng.synthesize(LONG))

    # a frames-per-phoneme estimate far too low: every row overflows its
    # stage-2 bucket and is re-rendered at the right one
    for eng in (jeng, peng):
        eng._fpp = eng._fpp_ema = 1.0
        eng._fpp_nobs = 1
    _same_audio(peng.synthesize(LONG), jeng.synthesize(LONG))
    assert peng._fpp == jeng._fpp

    # slow speech: rows predicted past MAX_MEL_LEN re-split at phoneme seams
    n_events = len(peng.events)
    _same_audio(peng.synthesize(LONG, duration_control=3.0),
                jeng.synthesize(LONG, duration_control=3.0))
    new = list(peng.events)[n_events:]
    assert new and all(e["event"] == "overflow_resplit" for e in new)
    assert new == list(jeng.events)[-len(new):]


def test_split_long_sequence_matches_jax():
    from e2e_tts_tpu.serve.engine import _split_long_sequence as jax_split
    from e2e_tts_tpu_torch.serve.engine import _split_long_sequence
    from e2e_tts_tpu_torch.text import SILENT_ID

    rng = np.random.RandomState(0)
    for n in (320, 321, 700, 1000):
        seq = rng.randint(3, 60, n).astype(np.int32)
        seq[rng.rand(n) < 0.03] = SILENT_ID
        got, want = _split_long_sequence(seq), jax_split(seq)
        assert [p.tolist() for p in got] == [p.tolist() for p in want]
        assert np.concatenate(got).tolist() == seq.tolist()


def test_int16_waveform_matches_jax_encoding():
    """Stage 2 hands the host int16 samples, encoded as the JAX engine's
    int16 transfer codec encodes them (clip to [-1, 1], scale, truncate)."""
    jeng, peng = _engines()
    x = np.linspace(-1.2, 1.2, 1001, dtype=np.float32)
    seqs, _ = peng.prepare_request(GOLDEN[0])
    x1, d1 = peng.acoustic.synthesize_stage1(
        torch.zeros(1, dtype=torch.int64), torch.from_numpy(seqs[0][None].astype(np.int64)),
        torch.tensor([len(seqs[0])]))
    vocoder = peng.vocoder
    try:  # a vocoder whose waveform is x, past both clip edges
        peng.vocoder = lambda mel: torch.from_numpy(x)[None].expand(mel.shape[0], -1)
        codes, _ = peng._stage2(x1, d1, 128, 1.0, 1.0)
    finally:
        peng.vocoder = vocoder
    assert codes.dtype == torch.int16
    np.testing.assert_array_equal(codes.numpy()[0], np.asarray(jeng._encode_transfer(x)))


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        SynthesisEngine.from_checkpoint(VIE_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        SynthesisEngine.from_random(seed=0)


def test_port_imports_no_jax():
    modules = ["e2e_tts_tpu_torch.serve.engine", "e2e_tts_tpu_torch.serve.bundle",
               "e2e_tts_tpu_torch.convert", "e2e_tts_tpu_torch.kernels.build",
               "e2e_tts_tpu_torch.kernels.flash_attention", "e2e_tts_tpu_torch.text.frontends"]
    code = (f"import sys, {', '.join(modules)}\n"
            "from e2e_tts_tpu_torch.text.frontends import get_frontend\n"
            "[get_frontend(lang) for lang in ('vie', 'eng', 'mya')]\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert "e2e_tts_tpu_torch.serve.engine" in out
    bad = [m for m in out if m in ("jax", "flax", "e2e_tts_tpu") or m.startswith(
        ("jax.", "flax.", "e2e_tts_tpu."))]
    assert not bad, bad

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
- An iSTFTNet engine from a bundle that the JAX engine's ``save_checkpoint``
  writes (``vie_tiny``'s acoustic weights, a narrow iSTFTNet initialised by
  JAX): the same length and mean |diff| < 1 LSB; ``vocode_mel`` max |diff|
  < 1e-4 on both vocoder kinds.
- ``mel_content_features`` (the aligner's posteriorgram) max |diff| < 1e-5.
- Bundles the port writes (``save_checkpoint`` of its vie_tiny engine, and
  ``save_bundle`` of a model made from a seed with no bundle behind it):
  JAX's engine serves them within 1 LSB mean of the port's engine.
- ``device=None`` without CUDA raises; the port imports no JAX, and its f0
  trackers load the port's own native YIN library.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.nn.hifigan import IstftNetGenerator as JaxIstftNet
from e2e_tts_tpu.serve.bundle import load_bundle as jax_load_bundle
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu_torch.serve.bundle import load_bundle
from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

pytestmark = pytest.mark.usefixtures("one_thread")

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


def _perturbed(params, seed):
    """g * 1.7 and nonzero biases: the fuse matters, the output is no
    near-silent init."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        key = getattr(path[-1], "key", None)
        if key == "g":
            return x * 1.7
        if key == "bias":
            return x + 0.05 * rng.randn(*x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def istft_engines(tmp_path_factory):
    """A JAX iSTFTNet engine (vie_tiny's acoustic model, a narrow iSTFTNet
    initialised by JAX), the bundle its ``save_checkpoint`` writes, and the
    port's engine loaded from that bundle."""
    cfg, aparams, _, speakers, stats, _, foreign, language = jax_load_bundle(VIE_TINY)
    istft = cfg.models.istft.replace(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                                     resblock_dilation_sizes=((1, 3), (1, 3)))
    cfg = cfg.replace(models=cfg.models.replace(istft=istft))
    gen = JaxIstftNet.from_config(istft)
    vparams = jax.jit(functools.partial(gen.init, mel=jax.numpy.zeros((1, 8, 80))))(
        jax.random.PRNGKey(5))
    jeng = JaxEngine(cfg, aparams, _perturbed(vparams, 5), speakers, stats,
                     vocoder_kind="istft", foreign_dict=foreign, language=language)
    bundle = str(tmp_path_factory.mktemp("istft_bundle"))
    jeng.save_checkpoint(bundle)
    return jeng, SynthesisEngine.from_checkpoint(bundle, device="cpu")


def test_istft_engine_from_jax_bundle_matches_jax(istft_engines):
    jeng, peng = istft_engines
    assert peng.vocoder_kind == "istft"
    assert type(peng.vocoder).__name__ == "IstftNetGenerator"
    for text in (*GOLDEN, LONG):
        got, want = peng.synthesize(text), jeng.synthesize(text)
        assert got.dtype == want.dtype == np.int16 and len(got) == len(want) > 0
        assert np.abs(want.astype(np.int32)).mean() > 10  # a real signal
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.mean() < 1.0, (text[:20], d.mean(), d.max())
    assert peng._fpp == jeng._fpp


def test_vocode_mel_matches_jax(istft_engines):
    mel = (np.random.RandomState(3).randn(150, 80) * 0.5 - 4.0).astype(np.float32)
    for jeng, peng in (istft_engines, _engines()):
        got, want = peng.vocode_mel(mel), jeng.vocode_mel(mel)
        assert got.dtype == np.float32 and got.shape == want.shape == (150 * peng.hop_length,)
        assert np.abs(got - want).max() < 1e-4
        assert peng.vocode_mel(mel[:0]).shape == (0,)


def test_engine_events_reach_on_event():
    """Degraded-output events are kept in ``events`` and handed, in order, to
    ``on_event`` when it is set, as the JAX engine does."""
    _, peng = _engines()
    seen = []
    peng.on_event = seen.append
    try:
        n = len(peng.events)
        peng.synthesize(LONG, duration_control=3.0)
    finally:
        peng.on_event = None
    assert seen and seen == list(peng.events)[n:]


def test_mel_content_features_matches_jax():
    """The aligner's posteriorgram of a mel through the engine: the mel padded
    to the serving bucket as the JAX engine pads it, trimmed to T frames."""
    jeng, peng = _engines()
    rng = np.random.RandomState(4)
    for T, spk in ((1, 0), (57, 0), (200, 1)):
        mel = (rng.randn(T, 80) * 0.8 - 4.0).astype(np.float32)
        got, want = peng.mel_content_features(mel, spk), jeng.mel_content_features(mel, spk)
        assert got.dtype == np.float32 and got.shape == want.shape == (T, peng.acoustic.n_symbols)
        assert np.abs(got - want).max() < 1e-5
    assert peng.mel_content_features(np.zeros((0, 80), np.float32)).shape == (0, peng.acoustic.n_symbols)


def test_engine_options_the_port_does_not_take():
    _, peng = _engines()
    # every option of the JAX engine is taken now: the serving mesh and the
    # global mesh (tests/test_torch_parallel.py, test_torch_parallel_steps.py),
    # the folded vocoder and the transfer codec (tests/test_torch_folded.py)
    sharded = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", serving_devices=2)
    assert sharded.n_devices == 2 and sharded.batch_size % 2 == 0
    one = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", global_mesh=True)
    assert one.n_devices == 1  # one process: the world is this engine
    assert SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu",
                                           use_folded_vocoder=True).use_folded_vocoder


def test_port_written_bundle_served_by_jax(tmp_path):
    """``save_checkpoint`` of the port's vie_tiny engine (the serving
    vocoder's fused kernels written as v = w, g = ||w||): JAX's engine
    serves it within 1 LSB mean of the port's engine."""
    jeng, peng = _engines()
    peng.save_checkpoint(str(tmp_path / "b"))
    jax_served = JaxEngine.from_checkpoint(str(tmp_path / "b"))
    assert jax_served.speakers == jeng.speakers and jax_served.language == jeng.language
    _same_audio(peng.synthesize(GOLDEN[0]), jax_served.synthesize(GOLDEN[0]))
    again = SynthesisEngine.from_checkpoint(str(tmp_path / "b"), device="cpu")
    np.testing.assert_array_equal(again.synthesize(GOLDEN[0]), peng.synthesize(GOLDEN[0]))


def test_bundle_of_a_fresh_port_model_served_by_jax(tmp_path):
    """A model the port made from a seed, with no bundle behind it (vie_tiny's
    config, the training-form generator writing its own (v, g), its last
    kernels at a trained norm, so that the waveform is at a speaking level):
    JAX's engine serves the bundle
    within 1 LSB mean of the port's engine."""
    from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.serve.bundle import save_bundle
    from e2e_tts_tpu_torch.text.symbols import symbols

    _engines()  # the JAX programs of vie_tiny's shapes, compiled once
    b = load_bundle(VIE_TINY)
    g = torch.Generator().manual_seed(5)
    acoustic = FastSpeech2(b.config.models.fastspeech2, len(symbols), 2,
                           b.config.audio.mel.channels, b.stats, device="cpu", generator=g)
    vocoder = build_generator(b.config, "hifigan", train=True, device="cpu", generator=g)
    with torch.no_grad():  # each kernel at norm U(0.5, 1.5), as a trained one keeps its level
        for name, p in vocoder.named_parameters():
            if name.endswith(".g"):
                p.uniform_(0.5, 1.5, generator=g)
    speakers = {"a": 0, "b": 1}
    save_bundle(str(tmp_path / "fresh"), b.config, acoustic, vocoder, speakers, b.stats)
    jeng = JaxEngine.from_checkpoint(str(tmp_path / "fresh"))
    peng = SynthesisEngine.from_checkpoint(str(tmp_path / "fresh"), device="cpu")
    for spk in speakers:
        got, want = peng.synthesize(GOLDEN[1], speaker_id=spk), jeng.synthesize(
            GOLDEN[1], speaker_id=spk)
        assert np.abs(want.astype(np.int32)).max() > 1000  # audible, so 1 LSB tests something
        _same_audio(got, want)


def test_c5_decoder_logits_of_a_trained_voice():
    """ROADMAP C5 on the CPU: the std of vie_tiny's decoder self-attention
    logits q k^T / sqrt(d_k) on a golden text (the card's run is
    ``chip_smoke.logit_sharpness``).  C5's bar was probed at std ~0.1 (within
    one ulp) and std ~1 (2 ulp in float16); this trained voice lies past
    both, at 6.80 and 4.90 in its two layers."""
    from chip_smoke import GOLDEN as C5_TEXT
    from chip_smoke import decoder_logits

    layers = decoder_logits(SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu"), C5_TEXT)
    assert len(layers) == 2 and all(layer["d_k"] == 24 for layer in layers)
    stds = [layer["std"] for layer in layers]
    np.testing.assert_allclose(stds, [6.8023, 4.9012], rtol=1e-3)
    q, k, v, kv = layers[0]["inputs"]
    assert q.shape == k.shape == v.shape and q.shape[0] == len(kv)


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        SynthesisEngine.from_checkpoint(VIE_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        SynthesisEngine.from_random(seed=0)


def test_port_imports_no_jax():
    """Every module of the port, found by ``pkgutil.walk_packages`` (so a new
    module is covered when it is added), imports in a fresh interpreter
    without jax, flax or the JAX package."""
    # the f0 trackers run too: the native YIN must be the port's own library
    code = ("import importlib, pkgutil, sys\n"
            "import e2e_tts_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(e2e_tts_tpu_torch.__path__,\n"
            "                                                 'e2e_tts_tpu_torch.')]\n"
            "[importlib.import_module(n) for n in names]\n"
            "print('\\n'.join('walked:' + n for n in names))\n"
            "import numpy as np\n"
            "from e2e_tts_tpu_torch.text.frontends import get_frontend\n"
            "from e2e_tts_tpu_torch.audio import extract_f0, extract_pitch\n"
            "[get_frontend(lang) for lang in ('vie', 'eng', 'mya')]\n"
            "x = np.sin(np.arange(8000) * 0.06).astype(np.float32)\n"
            "extract_f0(x, 32, 22050, 256), extract_pitch(x, 22050, 256)\n"
            "from e2e_tts_tpu_torch.serve.voice_conversion import KnnVoiceConverter\n"
            "from e2e_tts_tpu_torch.utils.metrics import DspProxyScorer\n"
            "KnnVoiceConverter(device='cpu'), DspProxyScorer()(x, 22050)\n"
            "maps = open('/proc/self/maps').read().split()\n"
            "print('\\n'.join(sorted(sys.modules) + [m for m in maps if 'libyin' in m]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    walked = {m[len("walked:"):] for m in out if m.startswith("walked:")}
    assert {"e2e_tts_tpu_torch.serve.engine", "e2e_tts_tpu_torch.serve.queue",
            "e2e_tts_tpu_torch.models.denoiser", "e2e_tts_tpu_torch.train.acoustic_step",
            "e2e_tts_tpu_torch.kernels.ctc", "e2e_tts_tpu_torch.train.e2e_step",
            "e2e_tts_tpu_torch.data.dataset", "e2e_tts_tpu_torch.train.checkpoint",
            "e2e_tts_tpu_torch.train.cli", "e2e_tts_tpu_torch.utils.prefetch",
            "e2e_tts_tpu_torch.utils.logging", "e2e_tts_tpu_torch.native.build",
            "e2e_tts_tpu_torch.serve.voice_conversion", "e2e_tts_tpu_torch.synthesizer",
            "e2e_tts_tpu_torch.compat.torch_import", "e2e_tts_tpu_torch.models.mos",
            "e2e_tts_tpu_torch.utils.metrics", "e2e_tts_tpu_torch.utils.profiling",
            "e2e_tts_tpu_torch.utils.params"} <= walked
    assert walked <= set(out)  # every walked module is loaded
    libs = {m for m in out if "libyin" in m}
    assert libs and all(m.startswith(os.path.join(REPO, "e2e_tts_tpu_torch", "native", "_build"))
                        for m in libs), libs
    bad = [m for m in out if m in ("jax", "flax", "e2e_tts_tpu") or m.startswith(
        ("jax.", "flax.", "e2e_tts_tpu."))]
    assert not bad, bad

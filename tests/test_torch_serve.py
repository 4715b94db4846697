"""The PyTorch port's serving modules against the JAX package's, on the CPU:
streaming, ``stream_synthesize``, the speed change, the ``Synthesizer``, the
batching queue and the int16 host transfer.

Bars: streamed int16 within 1 LSB of the JAX streamer and of the port's own
full pass (over the mel and the zero frames a segment sees past its end);
``stream_synthesize`` and the ``Synthesizer``'s wav of the JAX one's length
with mean |diff| < 1 LSB; the speed change equal; the queue's results equal
to a solo ``synthesize`` on the same engine.  The random weights of the JAX
package's init give a waveform well under 1 LSB, so each check also runs
with the last convolution scaled to a speaking level ("audible"); there the
queue's results are held within 1 LSB of the solo run (rows of several
requests share a batch, and sums run in another order).  Every future and
join has a timeout and every server closes in a ``with`` block, so no test
can hang the run.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.models import build_generator as jax_build_generator
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.serve.audio_post import change_speed_array as jax_change_speed_array
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu.serve.inference import Synthesizer as JaxSynthesizer
from e2e_tts_tpu.serve.streaming import StreamingVocoder as JaxStreamingVocoder
from e2e_tts_tpu.serve.streaming import stream_synthesize as jax_stream_synthesize
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import load_into
from e2e_tts_tpu_torch.models import build_generator
from e2e_tts_tpu_torch.serve import (BatchingServer, StreamingVocoder, SynthesisEngine,
                                     Synthesizer, change_speed_array, stream_synthesize)

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
TIMEOUT = 300  # seconds for any one future or join
LONG = " ".join(["xin chào việt nam hôm nay trời đẹp"] * 12)


def _lsb(a, b):
    assert a.dtype == b.dtype == np.int16 and len(a) == len(b) > 0, (len(a), len(b))
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


_ENGINES = {}


def _vie_tiny():
    """The JAX and the port's engine on vie_tiny, one of each per process."""
    if not _ENGINES:
        _ENGINES["jax"] = JaxEngine.from_checkpoint(VIE_TINY)
        _ENGINES["port"] = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    return _ENGINES["jax"], _ENGINES["port"]


# --- streaming ----------------------------------------------------------------------

def _audible_scale(port_vocoder, mel) -> float:
    """The factor on the last convolution that brings ``mel``'s waveform to
    an RMS of 0.1 (tanh is linear that close to 0)."""
    return 0.1 / float(port_vocoder(mel).pow(2).mean().sqrt())


def _small_hifigan(cfg):
    hifi = cfg.models.hifigan.replace(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                                      resblock_dilation_sizes=((1, 3), (1, 3)))
    return cfg.replace(models=cfg.models.replace(hifigan=hifi))


@pytest.mark.parametrize("level", ["init", "audible"])
def test_streaming_vocoder_matches_jax_and_its_full_pass(level):
    gen = jax_build_generator(_small_hifigan(jax_default_config()), "hifigan")
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))))
    port = build_generator(_small_hifigan(default_config()), "hifigan", device="cpu")
    load_into(port, params)
    mel = (np.random.RandomState(0).randn(150, 80) * 0.3).astype(np.float32)
    if level == "audible":
        scale = _audible_scale(port, torch.from_numpy(mel[None]))
        post = params["params"]["conv_post"]
        post["g"], post["bias"] = post["g"] * scale, post["bias"] * scale
        load_into(port, params)

    want = JaxStreamingVocoder(gen, params, 256, chunk_frames=48, halo_frames=16).vocode(mel)
    chunks = list(StreamingVocoder(port, 256, chunk_frames=48, halo_frames=16).stream(mel))
    assert len(chunks) == 4 and all(c.dtype == np.int16 for c in chunks)
    got = np.concatenate(chunks)
    if level == "audible":
        assert np.abs(want.astype(np.int32)).mean() > 1000
    assert _lsb(got, want).max() <= 1
    # the full pass over the mel and the zero frames that the last segment
    # holds past the end (a convolution of those frames reaches back into
    # the last valid ones), trimmed to the mel's length
    padded = np.concatenate([mel, np.zeros((16, 80), np.float32)])
    full = port(torch.from_numpy(padded[None]))[0, : 150 * 256]
    full = torch.clamp(full * 32767.0, -32768, 32767).to(torch.int16).numpy()
    assert _lsb(got, full).max() <= 1
    # mel_len shorter than the array: only mel_len frames are vocoded
    short = StreamingVocoder(port, 256, chunk_frames=48, halo_frames=16).vocode(mel, 100)
    assert len(short) == 100 * 256


def test_stream_synthesize_matches_jax_on_vie_tiny():
    jeng, peng = _vie_tiny()
    # each JAX streaming call compiles its vocoder program anew: two calls,
    # the controls path and the long text that chunks
    for text, kw in (("xin chào việt nam", dict(duration_control=1.4)), (LONG, {})):
        got = list(stream_synthesize(peng, text, **kw))
        want = np.concatenate(list(jax_stream_synthesize(jeng, text, **kw)))
        assert got and _lsb(np.concatenate(got), want).mean() < 1.0, (text[:20], kw)
    base = np.concatenate(list(stream_synthesize(peng, "xin chào việt nam")))
    slow = np.concatenate(list(stream_synthesize(peng, "xin chào việt nam",
                                                 duration_control=1.4)))
    long = np.concatenate(list(stream_synthesize(peng, LONG)))
    assert len(slow) > len(base) and len(long) > len(base)
    # the same chunks as the engine: its waveform is theirs with 0.5 s gaps
    solo = peng.synthesize("xin chào việt nam")
    assert len(solo) == len(base) + peng.sample_rate // 2
    with pytest.raises(KeyError):
        list(stream_synthesize(peng, "xin chào", speaker_id="nope"))


# --- audio post and the Synthesizer ------------------------------------------------

def test_change_speed_array_equals_jax():
    rng = np.random.RandomState(1)
    x = (0.3 * np.sin(np.arange(20000) * 0.05) + 0.05 * rng.randn(20000)).astype(np.float32)
    for rate in (1.0, 0.8, 1.25):
        np.testing.assert_array_equal(change_speed_array(x, rate), jax_change_speed_array(x, rate))
        i16 = (x * 20000).astype(np.int16)
        np.testing.assert_array_equal(change_speed_array(i16, rate),
                                      jax_change_speed_array(i16, rate))


def test_synthesizer_wav_matches_jax(tmp_path):
    jeng, peng = _vie_tiny()
    records = []
    for name, cls, eng in (("jax", JaxSynthesizer, jeng), ("port", Synthesizer, peng)):
        log = os.path.join(tmp_path, f"{name}.jsonl")
        synth = cls(eng, output_dir=os.path.join(tmp_path, name), log_path=log)
        # a text to normalize, and slow speech that re-splits (logged events)
        paths = [synth.synthesis("Ngày 16/8 có 35 độ.", speaker_id="nu"),
                 synth.synthesis(LONG, duration_control=3.0),
                 synth.synthesis("xin chào", sr=16000),
                 synth.synthesis("xin chào việt nam hôm nay trời đẹp", speed=1.25)]
        if name == "port":
            synth.close()
        with open(log) as f:
            records.append([json.loads(line) for line in f])
        records[-1].append(paths)
    (jrec, jpaths), (prec, ppaths) = ((r[:-1], r[-1]) for r in records)
    for jp, pp in zip(jpaths[:3], ppaths[:3]):
        (jsr, want), (psr, got) = wavfile.read(jp), wavfile.read(pp)
        assert jsr == psr and _lsb(got, want).mean() < 1.0, pp
    # the speed change accumulates phase, so a 1-LSB input difference can move
    # its output far: the stretch itself is held equal to JAX's above
    # (test_change_speed_array_equals_jax); here the lengths
    (_, want), (_, got) = wavfile.read(jpaths[3]), wavfile.read(ppaths[3])
    assert ppaths[3].endswith("_1.25.wav") and len(got) == len(want)
    plain = len(synth.synthesize_array("xin chào việt nam hôm nay trời đẹp"))
    assert abs(len(got) * 1.25 / plain - 1.0) < 0.05
    assert len(prec) == len(jrec) == 4  # one record per call
    for j, p in zip(jrec, prec):
        for k in ("text_chars", "speaker_id", "speed", "audio_s", "events"):
            assert p[k] == j[k], k
    assert prec[1]["events"] and all(e["event"] == "overflow_resplit" for e in prec[1]["events"])
    assert os.path.basename(prec[0]["path"]) != os.path.basename(prec[1]["path"])


def test_synthesizer_needs_an_engine_or_bundle_and_text(tmp_path):
    with pytest.raises(ValueError):
        Synthesizer()
    _, peng = _vie_tiny()
    with pytest.raises(ValueError):
        Synthesizer(peng, output_dir=str(tmp_path)).synthesis("")


# --- the batching queue --------------------------------------------------------------

def _small_cfg():
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    small = fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=64, decoder_hidden=64,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=64)),
        postnet=fs2.postnet.replace(embedding_dim=64, conv_layers=2),
    )
    hifi = cfg.models.hifigan.replace(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),))
    return cfg.replace(models=cfg.models.replace(fastspeech2=small, hifigan=hifi))


@pytest.fixture(scope="module", params=["init", "audible"])
def small_engine(request):
    eng = SynthesisEngine.from_random(seed=0, config=_small_cfg(), device="cpu")
    if request.param == "audible":
        mels = []
        real = eng.vocoder
        eng.vocoder = lambda mel: (mels.append(mel), real(mel))[1]
        eng.synthesize("hôm nay trời đẹp")
        eng.vocoder = real
        scale = _audible_scale(real, mels[0])
        with torch.no_grad():
            real.conv_post.weight.mul_(scale)
            real.conv_post.bias.mul_(scale)
        assert np.abs(eng.synthesize("xin chào").astype(np.int32)).mean() > 1000
    eng.level = request.param
    return eng


def _same_as_solo(engine, got, want):
    """Bit-equal at the init level; within 1 LSB once audible."""
    if engine.level == "init":
        np.testing.assert_array_equal(got, want)
    else:
        d = _lsb(got, want)
        assert d.max() <= 1 and d.mean() < 0.01, (d.max(), d.mean())


def _pinned(engine):
    """The engine's bucket estimator, to restore before each solo run: a
    solo run then picks the buckets the queue's batch picked."""
    return engine._fpp, engine._fpp_ema, engine._fpp_nobs


def test_batching_server_single(small_engine):
    state = _pinned(small_engine)
    with BatchingServer(small_engine) as srv:
        audio = srv.submit("xin chào việt nam", silence_distance=0.0).result(timeout=TIMEOUT)
    small_engine._fpp, small_engine._fpp_ema, small_engine._fpp_nobs = state
    _same_as_solo(small_engine, audio,
                  small_engine.synthesize("xin chào việt nam", silence_distance=0.0))


def test_batching_server_concurrent_requests(small_engine):
    texts = ["xin chào bạn", "hôm nay trời đẹp", "em yêu hoa lá", "núi sông hùng vĩ"]
    speakers = [f"speaker_{i % 2}" for i in range(len(texts))]
    futures = [None] * len(texts)
    with BatchingServer(small_engine, max_wait_ms=50.0) as srv:
        barrier = threading.Barrier(len(texts))

        def go(i):
            barrier.wait(timeout=TIMEOUT)
            futures[i] = srv.submit(texts[i], speaker_id=speakers[i], silence_distance=0.0)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        outs = [f.result(timeout=TIMEOUT) for f in futures]
    for text, spk, out in zip(texts, speakers, outs):
        _same_as_solo(small_engine, out,
                      small_engine.synthesize(text, speaker_id=spk, silence_distance=0.0))
    assert srv.n_cycles <= len(texts)


def test_batching_server_mixed_controls(small_engine):
    with BatchingServer(small_engine, max_wait_ms=50.0) as srv:
        f1 = srv.submit("xin chào", duration_control=1.0, silence_distance=0.0)
        f2 = srv.submit("xin chào", duration_control=1.2, silence_distance=0.0)
        a1, a2 = f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
    assert len(a2) > len(a1)


def test_batching_server_bad_speaker_fails_only_that_request(small_engine):
    with BatchingServer(small_engine) as srv:
        bad = srv.submit("xin chào", speaker_id="nope")
        good = srv.submit("xin chào", silence_distance=0.0)
        with pytest.raises(KeyError):
            bad.result(timeout=TIMEOUT)
        assert len(good.result(timeout=TIMEOUT)) > 0
        assert srv.submit("").result(timeout=TIMEOUT).shape == (0,)
    with pytest.raises(RuntimeError):
        srv.submit("xin chào")


def test_batching_server_worker_runs_without_grad(small_engine):
    """Grad mode is per thread: the worker turns it off for its own dispatch."""
    modes = []
    real = small_engine._synthesize_sequences

    def spy(*a, **kw):
        modes.append(torch.is_grad_enabled())
        return real(*a, **kw)

    small_engine._synthesize_sequences = spy
    try:
        assert torch.is_grad_enabled()
        with BatchingServer(small_engine) as srv:
            srv.submit("xin chào").result(timeout=TIMEOUT)
    finally:
        del small_engine._synthesize_sequences
    assert modes == [False]


class _FakeEngine:
    """Engine stand-in recording dispatch order; requests are integer tags."""

    batch_size = 4
    sample_rate = 22050

    def __init__(self, first_dispatch_sleep=0.0, fail_tag=None):
        self.dispatches = []
        self._sleep = first_dispatch_sleep
        self._fail = fail_tag
        self.first_dispatch_entered = threading.Event()

    def prepare_request(self, text, speaker_id):
        return [np.array([int(text)], np.int32)], 0

    def _synthesize_sequences(self, seqs, speakers, p, e, d):
        self.dispatches.append([int(s[0]) for s in seqs])
        if len(self.dispatches) == 1:
            self.first_dispatch_entered.set()
            time.sleep(self._sleep)
        if self._fail in self.dispatches[-1]:
            raise RuntimeError("engine failure")
        return [np.full(4, int(s[0]), np.int16) for s in seqs]

    def _combine(self, parts, gap):
        return np.concatenate(parts) if parts else np.zeros(0, np.int16)


def test_priority_lane_jumps_queue():
    eng = _FakeEngine(first_dispatch_sleep=0.5)
    with BatchingServer(eng, max_wait_ms=1.0, max_batch=2, age_promote_ms=60_000.0) as srv:
        f1 = srv.submit("1", silence_distance=0.0)
        assert eng.first_dispatch_entered.wait(timeout=10.0)
        f2 = srv.submit("2", silence_distance=0.0)
        f3 = srv.submit("3", silence_distance=0.0)
        f4 = srv.submit("4", silence_distance=0.0, priority=5)
        for f in (f1, f2, f3, f4):
            f.result(timeout=60)
    assert eng.dispatches[0] == [1]
    assert eng.dispatches[1][0] == 4, eng.dispatches


def test_aged_request_is_promoted():
    eng = _FakeEngine(first_dispatch_sleep=0.5)
    with BatchingServer(eng, max_wait_ms=1.0, max_batch=1, age_promote_ms=0.0) as srv:
        f1 = srv.submit("1", silence_distance=0.0)
        assert eng.first_dispatch_entered.wait(timeout=10.0)
        f2 = srv.submit("2", silence_distance=0.0)
        time.sleep(0.01)
        f3 = srv.submit("3", silence_distance=0.0, priority=9)
        for f in (f1, f2, f3):
            f.result(timeout=60)
    assert eng.dispatches[1] == [2] and eng.dispatches[2] == [3], eng.dispatches
    assert srv.n_promoted >= 1
    assert not srv._lanes


def test_queue_amortizes_dispatches_and_a_failure_stays_in_its_group():
    eng = _FakeEngine(fail_tag=7)
    n = 8
    futures = [None] * n
    with BatchingServer(eng, max_wait_ms=120.0) as srv:
        barrier = threading.Barrier(n)

        def go(i):
            barrier.wait(timeout=60)
            # request 7 asks for other controls: its own dispatch group
            futures[i] = srv.submit(str(i), duration_control=2.0 if i == 7 else 1.0)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        with pytest.raises(RuntimeError, match="engine failure"):
            futures[7].result(timeout=60)
        outs = [f.result(timeout=60) for f in futures[:7]]
        cycles = srv.n_cycles
    for i, out in enumerate(outs):
        assert (out == i).all()
    assert cycles < n, cycles
    assert sorted(tag for d in eng.dispatches for tag in d) == list(range(n))


# --- the host transfer format ----------------------------------------------------------

def test_port_engine_hands_int16_and_takes_no_codec():
    """The port's default wire format is lossless int16 (JAX's is mu-law on an
    accelerator): its output agrees with the JAX engine's in its lossless
    mode; "mulaw8" is taken (``tests/test_torch_folded.py`` holds it to JAX's)
    and an unknown codec is rejected."""
    _, peng = _vie_tiny()
    assert peng.transfer_codec is None
    jax_int16 = JaxEngine.from_checkpoint(VIE_TINY, transfer_codec="int16")
    text = "xin chào việt nam hôm nay trời đẹp"
    got = peng.synthesize(text)
    d = _lsb(got, jax_int16.synthesize(text))
    assert d.mean() < 1.0, d.mean()
    with pytest.raises(ValueError):
        SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", transfer_codec="alaw8")

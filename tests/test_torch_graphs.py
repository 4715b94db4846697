"""The engine's per-shape CUDA graphs (``e2e_tts_tpu_torch/serve/graphs.py``).

On the CPU: a CPU engine installs nothing and records no graph counter; an
installed module stays eager on CPU tensors, under autograd, while the test
hook holds it eager and while a layer of it is split over a model group,
and is left alone where it was not installed;
the families whose classes do not declare ``graph_safe`` stay out of
``serving_modules``; a deep copy (an engine's replica) starts with no graph
and calls its own weights; a parameter changed in place (an update or a
load) drops the module's graphs; a capture's flash launches go to a tally; the
variance predictor's cached positions equal the table it built each call,
and outgrown position tables stay held.

On the card (marked ``cuda``; ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_graphs.py``), for HiFi-GAN and
iSTFTNet engines at small widths: the graphed stages and the int16
waveforms bit-equal to eager at several (rows, bucket) shapes, a flash one
(T >= 256) and a re-render row count among them; a forward hook that keeps
the decoder's outputs sees fresh tensors of the right values; the flash
launch counts of eager, capturing and replayed calls equal; and more
batches of one shape in flight than ``PIPELINE_DEPTH`` each equal to their
own eager result; a call off the default stream runs eagerly.
"""

import copy
import os

import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.kernels.flash_attention import (_count_launch, count_launches,
                                                       flash_attention, tallied_launches)
from e2e_tts_tpu_torch.nn.transformer import _Positions
from e2e_tts_tpu_torch.nn.common import sinusoid_table, t2t_sinusoid
from e2e_tts_tpu_torch.serve import SynthesisEngine, graphs
from e2e_tts_tpu_torch.serve.engine import FRAMES_PER_PHONEME_EST, PIPELINE_DEPTH
from e2e_tts_tpu_torch.utils import tracing

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
COUNTERS = ("graph.replay", "graph.eager", "graph.capture")


def _small(block_type: str = "transformer"):
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    bb = fs2.building_block
    small = fs2.replace(encoder_layers=1, decoder_layers=1, encoder_hidden=64, decoder_hidden=64,
                        building_block=bb.replace(block_type=block_type,
                                                  transformer=bb.transformer.replace(
                                                      conv_filter_size=64)),
                        postnet=fs2.postnet.replace(embedding_dim=64, conv_layers=2))
    return cfg.replace(models=cfg.models.replace(fastspeech2=small))


def _graph_counts(fn):
    """{counter: amount} of the graph counters that ``fn()`` records under a
    CPU profiler session."""
    before = len(tracing.counts())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    out = {}
    for c in tracing.counts()[before:]:
        if c.name in COUNTERS:
            out[c.name] = out.get(c.name, 0) + c.amount
    return out


# --- the CPU ---------------------------------------------------------------------------------


def test_a_cpu_engine_installs_nothing_and_counts_nothing():
    eng = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    assert eng._graphs is None
    for m in graphs.serving_modules(eng.acoustic, eng.vocoder):
        assert "forward" not in m.__dict__ and not hasattr(m, "_graphs")
    counts = _graph_counts(lambda: eng.synthesize("xin chào việt nam"))
    assert counts == {}


def test_an_installed_module_stays_eager_off_the_card_under_autograd_and_the_hook():
    eng = SynthesisEngine.from_random(seed=0, config=_small(), device="cpu")
    mods = graphs.serving_modules(eng.acoustic, eng.vocoder)
    assert len(mods) == 7
    graphs.GraphCache().install(*mods)
    post = eng.acoustic.postnet
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(0))
    want = type(post).forward(post, mel)

    def calls():
        with torch.no_grad():
            for _ in range(3):
                assert torch.equal(post(mel), want)
            with graphs._eager():
                post(mel)
        post(mel)  # autograd on

    assert _graph_counts(calls) == {"graph.eager": 5}
    assert graphs._Held.depth == 0
    assert post._graphs.pool is None and post._graphs.entries == {}
    # a layer split over a model group (parallelize's ``tp``) holds the module eager
    dec = eng.acoustic.decoder
    assert not dec._graphs.split(dec)
    dec.layers[0].pos_ffn.tp = "a shard"
    try:
        assert dec._graphs.split(dec)
    finally:
        del dec.layers[0].pos_ffn.tp
    # a module the cache was not installed on records no graph counter
    emb = eng.acoustic.speaker_emb
    with torch.no_grad():
        assert _graph_counts(lambda: emb(torch.zeros(2, dtype=torch.int64))) == {}
    # the installed engine still serves on the CPU
    assert len(eng.synthesize("xin chào")) > 0


@pytest.mark.parametrize("block_type", ["conformer", "fastformer", "lstransformer", "reformer"])
def test_the_other_families_encoders_and_decoders_stay_eager(block_type):
    eng = SynthesisEngine.from_random(seed=0, config=_small(block_type), device="cpu")
    mods = graphs.serving_modules(eng.acoustic, eng.vocoder)
    assert eng.acoustic.encoder not in mods and eng.acoustic.decoder not in mods
    assert len(mods) == 5


def test_a_deep_copy_starts_with_no_graph_and_calls_its_own_weights():
    eng = SynthesisEngine.from_random(seed=0, config=_small(), device="cpu")
    cache = graphs.GraphCache()
    post = eng.acoustic.postnet
    cache.install(post)
    post._graphs.entries[("k",)] = "a graph"
    twin = copy.deepcopy(post)
    assert twin._graphs is not post._graphs and twin._graphs.pool is post._graphs.pool
    assert twin._graphs.entries == {}
    assert twin.forward.__self__ is twin
    with torch.no_grad():
        twin.convs[0].weight.mul_(2.0)
        mel = torch.randn(1, 8, 80, generator=torch.Generator().manual_seed(1))
        assert torch.equal(twin(mel), type(twin).forward(twin, mel))
        assert not torch.equal(twin(mel), post(mel))


def test_a_parameter_changed_in_place_drops_the_modules_graphs():
    eng = SynthesisEngine.from_random(seed=0, config=_small(), device="cpu")
    graphs.GraphCache().install(eng.acoustic.postnet, eng.acoustic.decoder)
    post, dec = eng.acoustic.postnet, eng.acoustic.decoder
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(3))
    for m in (post, dec):
        m._graphs.drop_if_changed(m)
        m._graphs.entries[("k",)] = "a graph"
    with torch.no_grad():
        post(mel)  # a call changes no version
        post._graphs.drop_if_changed(post)
        assert post._graphs.entries == {("k",): "a graph"}
        post.convs[1].weight.mul_(2.0)  # an in-place update
    post._graphs.drop_if_changed(post)
    assert post._graphs.entries == {}
    dec._graphs.drop_if_changed(dec)
    assert dec._graphs.entries == {("k",): "a graph"}
    eng.acoustic.load_state_dict(eng.acoustic.state_dict())  # a load copies in place
    dec._graphs.drop_if_changed(dec)
    assert dec._graphs.entries == {}


def test_a_captures_flash_launches_go_to_its_tally():
    before = flash_attention.launches
    with tallied_launches() as tally:
        _count_launch("launches")
        _count_launch("launches_16_sm90")
        _count_launch("launches")
    assert tally == {"launches": 2, "launches_16_sm90": 1}
    assert flash_attention.launches == before
    _count_launch("launches")
    count_launches(tally)
    assert flash_attention.launches == before + 3
    flash_attention.launches -= 3
    flash_attention.launches_16_sm90 -= 1


def test_the_predictors_positions_equal_the_table_built_each_call():
    eng = SynthesisEngine.from_random(seed=0, config=_small(), device="cpu")
    pred = eng.acoustic.variance_adaptor.pitch_predictor
    g = torch.Generator().manual_seed(2)
    for T in (40, 7, 96):  # grows, cuts, grows
        x = torch.randn(3, T, 64, generator=g)
        x[1, T // 2:] = 0.0  # padded rows do not count
        pos = torch.from_numpy(t2t_sinusoid(T + 1, 64))  # the table the call used to build
        nonpad = (x.abs().sum(-1) > 0).to(torch.int64)
        positions = torch.cumsum(nonpad, dim=1) * nonpad
        with torch.no_grad():
            want = pred.stack(x + pred.pos_alpha * pos[positions], None, None)
            assert torch.equal(pred(x), want)
    positions = _Positions(8)
    first = positions(4, torch.device("cpu"))
    positions(16, torch.device("cpu"))
    assert positions.outgrown[0].data_ptr() == first.data_ptr()
    assert torch.equal(positions(4, torch.device("cpu")),
                       torch.from_numpy(sinusoid_table(4, 8)))


# --- the card --------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _engine(kind, device):
    eng = SynthesisEngine.from_random(seed=0, config=_small(), vocoder_kind=kind, device=device)
    with torch.no_grad():  # an audible waveform: the random last convolution gives < 1 LSB
        eng.vocoder.conv_post.weight.mul_(300.0 if kind == "hifigan" else 30.0)
        eng.vocoder.conv_post.bias.mul_(300.0 if kind == "hifigan" else 30.0)
    return eng


def _stage_inputs(eng, rows, L, seed):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(max(1, L // 2), L + 1, (rows,), generator=g)
    texts = torch.randint(1, 40, (rows, L), generator=g) * (torch.arange(L)[None] < lens[:, None])
    spk = torch.randint(0, 4, (rows,), generator=g)
    return [t.to(eng.device) for t in (spk, texts, lens)]


def _synthesize(eng, text):
    """``eng.synthesize(text)`` from the bucket estimator's first state, so
    that every call takes the same buckets."""
    eng._fpp = eng._fpp_ema = float(FRAMES_PER_PHONEME_EST)
    eng._fpp_nobs = 0
    return eng.synthesize(text)


def _both_stages(eng, inputs, T):
    x, d = eng._stage1(*inputs, 1.0, 1.0, 1.0)
    codes, lens = eng._stage2(x, d, T, 1.0, 1.0)
    return x, d, codes, lens


# (stage-1 rows, text bucket, stage-2 rows, mel bucket): a flash bucket (T >= 256) and a
# re-render's odd row count among them
SHAPES = [(2, 32, 2, 128), (8, 64, 8, 384), (4, 96, 3, 512), (8, 32, 5, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_graphed_stages_and_waveforms_equal_eager(cuda, kind):
    eng = _engine(kind, cuda)
    mods = graphs.serving_modules(eng.acoustic, eng.vocoder)
    assert len(mods) == 7
    for i, (rows1, L, rows2, T) in enumerate(SHAPES):
        inputs = _stage_inputs(eng, rows1, L, seed=i)
        with torch.no_grad(), graphs._eager():
            x, d = eng._stage1(*inputs, 1.0, 1.0, 1.0)
            want = (x, d) + eng._stage2(x[:rows2], d[:rows2], T, 1.0, 1.0)
        for call in range(4):  # eager, capture, replay, replay
            with torch.no_grad():
                x, d = eng._stage1(*inputs, 1.0, 1.0, 1.0)
                got = (x, d) + eng._stage2(x[:rows2], d[:rows2], T, 1.0, 1.0)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (kind, rows1, L, rows2, T, call)
    for m in mods:
        assert any(isinstance(e, graphs._Graph) for e in m._graphs.entries.values())
    texts = ["xin chào việt nam, hôm nay trời đẹp quá", "núi sông hùng vĩ " * 12]
    with graphs._eager():
        want = [_synthesize(eng, t) for t in texts]
    for _ in range(3):
        for t, w in zip(texts, want):
            assert np.abs(w.astype(np.int32)).max() > 100  # audible
            assert np.array_equal(_synthesize(eng, t), w)


@pytest.mark.cuda
def test_a_hook_keeps_fresh_decoder_outputs(cuda):
    eng = _engine("hifigan", cuda)
    dec = eng.acoustic.decoder
    kept = []
    handle = dec.register_forward_hook(
        lambda m, a, o: kept.append((a[0].clone(), a[1].clone(), o[0])))
    try:
        for seed in range(5):  # eager, capture, then replays at one shape
            _both_stages(eng, _stage_inputs(eng, 4, 64, seed=10 + seed), 384)
    finally:
        handle.remove()
    assert len(kept) == 5 and len({o.data_ptr() for _, _, o in kept}) == 5
    with torch.no_grad(), graphs._eager():
        for x, mask, out in kept:
            assert torch.equal(out, dec(x, mask)[0])
    assert not torch.equal(kept[3][2], kept[4][2])


@pytest.mark.cuda
def test_flash_launches_count_alike_eager_captured_and_replayed(cuda):
    eng = _engine("hifigan", cuda)
    inputs = _stage_inputs(eng, 8, 64, seed=3)
    per_call = []
    for _ in range(4):
        before = flash_attention.launches
        _both_stages(eng, inputs, 512)
        torch.cuda.synchronize()
        per_call.append(flash_attention.launches - before)
    # one decoder layer at T = 512 >= 256: one launch a call, replayed or not
    assert per_call == [1, 1, 1, 1]
    dec = eng.acoustic.decoder
    assert any(isinstance(e, graphs._Graph) and e.launches == {"launches": 1}
               for e in dec._graphs.entries.values())


@pytest.mark.cuda
def test_more_batches_in_flight_than_the_pipeline_depth_keep_their_results(cuda):
    eng = _engine("istft", cuda)
    batches = [_stage_inputs(eng, 8, 32, seed=20 + i) for i in range(PIPELINE_DEPTH + 3)]
    with torch.no_grad():
        _both_stages(eng, batches[0], 256)  # eager
        _both_stages(eng, batches[0], 256)  # capture
        flight = [_both_stages(eng, b, 256) for b in batches]  # replays, none fetched
    with torch.no_grad(), graphs._eager():
        for b, got in zip(batches, flight):
            for a, w in zip(got, _both_stages(eng, b, 256)):
                assert torch.equal(a, w)


@pytest.mark.cuda
def test_a_call_off_the_default_stream_runs_eagerly(cuda):
    eng = _engine("hifigan", cuda)
    post = eng.acoustic.postnet
    mel = torch.randn(2, 64, 80, device=cuda)
    side = torch.cuda.Stream(cuda)
    with torch.no_grad():
        want = post(mel)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            got = [post(mel) for _ in range(3)]
        torch.cuda.current_stream(cuda).wait_stream(side)
    assert len(post._graphs.entries) == 1  # the default stream's first call only
    for g in got:
        assert torch.equal(g, want)

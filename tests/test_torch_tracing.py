"""The port's spans and counters (``e2e_tts_tpu_torch/utils/tracing.py``) on
the CPU:

- with no profiler running, every site hands back the shared no-op and
  nothing is recorded, a queued request included;
- under a CPU ``torch.profiler`` session, a ``BatchingServer`` on the tiny
  bundle serves three requests: each has its frontend, queued, stitch and
  resolve spans under one request id, inside its submit-to-result interval;
  the engine's and the requests' collector spans nest under their cycle; one
  ``queue.cycle`` a ``n_cycles``; ``engine_cache_stats`` reads what an
  untraced engine reads;
- two steps of the training CLI's ``acoustic`` on a tiny workdir record
  ``train.batch_wait``, ``data.batch`` (with its children) from the prefetch
  thread, and the step's forward, backward and optimizer phases; a step
  over a one-rank gloo group adds ``step.reduce``;
- ``device_trace`` writes the spans into its Chrome trace, on its clock.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu_torch.config import default_config, save_config
from e2e_tts_tpu_torch.data import synthetic
from e2e_tts_tpu_torch.serve import BatchingServer, SynthesisEngine
from e2e_tts_tpu_torch.train import cli
from e2e_tts_tpu_torch.utils import device_trace, engine_cache_stats, tracing

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
TEXTS = ["xin chào việt nam", "em yêu hoa lá trên núi cao", "một hai ba"]
REQUEST_SPANS = {"request.frontend", "request.queued", "request.stitch", "request.resolve"}
CPU = ["--device", "cpu"]


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _new(before):
    """The spans recorded since ``before`` (a list of spans)."""
    seen = {s.sid for s in before}
    return [s for s in tracing.spans() if s.sid not in seen]


@pytest.fixture(scope="module")
def engine():
    return SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")


def test_with_no_profiler_the_tracer_records_nothing(engine):
    assert not tracing.enabled()
    spans, counts = tracing.spans(), tracing.counts()
    assert tracing.span("x") is tracing.NOOP and tracing.start("x") is tracing.NOOP
    with tracing.span("x", request=1) as s:
        tracing.count("y")
        tracing.record("z", 0, 1)
    s.close()
    with BatchingServer(engine) as srv:
        assert len(srv.synthesize(TEXTS[0])) > 0
    assert tracing.spans() == spans and tracing.counts() == counts


def test_a_served_request_is_traced_under_its_ids():
    # an untraced engine serves the same requests first: its shapes are then
    # the process's, and its statistics what the traced one has to read
    untraced = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    with BatchingServer(untraced, max_wait_ms=200.0) as srv:
        [f.result() for f in [srv.submit(t) for t in TEXTS]]
    engine = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    before = tracing.spans()
    with BatchingServer(engine, max_wait_ms=200.0) as srv:
        cycles0 = srv.n_cycles
        prof = _profiler()
        prof.start()
        t_on = time.time_ns()
        windows, futures = [], []
        for text in TEXTS:
            t = time.time_ns()
            futures.append(srv.submit(text))
            windows.append(t)
        done = []
        for f in futures:
            f.result(timeout=120)
            done.append(time.time_ns())
        cycles = srv.n_cycles - cycles0
    t_off = time.time_ns()  # the collector has left its cycle: close() joined it
    prof.stop()
    spans = _new(before)
    names = collections.Counter(s.name for s in spans)
    assert names["queue.cycle"] == cycles >= 1
    assert all(t_on <= s.start_ns <= s.end_ns <= t_off for s in spans)
    by_request = collections.defaultdict(list)
    for s in spans:
        if s.request is not None:
            by_request[s.request].append(s)
    assert len(by_request) == len(TEXTS)
    for (rid, mine), t_submit, t_done in zip(sorted(by_request.items()), windows, done):
        assert {s.name for s in mine} == REQUEST_SPANS, mine
        # the future resolves inside request.resolve (set_result and its callbacks)
        assert all(t_submit <= s.start_ns and (s.start_ns if s.name == "request.resolve"
                                               else s.end_ns) <= t_done for s in mine)
    cycle_of = {s.cycle: s for s in spans if s.name == "queue.cycle"}
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.name.startswith("engine.") or s.name in ("request.stitch", "request.resolve"):
            up = s
            while up.parent is not None:  # the chain of parents ends at the cycle
                up = by_sid[up.parent]
            assert up is cycle_of[s.cycle], s
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
            assert up.thread == s.thread and s.cpu_ns is not None
    queued = [s for s in spans if s.name == "request.queued"]
    assert all(s.kind == tracing.WAIT and s.cycle in cycle_of for s in queued)
    assert all(s.kind == tracing.DEVICE_WAIT for s in spans if s.name == "engine.fetch")
    counts = [c for c in tracing.counts() if t_on <= c.t_ns <= t_off]
    assert sum(c.amount for c in counts if c.name == "queue.rows") >= len(TEXTS)
    assert not [c for c in counts if c.name == "engine.cold_shape"]  # run untraced above
    assert engine_cache_stats(engine) == engine_cache_stats(untraced)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A prepared tiny workdir and its config."""
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(transformer=fs2.building_block.transformer.replace(
            conv_filter_size=32)),
        variance=fs2.variance.replace(variance_predictor=fs2.variance.variance_predictor.replace(
            filter_size=16)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=2))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2),
                      train=cfg.train.replace(batch_size=2, log_step=1))
    root = tmp_path_factory.mktemp("tracing_cli")
    config_path, corpus, wd = str(root / "config.yaml"), str(root / "corpus"), str(root / "wd")
    save_config(cfg, config_path)
    synthetic.make_synthetic_corpus(corpus, n_sentences=4, seed=0)
    cli.main(["prepare", "--corpus", corpus, "--workdir", wd, "--config", config_path] + CPU)
    return cfg, config_path, wd


def test_two_steps_of_the_acoustic_loop_record_their_phases(workdir):
    _, config_path, wd = workdir
    before = tracing.spans()
    with _profiler():
        cli.main(["acoustic", "--workdir", wd, "--config", config_path, "--steps", "2",
                  "--ckpt-every", "2"] + CPU)
    spans = _new(before)
    names = collections.Counter(s.name for s in spans)
    loop = threading.get_native_id()
    steps = [s for s in spans if s.name.startswith("step.")]
    assert collections.Counter(s.name for s in steps) == {
        "step.forward": 2, "step.backward": 2, "step.optimizer": 2}
    assert all(s.thread == loop and s.kind == tracing.HOST for s in steps)
    waits = [s for s in spans if s.name == "train.batch_wait"]
    assert len(waits) >= 2 and all(s.thread == loop and s.kind == tracing.WAIT for s in waits)
    assert names["train.log"] == 2 and names["train.checkpoint"] == 1
    made = [s for s in spans if s.name == "data.batch"]
    assert [s for s in made if s.thread != loop] and all(s.batch is not None for s in made)
    checkpoint = [s for s in spans if s.name == "train.checkpoint"][0]
    assert all(checkpoint.start_ns <= s.start_ns <= s.end_ns <= checkpoint.end_ns
               for s in made if s.thread == loop)  # validation's batches
    by_sid = {s.sid: s for s in spans}
    for name in ("data.load", "data.collate", "data.copy"):
        children = [s for s in spans if s.name == name and s.thread != loop]
        assert children and all(by_sid[s.parent].name == "data.batch" for s in children), name
    priors = [s for s in spans if s.name == "data.prior"]
    assert priors and all(by_sid[s.parent].name == "data.collate" for s in priors)


def test_a_step_over_a_group_records_its_reduce(workdir, tmp_path):
    from e2e_tts_tpu_torch.audio import beta_binomial_prior
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer,
                                         build_acoustic_model, init_train_state,
                                         make_train_step)

    cfg = workdir[0]
    model = build_acoustic_model(cfg, len(symbols), n_speakers=1, device="cpu")
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 32)
    state = init_train_state(model, opt)
    rng = np.random.RandomState(0)
    B, L, T = 2, 32, 128
    tl, ml = np.array([32, 20]), np.array([128, 90])
    texts, mel = np.zeros((B, L), int), np.zeros((B, T, 80), "f4")
    prior = np.zeros((B, T, L), "f4")
    for b in range(B):
        texts[b, :tl[b]] = rng.randint(1, len(symbols), tl[b])
        mel[b, :ml[b]] = rng.randn(ml[b], 80) - 5.0
        prior[b, :ml[b], :tl[b]] = beta_binomial_prior(tl[b], ml[b])
    z = np.zeros((B, T), "f4")
    arrays = [np.zeros(B, int), texts, tl, np.zeros((B, L), int), mel, ml, prior,
              np.zeros((B, L), "f4"), z, z, z, z]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        step = make_train_step(model, cfg, opt, n_words=1000, group=dist.group.WORLD)
        before = tracing.spans()
        with _profiler():
            state, _ = step(state, AcousticBatch.from_numpy(arrays, "cpu"))
    finally:
        dist.destroy_process_group()
    names = [s.name for s in _new(before)]
    assert names == ["data.copy", "step.forward", "step.backward", "step.reduce",
                     "step.optimizer"]


def test_device_trace_writes_the_spans_on_its_clock(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with tracing.span("test.outer", request=7):
            torch.ones(64, 64) @ torch.ones(64, 64)
            tracing.count("test.count", 3)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    outer = [e for e in events if e.get("name") == "test.outer"]
    assert len(outer) == 1 and outer[0]["cat"] == "program_span"
    assert outer[0]["args"]["request"] == 7 and outer[0]["tid"] == threading.get_native_id()
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm
    lo, hi = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    assert lo <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= hi
    counter = [e for e in events if e.get("name") == "test.count"]
    assert counter and counter[0]["args"] == {"amount": 3, "request": 7}

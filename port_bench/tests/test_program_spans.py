"""The readers of the program's own spans and counters (``port_bench/spans.py``
and the metrics that read it) on synthetic records: overlapping device
operations, a request that waits through one cycle and is served in the
next, fetches inside cycles, a program without the tracer."""

from __future__ import annotations

import os

import pytest

from e2e_tts_tpu_torch.utils.tracing import DEVICE_WAIT, HOST, WAIT, Count, Span
from port_bench import harness
from port_bench import spans as program

MS = 1_000_000


def _reader(name):
    return harness.load_reader(os.path.join(harness.HERE, "metrics", f"{name}.py"))


def _span(name, start_ms, end_ms, cpu_ms=None, kind=HOST, thread=1, request=None, cycle=None,
          sid=0, parent=None):
    cpu = None if cpu_ms is None else int(cpu_ms * MS)
    return Span(name, int(start_ms * MS), int(end_ms * MS), thread, cpu, kind, sid, parent,
                request, cycle, None)


def _rec(ops_ms=(), window_ms=100.0):
    return {"ops": [("k", int(s * MS), int(e * MS), None) for s, e in ops_ms],
            "window_s": window_ms / 1e3}


@pytest.fixture()
def recorded(monkeypatch):
    """Set the records the readers see: recorded(spans, counts)."""
    def put(spans, counts=()):
        monkeypatch.setattr(program, "records", lambda: (list(spans), list(counts)))
    return put


def test_interval_arithmetic():
    assert program.union([(5, 9), (0, 3), (2, 4), (9, 10), (12, 12)]) == [(0, 4), (5, 10)]
    a = program.union([(0, 10), (20, 30)])
    b = program.union([(2, 4), (3, 6), (8, 22), (25, 26), (40, 50)])
    assert program.minus(a, b) == [(0, 2), (6, 8), (22, 25), (26, 30)]
    assert program.measure(program.minus(a, [])) == 20
    assert program.minus([], b) == []


# request 1 is served in cycle 1; request 2 arrives during cycle 1, waits
# through it and is served in cycle 2; the card runs (0-10), (8-20) and (40-45)
REQUESTS = [
    _span("request.frontend", 0, 2, 1.0, request=1, thread=9),
    _span("request.queued", 2, 3, kind=WAIT, request=1, cycle=1),
    _span("queue.cycle", 3, 30, 15.0, cycle=1, sid=1),
    _span("engine.fetch", 10, 25, 5.0, kind=DEVICE_WAIT, cycle=1, sid=2, parent=1),
    _span("request.stitch", 27, 28, 0.5, request=1, cycle=1, parent=1),
    _span("request.resolve", 28, 30, 1.5, request=1, cycle=1, parent=1),
    _span("request.frontend", 15, 16, 1.0, request=2, thread=9),
    _span("request.queued", 16, 31, kind=WAIT, request=2, cycle=2),
    _span("queue.cycle", 31, 60, 20.0, cycle=2, sid=3),
    _span("engine.fetch", 45, 50, 0.0, kind=DEVICE_WAIT, cycle=2, parent=3),
    _span("request.stitch", 57, 58, 1.0, request=2, cycle=2, parent=3),
    _span("request.resolve", 58, 60, 2.0, request=2, cycle=2, parent=3),
]
OPS = [(0, 10), (8, 20), (40, 45)]


def test_queue_wait_and_host_ms_per_request(recorded):
    recorded(REQUESTS)
    assert _reader("queue_wait_ms")(_rec()) == pytest.approx((1 + 15) / 2)
    assert _reader("request_host_ms")(_rec()) == pytest.approx(((2 + 1 + 2) + (1 + 1 + 2)) / 2)


def test_idle_with_work_counts_each_idle_instant_once(recorded):
    recorded(REQUESTS)
    # in the system: 2-30 (request 1) and 16-60 (request 2), so 2-60; the
    # overlapping operations cover 0-20 and 40-45: idle with work 20-40, 45-60
    assert _reader("idle_with_work")(_rec(OPS, window_ms=100.0)) == pytest.approx(35.0)
    assert _reader("device_idle")({"busy_s": 0.025, "window_s": 0.1}) == pytest.approx(75.0)


def test_host_offcpu_takes_the_fetches_out_of_the_cycles(recorded):
    recorded(REQUESTS)
    wall, cpu = (27 + 29) - (15 + 5), (15 + 20) - (5 + 0)
    assert _reader("host_offcpu")(_rec()) == pytest.approx(100.0 * (wall - cpu) / wall)


def test_host_offcpu_of_training_steps(recorded):
    recorded([_span("train.batch_wait", 0, 4, 0.0, kind=WAIT),
              _span("step.forward", 4, 10, 5.0), _span("step.backward", 10, 20, 8.0),
              _span("step.optimizer", 20, 24, 3.0), _span("data.batch", 0, 30, 10.0, thread=2)])
    # the backward's wall is autograd's device thread's, not the loop's: left out
    assert _reader("host_offcpu")(_rec()) == pytest.approx(100.0 * (10 - 8) / 10)
    assert _reader("batch_wait_ms")(_rec()) == pytest.approx(4.0)


def test_cold_shapes_read_the_counter_only_where_cycles_ran(recorded):
    counts = [Count("engine.cold_shape", 1, 5 * MS, 1, None, 1, 7),
              Count("queue.rows", 3, 5 * MS, 1, None, 1, None),
              Count("engine.cold_shape", 1, 35 * MS, 1, None, 2, 8)]
    recorded(REQUESTS, counts)
    assert _reader("cold_shapes")(_rec()) == 2.0
    recorded([], counts)
    assert _reader("cold_shapes")(_rec()) is None


def test_engine_host_idle_is_host_work_on_an_idle_card(recorded):
    recorded([_span("request.frontend", 0, 5, 5.0),
              _span("engine.pack", 5, 7, 2.0), _span("engine.launch", 7, 12, 5.0),
              _span("engine.fetch", 12, 30, 1.0, kind=DEVICE_WAIT),
              _span("engine.drain", 30, 40, 4.0),
              _span("engine.fetch", 33, 36, 1.0, kind=DEVICE_WAIT),
              _span("request.stitch", 40, 42, 2.0),
              _span("request.frontend", 0, 50, 50.0, thread=2)])  # no engine span: not counted
    # host work 0-12, 30-33, 36-42; the card runs 3-8 and 6-31: idle in it 0-3, 31-33, 36-42
    assert _reader("engine_host_idle")(_rec([(3, 8), (6, 31)], 50.0)) == pytest.approx(22.0)


@pytest.mark.parametrize("name", ["queue_wait_ms", "request_host_ms", "idle_with_work",
                                  "cold_shapes", "host_offcpu", "engine_host_idle",
                                  "batch_wait_ms"])
def test_a_program_without_the_tracer_leaves_the_metric_out(monkeypatch, name):
    monkeypatch.setattr(program, "records", lambda: None)
    assert _reader(name)(_rec(OPS)) is None

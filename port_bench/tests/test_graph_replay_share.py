"""``graph_replay_share`` on synthetic counters: replays over every call
of a graphed module, captures not counted twice, and left out where the
program records no graph counter or no tracer at all."""

from __future__ import annotations

import os

import pytest

from e2e_tts_tpu_torch.utils.tracing import Count
from port_bench import harness
from port_bench import spans as program

MS = 1_000_000
READ = harness.load_reader(os.path.join(harness.HERE, "metrics", "graph_replay_share.py"))
REC = {"ops": [], "window_s": 0.1}


def _count(name, t_ms, amount=1):
    return Count(name, amount, int(t_ms * MS), 1, None, 1, None)


def _records(monkeypatch, counts):
    monkeypatch.setattr(program, "records", lambda: ([], list(counts)))


def test_replays_over_every_call(monkeypatch):
    # a cold shape (eager), its capture (eager, counted as a capture too), then replays
    _records(monkeypatch, [_count("graph.eager", 1), _count("graph.eager", 2),
                           _count("graph.capture", 2), _count("queue.rows", 3, 8)]
             + [_count("graph.replay", 4 + i) for i in range(6)])
    assert READ(REC) == pytest.approx(100.0 * 6 / 8)


def test_all_eager_reads_zero(monkeypatch):
    _records(monkeypatch, [_count("graph.eager", i) for i in range(4)])
    assert READ(REC) == 0.0


def test_a_program_without_the_graphs_or_the_tracer_leaves_it_out(monkeypatch):
    _records(monkeypatch, [_count("engine.cold_shape", 1), _count("queue.rows", 2, 4)])
    assert READ(REC) is None
    monkeypatch.setattr(program, "records", lambda: None)
    assert READ(REC) is None

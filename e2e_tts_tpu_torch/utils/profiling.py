"""Profiling harness (port of ``e2e_tts_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace with the program's own
spans in it, an RTF measurement, and the serving engine's count of distinct
stage shapes run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from . import tracing


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (the CPU, and CUDA when there is a card) and write
    ``<logdir>/trace_<ns>.json``, viewable in Perfetto or chrome://tracing.
    Yields the ``torch.profiler.profile``; its ``trace_path`` is set on exit.

    The program's spans and counters of the block (``utils/tracing``, which
    record while the profiler does) are written into the same trace, on its
    clock (the offset read from ``record_function`` marks at the start), and
    on the threads that made them: an operator sees a request's queue wait,
    cycle and engine phases, or a training step's batch wait and phases,
    beside the kernels they launched."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        marks = tracing.clock_marks()
        yield prof
    t1 = time.time_ns()
    prof.trace_path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    with open(prof.trace_path, encoding="utf8") as f:
        trace = json.load(f)
    trace["traceEvents"].extend(tracing.chrome_events(
        tracing.clock_offset_ns(prof, marks), trace.get("baseTimeNanoseconds", 0), t0, t1,
        os.getpid()))
    with open(prof.trace_path, "w", encoding="utf8") as f:
        json.dump(trace, f)


@dataclass
class RtfReport:
    wall_s: float
    audio_s: float
    rtf: float
    runs: int
    per_run_s: List[float] = field(default_factory=list)


def measure_rtf(
    synthesize: Callable[[], np.ndarray],
    sample_rate: int = 22050,
    warmup: int = 1,
    runs: int = 5,
) -> RtfReport:
    """RTF = wall time / seconds of audio produced.  ``synthesize`` must
    return the final host-side waveform (so device work is complete)."""
    for _ in range(warmup):
        synthesize()
    per_run, audio_s = [], 0.0
    t_total = time.perf_counter()
    for _ in range(runs):
        t0 = time.perf_counter()
        audio = synthesize()
        per_run.append(time.perf_counter() - t0)
        audio_s += len(audio) / sample_rate
    wall = time.perf_counter() - t_total
    return RtfReport(
        wall_s=wall,
        audio_s=audio_s,
        rtf=wall / max(audio_s, 1e-9),
        runs=runs,
        per_run_s=per_run,
    )


def engine_cache_stats(engine) -> Dict[str, int]:
    """The JAX engine's compile-cache statistics, for the port's engine:
    the distinct stage-1 text buckets and stage-2 shapes (mel buckets,
    ``vocode_mel``'s and ``mel_content_features``' buckets) it has run,
    which is what the JAX engine compiles a program for."""
    s1, s2 = len(engine.stage1_shapes), len(engine.stage2_shapes)
    return {"stage1_programs": s1, "stage2_programs": s2, "total_compiled": s1 + s2}

"""Open loop through ``BatchingServer.submit``: requests are sent at their
due times from the mix's schedule whether or not earlier ones have
finished.  A request is timed from its due time to the moment its future
holds the int16 array; requests due in the window that finish after it are
waited for (a minute at most) and count with their whole wait.  Set-up
sends the mix's own traffic, on another seed, for ``warmup_seconds``: it
builds the kernels, warms the shapes this traffic uses and brings the
engine's bucket estimator to its steady state.
"""

from __future__ import annotations

import time

import numpy as np

from ..gen.schedule import poisson_due_times
from ..gen.text import make_texts, speakers_of
from ..compare.serving import compare_requests
from . import serving
from .outcome import Outcome, percentile

LATE_LIMIT_S = 60.0


def _send(server, texts, speakers, due, silence, clock0):
    """Submit each request at clock0 + due; returns (futures, lateness, done)."""
    done = [None] * len(texts)
    futures, late = [], []
    for i, (text, spk, d) in enumerate(zip(texts, speakers, due)):
        target = clock0 + d
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - target)
        fut = server.submit(text, speaker_id=f"speaker_{spk}", silence_distance=silence)
        fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        futures.append(fut)
    return futures, late, done


def _wait(futures, deadline):
    for f in futures:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        try:
            f.result(timeout=left)
        except Exception:  # a failed request counts as failed below
            pass


def run(run) -> Outcome:
    from e2e_tts_tpu_torch.serve.queue import BatchingServer

    mix, cfg = run.mix, run.config_file
    engine, wa, wv = serving.build_engine(cfg, run.seed, run.device)
    serving.warm_shapes(engine, mix["warm"])
    server = BatchingServer(engine, max_wait_ms=mix["max_wait_ms"])
    recorder = serving.Recorder(engine)
    silence = mix["silence_seconds"]

    warm_seed = run.seed + 7919
    n_warm = max(1, int(round(mix["rate"] * mix["warmup_seconds"])))
    warm_due = poisson_due_times(mix["rate"], mix["warmup_seconds"], warm_seed,
                                 mix.get("slice_requests"), mix.get("slices_seed"))
    futures, _, _ = _send(server, make_texts(mix, n_warm, warm_seed),
                          speakers_of(mix, n_warm, warm_seed), warm_due, silence,
                          time.perf_counter())
    _wait(futures, time.perf_counter() + LATE_LIMIT_S)

    due = poisson_due_times(mix["rate"], run.seconds, run.seed, mix.get("slice_requests"),
                            mix.get("slices_seed"))
    n = len(due)
    texts, speakers = make_texts(mix, n, run.seed), speakers_of(mix, n, run.seed)
    cycles0 = server.n_cycles
    recorder.clear()
    recorder.spans_on = run.trace
    clock0 = run.begin_window()
    futures, late, done = _send(server, texts, speakers, due, silence, clock0)
    _wait(futures, clock0 + run.seconds + LATE_LIMIT_S)
    run.end_window()
    recorder.spans_on = False

    for i, f in enumerate(futures):  # a done future's callback may still be running
        spin = time.perf_counter() + 1.0
        while f.done() and done[i] is None and time.perf_counter() < spin:
            time.sleep(0.0005)
    ok = [f.done() and f.exception() is None and done[i] is not None
          for i, f in enumerate(futures)]
    # a request that failed or never came counts with all the time it was waited for
    gave_up = clock0 + run.seconds + LATE_LIMIT_S
    lat = [(done[i] if ok[i] else gave_up) - (clock0 + due[i]) for i in range(n)]
    audio = [f.result() if ok[i] else None for i, f in enumerate(futures)]
    sr = engine.sample_rate
    cycles = server.n_cycles - cycles0
    server.close()
    host = recorder.to_host()
    recorder.remove()
    finite = [x for x in lat if np.isfinite(x)]
    run.note(f"requests {n}, done {sum(ok)}, audio {sum(len(a) for a in audio if a is not None) / sr:.3f} s, "
             f"latency p50 {percentile(finite, 50):.6f} s, generator lateness p50 "
             f"{percentile(late, 50) * 1e3:.3f} ms max {max(late) * 1e3:.3f} ms")

    counters = serving.counters(host, cfg, cycles=cycles)
    del engine, server

    def check(control=None):
        serving.free()
        return compare_requests(run, cfg, host, texts, speakers, audio, ok, wa, wv, silence,
                                control)

    return Outcome(metrics={"request_p95_s": percentile(lat, 95)}, attempted=n,
                   failed=n - sum(ok), counters=counters, spans=host["spans"], check=check)

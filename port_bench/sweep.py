"""Find the knee of an open-loop serving cell: the highest Poisson rate at
which the queue keeps pace with the arrivals.  One engine, one process, the
cell's own mix at each rate in turn for ``--seconds`` each:

    python3 -m port_bench.sweep --workload vie_mixed_open --rates 5 10 20 40 --seconds 20

For each rate it prints the requests, the 50th and 95th percentile
latencies, and how long after the window's end the last request finished
(the backlog left).  The knee is the highest rate at which, as at every
lower rate swept, every request came back and the median request waited
in the queue no longer than its own time: its latency at most twice the
median latency at the lowest rate swept, where requests hardly queue
(``knee``; the backlog, one request's reading, swings too much to decide
it).  The last line gives the knee and 0.6 x it, the rate a cell takes,
written into its mix file as a number.  The share keeps the cell's queue
away from the knee on a slower host too: on a host a fifth slower, 0.6 x
this knee is about 0.72 of that host's own, where 0.8 x would be 0.96,
and near the knee the queue's tail swings with every burst.  The engine
carries the benchmark's recording hooks, as in the cells' runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CELL_SHARE = 0.6  # of the knee: the rate an open cell's mix file takes


def knee(rows):
    """(knee rate, one request's own time) of a sweep's rows; the knee is
    None where requests failed at the lowest rate."""
    rows = sorted(rows, key=lambda r: r["rate"])
    own_s = rows[0]["p50_s"]
    best = None
    for r in rows:
        if r["done"] < r["requests"] or r["p50_s"] > 2.0 * own_s:
            break
        best = r["rate"]
    return best, own_s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=11)
    a = p.parse_args(argv)
    import torch

    from . import harness
    from .drivers import serving
    from .drivers.outcome import percentile
    from .drivers.queue_open import LATE_LIMIT_S, _send, _wait
    from .gen.schedule import poisson_due_times
    from .gen.text import make_texts, speakers_of

    if not torch.cuda.is_available():
        print("port_bench.sweep: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        plan = harness.plan(json.load(f), a.workload)
    from e2e_tts_tpu_torch.serve.queue import BatchingServer

    engine, _, _ = serving.build_engine(plan.config_file, a.seed, torch.device("cuda", 0))
    serving.warm_shapes(engine, plan.mix["warm"])
    server = BatchingServer(engine, max_wait_ms=plan.mix["max_wait_ms"])
    recorder = serving.Recorder(engine)  # the hooks the cells' runs carry
    silence = plan.mix["silence_seconds"]
    rows = []
    for k, rate in enumerate([a.rates[0]] + list(a.rates)):  # the first pass warms up
        seed = a.seed + 1000 * k
        due = poisson_due_times(rate, a.seconds, seed, plan.mix.get("slice_requests"),
                                plan.mix.get("slices_seed"))
        n = len(due)
        texts, spk = make_texts(plan.mix, n, seed), speakers_of(plan.mix, n, seed)
        recorder.clear()
        clock0 = time.perf_counter()
        futures, late, done = _send(server, texts, spk, due, silence, clock0)
        _wait(futures, clock0 + a.seconds + LATE_LIMIT_S)
        ok = [d is not None for d in done]
        lat = [(d if d is not None else clock0 + a.seconds + LATE_LIMIT_S) - (clock0 + t)
               for d, t in zip(done, due)]
        last = max(d for d in done if d is not None) - (clock0 + a.seconds)
        audio = sum(len(f.result()) for f, good in zip(futures, ok) if good) / engine.sample_rate
        row = dict(rate=rate, requests=n, done=sum(ok), p50_s=percentile(lat, 50),
                   p95_s=percentile(lat, 95), backlog_s=last, audio_s_per_s=audio / a.seconds,
                   late_p95_ms=1e3 * percentile(late, 95))
        if k > 0:
            rows.append(row)
            print(json.dumps(row), flush=True)
    server.close()
    rate, own_s = knee(rows)
    print(json.dumps(dict(knee=rate, own_s=own_s,
                          cell_rate=None if rate is None else round(CELL_SHARE * rate, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

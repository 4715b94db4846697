"""Run one cell on several seeds in turn, one process a run as the check
runs it, and print each metric's spread as the check reads it:

    python3 -m port_bench.sets --workload vie_mixed_open --seeds 1-6 [--pin 2]
        [--seconds 51] [--trace 0] [--out DIR]

``--seconds`` defaults to ``BENCHMARK.json``'s ``run_seconds``.  ``--pin k``
runs each child on the first k cores alone (what ``taskset -c 0-<k-1>``
does), acting on the benchmark's process and nothing else: a host with
fewer free cores.  It is no stand-in for a slower host: on an 8-core H100
host, one core read the open cell's median ``request_p95_s`` at 0.96x the
unpinned median and two cores at 1.09x.  ``--out`` keeps each child's
standard output and error.

One JSON line a run (its seed, exit code, wall time, ``correct``, the
requests or steps attempted and failed, each metric's value), then one a
metric: the median, the quartiles (``statistics.quantiles``, n=4), the
spread (interquartile range over the median) and the trimmed spread (the
same with the run farthest from the median left out, where that narrows
it: what the check's tightness test takes of one set), beside the bound
``BENCHMARK.json`` gives the metric.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional


def parse_seeds(text: str) -> List[int]:
    """``"1-6"``, ``"1,4,9"`` or both (``"1-3,10"``): the seeds in order."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def spread(values) -> float:
    """Interquartile range over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values) -> float:
    """The spread with the value farthest from the median left out, where
    that narrows it."""
    values = list(values)
    if len(values) < 3:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(spread(values), spread(values[:far] + values[far + 1:]))


def summary(name: str, values, bound: Optional[float]) -> Dict:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"metric": name, "n": len(values), "median": statistics.median(values),
            "q1": q1, "q3": q3, "spread": spread(values),
            "trimmed": trimmed_spread(values), "bound": bound}


def run_one(workload: str, seed: int, seconds: float, trace: int, pin: Optional[int],
            out: Optional[str], root: str) -> Dict:
    cmd = [sys.executable, "-m", "port_bench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", f"{seconds:g}", "--trace", str(trace)]
    cores = range(pin) if pin else None
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=1500,
                          preexec_fn=(lambda: os.sched_setaffinity(0, cores)) if cores else None)
    row = {"seed": seed, "rc": proc.returncode, "wall_s": time.perf_counter() - t}
    if out:
        stem = os.path.join(out, f"{workload}.trace{trace}.pin{pin or 0}.seed{seed}")
        for ext, text in (("out", proc.stdout), ("err", proc.stderr)):
            with open(f"{stem}.{ext}", "w", encoding="utf8") as f:
                f.write(text)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, ValueError):
        row["stderr_tail"] = proc.stderr[-2000:]
        return row
    row.update(correct=result["correct"], attempted=result["attempted"],
               failed=result["failed"],
               metrics={k: m["value"] for k, m in result["metrics"].items()},
               check={k: c["value"] for k, c in result["check"].items()})
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=parse_seeds, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--pin", type=int, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from . import harness

    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        bench = json.load(f)
    seconds = a.seconds if a.seconds is not None else bench["run_seconds"]
    bounds = {m["name"]: m["bound"] for m in bench["end_to_end"]}
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    rows = []
    for seed in a.seeds:
        row = run_one(a.workload, seed, seconds, a.trace, a.pin, a.out, harness.ROOT)
        rows.append(row)
        print(json.dumps({"workload": a.workload, "pin": a.pin, "seconds": seconds, **row}),
              flush=True)
    good = [r for r in rows if r.get("correct")]
    print(json.dumps({"workload": a.workload, "pin": a.pin, "seconds": seconds, "runs": len(rows),
                      "correct": len(good)}), flush=True)
    names = sorted({k for r in rows for k in r.get("metrics", {})})
    for name in names:
        values = [r["metrics"][name] for r in rows if name in r.get("metrics", {})]
        if len(values) >= 2:
            print(json.dumps({"workload": a.workload, "pin": a.pin,
                              **summary(name, values, bounds.get(name))}), flush=True)
    return 0 if len(good) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())

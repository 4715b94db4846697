"""The readings that a cell's limits are set from: on each seed, one short
run of the cell at its own load, then the numbers that decide ``correct``
twice: for the program, and for the control (the reference computed with
TF32 products put in the program's place, the precision below the
configurations' float32 with TF32 off).  The benchmark's own runs never
run the control.

    python3 -m port_bench.readings --workload vie_mixed_open --seconds 5 --seeds 1 2 3

Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def readings(workload: str, seed: int, seconds: float, device, bench=None, prepared=None):
    import torch

    from . import harness

    if bench is None:
        with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
            bench = json.load(f)
    p = prepared or harness.plan(bench, workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    run = harness.Run(args, p, device, time.perf_counter())
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    outcome = importlib.import_module(f"port_bench.drivers.{p.driver}").run(run)
    try:
        program = outcome.check()
        control = outcome.check(control="tf32")
    finally:
        outcome.close()
    return {"seed": seed, "program": program, "control": control, "limits": p.limits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.readings: no CUDA card", file=sys.stderr)
        return 3
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, seed, a.seconds, torch.device("cuda", 0)),
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

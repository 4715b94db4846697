"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  It runs on the
card of the machine it is started on and fails, printing no result, where
there is none; it never falls back to the CPU.  The last lines of standard
error, and the result's last key ``check``, give each number that decides
``correct`` beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".port_bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def main(argv=None) -> int:
    args = _args(argv)
    from . import harness

    _caches(harness.ROOT)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"port_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: the cell needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = harness.execute(args, torch.device("cuda", 0), T_PROCESS, bench)
    found = harness.jax_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

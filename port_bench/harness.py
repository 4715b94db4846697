"""The harness: a cell's plan from ``BENCHMARK.json`` and the files it names,
one run of it, and the run's result line.

Everything of a cell is found by name: the configuration at the ``file``
that ``BENCHMARK.json`` gives it, the traffic mix at
``traffic/<traffic>.json`` (whose ``driver`` names a module of
``drivers/``), each per-layer metric's reader at ``metrics/<name>.py`` or,
for a metric ``<base>.<suffix>``, ``metrics/<base>.py``, and the limits of
the numbers that decide ``correct`` at ``limits/<workload>.json``, and the
configuration's block family (``building_block.block_type``) other than the
transformer at ``reference/blocks/<block_type>.py`` (its stacks) and
``counts/blocks/<block_type>.py`` (its layer's FLOPs).  Adding a cell, a
mix, a metric or a block family adds files and entries; no file changes.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "e2e_tts_tpu")


def _json(path: str) -> dict:
    with open(path, encoding="utf8") as f:
        return json.load(f)


@dataclass
class Plan:
    workload: dict
    config_file: dict
    mix: dict
    driver: str
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    readers: Dict[str, str]


def metric_reader_path(name: str) -> Optional[str]:
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return path
    return None


def family_files(config: dict) -> List[str]:
    """The files of the configuration's block family: none for the
    transformer, which ``reference/fs2.py`` and ``counts/model.py`` hold."""
    block_type = config["models"]["fastspeech2"]["building_block"]["block_type"]
    if block_type == "transformer":
        return []
    return [os.path.join(HERE, sub, "blocks", f"{block_type}.py")
            for sub in ("reference", "counts")]


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if listed(m) and m["moves"] in names]
    return e2e, layer


def plan(bench: dict, workload: str, root: str = ROOT) -> Plan:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    mix = _json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    if not os.path.exists(os.path.join(HERE, "drivers", f"{mix['driver']}.py")):
        raise FileNotFoundError(f"mix {cell['traffic']!r} names driver {mix['driver']!r}, "
                                f"which drivers/ does not hold")
    e2e, layer = cell_metrics(bench, workload)
    readers = {}
    for m in layer:
        path = metric_reader_path(m["name"])
        if path is None:
            raise FileNotFoundError(f"no reader for per-layer metric {m['name']!r} in metrics/")
        readers[m["name"]] = path
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    limits = _json(limits_path)["limits"] if os.path.exists(limits_path) else {}
    config_file = _json(os.path.join(root, cfg["file"]))
    family = family_files(config_file["config"])
    if not all(os.path.exists(path) for path in family):
        raise FileNotFoundError(f"configuration {cfg['name']!r} needs its block family's "
                                f"{' and '.join(family)}, and not both are there")
    return Plan(cell, config_file, mix, mix["driver"], e2e, layer, limits, readers)


def load_reader(path: str):
    name = "port_bench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """One run of a cell: its arguments, plan and device, the window's
    clocks, and the notes printed to standard error."""

    def __init__(self, args, plan: Plan, device, t_process: float):
        self.workload, self.seed, self.seconds = args.workload, args.seed, args.seconds
        self.trace = bool(args.trace)
        self.mix, self.config_file, self.limits = plan.mix, plan.config_file, plan.limits
        self.device = device
        self.t_process = t_process
        self.setup_s = self.window_s = None
        self.prof, self.marks = None, []
        self.t0 = self.t0_ns = self.t1_ns = None

    def note(self, text: str) -> None:
        print(f"[port_bench] {text}", file=sys.stderr, flush=True)

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self) -> float:
        """Set-up ends and the window begins; returns its perf_counter."""
        self._sync()
        self.setup_s = time.perf_counter() - self.t_process
        if self.trace:
            from . import trace

            self.prof, self.marks = trace.start()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self.t0

    def end_window(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.t1_ns = time.time_ns()
        if self.prof is not None:
            self.prof.stop()


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def execute(args, device, t_process: float, bench: dict, prepared: Plan = None) -> dict:
    """One run; returns the result line's object.  ``prepared``: the plan to
    run in place of the one ``bench`` gives (tests)."""
    import torch

    p = prepared or plan(bench, args.workload)
    run = Run(args, p, device, t_process)
    driver = importlib.import_module(f"port_bench.drivers.{p.driver}")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    outcome = driver.run(run)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
    units = {m["name"]: m["unit"] for m in p.end_to_end + p.per_layer}
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace:
        from . import trace

        rec = trace.read(run.prof, outcome.spans, run.t0_ns, run.t1_ns, run.marks)
        run.prof = None
        labels = collections.Counter(op[3] for op in rec["ops"])
        run.note(f"trace: {len(rec['ops'])} device operations, {rec['linked']} linked to their "
                 f"launch, clock offset {rec['offset_ns'] / 1e6:.3f} ms; by span {dict(labels)}")
        on_card = device.type == "cuda"  # no device number comes from a CPU run
        if on_card:
            device_rec.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
            breakdown = rec["breakdown"]
        rec.update(counters=outcome.counters, config=p.config_file, peaks=_json(
            os.path.join(HERE, "counts", "peaks.json")))
        metrics = {}
        for m in p.per_layer:
            if m["source"] == "device_trace" and not on_card:
                continue
            value = load_reader(p.readers[m["name"]])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for name, value in outcome.metrics.items():
            metrics[name] = {"value": value, "unit": units[name]}
    try:
        numbers = outcome.check()
    finally:
        outcome.close()
    # a request or step that never came is not correct, whatever the others say
    numbers = {"failed": outcome.failed, **numbers}
    check, correct = {}, True
    for name, value in numbers.items():
        limit = 0 if name == "failed" else p.limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        correct &= good
        check[name] = {"value": value, "limit": limit}
    result = {"correct": bool(correct), "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result

"""The control: the reference computed with TF32 products, put in the
program's place, must come out not correct in every cell, at the cell's own
size and load, on three seeds.  On the card only (``-m cuda``); the sound
program's readings of the same runs must come out correct.

    python -m pytest -m cuda port_bench/tests/test_control.py
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from port_bench import harness
from port_bench.readings import readings

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
SECONDS = {"vie_mixed_open": 5.0, "vie_longform_closed": 5.0, "vie_train_acoustic": 1.0}


def _workloads():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cells' own size: it needs a CUDA card")
    return torch.device("cuda", 0)


def _within(numbers, limits):
    return all(v <= limits[k] for k, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _workloads())
def test_the_tf32_control_is_not_correct(card, workload):
    for seed in SEEDS:
        r = readings(workload, seed, SECONDS.get(workload, 5.0), card)
        assert _within(r["program"], r["limits"]), r
        assert not _within(r["control"], r["limits"]), r

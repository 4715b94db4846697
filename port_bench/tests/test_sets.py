"""The spread arithmetic of ``port_bench.sets`` on fixed numbers, and the
open cells' windows against their 95th percentile."""

from __future__ import annotations

import json
import math
import os

import pytest

from port_bench import harness
from port_bench.gen.schedule import poisson_due_times
from port_bench.sets import parse_seeds, spread, summary, trimmed_spread


def test_seeds_by_range_and_list():
    assert parse_seeds("1-6") == [1, 2, 3, 4, 5, 6]
    assert parse_seeds("7-9,20,2147483660") == [7, 8, 9, 20, 2147483660]


def test_spread_is_the_exclusive_quartiles_over_the_median():
    # statistics.quantiles' default (exclusive) quartiles of 1..6: 1.75 and 5.25
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)
    assert spread([6, 1, 5, 2, 4, 3]) == spread([1, 2, 3, 4, 5, 6])


def test_trimmed_leaves_out_the_run_farthest_from_the_median():
    runs = [0.30, 0.31, 0.29, 0.32, 0.30, 0.60]
    # 0.60 lies farthest from the median 0.305; the rest: 0.29 .. 0.32
    rest = [0.29, 0.30, 0.30, 0.31, 0.32]
    assert trimmed_spread(runs) == pytest.approx((0.315 - 0.295) / 0.30)
    assert trimmed_spread(runs) == pytest.approx(spread(rest))
    assert trimmed_spread(runs) < spread(runs)


def test_trimmed_keeps_every_run_where_leaving_one_out_widens():
    runs = [10.7, 7.2, 5.8, 7.7, 13.9, 10.6]
    # without 13.9 the median falls from 9.15 to 7.7 and the spread widens
    assert spread([10.7, 7.2, 5.8, 7.7, 10.6]) > spread(runs)
    assert trimmed_spread(runs) == spread(runs)


def test_summary_gives_median_quartiles_and_both_spreads():
    s = summary("request_p95_s", [1, 2, 3, 4, 5, 6], 0.25)
    assert (s["median"], s["q1"], s["q3"], s["n"], s["bound"]) == (3.5, 1.75, 5.25, 6, 0.25)
    assert s["spread"] == pytest.approx(1.0) and s["trimmed"] == pytest.approx(0.75)


def test_open_cells_leave_ten_requests_beyond_their_p95():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        bench = json.load(f)
    seconds = bench["run_seconds"]
    open_cells = 0
    for cell in bench["workloads"]:
        p = harness.plan(bench, cell["name"])
        if p.driver != "queue_open":
            continue
        open_cells += 1
        n = len(poisson_due_times(p.mix["rate"], seconds, 2 ** 31 + 12345))
        assert n - math.ceil(0.95 * n) >= 10, (cell["name"], n)
    assert open_cells >= 1

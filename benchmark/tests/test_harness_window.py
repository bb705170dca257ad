"""The window's arithmetic and the reading of an entry point's result."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, stats


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(1000, 30, 2.0) == 15000.0


def test_p95_is_the_nearest_rank_of_all_solves():
    walls = [float(i) for i in range(1, 101)]
    assert stats.percentile(walls, [False] * 100, 95) == 95.0
    assert stats.percentile(walls[:20], [False] * 20, 95) == 19.0


def test_a_failed_solve_counts_beyond_every_limit():
    walls = [1.0] * 19 + [2.0]
    failed = [False] * 19 + [True]
    assert stats.percentile(walls, failed, 95) == 1.0
    failed[0] = True
    assert math.isinf(stats.percentile(walls, failed, 95))


def test_rate_and_p95_readers_count_failures_as_missing():
    rec = [harness.Record(0.05, 1e-12, {}) for _ in range(10)]
    run = SimpleNamespace(records=rec, failed=[False] * 9 + [True], dof=100, window_s=0.5)
    from benchmark import spec
    assert spec.reader("end_to_end", "dof_per_s").read(run) == pytest.approx(100 * 9 / 0.5)
    assert math.isinf(spec.reader("metrics", "solve_p95_ms").read(run))
    run.failed = [False] * 10
    assert spec.reader("metrics", "solve_p95_ms").read(run) == pytest.approx(50.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(0.15)


def test_read_result_by_key_by_attribute_and_by_ratio():
    u = torch.zeros(2)
    traffic = {"result": {"residual": "residual",
                          "counts": {"iterations": "inner_iterations"}}}
    _, res, counts = harness.read_result(traffic, (u, {"residual": 1e-11,
                                                       "inner_iterations": 7}))
    assert res == 1e-11 and counts == {"iterations": 7.0}
    info = SimpleNamespace(residual_norm=torch.tensor(2e-10), r0_norm=torch.tensor(4.0),
                           iterations=5)
    traffic = {"result": {"residual": ["residual_norm", "r0_norm"],
                          "counts": {"iterations": "iterations"}}}
    _, res, counts = harness.read_result(traffic, (u, info))
    assert res == pytest.approx(5e-11) and counts == {"iterations": 5.0}

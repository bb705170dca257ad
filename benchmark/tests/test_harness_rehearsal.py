"""Each cell's path on the CPU at a small size, through the harness's own
run (without its look for a card): sound runs come out correct, and the
control and each fault a one-chip solve cell can have come out not correct.

The faults are planted under the timed entry point
(``PoissonSolver.solve_refined``): a solve that returns its state unchanged
(the zero start), one that leaves half of the batch of patches out, one
that returns the previous solve's answer, and an answer altered where it is
produced.  The exchange between chips does not exist on one chip."""

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, mesh
from pressurepoissonsolver_torch.solver import PoissonSolver


def _run(cell, seed=2 ** 35 + 3, overrides=None):
    return harness.execute(cell, seed, 0.3, False, "cpu", time.perf_counter(), overrides)


def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"dof_per_s", "setup_s"}
    assert list(res)[-1] == "compared"
    c = res["compared"]["reference_residual"]
    assert c["value"] <= c["limit"] == 2e-10


def test_control_is_not_correct(cell):
    res = _run(cell, overrides=control.CONTROL)
    assert not res["correct"]
    assert res["compared"]["reference_residual"]["value"] > 1e-9


def _zero(u, prev):
    return torch.zeros_like(u)


def _half(u, prev):
    out = u.clone()
    out[u.shape[0] // 2:] = 0
    return out


def _stale(u, prev):
    return u if prev is None else prev


def _altered(u, prev):
    return u * (1 + 1e-8)


@pytest.mark.parametrize("fault", [_zero, _half, _stale, _altered])
def test_fault_is_not_correct(cell, monkeypatch, fault):
    original = PoissonSolver.solve_refined
    last = {}

    def broken(self, f, *args, **kwargs):
        u, info = original(self, f, *args, **kwargs)
        out = fault(u, last.get("u"))
        last["u"] = u
        return out, info

    monkeypatch.setattr(PoissonSolver, "solve_refined", broken)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("seeded", [False, True])
def test_control_readings_on_the_cpu(cell, seeded):
    sound = control.readings(cell, [1, 2], 3, "cpu", seeded=seeded)
    ctl = control.readings(cell, [1], 3, "cpu", control.CONTROL, seeded=seeded)
    assert all(c["reference_residual"]["value"] <= 1e-10 for _, c, _ in sound)
    assert all(c["reference_residual"]["value"] > 1e-9 for _, c, _ in ctl)
    assert all(counts and "iterations" in counts[0] for _, _, counts in sound)


def test_seeded_problems_differ_from_the_fixed_ones(cell):
    run = harness.Run(cell, 7, torch.device("cpu"))
    run.starts, run.lengths = mesh.leaf_boxes(mesh.build(cell.config["mesh"], 2))
    run.n = cell.config["n"]
    harness.make_inputs(run)
    fixed = [p.phase for p in run.problems]
    harness.make_inputs(run, problem_seed=7)
    assert not any(np.array_equal(a, p.phase) for a in fixed for p in run.problems)


@pytest.mark.parametrize("key", ["patches", "dof", "leaf_levels"])
def test_a_stated_fact_that_the_mesh_contradicts_is_refused(cell, key):
    config = dict(cell.config, **{key: cell.config[key] + 1})
    with pytest.raises(ValueError, match=key):
        harness.build(harness.Run(cell._replace(config=config), 1, torch.device("cpu")))

"""The port's profiling layer on the CPU: ``utils.profiling`` (``time_op``,
``op_report``, ``trace`` / ``span``, the memory-rate table) and
``scripts/profile_ops.level_breakdown``, held to the reference's row names
and byte counts.  Device times come only from the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import json
import math

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_torch.ops.level_ops import Level
from pressurepoissonsolver_torch.scripts import profile_ops
from pressurepoissonsolver_torch.utils import profiling

# the reference's rows: utils/profiling.py:226-229 and
# scripts/profile_ops.py:81-100
OP_REPORT_ROWS = {"interpolate", "apply", "patch_solve", "smooth"}
BREAKDOWN_ROWS = ["extract_faces", "pipe_interpolate", "interpolate", "gamma_faces",
                  "stencil_only", "fold_rhs", "spectral_solve", "apply",
                  "patch_solve", "smooth"]
BREAKDOWN_LIGHT_ROWS = ["extract_faces", "interpolate", "stencil_only", "apply"]


def _level(dtype=torch.float64, **kw):
    h = DomainHierarchy(refined_tree(2, 3, 1), n=4)
    return Level(h.finest, dtype, device="cpu", **kw)


def test_time_op_on_a_cpu_op_is_finite_and_positive():
    x = torch.ones(64, 64)
    t = profiling.time_op(torch.matmul, x, x, reps=5)
    assert math.isfinite(t) and t > 0
    t_in, how = profiling.measure(torch.matmul, x, x, reps=5, in_graph=True)
    assert math.isfinite(t_in) and t_in > 0 and how == "cpu_wall"


def test_time_op_never_synchronises_a_device_it_was_not_given(monkeypatch):
    def no_sync(*_a, **_k):
        raise AssertionError("synchronised a CUDA device for a CPU op")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    lvl = _level()
    u = torch.ones((lvl.P, 4, 4), dtype=torch.float64)
    for in_graph in (False, True):
        assert profiling.time_op(lvl.apply, u, reps=3, in_graph=in_graph) > 0


def test_hbm_rotate_cycles_over_copies_of_the_first_argument():
    seen = []
    x, y = torch.zeros(8), torch.ones(8)

    def fn(a, b):
        seen.append(a.data_ptr())
        return a + b

    profiling.measure(fn, x, y, reps=9, trials=1, hbm_rotate=3)
    assert len(set(seen)) == 3 and x.data_ptr() in seen


@pytest.mark.parametrize("patch_solver", ["dft", "bcgs"])
def test_op_report_rows_and_shares(patch_solver):
    """The reference's four rows, ``gnnz_per_s`` on ``apply``, every share
    finite and positive (never rounded to 0), an ``_hbm`` row per op with
    ``hbm_force``."""
    lvl = _level(patch_solver=patch_solver)
    rep = profiling.op_report(lvl, reps=2, hbm_force=True)
    assert set(rep) == OP_REPORT_ROWS | {k + "_hbm" for k in OP_REPORT_ROWS}
    assert "gnnz_per_s" in rep["apply"] and rep["apply"]["gnnz_per_s"] > 0
    for key, row in rep.items():
        assert row["timing"] == "cpu_wall", key
        assert math.isfinite(row["ms"]) and row["ms"] > 0, key
        assert math.isfinite(row["roofline_pct"]) and row["roofline_pct"] > 0, key
    assert rep["apply_hbm"]["rotation_buffers"] == 2


def test_op_report_share_of_a_toy_level_is_not_zero():
    """A 4-patch level at n=4 against the nominal CPU rate: the share is
    tiny but never reads 0 (4 significant figures, not 2 decimals)."""
    h = DomainHierarchy(uniform_tree(2, 2), n=4)
    rep = profiling.op_report(Level(h.finest, device="cpu"), reps=2)
    assert all(row["roofline_pct"] > 0 for row in rep.values())
    assert profiling.sig4(1.23456e-9) == 1.235e-9


@pytest.mark.parametrize("light", [False, True])
def test_level_breakdown_rows(light):
    lvl = _level(torch.float32)
    rep = profile_ops.level_breakdown(lvl, reps=2, light=light)
    assert list(rep) == (BREAKDOWN_LIGHT_ROWS if light else BREAKDOWN_ROWS)
    for key in ("stencil_only", "apply"):
        assert rep[key]["gnnz_per_s"] > 0
    for row in rep.values():
        assert math.isfinite(row["ms"]) and row["roofline_pct"] > 0


def test_profile_ops_halo_is_not_ported(monkeypatch):
    """The halo engine is ported: ``PPS_PROFILE_HALO`` adds its rows (on a
    one-rank group that ends with the report)."""
    import torch.distributed as dist

    monkeypatch.setenv("PPS_PROFILE_HALO", "1")
    monkeypatch.setenv("PPS_PROFILE_DIVIDE", "0")
    monkeypatch.setenv("PPS_PROFILE_N", "4")
    monkeypatch.setenv("PPS_PROFILE_DTYPE", "f32")
    rep = profile_ops.main(device="cpu")
    assert set(rep["halo_ndev1_f32"]) == {"apply", "smooth", "interpolate"}
    for row in rep["halo_ndev1_f32"].values():
        assert math.isfinite(row["ms"]) and row["timing"] == "cpu_wall"
    assert not dist.is_initialized()


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    lvl = _level()
    u = torch.ones((lvl.P, 4, 4), dtype=torch.float64)
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as where:
        with profiling.span("pps_apply_region"):
            lvl.apply(u)
    assert where == logdir
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "pps_apply_region" for e in events)


def test_device_bw_table(monkeypatch):
    """The nominal CPU rate; the H100's data-sheet rate by name; and no
    guess for a card that is not in the table."""
    assert profiling._device_bw("cpu") == 50e9
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "NVIDIA H100 80GB HBM3")
    assert profiling._device_bw("cuda") == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "NVIDIA Unknown Card")
    with pytest.raises(ValueError, match="NVIDIA Unknown Card"):
        profiling._device_bw("cuda")


def test_kernel_times_reads_device_rows_only():
    """On a CPU-only profile there is no device row to sum."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) + 1
    assert profiling.kernel_times(prof) == []
    assert np.isclose(profiling.sig4(2 / 3), 0.6667)

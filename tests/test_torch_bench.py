"""The port's bench scripts against the JAX reference's on the CPU, at a
small size: ``pressurepoissonsolver_torch.bench`` against ``bench.py`` and
``pressurepoissonsolver_torch.scripts.bench3d`` against
``scripts/bench3d.py``, each run once per module with the same environment;
and ``solve_refined(..., sync=False)``, the reference's bench call, on both
packages."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.solver as tsolver
from pressurepoissonsolver_torch import bench as tbench
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.problems import get_problem, init_problem
from pressurepoissonsolver_torch.scripts import bench3d as tbench3d

from _torch_parity import hierarchies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small 2D bench: refined_tree(2, 5, 2) at n=8, no refinement, a 64-DOF
# coarse solve, one timed solve (reference: 16768 DOF, 2 / 5, error
# 2.2864880178904642e-04, Schur 5)
ENV_2D = {"PPS_BENCH_N": "8", "PPS_BENCH_DIVIDE": "0", "PPS_BENCH_COARSE_DOF": "64",
          "PPS_BENCH_REPS": "1"}
# the small 3D bench: refined_tree(3, 3, 2) written with Tree.to_file, n=4
# (reference: 4992 DOF, 2 / 9, error 2.2928495190679015e-03)
ENV_3D = {"PPS_BENCH3D_N": "4", "PPS_BENCH3D_REPS": "1"}


def _reference_module(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs_2d():
    """(reference JSON, port JSON) of the small 2D bench."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV_2D.items():
            mp.setenv(k, v)
        mp.delenv("PPS_BENCH_MESH", raising=False)
        ref = _json_line(_reference_module("bench.py", "reference_bench").main)
        port = _json_line(lambda: tbench.main(device="cpu"))
    return ref, port


@pytest.fixture(scope="module")
def runs_3d(tmp_path_factory):
    """(reference JSON, port JSON) of the small 3D bench on one mesh file."""
    mesh = str(tmp_path_factory.mktemp("bench3d") / "mesh3d.bin")
    refined_tree(3, 3, 2).to_file(mesh)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV_3D.items():
            mp.setenv(k, v)
        mp.setenv("PPS_BENCH3D_MESH", mesh)
        ref = _json_line(_reference_module("scripts/bench3d.py", "reference_bench3d").main)
        port = _json_line(lambda: tbench3d.main(device="cpu"))
    return ref, port


def _hold(ref, port):
    """Counts, residual and error of a port bench line against the
    reference's: outer rounds exactly, inner within one (an f32 cycle),
    the error to 1e-6 of itself."""
    assert port["dof"] == ref["dof"]
    assert port["outer_iterations"] == ref["outer_iterations"]
    assert abs(port["inner_iterations"] - ref["inner_iterations"]) <= 1
    assert ref["residual"] <= 1e-10 and port["residual"] <= 1e-10
    assert port["error"] == pytest.approx(ref["error"], rel=1e-6)


def test_bench_2d_matches_reference(runs_2d):
    ref, port = runs_2d
    _hold(ref, port)
    assert (port["dof"], port["outer_iterations"], port["inner_iterations"]) == (16768, 2, 5)
    assert port["error"] == pytest.approx(2.2864880178904642e-04, rel=1e-6)
    assert abs(port["schur_iterations"] - ref["schur_iterations"]) <= 1
    assert ref["schur_residual"] <= 1e-10 and port["schur_residual"] <= 1e-10


def test_bench_2d_keys_cover_reference(runs_2d):
    ref, port = runs_2d
    assert set(port) >= set(ref)
    assert port["dtype"] == ref["dtype"] == "ir" and port["device"] == "cpu"
    # measured on the CPU: every time and rate finite and positive; the
    # apply rows name their method
    for key in ("solve_s", "value", "apply_f32_ms", "apply_f64_ms",
                "apply_f32_roofline_pct", "apply_f64_roofline_pct", "setup_s"):
        assert np.isfinite(port[key]) and port[key] > 0, key
    assert port["apply_timing"] == "cpu_wall"


def test_bench_3d_matches_reference(runs_3d):
    ref, port = runs_3d
    _hold(ref, port)
    assert (port["dof"], port["outer_iterations"], port["inner_iterations"]) == (4992, 2, 9)
    assert port["error"] == pytest.approx(2.2928495190679015e-03, rel=1e-6)


def test_bench_3d_keys_cover_reference(runs_3d):
    ref, port = runs_3d
    assert set(port) >= set(ref)
    assert port["mode"] == ref["mode"] == "ir" and port["device"] == "cpu"


def test_bench_2d_mixed_without_schur(monkeypatch):
    """``PPS_BENCH_DTYPE=mixed`` runs ``solve`` (f64 BiCGStab, f32 cycle) as
    one outer round; ``PPS_BENCH_SCHUR=0`` leaves the Schur keys out."""
    for k, v in ENV_2D.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PPS_BENCH_DTYPE", "mixed")
    monkeypatch.setenv("PPS_BENCH_SCHUR", "0")
    out = tbench.main(device="cpu")
    assert out["outer_iterations"] == 1 and out["residual"] <= 1e-10
    assert out["dtype"] == "mixed" and not any(k.startswith("schur") for k in out)
    # solve() never builds the f32 finest level of the IR path
    assert "apply_f32_ms" not in out and np.isfinite(out["apply_f64_ms"])


def test_bench_mesh_knob_reads_the_file(monkeypatch, tmp_path):
    """``PPS_BENCH_MESH`` names the 2D mesh; unset, the generated tree."""
    path = str(tmp_path / "mesh2d.bin")
    refined_tree(2, 3, 1).to_file(path)
    monkeypatch.setenv("PPS_BENCH_MESH", path)
    assert len(tbench.bench_tree(0).leaves()) == len(refined_tree(2, 3, 1).leaves())
    monkeypatch.delenv("PPS_BENCH_MESH")
    assert len(tbench.bench_tree(1).leaves()) == 4 * len(refined_tree(2, 5, 2).leaves())


def test_solve_refined_sync_false_on_both_packages():
    """The reference bench's call ``solve_refined(f, tol=1e-10,
    inner_tol=1e-4, sync=False)`` runs on both packages with the same
    counts; both leave them on the device, as 0-d tensors."""
    import jax.numpy as jnp

    jh, th = hierarchies()
    fj, _ = init_problem(th.finest, get_problem("trig", 2))
    jopts = jsolver.SolveOptions(tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32)
    topts = tsolver.SolveOptions(tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32)
    _, jinfo = jsolver.PoissonSolver(jh, jopts).solve_refined(
        jnp.asarray(fj), tol=1e-10, inner_tol=1e-4, sync=False)
    ps = tsolver.PoissonSolver(th, topts, device="cpu")
    _, tinfo = ps.solve_refined(fj, tol=1e-10, inner_tol=1e-4, sync=False)
    _, tsync = ps.solve_refined(fj, tol=1e-10, inner_tol=1e-4)
    assert torch.is_tensor(tinfo["outer_iterations"]) and tinfo["outer_iterations"].dim() == 0
    assert (int(tinfo["outer_iterations"]) == int(jinfo["outer_iterations"])
            == tsync["outer_iterations"])
    assert abs(int(tinfo["inner_iterations"]) - int(jinfo["inner_iterations"])) <= 1
    assert int(tinfo["inner_iterations"]) == tsync["inner_iterations"]
    assert float(tinfo["residual"]) <= 1e-10 and float(jinfo["residual"]) <= 1e-10

"""The interface cell ``poisson2d-amr-schur.gmg``: its discovery and five
readers, its plain reference (``reference/schur.py``) against the program
and against a dense solve of ``reference/composite.py``'s operator, a CPU
rehearsal of its runs at a small size (sound runs correct; the control and
the faults not), its readings tool, and its stamped pass and roofline
counts.

The faults are planted under the timed entry point
(``PoissonSolver.solve_schur``): the zero start returned, half of the
patches left out, the previous solve's answer returned, and an answer
scaled by ``1 + 1e-8`` (composite residual 1e-8, ten times the limit).  What
the limit cannot catch is an error of the answer below about 1e-9 of it,
such as a scaling by ``1 + 1e-10``: the limit lies 650 times above the
sound answers' readings at the published size, so that it holds with room
on the CPU's small meshes, where sound answers read up to 1.1e-10
(PERF.md, §2)."""

import os
import tempfile
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, mesh, schur_check, schur_roofline, schur_spans, spec
from benchmark.reference.composite import CompositeOperator, relative_residual
from benchmark.reference.schur import SchurReference
from pressurepoissonsolver_torch import geometry
from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.ops.level_ops import Level
from pressurepoissonsolver_torch.solver import PoissonSolver
from pressurepoissonsolver_torch.utils import profiling

from .conftest import corner_mesh, stated

NAME = "poisson2d-amr-schur.gmg"
READERS = {"schur.operator_ms": "operator_ms", "schur.precond_ms": "precond_ms",
           "schur.kernels_per_solve": "nodes_per_solve"}
MESH = corner_mesh(2, 2)


def _cell(n=8):
    cell = spec.find_cell(NAME)
    return cell._replace(config=dict(cell.config, **stated(MESH, n)))


def _limit():
    return spec.find_cell(NAME).traffic["check"]["residual_limit"]


def _run(cell, seed=2 ** 35 + 3, overrides=None):
    return harness.execute(cell, seed, 0.3, False, "cpu", time.perf_counter(), overrides)


# -- discovery -----------------------------------------------------------------

def test_the_cell_finds_its_files_and_five_readers():
    cell = spec.find_cell(NAME)
    assert cell.config["name"] == "poisson2d-amr-schur" and cell.workload["chips"] == 1
    assert cell.traffic["entry"] == "solve_schur"
    assert cell.config["entry_kwargs"]["solve_schur"] == {"preconditioner": "gmg",
                                                          "max_iter": 60}
    assert {m["name"] for m in cell.per_layer} == {
        "iterations.schur", "schur.operator_ms", "schur.precond_ms",
        "schur.kernels_per_solve", "schur_S_roofline"}
    assert all(m["moves"] == "dof_per_s" for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(spec.reader("metrics", m["name"]).read)
    # the accepted cells report none of them
    for other in ("poisson2d-amr.ir", "poisson2d-amr-d4.ir"):
        assert not {m["name"] for m in spec.find_cell(other).per_layer} & {
            m["name"] for m in cell.per_layer}


def test_the_configuration_states_the_published_mesh():
    cfg = spec.find_cell(NAME).config
    ir = spec.find_cell("poisson2d-amr.ir").config
    for key in ("D", "n", "mesh", "patches", "dof", "leaf_levels", "cycle", "solve_options"):
        assert cfg[key] == ir[key], key
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200


# -- the plain reference -------------------------------------------------------

def _level_and_ref(n):
    t = mesh.build(MESH, 2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.bin")
        mesh.write_mesh(t, path)
        h = DomainHierarchy(geometry.Tree.from_file(path, 2), n=n)
    starts, lengths = mesh.leaf_boxes(t)
    return h, SchurReference(starts, lengths, n), CompositeOperator(starts, lengths, n)


@pytest.mark.parametrize("n", [8, 16])
def test_the_program_patch_solve_equals_the_reference(n):
    """``Level.patch_solve(f, Level.interpolate(v))`` against the
    reference's ``solve(f, interp(v))`` on random fields: the same f64
    patch solves, so within rounding (1e-12 of the largest value, about 1e4
    ulps for a transform of 2n terms and a divide)."""
    h, ref, _ = _level_and_ref(n)
    level = Level(h.finest, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(n)
    for _ in range(2):
        v, f = (torch.randn((level.P, n, n), dtype=torch.float64, generator=g)
                for _ in range(2))
        want = level.patch_solve(f, level.interpolate(v))
        got = ref.solve(f, ref.interp(ref.faces(v)))
        assert float((want - got).abs().max() / want.abs().max()) < 1e-12


@pytest.mark.parametrize("n", [8, 16])
def test_solve_schur_matches_the_dense_references(n):
    """The program's ``solve_schur`` answer against the reference's dense
    Schur solve (and, at n=8, a dense solve of ``composite.py``'s assembled
    operator): within 1e-8 of the largest value, since the solve stops at
    an interface residual of 1e-10 and ``I - S`` is well conditioned here
    (sound answers read 3e-11 and below); the all-f32 control misses by
    1e-6 and more, its rounding (6e-8) times the operator's condition."""
    h, ref, op = _level_and_ref(n)
    cell = _cell(n)
    g = torch.Generator().manual_seed(10 + n)
    f = torch.randn((h.finest.num_patches, n, n), dtype=torch.float64, generator=g)
    dense = ref.dense_solve(f)
    assert relative_residual(op, dense, f) < 1e-13
    if n == 8:
        N = f.numel()
        A = torch.stack([op.apply(e.reshape(f.shape)).reshape(-1)
                         for e in torch.eye(N, dtype=torch.float64)], dim=1)
        comp = torch.linalg.solve(A, f.reshape(-1)).reshape(f.shape)
        assert float((comp - dense).abs().max() / dense.abs().max()) < 1e-12
    errors = {}
    for side, over in (("program", None), ("control", control.CONTROL)):
        s = PoissonSolver(h, harness.solve_options(cell.config, over), device="cpu")
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
        errors[side] = float((u.double() - dense).abs().max() / dense.abs().max())
        errors[side + "_iface"] = ref.interface_residual(u, f)
    assert errors["program"] < 1e-8 < 1e-6 < errors["control"]
    assert errors["program_iface"] < 1e-9 < 1e-7 < errors["control_iface"]


def test_interface_residual_of_exact_and_perturbed_answers():
    """0 (to rounding) at the composite answer, and the size of a
    perturbation of it otherwise: scaling ``u`` by ``1 + 1e-8`` reads 1e-8."""
    h, ref, op = _level_and_ref(8)
    g = torch.Generator().manual_seed(3)
    f = torch.randn((h.finest.num_patches, 8, 8), dtype=torch.float64, generator=g)
    u = ref.dense_solve(f)
    assert ref.interface_residual(u, f) < 1e-13
    assert ref.interface_residual(u * (1 + 1e-8), f) == pytest.approx(1e-8, rel=1e-3)
    assert ref.interface_residual(u.float(), f) > 1e-8


# -- the rehearsal of a run -----------------------------------------------------

def test_a_sound_run_is_correct():
    res = _run(_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"dof_per_s", "setup_s"}
    c = res["compared"]["reference_residual"]
    assert c["value"] <= c["limit"] == _limit()


def test_the_control_is_not_correct():
    res = _run(_cell(), overrides=control.CONTROL)
    assert not res["correct"]
    assert res["compared"]["reference_residual"]["value"] > 10 * _limit()


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
def test_a_fault_is_not_correct(monkeypatch, fault):
    original = PoissonSolver.solve_schur
    last = {}

    def broken(self, f, *args, **kwargs):
        u, res = original(self, f, *args, **kwargs)
        out = fault(u, last.get("u"))
        last["u"] = u
        return out, res

    monkeypatch.setattr(PoissonSolver, "solve_schur", broken)
    assert not _run(_cell())["correct"]


def test_the_readings_tool_on_the_cpu():
    """Both references on the sampled answers after the program is freed:
    the program's interface residual within 10x of the solves' own returned
    residuals, the control's composite residual above the limit."""
    cell = _cell()
    sound = schur_check.readings(cell, [1, 2], 4, "cpu", seeded=True)
    ctl = schur_check.readings(cell, [1], 4, "cpu", control.CONTROL, seeded=True)
    for row in sound:
        assert row["reference_residual"] <= _limit() and row["failed_solves"] == 0
        assert row["interface_residual"] <= 10 * max(row["returned_residual"], 1e-14)
    assert all(row["reference_residual"] > _limit() for row in ctl)


# -- the stamped pass and the roofline -----------------------------------------

def test_each_reader_reads_its_number_or_nothing():
    for name, key in READERS.items():
        read = spec.reader("metrics", name).read
        assert read(SimpleNamespace(schur_spans={key: 1.5})) == 1.5
        assert read(SimpleNamespace(schur_spans=None)) is None
        assert read(SimpleNamespace(schur_spans={"stamps": {"overflow": 3}})) is None
    it = spec.reader("metrics", "iterations.schur").read
    recs = [harness.Record(0.1, 1e-11, {"iterations": k}) for k in (5.0, 6.0)]
    assert it(SimpleNamespace(records=recs)) == 5.5
    assert spec.reader("metrics", "schur_S_roofline").read(SimpleNamespace()) is None


def _span(name, parent, t0, t1, kids=0):
    return profiling.DeviceSpan(name, parent, 0, t0, t1, t1 - t0 - kids)


def test_summary_of_hand_made_device_spans():
    """One solve of two pieces 10 ns apart; an operator apply (its ``S``
    inside) and a preconditioner apply inside the second piece."""
    sp = [_span(schur_spans.ROOT, -1, 0, 500, kids=100 + 200),
          _span("pps.graphs.piece.init", 0, 50, 150),
          _span("pps.graphs.piece.step", 0, 160, 360, kids=40 + 60),
          _span("pps.krylov.operator", 2, 170, 210, kids=30),
          _span(schur_spans.OPERATOR, 3, 175, 205),
          _span(schur_spans.PRECOND, 2, 250, 310)]
    out = schur_spans.summarise(sp, card=True)
    assert out["operator_ms"] == pytest.approx(30e-6)
    assert out["precond_ms"] == pytest.approx(60e-6)
    assert out["krylov_operator_ms"] == pytest.approx(40e-6)
    assert out["graph_gap_pct"] == pytest.approx(100 * 10 / 310)
    assert out["closure"] == pytest.approx(1.0)
    assert out["counts"][schur_spans.OPERATOR] == 1
    assert "operator_ms" not in schur_spans.summarise(sp, card=False)


def test_the_extra_pass_rehearsed_on_the_cpu():
    """The pass of a traced run on the CPU: every solve's spans decoded
    under its root, two ``S`` applies an iteration and ``2k + 2``
    patch-solve passes a solve, and no device number."""
    run = harness.Run(_cell(), 2 ** 35 + 5, torch.device("cpu"))
    harness.build(run)
    harness.warm_up(run)
    out = schur_spans.read(run)
    n = int(run.traffic["trace_solves"])
    assert out["device"] == "cpu" and out["nodes_per_solve"] is None
    assert out["stamps"]["overflow"] == 0 and out["solves"] == n
    S = out["counts"][schur_spans.OPERATOR]
    assert S > 0 and S % (2 * n) == 0 and out["counts"][schur_spans.PRECOND] == S
    assert out["patch_solves_per_solve"]["passes"] == S / n + 2
    assert out["patch_solves_per_solve"]["patches"] == (S / n + 2) * len(run.starts)
    # the CPU runs the loop eagerly: no captured piece, so no closure
    assert "operator_ms" not in out and out["closure"] is None
    assert not profiling.device_spans_on() and profiling.host_spans() == []
    for name in READERS:
        assert spec.reader("metrics", name).read(run) is None


def test_schur_roofline_counts():
    """By hand: 2 patches of 4 x 4 cells and 3 interfaces of 4 values, f64:
    ``gamma`` and ``S gamma`` 12 values each, the field 32 written and 32
    read; 4 transforms of 2 * 4 flops a cell and a divide, 32 cells."""
    nbytes, flops = schur_roofline.schur_counts(2, 2, 4, 3, 8)
    assert nbytes == 8 * (2 * 12 + 2 * 32) and flops == 32 * (4 * 8 + 1)
    bound = schur_roofline.schur_bound_s(2, 2, 4, 3, torch.float64, 1e9,
                                         {"float64": 1e12})
    assert bound == pytest.approx(max(nbytes / 1e9, flops / 1e12))

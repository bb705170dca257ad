"""The 3D benchmark configuration ``poisson3d-2refine`` on the CPU, at n=4 on
its divide-0 shape (the reference's ``2refine`` octree: 15 patches on two
leaf levels, 960 DOF): the port's f64 composite apply against the
benchmark's plain reference, a solve with the configuration's options and
the traffic mix's arguments against that reference, and the plain-chain
spans (``pps.patch_sweep.plain``, ``pps.traces.plain``,
``pps.transfer.plain``), which open around each plain chain and nowhere on
a kernel's path.  No JAX: the reference here is ``benchmark/reference``."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, mesh, rhs, spec
from benchmark.reference.composite import CompositeOperator, relative_residual
from pressurepoissonsolver_torch import gmg as gmg_mod
from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import Tree
from pressurepoissonsolver_torch.ops import patch_sweep, traces, transfer
from pressurepoissonsolver_torch.ops.level_ops import Level
from pressurepoissonsolver_torch.solver import PoissonSolver
from pressurepoissonsolver_torch.utils import profiling

CELL = spec.find_cell("poisson3d-2refine.ir")
N = 4
SPANS = ("pps.patch_sweep.plain", "pps.traces.plain", "pps.transfer.plain")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The configuration's mesh at divide 0: the hierarchy at n=4, the leaf
    boxes and the plain reference's operator."""
    t = mesh.build(dict(CELL.config["mesh"], divide=0), 3)
    path = str(tmp_path_factory.mktemp("mesh") / "m.bin")
    mesh.write_mesh(t, path)
    h = DomainHierarchy(Tree.from_file(path, 3), n=N)
    starts, lengths = mesh.leaf_boxes(t)
    assert len(starts) == 15 and h.finest.num_cells == 960 and mesh.leaf_levels(t) == 2
    return SimpleNamespace(h=h, starts=starts, lengths=lengths,
                           op=CompositeOperator(starts, lengths, N))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_level_apply_equals_the_plain_reference(small, seed):
    level = Level(small.h.finest, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((len(small.starts), N, N, N), dtype=torch.float64, generator=g)
    want, got = level.apply(u), small.op.apply(u)
    assert float((want - got).abs().max() / want.abs().max()) < 1e-13


@pytest.mark.parametrize("problem", [0, 4, 8])
def test_solve_refined_meets_the_cell_limit(small, problem):
    """The configuration's ``solve_options`` and ``cycle``, the mix's
    arguments (no ``entry_kwargs``), a right-hand side of the mix's pool:
    the answer's residual under the plain reference within the cell's
    limit."""
    assert "entry_kwargs" not in CELL.config
    r = CELL.traffic["rhs"]
    problems = rhs.draw_pool(2 ** 33 + 1, 3, r["pool"], r["modes"], r["kmax"],
                             r["problem_seed"], r["scales"])
    f = rhs.make_pool(small.starts, small.lengths, N, [problems[problem]], "cpu")[0]
    solver = PoissonSolver(small.h, harness.solve_options(CELL.config), device="cpu")
    u, residual, _ = harness.read_result(
        CELL.traffic, solver.solve_refined(f, **CELL.traffic["kwargs"]))
    assert residual <= CELL.traffic["stop_tol"]
    limit = CELL.traffic["check"]["residual_limit"]
    assert relative_residual(small.op, u, f) <= limit == 2e-10


@pytest.fixture(scope="module")
def host_spans(small):
    """The host spans of one solve with a V-cycle of three levels (the
    configuration's cycle, its direct coarse solve cut to the one-patch
    level so that the 960 DOF have levels to smooth and transfers)."""
    cycle = dict(CELL.config["cycle"], coarse_direct_max_dof=N ** 3)
    cfg = dict(CELL.config, cycle=cycle)
    solver = PoissonSolver(small.h, harness.solve_options(cfg), device="cpu")
    assert len(solver.gmg.levels) >= 3
    f = torch.randn((len(small.starts), N, N, N), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    profiling.clear()
    profiling.enable()
    try:
        solver.solve_refined(f, tol=1e-6, max_outer=1, inner_max_iter=1)
        recs = profiling.host_spans()
    finally:
        profiling.disable()
        profiling.clear()
    return recs


@pytest.mark.parametrize("name, parents", [
    ("pps.patch_sweep.plain", (".smooth",)),
    ("pps.traces.plain", (".smooth", ".residual", "pps.krylov.operator",
                          "pps.solver.round_end")),
    ("pps.transfer.plain", (".restrict", ".prolong")),
])
def test_plain_chain_spans_open_on_a_3d_solve(host_spans, name, parents):
    """Each plain chain of the 3D levels runs in its span, inside the span
    of the cycle's step, the Krylov operator or the round's f64 residual
    that calls it, and none nests in another of the three."""
    mine = [r for r in host_spans if r.name == name]
    assert mine
    for r in mine:
        parent = host_spans[r.parent].name if r.parent >= 0 else ""
        assert parent.endswith(parents) or parent in parents, parent
        assert parent not in SPANS


class _OnCard:
    """Stands in for a CUDA tensor: the dispatchers read only ``is_cuda``
    before they hand it to the kernel."""

    is_cuda = True
    dtype = torch.float32


def _kernel_paths(monkeypatch):
    """The three dispatchers on a 2D card path, each with its kernel's tables
    and its kernel replaced by a stub that records the call."""
    called = []
    stub = (lambda *a, **k: called.append(a) or "kernel")
    monkeypatch.setattr(patch_sweep, "_kernel", stub)
    monkeypatch.setattr(traces, "build", stub)
    monkeypatch.setattr(transfer, "restrict", stub)
    monkeypatch.setattr(transfer, "prolong_add", stub)
    x = _OnCard()
    tr = gmg_mod.Transfer.__new__(gmg_mod.Transfer)
    tr._kt = object()
    paths = {
        "sweep": lambda: patch_sweep.sweep(SimpleNamespace(sweep=object()), x, None, None),
        "traces": lambda: traces.build_or_plain(object(), x, lambda u: pytest.fail()),
        "restrict": lambda: tr.restrict(x),
        "prolong_add": lambda: tr.prolong_add(x, x),
    }
    return paths, called


@pytest.mark.parametrize("path", ["sweep", "traces", "restrict", "prolong_add"])
def test_no_plain_chain_span_on_a_kernel_path(monkeypatch, path):
    paths, called = _kernel_paths(monkeypatch)
    profiling.clear()
    profiling.enable()
    try:
        assert paths[path]() == "kernel"
        recs = profiling.host_spans()
    finally:
        profiling.disable()
        profiling.clear()
    assert len(called) == 1 and not [r for r in recs if r.name in SPANS]

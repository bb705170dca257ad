"""The port's batched patch BiCGStab (``ops/patch_bcgs.py``) as init,
guarded pass and result, on the CPU, against the JAX package's
``batched_patch_bicgstab`` on the same numpy inputs: 2D and 3D, f32 and
f64, with a patch that is converged from the start and the others stopped
by the step limit or converged (1e-12 of max|x| in f64, 1e-5 in f32).  The
init and the pass make no host read.  Then bcgs solves (``solve``,
``solve_schur``) through an emulation of ``graphs.capture`` in which the
patch loops run inside the captured pieces (the card makes each one a loop
of the composed graph, ``graphs.PieceLoop``): the JAX package's counts, the
eager solve's iterate bit for bit, its stencil launches and patch passes,
and every piece run with the host reads of a tensor refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_tpu.ops.patch_bcgs as jbcgs
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.ops.patch_bcgs as tbcgs
import pressurepoissonsolver_torch.solver as tsolver
from pressurepoissonsolver_torch.ops import ghost_stencil as gs
from pressurepoissonsolver_torch.utils import counters, graphs

from _torch_parity import DTYPES, RTOL, hierarchies, rel_err
from test_torch_gmres_loop import _no_host_reads
from test_torch_graphs import _counting_plain

# the host read of the emulated WHILE node's condition, taken before any
# test patches the tensor's reads
_READ = torch.Tensor.__bool__


# -- the loop's pieces against the reference -----------------------------------

@pytest.mark.parametrize("max_iter", [6, 500])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("D", [2, 3])
def test_patch_loop_matches_reference(D, dt, max_iter):
    """The plain loop (init, then the guarded pass while the guard read
    to the host holds) on the homogeneous patch stencil gives the JAX
    package's iterate; patch 0 has a zero right-hand side (converged from
    the start: it stays exactly zero), the others stop at the step limit
    (6) or converge (500).  f32 runs to 1e-5 (1e-12 is below its
    rounding)."""
    npt, tdt = DTYPES[dt]
    jh, th = hierarchies(D=D)
    jl = jlo.Level(jh.finest, dtype=jnp.float32 if dt == "f32" else jnp.float64)
    tl = tlo.Level(th.finest, dtype=tdt, device="cpu")
    rng = np.random.default_rng(20 + D)
    b = rng.standard_normal((tl.P,) + tl.pl.ns_shape).astype(npt)
    b[0] = 0
    tol = 1e-12 if dt == "f64" else 1e-5
    jzero = jnp.zeros((jl.num_ifaces, jl.m), dtype=b.dtype)
    ref = np.asarray(jbcgs.batched_patch_bicgstab(
        lambda u: jl.apply_with_interface(u, jzero), jnp.asarray(b), tol=tol,
        max_iter=max_iter))
    zero = tl.gamma_zeros(tdt)

    def op(u):
        return tl.apply_with_interface(u, zero)

    s = tbcgs.bicgstab_init(op, torch.from_numpy(b), tol, max_iter)
    passes = 0
    while bool(s.go):
        s = tbcgs.bicgstab_step(op, s)
        passes += 1
    assert int(s.k) == passes and (passes == max_iter) == (max_iter == 6)
    assert s.x.dtype == tdt and not s.x[0].any()
    assert rel_err(ref, s.x) <= RTOL[dt]
    eager = tbcgs.batched_patch_bicgstab(op, torch.from_numpy(b), tol, max_iter)
    assert torch.equal(eager, s.x)


def test_patch_loop_pieces_make_no_host_read(monkeypatch):
    """The init and the pass, run with every host read of a tensor refused,
    give the plain loop's first pass."""
    _, th = hierarchies()
    tl = tlo.Level(th.finest, device="cpu")
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((tl.P,) + tl.pl.ns_shape))
    zero = tl.gamma_zeros()

    def op(u):
        return tl.apply_with_interface(u, zero)

    ref = tbcgs.bicgstab_step(op, tbcgs.bicgstab_init(op, b, 1e-12, 500))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        s = tbcgs.bicgstab_step(op, tbcgs.bicgstab_init(op, b, 1e-12, 500))
    assert torch.equal(s.x, ref.x) and int(s.k) == 1 and bool(s.go)


# -- the emulated capture with loops inside the pieces --------------------------

_EMU = {"on": False, "pending": None}


def _inline_cut(loop):
    """``graphs.cut`` emulated: the loop runs where the piece cuts, its
    pass replayed while its guard holds (the card's WHILE node, whose
    condition no host reads); the passes' launches are added after the
    replay of the piece that runs it."""
    n = 0
    while _READ(loop.go):
        loop.graph.replay()
        n += 1
    if _EMU["pending"] is not None:
        _EMU["pending"].append((loop.launches, n))


def _emulated_capture(fn, device):
    """``graphs.capture`` on the CPU: the warm-up (the patch loops capture
    their pass in it) and the capture call run ``fn``; a replay runs
    ``fn`` again under the emulated capture, the counters held still but
    for the patch loops' passes."""
    with graphs.warm_up():
        fn()
    _EMU["on"] = True
    try:
        before = counters.snapshot()
        fn()
        launches = counters.minus(counters.snapshot(), before)
    finally:
        _EMU["on"] = False

    class Replay:
        replays = 0

        def replay(self):
            snap = counters.snapshot()
            outer = dict(_EMU)  # a patch loop's pass replays inside a piece's
            _EMU.update(on=True, pending=[])
            try:
                fn()
            finally:
                pending = _EMU["pending"]
                _EMU.update(outer)
            counters.add(counters.minus(counters.snapshot(), snap), -1)
            for body, n in pending:
                counters.add(body, n)
                graphs.note_inner(n)
            self.replays += 1

    return Replay(), launches


@pytest.fixture
def emulated_loops(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _emulated_capture)
    monkeypatch.setattr(graphs, "capturing", lambda t: _EMU["on"])
    monkeypatch.setattr(graphs, "cut", _inline_cut)
    monkeypatch.setattr(gs, "_plain", _counting_plain(gs._plain))
    graphs.reset_launches()
    counters.reset()
    yield
    counters.reset()
    graphs.reset_launches()


# the small Schur mesh of the card's runs, refined_tree(2, 3, 1) at n=8,
# with its f64 V(2,1) active-set cycle: the finest level's smoothing takes
# the bcgs patch solves
GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active", coarse_direct_max_dof=64)


def _bcgs_solvers(jopts, **opts):
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(2, 3, 1), n=8, use_native=False)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=8)
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, gmg=jgmg.CycleOpts(**GMG), patch_solver="bcgs", **jopts))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, gmg=tgmg.CycleOpts(**GMG), patch_solver="bcgs", **opts), device="cpu")
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    return js, ts, f, exact


def _bcgs_run(s, f, how):
    if how == "solve":
        res = s.solve(f)
        return res.x, res.iterations
    u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
    return u, res.iterations


@pytest.mark.parametrize("how", ["solve", "schur"])
def test_bcgs_solves_through_the_capture(emulated_loops, monkeypatch, how):
    """A bcgs ``solve`` (f64 cycle) and ``solve_schur`` (f32 cycle, whose
    Schur operator applies the bcgs patch solves) run eagerly and through
    the emulated capture: the JAX package's count (the Schur count within
    the f32 cycle's band of one), the eager iterate bit for bit, its
    stencil launches and patch passes; then every piece of the captured
    program runs with the host reads of a tensor refused."""
    opts = {} if how == "solve" else {"precond_dtype": torch.float32}
    jopts = {} if how == "solve" else {"precond_dtype": jnp.float32}
    js, ts, f, _ = _bcgs_solvers(jopts, **opts)
    _, jcount = _bcgs_run(js, jnp.asarray(f), how)
    out = {}
    for mode in (False, True, True):
        ts._graphs = mode
        counters.reset()
        graphs.reset_launches()
        u, count = _bcgs_run(ts, torch.from_numpy(f), how)
        out.setdefault(mode, []).append((u, count, gs.counters(), dict(graphs.inner)))
    (ue, ce, le, ie), = out[False]
    assert ie["passes"] > ie["runs"] > 0 and sum(le[0].values()) > 0
    for u, count, launched, inner in out[True]:
        assert count == ce and torch.equal(u, ue) and launched == le and inner == ie
    assert ce == int(jcount) if how == "solve" else abs(ce - int(jcount)) <= 1
    (entry,) = ts._captured.values()
    assert any(isinstance(p, graphs.PieceLoop) for p in _pieces_loops(ts))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        _EMU["on"] = True
        try:
            for piece in entry.graphs.pieces:
                piece(entry.state)
        finally:
            _EMU["on"] = False


def _pieces_loops(ts):
    """The patch loops the solver's levels hold."""
    lvl = ts.fine_level
    return [loop for solve in lvl._bcgs.values() for loop in solve.loops.values()]

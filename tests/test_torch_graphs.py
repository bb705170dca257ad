"""The port's guarded-step Krylov loops and their captured form, on the
CPU.

``krylov.bicgstab``, ``cg`` and ``richardson`` run as an init, a guarded
step (the iteration, ``k + 1`` and the stop test on the device) and a
result, driven by ``krylov.run_loop``; ``utils.graphs.CapturedLoop``
replays a step captured over static buffers.  A CUDA graph exists only on
the card, so here ``graphs.capture`` is replaced by an emulation that
re-runs the step on the same static buffers per replay, with the launch
counters held still as a replay holds them, and the stencil's plain
version counts its calls as the kernel's wrapper counts launches.  The
card tests (``tests/test_torch_cuda.py``) capture for real.

Held here: the guarded-step loops against the loops as they were
written before the split (bit for bit, the same count) for every method,
step limit and a zero right-hand side, eager and captured; ``solve``, ``solve_refined`` and
``solve_schur(gmg)`` against the JAX package's counts and errors, and the
captured solves against the eager ones; the cache keys; the launch
accounting."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.solver as tsolver
from pressurepoissonsolver_torch.ops import ghost_stencil as gs
from pressurepoissonsolver_torch.utils import counters, graphs

from _torch_parity import hierarchies

GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
           coarse_direct_max_dof=64)
INNER_TOL = 1e-4


# -- the loops as they were before the split into guarded steps ---------------

def plain_bicgstab(A, b, M, tol, max_iter, weight=None):
    st, r0_norm = tkrylov.bicgstab_init(A, b)
    k = 0
    while k < max_iter:
        if not bool((tkrylov._norm(st.r) / r0_norm > tol).item()):
            break
        st = tkrylov.bicgstab_step(A, M, st)
        k += 1
    return st.x, k


def plain_cg(A, b, M, tol, max_iter, weight=None):
    def wdot(a, c):
        return tkrylov._dot(a if weight is None else a * weight, c)

    x, r = torch.zeros_like(b), b
    r0 = wdot(r, r)
    tol_t = torch.tensor(tol, dtype=b.dtype)
    thr = tol_t * tol_t
    z = r if M is None else M(r)
    p = z
    rz = wdot(r, z)
    k = 0
    while k < max_iter:
        if not bool((wdot(r, r) / r0 > thr).item()):
            break
        ap = A(p)
        alpha = rz / wdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if M is None else M(r)
        rz_new = wdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


def plain_richardson(A, b, M, tol, max_iter, weight=None):
    x, r = torch.zeros_like(b), b
    r0_norm = tkrylov._norm(r)
    k = 0
    while k < max_iter:
        if not bool((tkrylov._norm(r) / r0_norm > tol).item()):
            break
        x = x + (r if M is None else M(r))
        r = b - A(x)
        k += 1
    return x, k


PLAIN = {"bicgstab": plain_bicgstab, "cg": plain_cg, "richardson": plain_richardson}


def make_loop(method, A, M, weight):
    if method == "cg":
        return tkrylov.cg_loop(A, M, weight)
    return getattr(tkrylov, f"{method}_loop")(A, M)


# -- the emulated capture ------------------------------------------------------

def _counting_plain(plain):
    """The stencil's plain version, counting each call as the kernel's
    wrapper counts a launch (the CPU path counts none)."""
    def run(u, gf, coef, h2):
        D = u.dim() - 1
        gs._COUNTS[D][gs._NAMES[u.dtype]] += 1
        if gf is None:
            gs.launches_nogf[D][gs._NAMES[u.dtype]] += 1
        gs.widths[D][1] += 1
        gs.last_width[D] = 1
        return plain(u, gf, coef, h2)

    return run


def _emulated_capture(fn, device):
    """``graphs.capture`` on the CPU: the warm-up and the capture call run
    ``fn`` (the capture's call counts the step's launches, in every table
    of ``utils.counters``); a replay runs ``fn`` again on the same static
    buffers with every counter held still, as a graph's replay does not
    pass the wrappers."""
    fn()
    before = counters.snapshot()
    fn()
    launches = counters.minus(counters.snapshot(), before)

    class Replay:
        replays = 0

        def replay(self):
            snap = counters.snapshot()
            fn()
            counters.add(counters.minus(counters.snapshot(), snap), -1)
            self.replays += 1

    return Replay(), launches


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _emulated_capture)
    monkeypatch.setattr(gs, "_plain", _counting_plain(gs._plain))
    counters.reset()
    yield
    counters.reset()


# -- the guarded-step loop ----------------------------------------------------

@pytest.fixture(scope="module")
def inner_ops():
    """The f32 operator, V-cycle and volume weight of the IR inner solves
    on the small test mesh, and a seeded right-hand side."""
    _, th = hierarchies()
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
        gmg=tgmg.CycleOpts(**GMG)), device="cpu")
    rng = np.random.default_rng(11)
    low = ts.gmg.levels[0]
    b = torch.as_tensor(rng.standard_normal((low.P,) + low.pl.ns_shape), dtype=torch.float32)
    return low.apply, ts.gmg.apply, ts._volume_weight(torch.float32), b


@pytest.mark.parametrize("mode", ["eager", "captured"])
@pytest.mark.parametrize("rhs", ["seeded", "zero"])
@pytest.mark.parametrize("max_iter", [1, 3, 8, 60])
@pytest.mark.parametrize("method", ["bicgstab", "cg", "richardson"])
def test_guarded_loop_matches_plain_loop(inner_ops, emulated, method, max_iter, rhs,
                                         mode):
    """The guarded steps give the plain loop's iterate bit for bit and its
    count: at the step limit (``max_iter`` 1, 3, 8), at convergence (60) and
    at once for a zero right-hand side (``nan > tol`` = False).  Captured,
    the step is captured on another right-hand side, ``tol`` and step
    limit first."""
    A, M, w, b = inner_ops
    if rhs == "zero":
        b = torch.zeros_like(b)
    weight = w if method == "cg" else None
    x_ref, k_ref = PLAIN[method](A, b, M, INNER_TOL, max_iter, weight)
    loop = make_loop(method, A, M, weight)
    if mode == "eager":
        res = tkrylov.solve_loop(loop, b, INNER_TOL, max_iter)
    else:
        cap = graphs.CapturedLoop(loop, 3 * b + 1, 1e-2, 5)
        res = cap.run(b, INNER_TOL, max_iter)
        assert cap.graph.replays == res.iterations
    assert res.iterations == k_ref
    if rhs == "zero":
        assert k_ref == 0
    if rhs == "seeded" and max_iter < 8:
        assert k_ref == max_iter  # stopped by the limit, not by tol
    if rhs == "seeded" and max_iter == 60:
        assert 0 < k_ref < 60  # converged
    assert torch.equal(res.x, x_ref)


def test_captured_results_are_fresh_tensors(inner_ops, emulated):
    """Two runs of one captured loop give two answers: the first one's
    iterate is not a view of the static buffers the second overwrites."""
    A, M, _, b = inner_ops
    cap = graphs.CapturedLoop(tkrylov.bicgstab_loop(A, M), b, INNER_TOL, 60)
    first = cap.run(b, INNER_TOL, 60)
    x1 = first.x.clone()
    second = cap.run(2 * b, INNER_TOL, 60)
    assert torch.equal(first.x, x1)
    assert first.x.data_ptr() != cap.state.x.data_ptr()
    assert not torch.equal(second.x, first.x)
    assert torch.equal(second.x, tkrylov.bicgstab(A, 2 * b, M=M, tol=INNER_TOL,
                                                  max_iter=60).x)


# -- the solves against the JAX package ----------------------------------------

# (solver options, entry point): solve by opts.krylov, solve_refined by
# opts.inner_krylov, solve_schur with the "gmg" preconditioner
SOLVES = {
    "solve-bicgstab": ({}, "solve"),
    "solve-cg": ({"krylov": "cg"}, "solve"),
    "refined-bicgstab": ({"precond_dtype": "float32"}, "refined"),
    "refined-cg": ({"precond_dtype": "float32", "inner_krylov": "cg"}, "refined"),
    "refined-richardson": ({"precond_dtype": "float32", "inner_krylov": "richardson"},
                           "refined"),
    "schur-gmg": ({"precond_dtype": "float32"}, "schur"),
}


def _run(solver, f, how, tol=1e-10, **kw):
    """``(u, counts)`` of one solve."""
    if how == "solve":
        res = solver.solve(f, tol=tol, **kw)
        return res.x, (res.iterations,)
    if how == "refined":
        u, info = solver.solve_refined(f, tol=tol, inner_tol=INNER_TOL, **kw)
        return u, (info["outer_iterations"], info["inner_iterations"])
    u, res = solver.solve_schur(f, tol=tol, max_iter=60, preconditioner="gmg")
    return u, (res.iterations,)


def _solvers(opts):
    jh, th = hierarchies()
    dt = {"precond_dtype": (jnp.float32, torch.float32)}
    jkw = {k: dt[k][0] if k in dt else v for k, v in opts.items()}
    tkw = {k: dt[k][1] if k in dt else v for k, v in opts.items()}
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, gmg=jgmg.CycleOpts(**GMG), **jkw))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, gmg=tgmg.CycleOpts(**GMG), **tkw), device="cpu")
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    return js, ts, f, exact


@pytest.mark.parametrize("case", list(SOLVES))
def test_solves_match_reference_eager_and_captured(emulated, case):
    """Each solve through the guarded-step loop holds the JAX package's
    counts (outer rounds exactly; inner or Krylov iterations within one,
    the band of ``test_torch_solve.py``) and error (1e-6 relative); the
    captured solve (the key's second, which captures) gives the eager
    one's counts, iterate (bit for bit) and stencil launch counts."""
    opts, how = SOLVES[case]
    js, ts, f, exact = _solvers(opts)
    if how == "solve":
        jres = js.solve(jnp.asarray(f), tol=1e-10)
        ju, jc = jres.x, (int(jres.iterations),)
    elif how == "refined":
        ju, jinfo = js.solve_refined(jnp.asarray(f), tol=1e-10, inner_tol=INNER_TOL)
        jc = (int(jinfo["outer_iterations"]), int(jinfo["inner_iterations"]))
    else:
        ju, jres = js.solve_schur(jnp.asarray(f), tol=1e-10, max_iter=60,
                                  preconditioner="gmg")
        jc = (int(jres.iterations),)
    jerr = js.report(ju, jnp.asarray(f), jnp.asarray(exact))["error"]

    tf = torch.from_numpy(f)
    out = {}
    for mode in (False, True):
        ts._graphs = mode
        counters.reset()
        u, counts = _run(ts, tf, how)
        out[mode] = (u, counts, gs.counters())
    (ue, ce, le), (ug, cg, lg) = out[False], out[True]
    assert len(ts._captured) == 1
    assert ce == cg and torch.equal(ue, ug) and le == lg
    assert sum(le[0].values()) > 0  # the solves counted stencil launches
    assert ce[0] == jc[0] if how == "refined" else abs(ce[0] - jc[0]) <= 1
    if how == "refined":
        assert abs(ce[1] - jc[1]) <= ce[0]
    err = ts.report(ue, tf, torch.from_numpy(exact))["error"]
    assert abs(err - jerr) <= 1e-6 * jerr


# -- the cache keys and the launch accounting ----------------------------------

def test_cache_keys(emulated):
    """One graph per entry point and method, captured at the key's first
    solve: a new ``tol``, step limit, ``max_outer`` or right-hand side does
    not capture anew, and the captured loop then stops where the eager one
    does."""
    _, ts, f, _ = _solvers(SOLVES["refined-bicgstab"][0])
    f = torch.from_numpy(f)
    ts._graphs = True

    def eager(fn):
        ts._graphs = False
        try:
            return fn()
        finally:
            ts._graphs = True

    keys = []
    for kw in ({}, {"tol": 1e-6}, {"max_iter": 40}, {"tol": 1e-3, "max_iter": 2}):
        res = ts.solve(2 * f, **kw)
        ref = eager(lambda: ts.solve(2 * f, **kw))
        assert res.iterations == ref.iterations and torch.equal(res.x, ref.x)
        keys.append(sorted(ts._captured))
    assert res.iterations == 2  # stopped by the limit, not by tol
    assert keys == [[("solve", "bicgstab")]] * 4

    runs = [dict(), dict(inner_tol=1e-2), dict(inner_max_iter=2), dict(max_outer=5)]
    for kw in runs:
        u, info = ts.solve_refined(f, tol=1e-10, **{"inner_tol": INNER_TOL, **kw})
        ue, ie = eager(lambda: ts.solve_refined(f, tol=1e-10,
                                                **{"inner_tol": INNER_TOL, **kw}))
        assert info["inner_iterations"] == ie["inner_iterations"]
        assert torch.equal(u, ue)
        if kw.get("inner_max_iter") == 2:
            assert info["inner_iterations"] == 2 * info["outer_iterations"]
    assert sorted(k for k in ts._captured if k[0] == "refined") == [("refined", "bicgstab")]
    for prec in ("gmg", "gmg", None):
        ts.solve_schur(f, tol=1e-8, max_iter=60, preconditioner=prec)
    assert sorted((k for k in ts._captured if k[0] == "schur"), key=str) == [
        ("schur", "gmg"), ("schur", None)]


def test_launch_accounting(emulated):
    """A captured solve counts the stencil launches of the eager one: the
    step's launches counted at capture (those of one eager step) times the
    steps, plus the launches outside the loop, which count themselves.
    Held for the solve that captures and for one that only replays."""
    _, ts, f, _ = _solvers(SOLVES["refined-bicgstab"][0])
    f = torch.from_numpy(f)
    counters.reset()
    _, info = ts.solve_refined(f, tol=1e-10, inner_tol=INNER_TOL)
    eager = gs.counters()

    ts._graphs = True
    for _ in range(2):  # the capture, then replays only
        counters.reset()
        ts.solve_refined(f, tol=1e-10, inner_tol=INNER_TOL)
        assert gs.counters() == eager

    entry = next(iter(ts._captured.values()))
    low, M = ts._fine_low, ts.gmg.apply
    loop = tkrylov.bicgstab_loop(low.apply, M)
    state = loop.init(f.to(torch.float32), INNER_TOL, 60)
    before = counters.snapshot()
    loop.step(state)
    one_step = counters.minus(counters.snapshot(), before)
    assert entry.launches == one_step
    steps = info["inner_iterations"]
    step_f32 = one_step["ghost_stencil.2d"]["float32"]
    assert step_f32 > 0
    # outside the loop: the f64 residual of each outer round, and nothing
    # in f32 beyond the steps
    assert eager[0]["float32"] == steps * step_f32
    assert eager[0]["float64"] == info["outer_iterations"]

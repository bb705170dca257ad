"""The port's device GMRES (``krylov.gmres_loop``) on the CPU, run eagerly
(each guard read on the host), against the JAX package's ``gmres`` on the
same numpy inputs: dense nonsymmetric systems in f64 and f32, with and
without a preconditioner, restart 5 and 30, with ``x0``, with the
history, a lucky breakdown (a degenerate column) and a non-finite update;
and the composite operator of the small mesh with its V-cycle.  Held:
the iteration counts equal; x within 1e-10 of max|x| in f64 and 1e-4 in
f32; the history's prefix to the same tolerance of ||r0||.  Then every
piece of the loop (the cycle's init, the Gram-Schmidt step, the Givens
algebra, the cycle's end) runs with the host reads of a tensor patched to
raise: the pieces do device work only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.krylov as jkrylov
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import hierarchies

TOL = {"f64": 1e-10, "f32": 1e-4}
DT = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _system(dt, seed=3, n=40):
    """A nonsymmetric system, a right-hand side and a Jacobi
    preconditioner, in ``dt``."""
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 20.0, n)) + 0.3 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x0 = 0.1 * rng.standard_normal(n)
    Minv = np.diag(1.0 / np.diag(A))
    npt = DT[dt][0]
    return A.astype(npt), b.astype(npt), x0.astype(npt), Minv.astype(npt)


def _ops(A, Minv, precondition):
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    if not precondition:
        return (lambda v: jA @ v), (lambda v: tA @ v), None, None
    jM, tM = jnp.asarray(Minv), torch.from_numpy(Minv)
    return (lambda v: jA @ v), (lambda v: tA @ v), (lambda v: jM @ v), (lambda v: tM @ v)


def _close(dt, ref, got, scale):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max()) <= TOL[dt] * scale


# (dtype, preconditioned, restart, x0, history)
CASES = [(dt, pc, rs, False, False) for dt in ("f64", "f32") for pc in (False, True)
         for rs in (5, 30)] + [("f64", True, 5, True, False), ("f64", False, 5, False, True),
                               ("f32", True, 30, False, True), ("f64", True, 5, True, True)]


@pytest.mark.parametrize("dt, precondition, restart, with_x0, history", CASES)
def test_gmres_loop_matches_reference(dt, precondition, restart, with_x0, history):
    A, b, x0, Minv = _system(dt)
    jA, tA, jM, tM = _ops(A, Minv, precondition)
    tol = 1e-12 if dt == "f64" else 1e-5
    max_iter = 200
    jx0 = jnp.asarray(x0) if with_x0 else None
    tx0 = torch.from_numpy(x0) if with_x0 else None
    jout = jkrylov.gmres(jA, jnp.asarray(b), x0=jx0, M=jM, tol=tol, restart=restart,
                         max_iter=max_iter, history=history)
    slots = max_iter + restart + 1 if history else 0
    loop = tkrylov.gmres_loop(tA, tM, restart, None, slots)
    tout = tkrylov.solve_loop(loop, torch.from_numpy(b), tol, max_iter, tx0)
    (jres, jhist), (tres, thist) = (jout, tout) if history else ((jout, None), (tout, None))
    assert tres.iterations == int(jres.iterations) > 0
    x = tres.x.numpy()
    assert x.dtype == DT[dt][0]
    assert _close(dt, jres.x, x, np.abs(x).max())
    r0 = float(jres.r0_norm)
    assert abs(float(tres.r0_norm) - r0) <= TOL[dt] * r0
    if history:
        k = tres.iterations
        assert thist.shape == np.asarray(jhist).shape and thist.dtype == DT[dt][0]
        assert _close(dt, np.asarray(jhist)[:k + 1], thist[:k + 1], r0)


def test_gmres_loop_lucky_breakdown_and_non_finite_update():
    """A degenerate first column in every cycle (``A b = 0``: no column is
    taken, one count per cycle) and a preconditioner that returns NaN (each
    cycle's update rejected, the iterate kept at zero): the reference's
    counts, iterates and residual norms."""
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    b = np.array([1.0, 0.0])
    jres = jkrylov.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12,
                         restart=2, max_iter=5)
    tres = tkrylov.solve_loop(
        tkrylov.gmres_loop(lambda v: torch.from_numpy(A) @ v, None, 2),
        torch.from_numpy(b), 1e-12, 5)
    assert tres.iterations == int(jres.iterations) == 5
    assert not tres.x.any() and not np.asarray(jres.x).any()
    ones = np.ones(6)
    jres = jkrylov.gmres(lambda v: 2.0 * v, jnp.asarray(ones), M=lambda v: v * jnp.nan,
                         tol=1e-12, restart=3, max_iter=7)
    tres = tkrylov.solve_loop(
        tkrylov.gmres_loop(lambda v: 2.0 * v, lambda v: v * float("nan"), 3),
        torch.from_numpy(ones), 1e-12, 7)
    assert tres.iterations == int(jres.iterations) == 9
    assert not tres.x.any() and not np.asarray(jres.x).any()
    assert float(tres.residual_norm) == float(jres.residual_norm)


@pytest.fixture(scope="module")
def composite():
    """The f64 composite operator and V-cycle of the small test mesh, in
    both packages, and a seeded right-hand side."""
    jh, th = hierarchies()
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(tol=1e-10))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(tol=1e-10), device="cpu")
    rng = np.random.default_rng(7)
    b = rng.standard_normal((ts.fine_level.P,) + ts.fine_level.pl.ns_shape)
    return js, ts, b


def test_gmres_loop_on_the_composite_operator(composite):
    """GMG-preconditioned GMRES(5) on the f64 composite operator (several
    cycles): the reference's count and iterate."""
    js, ts, b = composite
    jres = jkrylov.gmres(js.fine_level.apply, jnp.asarray(b), M=js.gmg.apply, tol=1e-10,
                         restart=5, max_iter=60)
    tres = tkrylov.solve_loop(tkrylov.gmres_loop(ts.fine_level.apply, ts.gmg.apply, 5),
                              torch.from_numpy(b), 1e-10, 60)
    assert tres.iterations == int(jres.iterations) > 5
    x = tres.x.numpy()
    assert np.abs(x - np.asarray(jres.x)).max() <= 1e-10 * np.abs(x).max()


def _no_host_reads(monkeypatch):
    """Make every host read of a tensor raise."""
    def refuse(*_, **__):
        raise AssertionError("a host read inside a piece")

    for name in ("item", "__bool__", "cpu", "__float__", "__int__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _pieces(body):
    """The pieces of a program in order, each loop's body once."""
    for item in body:
        if isinstance(item, tkrylov.While):
            yield from _pieces(item.body)
        else:
            yield item


def test_gmres_pieces_make_no_host_read(composite, monkeypatch):
    """The cycle's init, the Gram-Schmidt step, the Givens algebra and the
    cycle's end, run in order on the composite operator with every host
    read refused, give the state the eager loop's first pass gives."""
    _, ts, b = composite
    loop = tkrylov.gmres_loop(ts.fine_level.apply, ts.gmg.apply, 5)
    state = loop.init(torch.from_numpy(b), 1e-10, 60)
    names = [p.__name__ for p in _pieces(tkrylov.program(loop))]
    assert names == ["cycle_init", "gram_schmidt", "givens", "cycle_end"]
    with monkeypatch.context() as m:
        _no_host_reads(m)
        for piece in _pieces(tkrylov.program(loop)):
            state = piece(state)
    assert int(state.it) == 1 and int(state.kdone) == 1
    assert bool(torch.isfinite(state.x).all()) and float(state.rnorm) < float(state.r0)

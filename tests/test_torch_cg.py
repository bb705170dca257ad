"""CG, Richardson and the monitored Krylov forms of the port against the
JAX reference on the CPU: ``krylov.cg`` (plain and in the cell-volume
inner product), ``richardson``, ``residual_history``, ``cg_history`` and
``gmres(history=True)`` on one operator (the f64 composite operator of the
n=8 test mesh, preconditioned by its f64 V(2,1) cycle); then
``PoissonSolver.solve_monitored`` (composite and Schur) and
``solve_refined`` with inner CG and Richardson.

Held equal: the iteration count exactly; the iterate to 1e-10 of its
largest; a history's entries, relative to the initial residual norm, to
1e-12 (absolute: an entry near 1e-11 of ``||r0||`` is a true residual that
cancellation leaves with few exact digits).  The reference's monitored
BiCGStab and CG run all ``max_iter`` iterations with the state frozen;
the port stops at convergence, so only the prefix up to the count exists
in both."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.krylov as jkrylov
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import hierarchies, rel_err

OPTS = dict(pre_sweeps=2, post_sweeps=1, coarse_direct_max_dof=64)
HIST_ATOL = 1e-12


@functools.lru_cache(maxsize=None)
def solvers(**kw):
    """(JAX solver, port solver, f, exact) on the n=8 test mesh, all f64
    unless ``precond="f32"``."""
    jh, th = hierarchies()
    kw = dict(kw)
    pdt = kw.pop("precond", "f64")
    gkw = dict(OPTS, **dict(kw.pop("gmg", ())))
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, precond_dtype=jnp.float32 if pdt == "f32" else jnp.float64,
        gmg=jgmg.CycleOpts(**gkw), **kw))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, precond_dtype=torch.float32 if pdt == "f32" else torch.float64,
        gmg=tgmg.CycleOpts(**gkw), **kw), device="cpu")
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    return js, ts, f, exact


def test_volume_weight_equal():
    js, ts, _, _ = solvers()
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        a, b = np.asarray(js._volume_weight(jdt)), ts._volume_weight(tdt).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert abs(float(b.mean()) - 1.0) <= 1e-6


def _hist_close(jhist, thist, iters):
    jh = np.asarray(jhist)[: iters + 1]
    th = np.asarray(thist)[: iters + 1]
    assert jh.shape == th.shape and th[0] > 0
    assert np.abs(jh - th).max() <= HIST_ATOL * jh[0], np.abs(jh - th).max() / jh[0]


# name -> (reference call, port call); each gets (A, b, M, weight)
METHODS = {
    "cg": (lambda A, b, M, w: jkrylov.cg(A, b, M=M, tol=1e-10, max_iter=100),
           lambda A, b, M, w: tkrylov.cg(A, b, M=M, tol=1e-10, max_iter=100)),
    "cg-weighted": (lambda A, b, M, w: jkrylov.cg(A, b, M=M, tol=1e-10, max_iter=100, weight=w),
                    lambda A, b, M, w: tkrylov.cg(A, b, M=M, tol=1e-10, max_iter=100, weight=w)),
    "richardson": (lambda A, b, M, w: jkrylov.richardson(A, b, M=M, tol=1e-10, max_iter=60),
                   lambda A, b, M, w: tkrylov.richardson(A, b, M=M, tol=1e-10, max_iter=60)),
    "richardson-capped": (lambda A, b, M, w: jkrylov.richardson(A, b, M=M, tol=1e-10, max_iter=4),
                          lambda A, b, M, w: tkrylov.richardson(A, b, M=M, tol=1e-10, max_iter=4)),
    "residual_history": (
        lambda A, b, M, w: jkrylov.residual_history(A, b, M=M, tol=1e-10, max_iter=40),
        lambda A, b, M, w: tkrylov.residual_history(A, b, M=M, tol=1e-10, max_iter=40)),
    "cg_history-weighted": (
        lambda A, b, M, w: jkrylov.cg_history(A, b, M=M, tol=1e-10, max_iter=40, weight=w),
        lambda A, b, M, w: tkrylov.cg_history(A, b, M=M, tol=1e-10, max_iter=40, weight=w)),
    "cg_history-capped": (
        lambda A, b, M, w: jkrylov.cg_history(A, b, M=M, tol=1e-10, max_iter=5),
        lambda A, b, M, w: tkrylov.cg_history(A, b, M=M, tol=1e-10, max_iter=5)),
    "gmres-history": (
        lambda A, b, M, w: jkrylov.gmres(A, b, M=M, tol=1e-10, restart=4, max_iter=100,
                                         history=True),
        lambda A, b, M, w: tkrylov.gmres(A, b, M=M, tol=1e-10, restart=4, max_iter=100,
                                         history=True)),
    "gmres-history-unpreconditioned": (
        lambda A, b, M, w: jkrylov.gmres(A, b, tol=1e-8, restart=20, max_iter=300,
                                         history=True),
        lambda A, b, M, w: tkrylov.gmres(A, b, tol=1e-8, restart=20, max_iter=300,
                                         history=True)),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_krylov_matches_reference(name):
    js, ts, f, _ = solvers()
    jcall, tcall = METHODS[name]
    jw, tw = js._volume_weight(jnp.float64), ts._volume_weight(torch.float64)
    jout = jax.jit(lambda b: jcall(js.fine_level.apply, b, js.gmg.apply, jw))(jnp.asarray(f))
    tout = tcall(ts.fine_level.apply, torch.from_numpy(f), ts.gmg.apply, tw)
    if isinstance(tout, tkrylov.KrylovResult):
        jout, tout = (jout, None), (tout, None)
    (jres, jhist), (tres, thist) = jout, tout
    assert tres.iterations == int(jres.iterations)
    assert rel_err(jres.x, tres.x) <= 1e-10
    assert abs(float(tres.r0_norm) - float(jres.r0_norm)) <= 1e-14 * float(jres.r0_norm)
    assert (abs(float(tres.residual_norm) - float(jres.residual_norm))
            <= HIST_ATOL * float(jres.r0_norm))
    if thist is not None:
        if name.startswith("gmres"):  # the reference's slots, zeros included
            assert thist.shape == np.asarray(jhist).shape
        _hist_close(jhist, thist, tres.iterations)


@pytest.mark.parametrize("name", ["cg", "richardson", "residual_history", "cg_history"])
def test_unpreconditioned_on_a_small_spectrum(name):
    """``M=None`` on a diagonal operator with three eigenvalues in (0, 2):
    CG ends in three iterations, Richardson contracts by 0.4 a step."""
    rng = np.random.default_rng(5)
    d = rng.choice([0.6, 1.0, 1.4], size=(6, 4, 4))
    b = rng.standard_normal((6, 4, 4))
    w = rng.uniform(0.5, 2.0, size=(6, 1, 1))
    kw = {"weight": w} if name.startswith("cg") else {}
    jout = getattr(jkrylov, name)(lambda x: jnp.asarray(d) * x, jnp.asarray(b), tol=1e-12,
                                  max_iter=60, **{k: jnp.asarray(v) for k, v in kw.items()})
    tout = getattr(tkrylov, name)(lambda x: torch.from_numpy(d) * x, torch.from_numpy(b),
                                  tol=1e-12, max_iter=60,
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    if isinstance(tout, tkrylov.KrylovResult):
        jout, tout = (jout, None), (tout, None)
    (jres, jhist), (tres, thist) = jout, tout
    assert tres.iterations == int(jres.iterations) <= (4 if "cg" in name else 40)
    assert rel_err(jres.x, tres.x) <= 1e-12
    if thist is not None:
        _hist_close(jhist, thist, tres.iterations)


def test_cg_stops_at_once_on_a_zero_rhs():
    """``r0 = 0``: the stop test is ``nan > tol^2`` = False, as in the
    reference's while_loop; Richardson likewise."""
    A = lambda x: 2.0 * x  # noqa: E731
    for jf, tf in ((jkrylov.cg, tkrylov.cg), (jkrylov.richardson, tkrylov.richardson)):
        jres = jf(A, jnp.zeros((3, 4, 4)), tol=1e-8)
        tres = tf(A, torch.zeros(3, 4, 4, dtype=torch.float64), tol=1e-8)
        assert int(jres.iterations) == tres.iterations == 0
        assert not tres.x.any()


@pytest.mark.parametrize("method", [tkrylov.cg, tkrylov.richardson])
def test_initial_guess(method):
    """With ``x0`` the residual starts at ``b - A x0``; from the exact
    solution no iteration runs."""
    js, ts, f, _ = solvers()
    A, b = ts.fine_level.apply, torch.from_numpy(f)
    x = tkrylov.cg(A, b, M=ts.gmg.apply, tol=1e-12, max_iter=100).x
    res = method(A, A(x), x0=x, M=ts.gmg.apply, tol=1e-8, max_iter=10)
    assert res.iterations == 0 and torch.equal(res.x, x)


# (krylov, schur preconditioner or "composite")
MONITORED = [("bicgstab", "composite"), ("cg", "composite"), ("gmres", "composite"),
             ("bicgstab", "gmg"), ("cg", None), ("gmres", "cheb"), ("bicgstab", "blockjacobi")]


@pytest.mark.parametrize("krylov,target", MONITORED,
                         ids=[f"{k}-{p}" for k, p in MONITORED])
def test_solve_monitored_matches_reference(krylov, target):
    js, ts, f, _ = solvers(krylov=krylov)
    schur = target != "composite"
    prec = target if schur else None
    ju, jres, jhist = js.solve_monitored(jnp.asarray(f), max_iter=200, schur=schur,
                                         schur_preconditioner=prec)
    tu, tres, thist = ts.solve_monitored(torch.from_numpy(f), max_iter=200, schur=schur,
                                         schur_preconditioner=prec)
    assert tres.iterations == int(jres.iterations) < 200
    assert len(thist) == len(jhist) == tres.iterations + 1
    assert thist[0] == 1.0 and thist[-1] <= 1e-10
    assert np.abs(np.asarray(jhist) - thist).max() <= HIST_ATOL
    assert rel_err(ju, tu) <= 1e-10


@pytest.mark.parametrize("inner", ["cg", "richardson"])
def test_solve_refined_inner_methods(inner):
    """Mixed-precision IR with inner CG (volume-weighted, f32) and inner
    Richardson: outer rounds exactly, inner iterations within one (f32
    inner solves), the solution to 1e-9."""
    js, ts, f, exact = solvers(precond="f32", inner_krylov=inner,
                               gmg=(("fac_smoothing", "active"),))
    ju, jinfo = js.solve_refined(jnp.asarray(f), tol=1e-10, inner_tol=1e-4)
    tu, tinfo = ts.solve_refined(torch.from_numpy(f), tol=1e-10, inner_tol=1e-4)
    assert tinfo["outer_iterations"] == jinfo["outer_iterations"]
    assert abs(tinfo["inner_iterations"] - jinfo["inner_iterations"]) <= 1
    assert tinfo["residual"] <= 1e-10
    assert len(tinfo["outer_history"]) == tinfo["outer_iterations"] + 1
    assert rel_err(ju, tu) <= 1e-9
    jrep = js.report(ju, jnp.asarray(f), jnp.asarray(exact))
    trep = ts.report(tu, torch.from_numpy(f), exact)
    assert abs(trep["error"] - jrep["error"]) <= 1e-6 * jrep["error"]

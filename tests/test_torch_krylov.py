"""GMRES, the Chebyshev and Schwarz preconditioners, and the solves that
select them, in the port against the JAX reference on the CPU:
``krylov.gmres`` on small dense systems, ``precond.poly_cheb``, and
``solve`` with Schwarz and GMRES (``solvers`` and ``_compare`` also serve
``test_torch_schur_solve.py``).

Meshes and walls as in ``test_torch_schur.py``.  Solves: tol 1e-10, f64
Krylov, an f32 V(2,1) FAC cycle where GMG is used.  Iterations match the
reference's within one, but see ``BAND``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.krylov as jkrylov
import pressurepoissonsolver_tpu.precond as jprecond
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.precond as tprecond
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import rel_err
from test_torch_schur import WALLS, hierarchies, levels

GMG = chip_smoke.SCHUR_SMALL_GMG
# iterations of BiCGStab with no or a one-sweep preconditioner move with
# rounding (test_weak_bicgstab_counts_move_with_rounding): held within 3
BAND = {None: 3, "schwarz": 3}


# --- GMRES on dense systems (the reference's test_solve.py cases) --------


def _dense_case(name):
    """(A, b, M or None, restart, max_iter) as numpy arrays."""
    if name == "random":
        rng = np.random.default_rng(3)
        A = np.eye(40) + 0.1 * rng.standard_normal((40, 40))
        return A, rng.standard_normal(40), None, 15, 200
    if name == "preconditioned":
        rng = np.random.default_rng(4)
        A = np.diag(np.linspace(1.0, 50.0, 30)) + 0.5 * rng.standard_normal((30, 30))
        return A, rng.standard_normal(30), np.diag(1.0 / np.diag(A)), 10, 300
    if name == "identity":  # a lucky breakdown at the first column
        return 3.0 * np.eye(12), np.arange(1.0, 13.0), None, 5, 50
    if name == "zero_rhs":
        return np.eye(8) + 0.1 * np.ones((8, 8)), np.zeros(8), None, 4, 20
    if name == "degenerate":  # A b = 0: every cycle's first column is zero
        return np.array([[0.0, 1.0], [0.0, 0.0]]), np.array([1.0, 0.0]), None, 2, 5
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "preconditioned", "identity", "zero_rhs",
                                  "degenerate"])
def test_gmres_matches_reference(name):
    A, b, Minv, restart, max_iter = _dense_case(name)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    jM = None if Minv is None else (lambda v: jnp.asarray(Minv) @ v)
    tM = None if Minv is None else (lambda v: torch.from_numpy(Minv) @ v)
    jres = jkrylov.gmres(lambda v: jA @ v, jnp.asarray(b), M=jM, tol=1e-12,
                         restart=restart, max_iter=max_iter)
    tres = tkrylov.gmres(lambda v: tA @ v, torch.from_numpy(b), M=tM, tol=1e-12,
                         restart=restart, max_iter=max_iter)
    assert tres.iterations == int(jres.iterations)
    x = tres.x.numpy()
    if name == "zero_rhs":
        assert tres.iterations == 0 and not x.any()
        return
    if name == "degenerate":  # no column is taken; one count per cycle
        assert tres.iterations == max_iter and not x.any()
        return
    assert np.abs(x - np.asarray(jres.x)).max() <= 1e-10 * np.abs(x).max()
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)
    assert float(tres.residual_norm) <= 1e-12 * float(tres.r0_norm)


def test_gmres_rejects_a_non_finite_update():
    """A preconditioner that returns NaN: each cycle's update is rejected,
    the iterate stays at zero and the count still reaches max_iter."""
    res = tkrylov.gmres(lambda v: 2.0 * v, torch.ones(6, dtype=torch.float64),
                        M=lambda v: v * float("nan"), tol=1e-12, restart=3, max_iter=7)
    jres = jkrylov.gmres(lambda v: 2.0 * v, jnp.ones(6), M=lambda v: v * jnp.nan,
                         tol=1e-12, restart=3, max_iter=7)
    assert res.iterations == int(jres.iterations) == 9
    assert not res.x.any() and not np.asarray(jres.x).any()
    assert float(res.residual_norm) == float(jres.residual_norm)


# --- the Chebyshev polynomial preconditioner ------------------------------


@pytest.mark.parametrize("D,walls", [(D, w) for D in (2, 3) for w in WALLS],
                         ids=[f"{D}d-{w}" for D in (2, 3) for w in WALLS])
def test_poly_cheb_matches_reference(D, walls):
    jl, tl = levels(D, walls, "f64")
    g = np.random.default_rng(8).standard_normal((tl.num_ifaces, tl.m))
    ref = jax.jit(jprecond.poly_cheb(jl))(jnp.asarray(g))
    got = tprecond.poly_cheb(tl)(torch.from_numpy(g))
    assert rel_err(ref, got) <= 1e-12
    assert tprecond.CHEB_COEFFS == jprecond.CHEB_COEFFS
    assert tprecond.CHEB_INTERVAL == jprecond.CHEB_INTERVAL


# --- solves --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def solvers(D, walls, **kw):
    """(JAX solver, port solver, JAX f, port f, exact) on the test mesh;
    f shifted to zero mean with all-Neumann walls."""
    jh, th = hierarchies(D, walls)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", D))
    kw = dict(kw)
    pdt = kw.pop("precond", "f32")
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64,
        precond_dtype=jnp.float32 if pdt == "f32" else jnp.float64,
        gmg=jgmg.CycleOpts(**GMG), **kw))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, dtype=torch.float64,
        precond_dtype=torch.float32 if pdt == "f32" else torch.float64,
        gmg=tgmg.CycleOpts(**GMG), **kw), device="cpu")
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    if walls == "neumann":
        jf = jsolver.shift_for_neumann(js.fine_level, jf)
        tf = tsolver.shift_for_neumann(ts.fine_level, tf)
    return js, ts, jf, tf, exact


def _compare(js, ts, jf, tf, exact, ju, jres, tu, tres, walls, band=1):
    """Iterations within ``band``; the composite residual <= tol, or, for a
    Schur solve (which stops on the interface residual), no more than
    twice the reference's; report errors within 1e-6 of each other
    (relative); u within 1e-8 (modulo a constant with all-Neumann
    walls)."""
    assert abs(int(jres.iterations) - tres.iterations) <= band
    neumann = walls == "neumann"
    jrep = js.report(ju, jf, jnp.asarray(exact), neumann=neumann)
    trep = ts.report(tu, tf, exact, neumann=neumann)
    assert trep["residual"] <= max(1e-10, 2 * jrep["residual"])
    assert abs(trep["error"] - jrep["error"]) <= 1e-6 * jrep["error"]
    ju, tu = np.asarray(ju), tu.numpy()
    if neumann:
        ju, tu = ju - ju.mean(), tu - tu.mean()
    assert np.abs(ju - tu).max() <= 1e-8 * np.abs(ju).max()
    return int(jres.iterations), tres.iterations


# the 2D Dirichlet Schwarz and "bcgs" solves are in test_torch_schur_solve
SOLVE_CASES = ([(2, "mixed", kw) for kw in ("schwarz", "gmres-schwarz", "gmres-gmg")]
               + [(3, "dirichlet", kw) for kw in ("schwarz", "gmres-schwarz", "gmres-gmg")]
               + [(3, "neumann", "gmres-schwarz")])
SOLVE_KW = {"schwarz": dict(preconditioner="schwarz"),
            "gmres-schwarz": dict(preconditioner="schwarz", krylov="gmres"),
            "gmres-gmg": dict(krylov="gmres"),
            "bcgs": dict(patch_solver="bcgs", precond="f64")}


@pytest.mark.parametrize("D,walls,kw", SOLVE_CASES,
                         ids=[f"{D}d-{w}-{k}" for D, w, k in SOLVE_CASES])
def test_solve_with_schwarz_and_gmres_matches_reference(D, walls, kw):
    js, ts, jf, tf, exact = solvers(D, walls, **SOLVE_KW[kw])
    jres, tres = js.solve(jf, max_iter=300), ts.solve(tf, max_iter=300)
    band = BAND["schwarz"] if kw == "schwarz" else 1
    _compare(js, ts, jf, tf, exact, jres.x, jres, tres.x, tres, walls, band)


def test_weak_bicgstab_counts_move_with_rounding():
    """Why ``BAND``: perturbing f by 1e-14 of itself moves the count of
    the Schwarz-preconditioned BiCGStab solve (the reference takes 35),
    while the GMG-preconditioned Schur solve keeps its count."""
    _, ts, _, tf, _ = solvers(2, "dirichlet", preconditioner="schwarz")
    _, tg, _, _, _ = solvers(2, "dirichlet")
    rng = np.random.default_rng(0)
    counts, gmg_counts = set(), set()
    for _ in range(4):
        fp = tf * (1 + 1e-14 * torch.from_numpy(rng.standard_normal(tuple(tf.shape))))
        counts.add(ts.solve(fp, max_iter=300).iterations)
        gmg_counts.add(tg.solve_schur(fp, tol=1e-10, max_iter=60,
                                      preconditioner="gmg")[1].iterations)
    assert len(counts) > 1 and max(counts) - min(counts) <= 2 * BAND["schwarz"]
    assert gmg_counts == {chip_smoke.SCHUR_SMALL_ITERS["gmg"]}

"""The slice end to end on the CPU: the port's solves against the JAX
reference on the n=8 test mesh (refined_tree(2, 4, 2): 6 levels, FAC
active-set smoothing on levels 1-2).  The reference's mesh and right-hand
side reach the port through a checkpoint the reference wrote.

Measured with the reference: 3 outer / 7 inner iterations, residual
1.5e-14, error 9.152e-4."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.checkpoint as jckpt
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.krylov as jkrylov
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.checkpoint as tckpt
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import hierarchies

GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
           coarse_direct_max_dof=64)


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def refined(tmp_path_factory):
    """Mixed-precision IR solve by both packages; the port's inputs come
    from a checkpoint written by the reference."""
    jh, _ = hierarchies()
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    path = str(tmp_path_factory.mktemp("ckpt") / "state.npz")
    jckpt.save_checkpoint(path, jh.tree, jh.n, {"f": f, "exact": exact})
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32,
        gmg=jgmg.CycleOpts(**GMG)))
    ju, jinfo = js.solve_refined(jnp.asarray(f), tol=1e-10, inner_tol=1e-4)
    jrep = js.report(ju, jnp.asarray(f), jnp.asarray(exact))

    tree, n, arrays, _ = tckpt.load_checkpoint(path)
    th = tdomain.DomainHierarchy(tree, n=n)
    state = tckpt.state_to_torch(arrays, device="cpu", dtype=torch.float64)
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
        gmg=tgmg.CycleOpts(**GMG)), device="cpu")
    tu, tinfo = ts.solve_refined(state["f"], tol=1e-10, inner_tol=1e-4)
    trep = ts.report(tu, state["f"], state["exact"])
    return (np.asarray(ju), jinfo, jrep), (tu, tinfo, trep)


def test_solve_refined_iterations(refined):
    (_, jinfo, _), (_, tinfo, _) = refined
    assert jinfo["outer_iterations"] == tinfo["outer_iterations"] == 3
    assert (abs(jinfo["inner_iterations"] - tinfo["inner_iterations"])
            <= tinfo["outer_iterations"])
    assert len(tinfo["outer_history"]) == tinfo["outer_iterations"] + 1


def test_solve_refined_solution(refined):
    (ju, _, jrep), (tu, tinfo, trep) = refined
    assert tu.dtype == torch.float64 and tuple(tu.shape) == ju.shape
    assert tinfo["residual"] <= 1e-10 and trep["residual"] <= 1e-10
    assert _rel(ju, tu) <= 1e-9
    assert abs(trep["error"] - jrep["error"]) <= 1e-6 * jrep["error"]
    assert abs(trep["error"] - 9.152e-4) <= 1e-3 * 9.152e-4


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_solve_all_f64_default_options(neumann):
    """``solve`` with the default (all-f64) options; the all-Neumann case
    exercises the DC pin of the spectral solves, the pseudo-inverse coarse
    solve and the nullspace shift (with a 64-DOF coarse level: the default
    4096-DOF pseudo-inverse costs seconds of SVD on each side)."""
    jh, th = hierarchies(neumann)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    cd = {"coarse_direct_max_dof": 64} if neumann else {}
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, gmg=jgmg.CycleOpts(**cd)))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, gmg=tgmg.CycleOpts(**cd)), device="cpu")
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    if neumann:
        jf = jsolver.shift_for_neumann(js.fine_level, jf)
        tf = tsolver.shift_for_neumann(ts.fine_level, tf)
        assert _rel(jf, tf) <= 1e-14
    jres, tres = js.solve(jf), ts.solve(tf)
    assert abs(int(jres.iterations) - tres.iterations) <= 1
    jrep = js.report(jres.x, jf, jnp.asarray(exact), neumann=neumann)
    trep = ts.report(tres.x, tf, exact, neumann=neumann)
    assert trep["residual"] <= 1e-10
    assert abs(trep["error"] - jrep["error"]) <= 1e-6 * jrep["error"]
    if not neumann:  # with Neumann walls u is fixed only up to a constant
        assert _rel(jres.x, tres.x) <= 1e-8


def test_bicgstab_zero_rhs_stops_at_once():
    """``r0 = 0``: the stop test is ``nan > tol`` = False, as in the
    reference's while_loop."""
    A = lambda x: 2.0 * x  # noqa: E731
    jres = jkrylov.bicgstab(A, jnp.zeros((3, 4, 4)), tol=1e-8)
    tres = tkrylov.bicgstab(A, torch.zeros(3, 4, 4, dtype=torch.float64), tol=1e-8)
    assert int(jres.iterations) == tres.iterations == 0
    assert not tres.x.any()


def test_bicgstab_breakdown_guard():
    """A zero operator makes every denominator zero: ``_safe_div`` stalls
    the iteration (x stays finite) instead of producing NaN."""
    A = lambda x: 0.0 * x  # noqa: E731
    b = torch.ones(2, 4, 4, dtype=torch.float32)
    res = tkrylov.bicgstab(A, b, tol=1e-6, max_iter=5)
    jres = jkrylov.bicgstab(A, jnp.ones((2, 4, 4), dtype=jnp.float32), tol=1e-6,
                            max_iter=5)
    assert res.iterations == int(jres.iterations) == 5
    assert bool(torch.isfinite(res.x).all())
    assert np.array_equal(np.asarray(jres.x), res.x.numpy())


def test_unported_solver_options_raise():
    """Every option of the reference is ported (``comm="pjit"`` without a
    mesh is the plain solver, as there); unknown option values raise; CG
    falls back to BiCGStab under the quadratic closures, as in the
    reference."""
    _, th = hierarchies()
    s = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        comm="pjit", gmg=tgmg.CycleOpts(coarse_direct_max_dof=64)), device="cpu")
    assert s._op is s.fine_level
    for kw in ({"krylov": "minres"}, {"inner_krylov": "gmres"},
               {"iface_scheme": "cubic"}, {"preconditioner": "ilu"},
               {"comm": "mpi"}):
        with pytest.raises(ValueError):
            tsolver.PoissonSolver(th, tsolver.SolveOptions(**kw), device="cpu")
    s = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        krylov="cg", inner_krylov="cg", iface_scheme="quadratic",
        gmg=tgmg.CycleOpts(coarse_direct_max_dof=64)), device="cpu")
    assert (s.opts.krylov, s.opts.inner_krylov) == ("bicgstab", "bicgstab")
    assert s.fine_level.face_depth == 2

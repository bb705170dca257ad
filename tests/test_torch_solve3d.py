"""The 3D slice end to end on the CPU: the port's solves against the JAX
reference.

``solve_refined`` runs with the options of ``scripts/bench3d.py`` (f64
iterative refinement around f32 BiCGStab, V(1,1) with full FAC smoothing,
``coarse_direct_max_dof=4096``, ``inner_tol=1e-5``) on the small mesh of
the 3D bench's generated tree, ``refined_tree(3, 3, 2)`` at n=8 (78
patches, 39,936 DOF; the 8-patch level is the dense coarse solve).
Measured with the reference: 2 outer / 7 inner iterations, residual
1.02e-11, error 5.739378412e-4.  Both packages take their Kronecker
spectral and transfer forms at n <= 16, but their f32 sums run in another
order, so the f32 inner solves differ in rounding: inner iterations may
differ by one, and the f64 solutions agree to 1e-9 relative, not to
round-off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import hierarchies


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def refined():
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(3, 3, 2), n=8, use_native=False)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(3, 3, 2), n=8)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 3))
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32))
    ju, jinfo = js.solve_refined(jnp.asarray(f), tol=1e-10)
    jrep = js.report(ju, jnp.asarray(f), jnp.asarray(exact))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32), device="cpu")
    tu, tinfo = ts.solve_refined(f, tol=1e-10)
    trep = ts.report(tu, f, exact)
    return (np.asarray(ju), jinfo, jrep), (tu, tinfo, trep, ts)


def test_solve_refined_3d_iterations(refined):
    (_, jinfo, _), (_, tinfo, _, ts) = refined
    assert [l.P for l in ts.gmg.levels] == [78, 71, 64, 8]
    assert ts.gmg._coarse_inv is not None and ts.gmg._coarse_inv.shape == (4096, 4096)
    assert jinfo["outer_iterations"] == tinfo["outer_iterations"] == 2
    assert abs(jinfo["inner_iterations"] - tinfo["inner_iterations"]) <= 1
    assert len(tinfo["outer_history"]) == tinfo["outer_iterations"] + 1


def test_solve_refined_3d_solution(refined):
    (ju, _, jrep), (tu, tinfo, trep, _) = refined
    assert tu.dtype == torch.float64 and tuple(tu.shape) == ju.shape == (78, 8, 8, 8)
    assert tinfo["residual"] <= 1e-10 and trep["residual"] <= 1e-10
    assert _rel(ju, tu) <= 1e-9
    assert abs(trep["error"] - jrep["error"]) <= 1e-6 * jrep["error"]
    assert abs(trep["error"] - 5.739378412e-4) <= 1e-6 * 5.739378412e-4


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_solve_3d_all_f64(neumann):
    """``solve`` in f64 on the n=4 mesh with a 64-DOF dense bottom; the
    all-Neumann case runs the 3D DC pin, the pseudo-inverse coarse solve
    and the nullspace shift."""
    jh, th = hierarchies(neumann, D=3)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 3))
    gmg = {"coarse_direct_max_dof": 64}
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(tol=1e-10, gmg=jgmg.CycleOpts(**gmg)))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(tol=1e-10, gmg=tgmg.CycleOpts(**gmg)),
                               device="cpu")
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

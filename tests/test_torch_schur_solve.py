"""``PoissonSolver.solve_schur`` in the port against the JAX reference on
the CPU: every preconditioner (None, "cheb", "blockjacobi", "gmg") and both
Krylov methods in 2D and 3D, with Dirichlet, all-Neumann (f shifted to
zero mean) and mixed walls; and ``chip_smoke.py``'s small-mesh reference
numbers (Schur runs, the Schwarz and ``"bcgs"`` solves) held to the
reference.  Meshes, options and checks as in ``test_torch_krylov.py``."""

import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.solver as tsolver

from test_torch_krylov import BAND, SOLVE_KW, _compare, solvers

# the 2D Dirichlet bicgstab runs and the GMRES ones without and with GMG
# are test_chip_smoke_small_mesh_numbers' cases
SCHUR_CASES = (
    [(2, "dirichlet", "gmres", p) for p in ("cheb", "blockjacobi")]
    + [(3, "dirichlet", kr, p) for kr in ("bicgstab", "gmres")
       for p in (None, "cheb", "blockjacobi", "gmg")]
    + [(D, w, kr, p) for D in (2, 3) for w in ("neumann", "mixed")
       for kr, p in (("bicgstab", "gmg"), ("gmres", None))]
)


@pytest.mark.parametrize("D,walls,krylov,prec", SCHUR_CASES,
                         ids=[f"{D}d-{w}-{k}-{p}" for D, w, k, p in SCHUR_CASES])
def test_solve_schur_matches_reference(D, walls, krylov, prec):
    js, ts, jf, tf, exact = solvers(D, walls, krylov=krylov)
    ju, jres = js.solve_schur(jf, tol=1e-10, max_iter=300, preconditioner=prec)
    tu, tres = ts.solve_schur(tf, tol=1e-10, max_iter=300, preconditioner=prec)
    band = BAND.get(prec, 1) if krylov == "bicgstab" else 1
    _compare(js, ts, jf, tf, exact, ju, jres, tu, tres, walls, band)
    if prec is not None:  # the preconditioner is built once and kept
        M = ts._schur_M[prec]
        ts.solve_schur(tf, tol=1e-10, max_iter=60, preconditioner=prec)
        assert ts._schur_M[prec] is M



SMALL = [("none", {}, None), ("cheb", {}, "cheb"), ("blockjacobi", {}, "blockjacobi"),
         ("gmg", {}, "gmg"), ("gmres-none", {"krylov": "gmres"}, None),
         ("gmres-gmg", {"krylov": "gmres"}, "gmg"),
         ("schwarz", SOLVE_KW["schwarz"], False), ("bcgs", SOLVE_KW["bcgs"], False)]


@pytest.mark.parametrize("key,kw,prec", SMALL, ids=[k for k, _, _ in SMALL])
def test_chip_smoke_small_mesh_numbers(key, kw, prec):
    """The reference's iterations and error on the small Schur mesh (2D,
    Dirichlet) are ``chip_smoke.py``'s constants; the port's run agrees
    with the reference's and stays within ``chip_smoke.SCHUR_SMALL_BAND``
    of its count."""
    js, ts, jf, tf, exact = solvers(2, "dirichlet", **kw)
    if prec is False:
        jres, tres = js.solve(jf, max_iter=300), ts.solve(tf, max_iter=300)
        ju, tu = jres.x, tres.x
    else:
        ju, jres = js.solve_schur(jf, tol=1e-10, max_iter=60, preconditioner=prec)
        tu, tres = ts.solve_schur(tf, tol=1e-10, max_iter=60, preconditioner=prec)
    assert int(jres.iterations) == chip_smoke.SCHUR_SMALL_ITERS[key]
    band = chip_smoke.SCHUR_SMALL_BAND.get(key, 0)
    _compare(js, ts, jf, tf, exact, ju, jres, tu, tres, "dirichlet", band)
    err = js.report(ju, jf, jnp.asarray(exact))["error"]
    assert abs(err - chip_smoke.SCHUR_SMALL_ERROR) <= 1e-6 * err


def test_chip_smoke_small_3d_schur_numbers():
    """The small 3D Schur solve of ``chip_smoke.py`` (n=8, the small 3D
    solve's options) against the reference's numbers."""
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(3, 3, 2), n=8, use_native=False)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(3, 3, 2), n=8)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 3))
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32), device="cpu")
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    ju, jres = js.solve_schur(jf, tol=1e-10, max_iter=60, preconditioner="gmg")
    tu, tres = ts.solve_schur(tf, tol=1e-10, max_iter=60, preconditioner="gmg")
    assert int(jres.iterations) == chip_smoke.SCHUR3D_SMALL_ITERS
    assert abs(tres.iterations - chip_smoke.SCHUR3D_SMALL_ITERS) <= 1
    for s, u, ff in ((js, ju, jf), (ts, tu, tf)):
        err = s.report(u, ff, jnp.asarray(exact) if s is js else exact)["error"]
        assert abs(err - chip_smoke.SCHUR3D_SMALL_ERROR) <= 1e-6 * err

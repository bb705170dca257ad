"""The port's monitored BiCGStab and CG (``krylov.residual_history_loop``,
``cg_history_loop``: the history in a device buffer written per step, read
once with the count) on the CPU against the JAX package's
``residual_history`` and ``cg_history`` on the same numpy inputs: the
count, and the history up to it at 1e-10 of ||r0||.  Then
``solve_monitored`` (BiCGStab, CG, and the Schur form) through the
emulated capture of ``tests/test_torch_graphs.py`` against the eager
solve (bit for bit, the history equal; the Schur form against the JAX
package's too), with every piece run with the host reads of a tensor
refused; and the CLI's ``--matrix-type crs`` and ``pbm`` solves through
``_run_loop`` (the solver's one-launch path, emulated) against the JAX
CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.krylov as jkrylov
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.krylov as tkrylov
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import hierarchies
from test_torch_cli import BASE2, compare_runs, meshes, outputs_equal, run_both  # noqa: F401
from test_torch_gmres_loop import _no_host_reads, _pieces
from test_torch_graphs import emulated  # noqa: F401 (the emulated capture)


@pytest.fixture(scope="module")
def composite():
    """The f64 composite operator, V-cycle and volume weight of the small
    test mesh in both packages, and a seeded right-hand side."""
    jh, th = hierarchies()
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(tol=1e-10))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(tol=1e-10), device="cpu")
    rng = np.random.default_rng(13)
    b = rng.standard_normal((ts.fine_level.P,) + ts.fine_level.pl.ns_shape)
    w = ts._volume_weight(torch.float64)
    return js, ts, b, w


def _reference(js, b, method, w, max_iter):
    jb = jnp.asarray(b)
    if method == "bicgstab":
        return jkrylov.residual_history(js.fine_level.apply, jb, M=js.gmg.apply, tol=1e-10,
                                        max_iter=max_iter)
    return jkrylov.cg_history(js.fine_level.apply, jb, M=js.gmg.apply, tol=1e-10,
                              max_iter=max_iter, weight=jnp.asarray(w.numpy()))


def _loop(ts, method, w, max_iter):
    if method == "bicgstab":
        return tkrylov.residual_history_loop(ts.fine_level.apply, ts.gmg.apply, None,
                                             max_iter + 1)
    return tkrylov.cg_history_loop(ts.fine_level.apply, ts.gmg.apply, w, None, max_iter + 1)


@pytest.mark.parametrize("method", ["bicgstab", "cg"])
def test_monitored_loops_match_reference(composite, method):
    """GMG-preconditioned monitored BiCGStab and weighted CG, converged
    (60 steps allowed) and stopped by the step limit (3): the reference's
    count, iterate (1e-10 of max|x|) and history (1e-10 of ||r0||; the
    reference's history of 60 trips holds the 3-step run's as its prefix);
    the eager functions give the loop's result."""
    js, ts, b, w = composite
    jres, jhist = _reference(js, b, method, w, 60)
    jhist, r0 = np.asarray(jhist), float(jres.r0_norm)
    for max_iter in (60, 3):
        res, hist = tkrylov.solve_loop(_loop(ts, method, w, max_iter), torch.from_numpy(b),
                                       1e-10, max_iter)
        k = res.iterations
        assert hist.shape == (k + 1,) and hist.dtype == np.float64
        assert np.abs(jhist[:k + 1] - hist).max() <= 1e-10 * r0
        if max_iter == 3:
            assert k == 3 < int(jres.iterations)
            continue
        assert k == int(jres.iterations)
        x = res.x.numpy()
        assert np.abs(x - np.asarray(jres.x)).max() <= 1e-10 * np.abs(x).max()
        if method == "bicgstab":
            eres, ehist = tkrylov.residual_history(ts.fine_level.apply, torch.from_numpy(b),
                                                   M=ts.gmg.apply, tol=1e-10,
                                                   max_iter=max_iter)
        else:
            eres, ehist = tkrylov.cg_history(ts.fine_level.apply, torch.from_numpy(b),
                                             M=ts.gmg.apply, tol=1e-10, max_iter=max_iter,
                                             weight=w)
        assert eres.iterations == k and torch.equal(eres.x, res.x)
        assert np.array_equal(ehist, hist)


@pytest.mark.parametrize("method", ["bicgstab", "cg"])
def test_monitored_pieces_make_no_host_read(composite, monkeypatch, method):
    """The init and the step of each monitored loop, run with every host
    read of a tensor refused, give the eager loop's first step."""
    _, ts, b, w = composite
    loop = _loop(ts, method, w, 10)
    ref = loop.step(loop.init(torch.from_numpy(b), 1e-10, 10))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        state = loop.init(torch.from_numpy(b), 1e-10, 10)
        for piece in _pieces(tkrylov.program(loop)):
            state = piece(state)
    assert torch.equal(state.x, ref.x) and torch.equal(state.hist, ref.hist)
    assert int(state.k) == 1 and float(state.hist[1]) > 0


MONITORED = {"bicgstab": ("bicgstab", False), "cg": ("cg", False),
             "schur-bicgstab": ("bicgstab", True)}


@pytest.mark.parametrize("case", list(MONITORED))
def test_solve_monitored_through_the_capture(emulated, monkeypatch, case):  # noqa: F811
    """``solve_monitored`` eagerly and through the emulated capture (under
    the key ``("monitored", method, schur, prec, max_iter)``): the same
    count, iterate bit for bit and history; every piece of the captured
    program with the host reads of a tensor refused.  The Schur form (its
    right-hand side and recovery inside the program) is held to the JAX
    package's count, history (1e-10) and field; the composite loops are
    held to it above."""
    method, schur = MONITORED[case]
    jh, th = hierarchies()
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(tol=1e-10, krylov=method),
                               device="cpu")
    f = np.random.default_rng(17).standard_normal((ts.fine_level.P,) + ts.fine_level.pl.ns_shape)
    prec = "blockjacobi" if schur else None
    out = {}
    for mode in (False, True, True):
        ts._graphs = mode
        out.setdefault(mode, []).append(ts.solve_monitored(
            torch.from_numpy(f), max_iter=80, schur=schur, schur_preconditioner=prec))
    (ue, re, he), = out[False]
    for u, res, hist in out[True]:
        assert res.iterations == re.iterations and torch.equal(u, ue)
        assert np.array_equal(hist, he)
    assert list(ts._captured) == [("monitored", method, schur, prec, 80)]
    assert len(he) == re.iterations + 1
    if schur:
        js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(tol=1e-10, krylov=method))
        ju, jres, jhist = js.solve_monitored(jnp.asarray(f), max_iter=80, schur=schur,
                                             schur_preconditioner=prec)
        assert re.iterations == int(jres.iterations)
        assert np.abs(np.asarray(jhist) - he).max() <= 1e-10
        assert np.abs(ue.numpy() - np.asarray(ju)).max() <= 1e-10 * np.abs(ue.numpy()).max()
    (entry,) = ts._captured.values()
    with monkeypatch.context() as m:
        _no_host_reads(m)
        for piece in entry.graphs.pieces:
            piece(entry.state)


# the assembled-matrix runs of the CLI through the solver's one-launch path
MATRIX_CASES = {
    "crs-cg": BASE2 + ["--matrix-type", "crs", "--solver", "cg"],
    "schur-pbm": BASE2 + ["--schur", "--matrix-type", "pbm"],
}


@pytest.mark.parametrize("case", list(MATRIX_CASES))
def test_cli_matrix_solves_through_the_capture(emulated, monkeypatch, case, meshes,  # noqa: F811
                                               tmp_path):
    """``--matrix-type crs`` (CG, in the volume inner product) and ``pbm``
    (the Schur form, BiCGStab) with the port's solver on its one-launch
    path (emulated): the JAX CLI's counts, error and printed lines, and the
    solve made once, under ``("matrix", kind, method)``."""
    made = []
    init = tsolver.PoissonSolver.__init__

    def one_launch(self, *args, **kw):
        init(self, *args, **kw)
        self._graphs = True
        made.append(self)

    monkeypatch.setattr(tsolver.PoissonSolver, "__init__", one_launch)
    argv = MATRIX_CASES[case]
    j, t = run_both(2, argv, meshes, tmp_path)
    compare_runs(argv, j, t)
    outputs_equal(j[2], t[2], exact_rhs=True)
    (solver,) = made
    kind = "schur-pbm" if "pbm" in argv else "crs"
    method = "cg" if "cg" in argv else "bicgstab"
    assert list(solver._captured) == [("matrix", kind, method)]

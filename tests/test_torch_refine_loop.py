"""The port's refinement loop on the CPU against the JAX package's
``solve_refined``: the program (``solver._refinement``: the rounds and the
inner loop as pieces and nested loops) as the card runs it, one graph
launch (``solver._RefineGraph``), here piece by piece through an emulation
of the capture (``test_torch_graphs.emulated``), and the same program run
eagerly (``krylov.run_program``).

Held, on the small 2D mesh with an f32 cycle: with each inner method, and
with a breakdown (a NaN-producing operator), stagnation (inner solves
that take no step) and ``max_outer``, the two runs agree bit for bit
(iterate, counts, residual, history, stencil launches, host reads), the
eager run reads the round's guard once a round and the inner guard once
an inner step (and once more at each loop's end) and its counts once, and
both hold the reference's outer count exactly and its inner count within
one (as ``tests/test_torch_bench.py``) and its residual; ``sync=False``
gives 0-d tensors equal to ``sync=True``'s values and the reference's
``max_outer + 1`` history slots; and the pieces (the init, the inner
init, the inner step, the round's end) make no host read."""

import math
import types

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
from pressurepoissonsolver_torch.utils import counters

from _torch_parity import hierarchies
from test_torch_gmres_loop import _no_host_reads
from test_torch_graphs import GMG, emulated  # noqa: F401 (the emulated capture)

INNER_TOL = 1e-4
# (solver options, solve_refined keywords, operator): the inner methods,
# then the three other ways a refinement stops
CASES = {
    "bicgstab": ({}, {}, None),
    "cg": ({"inner_krylov": "cg"}, {}, None),
    "richardson": ({"inner_krylov": "richardson"}, {}, None),
    # every round's residual is NaN: the first round breaks down and the
    # best iterate so far (zero) is kept
    "breakdown": ({}, {}, "nan"),
    # inner solves that take no step leave the residual at 1: the rounds
    # stagnate at k = 4
    "stagnation": ({}, {"inner_max_iter": 0}, None),
    "max_outer": ({}, {"max_outer": 2, "tol": 1e-14}, None),
}


def _solvers(opts, op):
    jh, th = hierarchies()
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, precond_dtype=jnp.float32, gmg=jgmg.CycleOpts(**GMG), **opts))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, precond_dtype=torch.float32, gmg=tgmg.CycleOpts(**GMG), **opts),
        device="cpu")
    if op == "nan":
        js._op = types.SimpleNamespace(apply=lambda u: u * jnp.nan)
        ts._op = types.SimpleNamespace(apply=lambda u: u * math.nan)
    f, _ = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    return js, ts, f


def _port(ts, f, mode, **kw):
    """``(u, info, stencil launches, host reads)`` of one solve."""
    ts._graphs = mode
    counters.reset()
    reads = tkrylov.reads["host"]
    u, info = ts.solve_refined(torch.from_numpy(f), inner_tol=INNER_TOL, **kw)
    return u, info, gs.counters(), tkrylov.reads["host"] - reads


@pytest.mark.parametrize("case", list(CASES))
def test_refine_loop_matches_reference(emulated, case):
    opts, kw, op = CASES[case]
    js, ts, f = _solvers(opts, op)
    kw = {"tol": 1e-10, **kw}
    _, jinfo = js.solve_refined(jnp.asarray(f), inner_tol=INNER_TOL, **kw)
    jk, jinner = int(jinfo["outer_iterations"]), int(jinfo["inner_iterations"])
    ug, ig, lg, rg = _port(ts, f, True, **kw)
    ue, ie, le, re = _port(ts, f, False, **kw)
    assert "refined" in next(iter(ts._captured))
    assert torch.equal(ug, ue) and lg == le
    # eager: a guard read before each round and after the last, one before
    # each inner step and after each inner loop's last, one read of the counts
    k_e, inner_e = ie["outer_iterations"], ie["inner_iterations"]
    assert re == (k_e + 1) + (inner_e + k_e) + 1 == rg
    assert {k: v for k, v in ig.items() if k != "outer_history"} == {
        k: v for k, v in ie.items() if k != "outer_history"}
    assert np.array_equal(ig["outer_history"], ie["outer_history"])
    k, inner = ig["outer_iterations"], ig["inner_iterations"]
    assert k == jk and abs(inner - jinner) <= 1
    assert len(ig["outer_history"]) == k + 1
    if case == "breakdown":
        assert k == 1 and ig["residual"] == math.inf == float(jinfo["residual"])
        assert not bool(ug.abs().max())
    elif case == "stagnation":
        assert k == 4 and inner == 0 and ig["residual"] == 1.0
    elif case == "max_outer":
        assert k == 2 and ig["residual"] > 1e-14
    else:
        assert ig["residual"] <= 1e-10 and float(jinfo["residual"]) <= 1e-10
        assert abs(ig["residual"] - float(jinfo["residual"])) <= 1e-11


@pytest.mark.parametrize("mode", [True, False])
def test_refine_loop_sync_false_returns_tensors(emulated, mode):
    """``sync=False``: 0-d tensors on the solver's device (and the 1-d
    history of ``max_outer + 1`` slots, 1 past the rounds, as the
    reference's) equal to the ``sync=True`` values, from the loop of the
    card (``mode`` True) and from the program run eagerly."""
    _, ts, f = _solvers({}, None)
    u1, i1, _, _ = _port(ts, f, mode, tol=1e-10, max_outer=6)
    u2, i2, _, _ = _port(ts, f, mode, tol=1e-10, max_outer=6, sync=False)
    assert torch.equal(u1, u2)
    for key in ("outer_iterations", "inner_iterations", "residual"):
        v = i2[key]
        assert torch.is_tensor(v) and v.dim() == 0 and v.device == ts.device
        assert v.item() == i1[key]
    k = i1["outer_iterations"]
    hist = i2["outer_history"].numpy()
    assert hist.shape == (7,) and np.array_equal(hist[:k + 1], i1["outer_history"])
    assert np.all(hist[k + 1:] == 1.0)


def test_refine_pieces_make_no_host_read(emulated, monkeypatch):
    """Every piece of the refinement's program (its init, the round's inner
    init, the inner step, the round's end), each run once on the static
    state with every host read of a tensor refused."""
    _, ts, f = _solvers({"inner_krylov": "cg"}, None)
    ts._graphs = True
    ts.solve_refined(torch.from_numpy(f), tol=1e-10, inner_tol=INNER_TOL)
    (entry,) = ts._captured.values()
    pieces = list(entry.graphs.pieces)
    assert len(pieces) == 4
    with monkeypatch.context() as m:
        _no_host_reads(m)
        for piece in pieces:
            piece(entry.state)

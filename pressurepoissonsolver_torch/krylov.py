"""Krylov solvers in PyTorch: right-preconditioned BiCGStab
(``BiCGStab.h:45-106``), restarted GMRES, preconditioned CG (optionally in
a weighted inner product) and preconditioned Richardson iteration, plus
the monitored forms that record a residual-norm history.

Port of ``pressurepoissonsolver_tpu.krylov``: the same recurrences,
breakdown guards, stop rules and iteration counts.  The reference runs
each loop inside one ``lax.while_loop``.  Here each method is a
:class:`KrylovLoop`: an init, pieces that do device work only, and a
result.  BiCGStab, CG and Richardson have one piece, the guarded step
(the iteration, the step count ``k + 1`` and the stop test ``(k <
max_iter) & (||r|| / ||r0|| > tol)`` on the device, in the working
dtype).  GMRES (:func:`gmres_loop`) is two nested loops of pieces, as the
reference's restart ``while_loop`` around its Arnoldi ``fori_loop``: a
cycle's init, the Arnoldi step (the masked two-pass Gram-Schmidt, then
the Givens rotations, all on the device) while the cycle is not done, and
the cycle's end (the masked triangular solve, the update and the true
residual).  A loop is a :class:`While` over a guard flag of the state.

The plain driver reads each guard to the host before every pass
(:func:`run_loop`, :func:`run_program`; every read is counted in
``reads``), so a step past the stop is never computed: the CPU takes it,
and so do these functions.  On one CUDA device ``solver.PoissonSolver``
runs the pieces from CUDA graphs composed into one executable graph with
WHILE nodes (``utils.graphs``), one launch per solve.

The monitored forms (``residual_history_loop``, ``cg_history_loop``,
``gmres_loop(history=...)``) write the history into a device buffer per
step, read once with the count (``KrylovLoop.read``), and stop at
convergence.  The reference's ``residual_history`` and ``cg_history`` run
all ``max_iter`` iterations with the converged state frozen; here the loop
leaves at that point, which gives the same iterate, count and history up to
the count.  Their histories are host numpy arrays.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .utils.profiling import span

Op = Callable[[torch.Tensor], torch.Tensor]
#: a reduction hook: the sum of a rank-local partial over the solver's
#: process group (``parallel.sharding.Comm.all_reduce``); ``None`` on one
#: device, where no collective is made
Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _dot(a: torch.Tensor, b: torch.Tensor, allreduce: Reduce = None) -> torch.Tensor:
    d = torch.dot(a.reshape(-1), b.reshape(-1))
    return d if allreduce is None else allreduce(d)


def _norm(a: torch.Tensor, allreduce: Reduce = None) -> torch.Tensor:
    return torch.sqrt(_dot(a, a, allreduce))


def _precond(M: Optional[Op], x: torch.Tensor) -> torch.Tensor:
    """``M(x)`` in the span ``pps.krylov.precond`` (``x`` without ``M``)."""
    if M is None:
        return x
    with span("pps.krylov.precond"):
        return M(x)


def _operator(A: Op, x: torch.Tensor) -> torch.Tensor:
    """``A(x)`` in the span ``pps.krylov.operator``."""
    with span("pps.krylov.operator"):
        return A(x)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b``, or 0 where ``b == 0`` (breakdown guard for the f32 inner
    solves: a zero denominator stalls the iteration instead of making NaN)."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # final ||r|| (recurrence residual)
    r0_norm: torch.Tensor


class BiCGStabState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    rhat: torch.Tensor


class While(NamedTuple):
    """A loop of a program: ``body`` (pieces ``state -> state`` and
    loops) runs again for as long as the flag ``guard(state)`` (a 0-d bool
    of the state) holds; the counterpart of ``lax.while_loop``'s cond and
    body, and of a CUDA graph's WHILE node (``utils.graphs.GraphLoop``)."""

    guard: Callable
    body: tuple


def _go(state) -> torch.Tensor:
    return state.go


class KrylovLoop(NamedTuple):
    """A Krylov method as the parts of a guarded loop, the counterpart of
    the reference's ``lax.while_loop`` (cond, body, init):

    * ``init(b, tol, max_iter, x0=None)``: the state, a NamedTuple of
      tensors ending in the step limit ``max_iter``, the step count ``k``
      (both int64) and the guard ``go`` (bool), all 0-d and on ``b``'s
      device; ``tol`` becomes a 0-d tensor of ``b``'s dtype (``tol`` and
      ``max_iter`` may be given as 0-d tensors: a captured init reads them
      from static buffers);
    * ``step(state)``: one guarded step, device work only: the iteration,
      ``k + 1`` and the guard re-tested on the new state;
    * ``result(state, iterations)``: the :class:`KrylovResult`;
    * ``body``: the program after init (pieces and :class:`While` loops);
      empty for one loop of ``step`` on ``go``;
    * ``count``: the state field holding the iteration count; empty when it
      is the number of steps;
    * ``read``: state fields read to the host with the count after a run
      (one read), passed to ``result`` after ``iterations`` as flat float64
      numpy arrays (a monitored loop's history).

    The state holds everything a solve changes, so that pieces captured
    over static copies of it (``utils.graphs.CapturedLoop``) serve every
    right-hand side, ``tol`` and ``max_iter``."""

    init: Callable
    step: Callable
    result: Callable
    body: tuple = ()
    count: str = ""
    read: tuple = ()


def program(loop: KrylovLoop) -> tuple:
    """The pieces and loops ``loop`` runs after its init."""
    return loop.body or (While(_go, (loop.step,)),)


def _scalar(v, b: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``b``'s dtype on its device (a tensor ``v``
    is taken as it is, cast if need be)."""
    if torch.is_tensor(v):
        return v.to(dtype=b.dtype)
    return torch.full((), v, dtype=b.dtype, device=b.device)


def _count(b: torch.Tensor, v=0) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(dtype=torch.int64)
    return torch.full((), v, dtype=torch.int64, device=b.device)


def _guard(k: torch.Tensor, max_iter: torch.Tensor, ratio: torch.Tensor,
           tol: torch.Tensor) -> torch.Tensor:
    """Whether another step runs: ``k < max_iter`` and ``ratio > tol``,
    compared in the working dtype (a zero initial residual gives ``nan >
    tol`` = False)."""
    return (k < max_iter) & (ratio > tol)


#: device-to-host reads made at the loops' read points (a guard before a
#: pass, the counts and results after a launch): ``reads["host"]``; a
#: solve's reads are the difference across it
reads = {"host": 0}


def read_flag(flag: torch.Tensor) -> bool:
    """A 0-d flag read to the host (one counted read)."""
    reads["host"] += 1
    return bool(flag.item())


def read_scalar(t: torch.Tensor) -> float:
    """A 0-d tensor read to the host (one counted read)."""
    reads["host"] += 1
    return float(t.item())


def host_read(*tensors: torch.Tensor) -> list:
    """``tensors`` read to the host in one copy (one counted read): a flat
    float64 numpy array per tensor (counts are exact in it)."""
    reads["host"] += 1
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()])
        i += t.numel()
    return out


def run_loop(state, advance: Callable):
    """Run guarded steps while ``state.go`` holds, reading it to the host
    once per step (the loop's only host read); ``advance(state)`` is the
    state after one step, computed eagerly or by replaying a captured step
    over static buffers.  ``(state, steps)``.  The plain version of a WHILE
    node."""
    steps = 0
    while read_flag(state.go):
        state = advance(state)
        steps += 1
    return state, steps


def run_program(state, body: tuple):
    """``body`` run eagerly on ``state``: each piece in turn, each
    :class:`While` reading its guard to the host before every pass (as
    :func:`run_loop`).  The state after it."""
    for item in body:
        if isinstance(item, While):
            while read_flag(item.guard(state)):
                state = run_program(state, item.body)
        else:
            state = item(state)
    return state


def solve_loop(loop: KrylovLoop, b: torch.Tensor, tol, max_iter: int,
               x0=None) -> KrylovResult:
    """``loop`` run eagerly on ``b`` to its stop."""
    state = loop.init(b, tol, max_iter, x0)
    if not loop.body:
        state, steps = run_loop(state, loop.step)
    else:
        state, steps = run_program(state, loop.body), None
    names = ((loop.count,) if steps is None else ()) + loop.read
    got = host_read(*(getattr(state, n) for n in names)) if names else []
    if steps is None:
        steps, got = int(got[0][0]), got[1:]
    return loop.result(state, steps, *got)


class _BiCGStab(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    rhat: torch.Tensor
    r0_norm: torch.Tensor
    tol: torch.Tensor
    max_iter: torch.Tensor
    k: torch.Tensor
    go: torch.Tensor


def bicgstab_init(A: Op, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                  allreduce: Reduce = None):
    """Initial state and ``||r0||``."""
    if x0 is None:
        x, r = torch.zeros_like(b), b  # b - A(0) = b
    else:
        x, r = x0, b - _operator(A, x0)
    return (BiCGStabState(x=x, r=r, p=r, rho=_dot(r, r, allreduce), rhat=r),
            _norm(r, allreduce))


def bicgstab_step(A: Op, M: Optional[Op], st: BiCGStabState,
                  allreduce: Reduce = None) -> BiCGStabState:
    """One BiCGStab iteration; launches device work only (no host read)."""
    x, r, p, rho, rhat = st
    mp = _precond(M, p)
    ap = _operator(A, mp)
    alpha = _safe_div(rho, _dot(rhat, ap, allreduce))
    s = r - alpha * ap
    ms = _precond(M, s)
    as_ = _operator(A, ms)
    omega = _safe_div(_dot(as_, s, allreduce), _dot(as_, as_, allreduce))
    x = x + alpha * mp + omega * ms
    r = r - alpha * ap - omega * as_
    rho_new = _dot(r, rhat, allreduce)
    beta = _safe_div(rho_new * alpha, rho * omega)
    p = beta * (p - omega * ap) + r
    return BiCGStabState(x=x, r=r, p=p, rho=rho_new, rhat=rhat)


def bicgstab_loop(A: Op, M: Optional[Op] = None, allreduce: Reduce = None) -> KrylovLoop:
    """Right-preconditioned BiCGStab (``BiCGStab.h:45-106``) as the parts
    of a guarded loop (see :class:`KrylovLoop`)."""

    def init(b, tol, max_iter, x0=None):
        st, r0_norm = bicgstab_init(A, b, x0, allreduce)
        tol, max_iter, k = _scalar(tol, b), _count(b, max_iter), _count(b)
        return _BiCGStab(*st, r0_norm, tol, max_iter, k,
                         _guard(k, max_iter, _norm(st.r, allreduce) / r0_norm, tol))

    def step(s):
        st = bicgstab_step(A, M, BiCGStabState(*s[:5]), allreduce)
        k = s.k + 1
        return _BiCGStab(*st, s.r0_norm, s.tol, s.max_iter, k,
                         _guard(k, s.max_iter, _norm(st.r, allreduce) / s.r0_norm,
                                s.tol))

    def result(s, iterations):
        return KrylovResult(x=s.x, iterations=iterations,
                            residual_norm=_norm(s.r, allreduce), r0_norm=s.r0_norm)

    return KrylovLoop(init, step, result)


def bicgstab(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 1000,
    allreduce: Reduce = None,
) -> KrylovResult:
    """Right-preconditioned BiCGStab (``BiCGStab.h:45-106``).

    The stop test compares in the working dtype, as the reference does; a
    zero initial residual gives ``nan > tol`` = False and stops at once.
    ``allreduce`` (every solver here takes it) sums each dot over the
    ranks of a sharded solve."""
    return solve_loop(bicgstab_loop(A, M, allreduce), b, tol, max_iter, x0)


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _slots(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _monitor_go(k: torch.Tensor, max_iter: torch.Tensor, rn: torch.Tensor,
                r0: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """The monitored loops' guard: ``k < max_iter`` and not ``||r|| /
    ||r0|| <= tol`` (in the working dtype; a zero ``||r0||`` gives NaN,
    which never stops the loop, as in the reference)."""
    return (k < max_iter) & ~(rn / r0 <= tol)


class _BiCGStabHistory(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    rhat: torch.Tensor
    r0_norm: torch.Tensor
    tol: torch.Tensor
    max_iter: torch.Tensor
    k: torch.Tensor
    go: torch.Tensor
    hist: torch.Tensor  # [slots]: ||r|| after iteration k at k, 0 past the count


def residual_history_loop(A: Op, M: Optional[Op] = None, allreduce: Reduce = None,
                          slots: int = 101) -> KrylovLoop:
    """:func:`residual_history` as the parts of a guarded loop (see
    :class:`KrylovLoop`): the history in a device buffer of ``slots``
    (``max_iter + 1``) entries, written per step, read once with the count;
    ``result(state, iterations, hist)`` gives ``(KrylovResult, history up to
    the count)``."""

    def init(b, tol, max_iter, x0=None):
        st, r0_norm = bicgstab_init(A, b, allreduce=allreduce)
        tol, max_iter, k = _scalar(tol, b), _count(b, max_iter), _count(b)
        hist = torch.where(_slots(slots, b) == 0, r0_norm, b.new_zeros(slots))
        return _BiCGStabHistory(*st, r0_norm, tol, max_iter, k, k < max_iter, hist)

    def step(s):
        st = bicgstab_step(A, M, BiCGStabState(*s[:5]), allreduce)
        k = s.k + 1
        rn = _norm(st.r, allreduce)
        return _BiCGStabHistory(*st, s.r0_norm, s.tol, s.max_iter, k,
                                _monitor_go(k, s.max_iter, rn, s.r0_norm, s.tol),
                                torch.where(_slots(slots, rn) == k, rn, s.hist))

    def result(s, iterations, hist):
        return (KrylovResult(x=s.x, iterations=iterations,
                             residual_norm=_norm(s.r, allreduce), r0_norm=s.r0_norm),
                hist[:iterations + 1].astype(_NP[s.hist.dtype]))

    return KrylovLoop(init, step, result, read=("hist",))


def residual_history(
    A: Op,
    b: torch.Tensor,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 100,
    allreduce: Reduce = None,
) -> Tuple[KrylovResult, np.ndarray]:
    """BiCGStab with a per-iteration residual-norm history (the
    ``--monitor`` hook; the reference's BiCGStab reports only the final
    count, ``BiCGStab.h:70-105``): ``hist[k]`` is ``||r||`` after iteration
    ``k``, ``hist[0] = ||r0||``, up to the count.  The stop test is
    ``||r|| / ||r0|| <= tol`` after each iteration, in the working dtype;
    the count is ``max_iter`` when it never holds.  Run eagerly
    (:func:`residual_history_loop`)."""
    return solve_loop(residual_history_loop(A, M, allreduce, max_iter + 1), b, tol,
                      max_iter)


def _weighted_dot(weight: Optional[torch.Tensor], dtype: torch.dtype,
                  allreduce: Reduce = None):
    """``<a, c>_w = sum(w * a * c)``, or the plain dot without a weight."""
    if weight is None:
        return lambda a, c: _dot(a, c, allreduce)
    w = weight.to(dtype)
    return lambda a, c: _dot(a * w, c, allreduce)


class _CG(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    r0: torch.Tensor  # <r0, r0>_w
    thr: torch.Tensor  # tol^2 in the working dtype
    max_iter: torch.Tensor
    k: torch.Tensor
    go: torch.Tensor


def cg_loop(A: Op, M: Optional[Op] = None, weight: Optional[torch.Tensor] = None,
            allreduce: Reduce = None) -> KrylovLoop:
    """Preconditioned CG (see :func:`cg`; ``weight`` in the working dtype)
    as the parts of a guarded loop (see :class:`KrylovLoop`)."""
    wdot = _weighted_dot(weight, None if weight is None else weight.dtype, allreduce)

    def init(b, tol, max_iter, x0=None):
        if x0 is None:
            x, r = torch.zeros_like(b), b  # b - A(0) = b
        else:
            x, r = x0, b - _operator(A, x0)
        r0 = wdot(r, r)
        tol_t = _scalar(tol, b)
        thr = tol_t * tol_t
        z = _precond(M, r)
        rz = wdot(r, z)
        max_iter, k = _count(b, max_iter), _count(b)
        return _CG(x, r, z, rz, r0, thr, max_iter, k,
                   _guard(k, max_iter, wdot(r, r) / r0, thr))

    def step(s):
        x, r, p, rz = s[:4]
        ap = _operator(A, p)
        alpha = rz / wdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = _precond(M, r)
        rz_new = wdot(r, z)
        p = z + (rz_new / rz) * p
        k = s.k + 1
        return _CG(x, r, p, rz_new, s.r0, s.thr, s.max_iter, k,
                   _guard(k, s.max_iter, wdot(r, r) / s.r0, s.thr))

    def result(s, iterations):
        return KrylovResult(x=s.x, iterations=iterations,
                            residual_norm=torch.sqrt(wdot(s.r, s.r)),
                            r0_norm=torch.sqrt(s.r0))

    return KrylovLoop(init, step, result)


def cg(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 1000,
    weight: Optional[torch.Tensor] = None,
    allreduce: Reduce = None,
) -> KrylovResult:
    """Preconditioned conjugate gradient.

    ``weight`` selects the inner product ``<x, y>_D = sum(weight * x * y)``.
    The composite FAC operator is exactly self-adjoint (and definite) in
    the cell-volume inner product, and so is the V-cycle with cell-average
    restriction and constant prolongation, so ``weight = per-cell volume``
    makes the composite solve a true PCG: one operator and one
    preconditioner apply per iteration, against BiCGStab's two of each.

    The stop test ``<r, r>_w / <r0, r0>_w > tol^2`` runs in the working
    dtype, ``tol^2`` squared in it, as in the reference; no breakdown
    guard, as in the reference."""
    w = None if weight is None else weight.to(b.dtype)
    return solve_loop(cg_loop(A, M, w, allreduce), b, tol, max_iter, x0)


class _CGHistory(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    r0_norm: torch.Tensor
    tol: torch.Tensor
    max_iter: torch.Tensor
    k: torch.Tensor
    go: torch.Tensor
    hist: torch.Tensor


def cg_history_loop(A: Op, M: Optional[Op] = None, weight: Optional[torch.Tensor] = None,
                    allreduce: Reduce = None, slots: int = 101) -> KrylovLoop:
    """:func:`cg_history` as the parts of a guarded loop (see
    :func:`residual_history_loop`)."""

    def init(b, tol, max_iter, x0=None):
        wdot = _weighted_dot(weight, b.dtype, allreduce)
        x, r = torch.zeros_like(b), b  # b - A(0) = b
        r0_norm = torch.sqrt(wdot(r, r))
        z = _precond(M, r)
        tol, max_iter, k = _scalar(tol, b), _count(b, max_iter), _count(b)
        hist = torch.where(_slots(slots, b) == 0, r0_norm, b.new_zeros(slots))
        return _CGHistory(x, r, z, wdot(r, z), r0_norm, tol, max_iter, k, k < max_iter,
                          hist)

    def step(s):
        wdot = _weighted_dot(weight, s.x.dtype, allreduce)
        x, r, p, rz = s[:4]
        ap = _operator(A, p)
        alpha = _safe_div(rz, wdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = _precond(M, r)
        rz_new = wdot(r, z)
        p = z + _safe_div(rz_new, rz) * p
        k = s.k + 1
        rn = torch.sqrt(wdot(r, r))
        return _CGHistory(x, r, p, rz_new, s.r0_norm, s.tol, s.max_iter, k,
                          _monitor_go(k, s.max_iter, rn, s.r0_norm, s.tol),
                          torch.where(_slots(slots, rn) == k, rn, s.hist))

    def result(s, iterations, hist):
        wdot = _weighted_dot(weight, s.x.dtype, allreduce)
        return (KrylovResult(x=s.x, iterations=iterations,
                             residual_norm=torch.sqrt(wdot(s.r, s.r)), r0_norm=s.r0_norm),
                hist[:iterations + 1].astype(_NP[s.hist.dtype]))

    return KrylovLoop(init, step, result, read=("hist",))


def cg_history(
    A: Op,
    b: torch.Tensor,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 100,
    weight: Optional[torch.Tensor] = None,
    allreduce: Reduce = None,
) -> Tuple[KrylovResult, np.ndarray]:
    """Preconditioned CG with a per-iteration residual-norm history (see
    ``residual_history``): the norms are the weighted ones when ``weight``
    is given, and the divisions are guarded against a zero denominator, as
    in the reference's monitored CG.  Run eagerly
    (:func:`cg_history_loop`)."""
    return solve_loop(cg_history_loop(A, M, weight, allreduce, max_iter + 1), b, tol,
                      max_iter)


class _Richardson(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    b: torch.Tensor
    r0_norm: torch.Tensor
    tol: torch.Tensor
    max_iter: torch.Tensor
    k: torch.Tensor
    go: torch.Tensor


def richardson_loop(A: Op, M: Optional[Op] = None, allreduce: Reduce = None) -> KrylovLoop:
    """Preconditioned Richardson iteration (see :func:`richardson`) as the
    parts of a guarded loop (see :class:`KrylovLoop`)."""

    def init(b, tol, max_iter, x0=None):
        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x, r = x0, b - _operator(A, x0)
        r0_norm = _norm(r, allreduce)
        tol, max_iter, k = _scalar(tol, b), _count(b, max_iter), _count(b)
        return _Richardson(x, r, b, r0_norm, tol, max_iter, k,
                           _guard(k, max_iter, _norm(r, allreduce) / r0_norm, tol))

    def step(s):
        x = s.x + _precond(M, s.r)
        r = s.b - _operator(A, x)
        k = s.k + 1
        return _Richardson(x, r, s.b, s.r0_norm, s.tol, s.max_iter, k,
                           _guard(k, s.max_iter, _norm(r, allreduce) / s.r0_norm,
                                  s.tol))

    def result(s, iterations):
        return KrylovResult(x=s.x, iterations=iterations,
                            residual_norm=_norm(s.r, allreduce), r0_norm=s.r0_norm)

    return KrylovLoop(init, step, result)


def richardson(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 100,
    allreduce: Reduce = None,
) -> KrylovResult:
    """Preconditioned Richardson iteration ``x += M(b - A x)``: with a
    multigrid preconditioner, plain multigrid iteration.  Each step costs
    one preconditioner and one operator apply, half a BiCGStab iteration.
    Stops once ``||r|| / ||r0|| <= tol`` (in the working dtype)."""
    return solve_loop(richardson_loop(A, M, allreduce), b, tol, max_iter, x0)


class _GMRES(NamedTuple):
    b: torch.Tensor  # the right-hand side, flat
    x: torch.Tensor
    r: torch.Tensor
    rnorm: torch.Tensor
    r0: torch.Tensor
    target: torch.Tensor  # ||r0|| * tol
    it: torch.Tensor
    max_iter: torch.Tensor
    go: torch.Tensor  # another cycle: rnorm > target and it < max_iter
    H: torch.Tensor  # [restart + 1, restart]
    cs: torch.Tensor
    sn: torch.Tensor
    g: torch.Tensor
    j: torch.Tensor  # the cycle's next Arnoldi column
    kdone: torch.Tensor  # the columns taken
    done: torch.Tensor
    go_in: torch.Tensor  # another Arnoldi step: not done and j < restart
    w: torch.Tensor  # the Gram-Schmidt step's new vector, flat
    h: torch.Tensor  # and its Hessenberg column
    wnorm: torch.Tensor
    hist: torch.Tensor


def _go_in(state) -> torch.Tensor:
    return state.go_in


def gmres_loop(A: Op, M: Optional[Op] = None, restart: int = 30,
               allreduce: Reduce = None, history: int = 0) -> KrylovLoop:
    """Right-preconditioned restarted GMRES(restart) as the pieces of two
    nested loops (see :class:`KrylovLoop`), all device work in the working
    dtype: the port of the reference's ``gmres``
    (``pressurepoissonsolver_tpu/krylov.py:255-424``).  While ``||r|| >
    tol ||r0||`` and ``it < max_iter``: the cycle's init (``V[0] = r /
    beta``; H, the Givens pairs and g reset), then while the cycle is not
    done and ``j < restart`` the Arnoldi step, as two pieces: the masked
    two-pass modified Gram-Schmidt over all ``restart + 1`` basis rows (rows
    past ``j`` are zero and masked), and the Givens algebra (the earlier
    rotations applied to the new column, masked as the reference's scan,
    the new pair, g, the degenerate-column rule, ``done``); then the
    cycle's end (the masked triangular solve with identity on the inactive
    diagonal, ``x + M(V^T y)``, the true residual, a non-finite update
    rejected, ``it += max(kdone, 1)``).  The reference's Arnoldi runs
    every slot of a cycle and freezes its state once the cycle is done;
    here the cycle leaves at that point, which gives the same iterate and
    count.

    ``history``: the slots of the residual history (the reference's
    ``max_iter + restart + 1``), 0 for none; ``hist[k]`` is the norm after
    iteration ``k``, the running Givens estimate within a cycle, the true
    residual at a cycle boundary, zero where nothing was written.  The
    basis ``V`` (``restart + 1`` rows of the flat size) is a workspace of
    the loop, allocated at its first init and reset by each cycle's init,
    so that a captured loop keeps one copy."""
    R = restart
    ws: dict = {}

    def red(t):
        return t if allreduce is None else allreduce(t)

    def Af(v):
        return _operator(A, v.reshape(ws["shape"])).reshape(-1)

    def Mf(v):
        return v if M is None else _precond(M, v.reshape(ws["shape"])).reshape(-1)

    def pos(n, like):
        return torch.arange(n, device=like.device)

    def init(b, tol, max_iter, x0=None):
        ws["shape"] = b.shape
        bf = b.reshape(-1)
        N = bf.numel()
        V = ws.get("V")
        if V is None or V.shape[1] != N or V.dtype != b.dtype or V.device != b.device:
            ws["V"] = b.new_zeros((R + 1, N))
        if x0 is None:
            x, r = torch.zeros_like(bf), bf  # b - A(0) = b
        else:
            x = x0.reshape(-1)
            r = bf - Af(x)
        r0 = _norm(r, allreduce)
        # tolerance on ||r||/||r0||, as bicgstab's
        target = r0 * _scalar(tol, b)
        it, max_iter = _count(b), _count(b, max_iter)
        hist = b.new_zeros(max(history, 1))
        hist = torch.where(pos(hist.numel(), b) == 0, r0, hist)
        z = b.new_zeros
        no = torch.zeros((), dtype=torch.bool, device=b.device)
        return _GMRES(bf, x, r, r0, r0, target, it, max_iter,
                      (r0 > target) & (it < max_iter), z((R + 1, R)), z(R), z(R), z(R + 1),
                      _count(b), _count(b), ~no, no, torch.zeros_like(bf), z(R + 1),
                      z(()), hist)

    def cycle_init(s):
        # r is carried from the previous cycle's true-residual check
        beta = s.rnorm
        safe_beta = torch.where(beta != 0, beta, torch.ones_like(beta))
        V = ws["V"]
        V[1:].zero_()
        V[0].copy_(s.r / safe_beta)
        g = torch.where(pos(R + 1, beta) == 0, beta, torch.zeros_like(s.g))
        done = beta <= s.target
        return s._replace(H=torch.zeros_like(s.H), cs=torch.zeros_like(s.cs),
                          sn=torch.zeros_like(s.sn), g=g, j=torch.zeros_like(s.j),
                          kdone=torch.zeros_like(s.kdone), done=done, go_in=~done)

    def gram_schmidt(s):
        V, j = ws["V"], s.j
        w = Af(Mf(V.index_select(0, j.reshape(1)).reshape(-1)))
        # masked modified Gram-Schmidt: one classical pass and a
        # re-orthogonalization pass over rows i <= j
        p = pos(R + 1, w)
        mask = (p <= j).to(w.dtype)
        h1 = red(torch.mv(V, w)) * mask
        w = w - torch.mv(V.t(), h1)
        h2 = red(torch.mv(V, w)) * mask
        w = w - torch.mv(V.t(), h2)
        wnorm = _norm(w, allreduce)
        h = torch.where(p == j + 1, wnorm, h1 + h2)
        return s._replace(w=w, h=h, wnorm=wnorm)

    def givens(s):
        V, j, h = ws["V"], s.j, s.h.clone()
        one = torch.ones((), dtype=h.dtype, device=h.device)
        # the earlier rotations on the new column, masked to the slots i < j
        # as the reference's scan over all slots: slot i turns (h[i],
        # h[i+1]) by [[c, s], [-s, c]] when active, by the identity if not
        act = (pos(R, h) < j).to(h.dtype)
        c, sn_ = act * s.cs + (1 - act), act * s.sn
        G = torch.stack([torch.stack([c, sn_], -1), torch.stack([-sn_, c], -1)], -2)
        for i in range(R):
            h[i:i + 2] = torch.mv(G[i], h[i:i + 2])
        jj, j1 = j.reshape(1), (j + 1).reshape(1)
        hj, hj1 = h.index_select(0, jj)[0], h.index_select(0, j1)[0]
        denom = torch.sqrt(hj * hj + hj1 * hj1)
        nz = denom != 0
        safe_d = torch.where(nz, denom, one)
        cj = torch.where(nz, hj / safe_d, one)
        sj = torch.where(nz, hj1 / safe_d, torch.zeros_like(one))
        p = pos(R + 1, h)
        h = torch.where(p == j, cj * hj + sj * hj1, torch.where(p == j + 1, 0.0, h))
        gj = s.g.index_select(0, jj)[0]
        g_j1 = -sj * gj
        g_new = torch.where(p == j + 1, g_j1, torch.where(p == j, cj * gj, s.g))
        # degenerate column: the rotated diagonal is zero, i.e. A M V[j] lies
        # in the previous Krylov subspace (a lucky breakdown); taking it
        # would put a zero on R's diagonal, so the cycle ends and the
        # true-residual check decides
        degenerate = denom <= 0
        take = ~s.done & ~degenerate
        safe_w = torch.where(s.wnorm != 0, s.wnorm, one)
        V.index_copy_(0, j1, torch.where(take, s.w / safe_w,
                                         V.index_select(0, j1)[0]).reshape(1, -1))
        col = pos(R, h) == j
        H = torch.where(take & col.reshape(1, R), h.reshape(R + 1, 1), s.H)
        cs = torch.where(take & col, cj, s.cs)
        sn = torch.where(take & col, sj, s.sn)
        g = torch.where(take, g_new, s.g)
        kdone = torch.where(take, j + 1, s.kdone)
        done = s.done | degenerate | (g_j1.abs() <= s.target)
        hist = s.hist
        if history:
            at = pos(hist.numel(), h) == s.it + j + 1
            hist = torch.where(take & at, g_j1.abs(), hist)
        j = j + 1
        return s._replace(H=H, cs=cs, sn=sn, g=g, j=j, kdone=kdone, done=done,
                          go_in=~done & (j < R), hist=hist)

    def cycle_end(s):
        V = ws["V"]
        # the triangular system R y = g: inactive columns get an identity
        # diagonal and a zero right-hand side, so their y is 0
        act = pos(R, s.g) < s.kdone
        Rm = torch.where(act.reshape(1, R) & act.reshape(R, 1), s.H[:R], 0.0)
        Rm = Rm + torch.diag((~act).to(Rm.dtype))
        rhs = torch.where(act, s.g[:R], 0.0)
        y = torch.linalg.solve_triangular(Rm, rhs.reshape(R, 1), upper=True).reshape(R)
        dx = torch.mv(V[:R].t(), y)
        # the Givens estimate can drift from the true residual when the
        # basis loses orthogonality: check the true residual (reused as the
        # next cycle's r)
        x_new = s.x + Mf(dx)
        r_new = s.b - Af(x_new)
        rnorm_new = _norm(r_new, allreduce)
        # reject a non-finite update: keep the last good iterate; ``it``
        # still advances, so the loop ends at max_iter
        ok = torch.isfinite(rnorm_new)
        hist = s.hist
        if history:
            at = pos(hist.numel(), s.g) == s.it + s.kdone
            hist = torch.where(ok & at, rnorm_new, hist)
        rnorm = torch.where(ok, rnorm_new, s.rnorm)
        it = s.it + torch.clamp(s.kdone, min=1)
        return s._replace(x=torch.where(ok, x_new, s.x), r=torch.where(ok, r_new, s.r),
                          rnorm=rnorm, it=it, go=(rnorm > s.target) & (it < s.max_iter),
                          hist=hist)

    def result(s, iterations, hist=None):
        res = KrylovResult(x=s.x.reshape(ws["shape"]), iterations=iterations,
                           residual_norm=s.rnorm, r0_norm=s.r0)
        if not history:
            return res
        return res, hist.astype(_NP[s.hist.dtype])

    body = (While(_go, (cycle_init, While(_go_in, (gram_schmidt, givens)), cycle_end)),)
    return KrylovLoop(init, gram_schmidt, result, body, "it", ("hist",) if history else ())


def gmres(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    restart: int = 30,
    max_iter: int = 1000,
    history: bool = False,
    allreduce: Reduce = None,
):
    """Right-preconditioned restarted GMRES(restart) (:func:`gmres_loop`)
    run eagerly: Arnoldi with two-pass modified Gram-Schmidt, Givens
    rotations, and the true residual checked at every cycle boundary;
    ``iterations`` advances by ``max(columns taken, 1)`` per cycle and the
    loop stops once ``||r|| <= tol * ||r0||`` or ``iterations >=
    max_iter``.

    With ``history=True`` returns ``(result, hist)``: ``hist[k]`` is the
    residual norm after iteration ``k``, the running Givens estimate within
    a cycle, overwritten by the true residual at each cycle boundary
    (``max_iter + restart + 1`` slots, zero where nothing was written, as
    the reference's; a host numpy array)."""
    slots = max_iter + restart + 1 if history else 0
    return solve_loop(gmres_loop(A, M, restart, allreduce, slots), b, tol, max_iter, x0)

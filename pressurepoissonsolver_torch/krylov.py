"""Krylov solvers in PyTorch: right-preconditioned BiCGStab
(``BiCGStab.h:45-106``), restarted GMRES, preconditioned CG (optionally in
a weighted inner product) and preconditioned Richardson iteration, plus
the monitored forms that record a residual-norm history.

Port of ``pressurepoissonsolver_tpu.krylov``: the same recurrences,
breakdown guards, stop rules and iteration counts.  The reference runs
each loop inside one ``lax.while_loop``.  Here BiCGStab, CG and Richardson
are each three parts, :class:`KrylovLoop`: an init, a guarded step that
does device work only (the iteration, the step count ``k + 1`` and the
stop test ``(k < max_iter) & (||r|| / ||r0|| > tol)`` on the device, in
the working dtype) and a result.  :func:`run_loop` drives them: it reads
the guard to the host once per step and runs the step while it holds, so
a step past the stop is never computed.  The step runs eagerly (on the
CPU, and from these functions), or as a CUDA graph captured once per
solver and key and replayed (``utils.graphs.CapturedLoop``, which
``solver.PoissonSolver`` uses on one CUDA device).  GMRES reads the new
Hessenberg column per Arnoldi step and runs the Givens rotations and the
small triangular solve on the host.

The monitored forms (``residual_history``, ``cg_history``,
``gmres(history=True)``) stop at convergence.  The reference's
``residual_history`` and ``cg_history`` run all ``max_iter`` iterations
with the converged state frozen; here the loop leaves at that point, which
gives the same iterate, count and history up to the count.  Their
histories are host numpy arrays.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

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


class KrylovLoop(NamedTuple):
    """A Krylov method as the three parts of a guarded loop, the
    counterpart of the reference's ``lax.while_loop`` (cond, body, init):

    * ``init(b, tol, max_iter, x0=None)``: the state, a NamedTuple of
      tensors ending in the step limit ``max_iter``, the step count ``k``
      (both int64) and the guard ``go`` (bool), all 0-d and on ``b``'s
      device; ``tol`` becomes a 0-d tensor of ``b``'s dtype;
    * ``step(state)``: one guarded step, device work only: the iteration,
      ``k + 1`` and the guard re-tested on the new state;
    * ``result(state, iterations)``: the :class:`KrylovResult`.

    The state holds everything a solve changes, so that a step captured
    over static copies of it (``utils.graphs.CapturedLoop``) serves every
    right-hand side, ``tol`` and ``max_iter``."""

    init: Callable
    step: Callable
    result: Callable


def _scalar(v, b: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``b``'s dtype on its device."""
    return torch.full((), v, dtype=b.dtype, device=b.device)


def _count(b: torch.Tensor, v: int = 0) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int64, device=b.device)


def _guard(k: torch.Tensor, max_iter: torch.Tensor, ratio: torch.Tensor,
           tol: torch.Tensor) -> torch.Tensor:
    """Whether another step runs: ``k < max_iter`` and ``ratio > tol``,
    compared in the working dtype (a zero initial residual gives ``nan >
    tol`` = False)."""
    return (k < max_iter) & (ratio > tol)


def run_loop(state, advance: Callable):
    """Run guarded steps while ``state.go`` holds, reading it to the host
    once per step (the loop's only host read); ``advance(state)`` is the
    state after one step, computed eagerly or by replaying a captured step
    over static buffers.  ``(state, steps)``."""
    steps = 0
    while bool(state.go.item()):
        state = advance(state)
        steps += 1
    return state, steps


def solve_loop(loop: KrylovLoop, b: torch.Tensor, tol, max_iter: int,
               x0=None) -> KrylovResult:
    """``loop`` run eagerly on ``b`` to its stop."""
    state, steps = run_loop(loop.init(b, tol, max_iter, x0), loop.step)
    return loop.result(state, steps)


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
        x, r = x0, b - A(x0)
    return (BiCGStabState(x=x, r=r, p=r, rho=_dot(r, r, allreduce), rhat=r),
            _norm(r, allreduce))


def bicgstab_step(A: Op, M: Optional[Op], st: BiCGStabState,
                  allreduce: Reduce = None) -> BiCGStabState:
    """One BiCGStab iteration; launches device work only (no host read)."""
    x, r, p, rho, rhat = st
    mp = p if M is None else M(p)
    ap = A(mp)
    alpha = _safe_div(rho, _dot(rhat, ap, allreduce))
    s = r - alpha * ap
    ms = s if M is None else M(s)
    as_ = A(ms)
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


def _host_scalar(t: torch.Tensor):
    """A 0-d tensor as a numpy scalar of its dtype (one host read)."""
    return t.detach().cpu().numpy()[()]


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
    the count is ``max_iter`` when it never holds."""
    st, r0_norm = bicgstab_init(A, b, allreduce=allreduce)
    r0 = _host_scalar(r0_norm)
    hist = [r0]
    k = 0
    while k < max_iter:
        st = bicgstab_step(A, M, st, allreduce)
        k += 1
        rn = _host_scalar(_norm(st.r, allreduce))
        hist.append(rn)
        if rn / r0 <= tol:
            break
    return (KrylovResult(x=st.x, iterations=k, residual_norm=_norm(st.r, allreduce),
                         r0_norm=r0_norm), np.asarray(hist))


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
            x, r = x0, b - A(x0)
        r0 = wdot(r, r)
        tol_t = _scalar(tol, b)
        thr = tol_t * tol_t
        z = r if M is None else M(r)
        rz = wdot(r, z)
        max_iter, k = _count(b, max_iter), _count(b)
        return _CG(x, r, z, rz, r0, thr, max_iter, k,
                   _guard(k, max_iter, wdot(r, r) / r0, thr))

    def step(s):
        x, r, p, rz = s[:4]
        ap = A(p)
        alpha = rz / wdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if M is None else M(r)
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
    in the reference's monitored CG."""
    wdot = _weighted_dot(weight, b.dtype, allreduce)
    x, r = torch.zeros_like(b), b  # b - A(0) = b
    r0_norm = torch.sqrt(wdot(r, r))
    r0 = _host_scalar(r0_norm)
    z = r if M is None else M(r)
    p = z
    rz = wdot(r, z)
    hist = [r0]
    k = 0
    while k < max_iter:
        ap = A(p)
        alpha = _safe_div(rz, wdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = r if M is None else M(r)
        rz_new = wdot(r, z)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
        k += 1
        rn = _host_scalar(torch.sqrt(wdot(r, r)))
        hist.append(rn)
        if rn / r0 <= tol:
            break
    return (KrylovResult(x=x, iterations=k, residual_norm=torch.sqrt(wdot(r, r)),
                         r0_norm=r0_norm), np.asarray(hist))


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
            x, r = x0, b - A(x0)
        r0_norm = _norm(r, allreduce)
        tol, max_iter, k = _scalar(tol, b), _count(b, max_iter), _count(b)
        return _Richardson(x, r, b, r0_norm, tol, max_iter, k,
                           _guard(k, max_iter, _norm(r, allreduce) / r0_norm, tol))

    def step(s):
        x = s.x + (s.r if M is None else M(s.r))
        r = s.b - A(x)
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
    """Right-preconditioned restarted GMRES(restart): Arnoldi with two-pass
    modified Gram-Schmidt, Givens rotations, and the true residual checked
    at every cycle boundary; ``iterations`` advances by ``max(columns
    taken, 1)`` per cycle and the loop stops once ``||r|| <= tol * ||r0||``
    or ``iterations >= max_iter``.

    With ``history=True`` returns ``(result, hist)``: ``hist[k]`` is the
    residual norm after iteration ``k``, the running Givens estimate within
    a cycle, overwritten by the true residual at each cycle boundary
    (``max_iter + restart + 1`` slots, zero where nothing was written, as
    the reference's).

    The reference's Arnoldi runs every slot of a cycle and freezes its
    state once the cycle is done (converged or a degenerate column); here
    the cycle leaves at that point, which gives the same iterate and
    count.  The masked Gram-Schmidt of the reference projects on all
    ``restart + 1`` basis rows with the rows past ``j`` masked; those rows
    are zero, so here it projects on rows ``0..j``."""
    shape = b.shape
    N = b.numel()
    hdt = np.float64 if b.dtype == torch.float64 else np.float32
    bf = b.reshape(-1)

    def Af(v):
        return A(v.reshape(shape)).reshape(-1)

    def Mf(v):
        return v if M is None else M(v.reshape(shape)).reshape(-1)

    if x0 is None:
        x, r = torch.zeros_like(bf), bf  # b - A(0) = b
    else:
        x = x0.reshape(-1)
        r = bf - Af(x)
    r0_norm = _norm(r, allreduce)
    rnorm = r0_norm
    r0 = hdt(r0_norm.item())
    # tolerance on ||r||/||r0||, as bicgstab's
    target = r0 * hdt(tol)
    rn = r0
    it = 0
    hist = np.zeros(max_iter + restart + 1 if history else 1, dtype=hdt)
    hist[0] = r0
    with np.errstate(all="ignore"):
        while rn > target and it < max_iter:
            V = b.new_zeros(restart + 1, N)
            V[0] = r / torch.where(rnorm != 0, rnorm, torch.ones_like(rnorm))
            H = np.zeros((restart + 1, restart), dtype=hdt)
            cs = np.zeros(restart, dtype=hdt)
            sn = np.zeros(restart, dtype=hdt)
            g = np.zeros(restart + 1, dtype=hdt)
            g[0] = rn
            done = rn <= target
            kdone = 0
            for j in range(restart):
                if done:
                    break
                w = Af(Mf(V[j]))
                Vj = V[: j + 1]
                h1 = Vj @ w
                if allreduce is not None:
                    h1 = allreduce(h1)
                w = w - Vj.t() @ h1
                h2 = Vj @ w
                if allreduce is not None:
                    h2 = allreduce(h2)
                w = w - Vj.t() @ h2
                wnorm = _norm(w, allreduce)
                # the one host read of the step: the new column and ||w||
                col = torch.cat([h1 + h2, wnorm.reshape(1)]).cpu().numpy()
                h = np.zeros(restart + 1, dtype=hdt)
                h[: j + 2] = col
                for i in range(j):  # the earlier rotations
                    t1 = cs[i] * h[i] + sn[i] * h[i + 1]
                    t2 = -sn[i] * h[i] + cs[i] * h[i + 1]
                    h[i], h[i + 1] = t1, t2
                denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
                safe_d = denom if denom != 0 else hdt(1.0)
                cj = h[j] / safe_d if denom != 0 else hdt(1.0)
                sj = h[j + 1] / safe_d if denom != 0 else hdt(0.0)
                h[j] = cj * h[j] + sj * h[j + 1]
                h[j + 1] = 0.0
                g_j1 = -sj * g[j]
                # degenerate column: the rotated diagonal is zero, i.e.
                # A M V[j] lies in the previous Krylov subspace (a lucky
                # breakdown); taking it would put a zero on R's diagonal,
                # so the cycle ends and the true-residual check decides
                degenerate = bool(denom <= 0)
                if not degenerate:
                    V[j + 1] = w / torch.where(wnorm != 0, wnorm, torch.ones_like(wnorm))
                    H[:, j] = h
                    cs[j], sn[j] = cj, sj
                    g[j + 1], g[j] = g_j1, cj * g[j]
                    kdone = j + 1
                    if history:
                        hist[it + j + 1] = abs(g_j1)
                done = degenerate or abs(g_j1) <= target
            # the triangular system R y = g on the columns taken
            if kdone:
                y = scipy.linalg.solve_triangular(H[:kdone, :kdone], g[:kdone],
                                                check_finite=False)
                dx = V[:kdone].t() @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
            else:
                dx = torch.zeros_like(bf)
            # the Givens estimate can drift from the true residual when the
            # basis loses orthogonality: check the true residual (reused as
            # the next cycle's r)
            x_new = x + Mf(dx)
            r_new = bf - Af(x_new)
            rnorm_new = _norm(r_new, allreduce)
            rn_new = hdt(rnorm_new.item())
            # reject a non-finite update: keep the last good iterate;
            # ``it`` still advances, so the loop ends at max_iter
            if np.isfinite(rn_new):
                x, r, rnorm, rn = x_new, r_new, rnorm_new, rn_new
                if history:
                    hist[it + kdone] = rn_new
            it += max(kdone, 1)
    res = KrylovResult(x=x.reshape(shape), iterations=it, residual_norm=rnorm,
                       r0_norm=r0_norm)
    return (res, hist) if history else res

"""Krylov solvers in PyTorch: right-preconditioned BiCGStab
(``BiCGStab.h:45-106``) and restarted GMRES.

Port of ``pressurepoissonsolver_tpu.krylov.bicgstab`` and ``gmres``: the
same recurrences, breakdown guards, stop rules and iteration counts.  The
reference runs each loop inside one ``lax.while_loop``; here the loops are
Python.  BiCGStab reads one scalar back to the host per iteration (its
stop test) and keeps every other scalar of the recurrence on the device;
GMRES reads the new Hessenberg column per Arnoldi step and runs the Givens
rotations and the small triangular solve on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

Op = Callable[[torch.Tensor], torch.Tensor]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


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


def bicgstab_init(A: Op, b: torch.Tensor, x0: Optional[torch.Tensor] = None):
    """Initial state and ``||r0||``."""
    if x0 is None:
        x, r = torch.zeros_like(b), b  # b - A(0) = b
    else:
        x, r = x0, b - A(x0)
    return BiCGStabState(x=x, r=r, p=r, rho=_dot(r, r), rhat=r), _norm(r)


def bicgstab_step(A: Op, M: Optional[Op], st: BiCGStabState) -> BiCGStabState:
    """One BiCGStab iteration; launches device work only (no host read)."""
    x, r, p, rho, rhat = st
    mp = p if M is None else M(p)
    ap = A(mp)
    alpha = _safe_div(rho, _dot(rhat, ap))
    s = r - alpha * ap
    ms = s if M is None else M(s)
    as_ = A(ms)
    omega = _safe_div(_dot(as_, s), _dot(as_, as_))
    x = x + alpha * mp + omega * ms
    r = r - alpha * ap - omega * as_
    rho_new = _dot(r, rhat)
    beta = _safe_div(rho_new * alpha, rho * omega)
    p = beta * (p - omega * ap) + r
    return BiCGStabState(x=x, r=r, p=p, rho=rho_new, rhat=rhat)


def bicgstab(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    max_iter: int = 1000,
) -> KrylovResult:
    """Right-preconditioned BiCGStab (``BiCGStab.h:45-106``).

    The stop test compares in the working dtype, as the reference does; a
    zero initial residual gives ``nan > tol`` = False and stops at once."""
    st, r0_norm = bicgstab_init(A, b, x0)
    k = 0
    while k < max_iter:
        if not bool((_norm(st.r) / r0_norm > tol).item()):
            break
        st = bicgstab_step(A, M, st)
        k += 1
    return KrylovResult(x=st.x, iterations=k, residual_norm=_norm(st.r),
                        r0_norm=r0_norm)


def gmres(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    M: Optional[Op] = None,
    tol: float = 1e-12,
    restart: int = 30,
    max_iter: int = 1000,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES(restart) (the reference's
    ``gmres`` without ``history``): Arnoldi with two-pass modified
    Gram-Schmidt, Givens rotations, and the true residual checked at every
    cycle boundary; ``iterations`` advances by ``max(columns taken, 1)``
    per cycle and the loop stops once ``||r|| <= tol * ||r0||`` or
    ``iterations >= max_iter``.

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
    r0_norm = _norm(r)
    rnorm = r0_norm
    r0 = hdt(r0_norm.item())
    # tolerance on ||r||/||r0||, as bicgstab's
    target = r0 * hdt(tol)
    rn = r0
    it = 0
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
                w = w - Vj.t() @ h1
                h2 = Vj @ w
                w = w - Vj.t() @ h2
                wnorm = _norm(w)
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
            rnorm_new = _norm(r_new)
            rn_new = hdt(rnorm_new.item())
            # reject a non-finite update: keep the last good iterate;
            # ``it`` still advances, so the loop ends at max_iter
            if np.isfinite(rn_new):
                x, r, rnorm, rn = x_new, r_new, rnorm_new, rn_new
            it += max(kdone, 1)
    return KrylovResult(x=x.reshape(shape), iterations=it, residual_norm=rnorm,
                        r0_norm=r0_norm)

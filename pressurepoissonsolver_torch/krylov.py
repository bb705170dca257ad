"""Right-preconditioned BiCGStab (``BiCGStab.h:45-106``) in PyTorch.

Port of ``pressurepoissonsolver_tpu.krylov.bicgstab``: the same recurrence,
the same ``_safe_div`` breakdown guards and the same stop rule
(``||r|| / ||r0|| > tol`` and ``k < max_iter``, tested before every
iteration).  The reference runs the loop inside one ``lax.while_loop``;
here the loop is Python and the convergence test reads one scalar back to
the host per iteration (a device synchronisation).  Every other scalar of
the recurrence stays on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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

"""Iterative per-patch solver: batched BiCGStab over all patches at once.

Port of ``pressurepoissonsolver_tpu.ops.patch_bcgs``.  The reference's
``PatchSolvers/BiCGStabSolver.h:524-624`` runs a scalar BiCGStab per patch
as a fallback for operators the DST/DCT diagonalization cannot handle.
Here every patch runs at once: the per-patch scalars (rho, alpha, omega)
are ``[P]`` vectors and converged patches are frozen with masks.  The
reference loops in ``lax.while_loop`` while any patch is active; here the
loop is Python and reads that one flag back to the host per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch


def batched_patch_bicgstab(
    op_apply: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1e-12,
    max_iter: int = 1000,
) -> torch.Tensor:
    """Solve ``op(u_p) = b_p`` independently for every patch ``p``.

    ``op_apply`` must act patchwise (block-diagonal over the leading axis),
    e.g. the homogeneous patch stencil with fixed interface data folded
    into ``b`` beforehand.  A patch stops once its residual falls to
    ``tol`` times its initial one."""
    P = b.shape[0]
    bshape = (P,) + (1,) * (b.dim() - 1)

    def pdot(u, v):
        return (u.reshape(P, -1) * v.reshape(P, -1)).sum(dim=1)

    def bc(s):
        return s.reshape(bshape)

    def safe(d):  # 1 where d == 0 (the quotient is then masked to 0)
        return torch.where(d != 0, d, torch.ones_like(d))

    x = torch.zeros_like(b)
    r = b - op_apply(x)
    r0n = torch.sqrt(pdot(r, r))
    safe_r0n = torch.where(r0n > 0, r0n, torch.ones_like(r0n))
    rhat = r
    p = r
    rho = pdot(rhat, r)
    zero = torch.zeros_like(rho)
    k = 0
    while k < max_iter:
        mask = torch.sqrt(pdot(r, r)) / safe_r0n > tol  # the active patches
        if not bool(mask.any().item()):
            break
        ap = op_apply(p)
        denom = pdot(rhat, ap)
        alpha = torch.where(denom != 0, rho / safe(denom), zero)
        s = r - bc(alpha) * ap
        as_ = op_apply(s)
        as2 = pdot(as_, as_)
        omega = torch.where(as2 != 0, pdot(as_, s) / safe(as2), zero)
        x_new = x + bc(alpha) * p + bc(omega) * s
        r_new = r - bc(alpha) * ap - bc(omega) * as_
        rho_new = pdot(r_new, rhat)
        beta = torch.where((rho != 0) & (omega != 0),
                           rho_new * alpha / safe(rho * omega), zero)
        p_new = r_new + bc(beta) * (p - bc(omega) * ap)
        # freeze converged patches
        mk = bc(mask.to(x.dtype))
        x = x + mk * (x_new - x)
        r = r + mk * (r_new - r)
        p = p + mk * (p_new - p)
        rho = torch.where(mask, rho_new, rho)
        k += 1
    return x


class BcgsPatchSolver:
    """The per-patch systems of a level's spectral patch solve, solved
    iteratively: the interface values are folded into the right-hand side,
    then the homogeneous patch stencil (``apply_with_interface`` with zero
    interface data, through the stencil kernel) is inverted by
    :func:`batched_patch_bicgstab`."""

    def __init__(self, level, tol: float = 1e-12, max_iter: int = 1000):
        self.level = level
        self.tol = tol
        self.max_iter = max_iter

    def patch_solve(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        lvl = self.level
        fc = lvl.fold_gamma(f, gamma)
        zero_gamma = lvl.gamma_zeros(f.dtype)

        def op(u):
            return lvl.apply_with_interface(u, zero_gamma)

        return batched_patch_bicgstab(op, fc, tol=self.tol, max_iter=self.max_iter)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.patch_solve(f, self.level.interpolate(u))

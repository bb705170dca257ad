"""Iterative per-patch solver: batched BiCGStab over all patches at once.

Port of ``pressurepoissonsolver_tpu.ops.patch_bcgs``.  The reference's
``PatchSolvers/BiCGStabSolver.h:524-624`` runs a scalar BiCGStab per patch
as a fallback for operators the DST/DCT diagonalization cannot handle.
Here every patch runs at once: the per-patch scalars (rho, alpha, omega)
are ``[P]`` vectors and converged patches are frozen with masks.  The
reference loops in one ``lax.while_loop`` while any patch is active and
fewer than ``max_iter`` passes ran; here the loop is an init, a guarded
pass (device work only: the pass, ``k + 1`` and that guard on the
device) and the result.  The plain version reads the guard to the host
before every pass (the CPU, eager solves).  Inside a piece that
``utils.graphs`` captures (a smoothing of a V-cycle, inside a Krylov step
or the Schur operator), :class:`PatchBicgstab` runs it as a loop of the
solve's one graph launch (``utils.graphs.PieceLoop``): its pass is
captured once per operator, shape and dtype, during the warm-up of that
capture.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..krylov import read_flag
from ..utils import graphs


class _Bcgs(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor  # [P]
    rhat: torch.Tensor
    safe_r0n: torch.Tensor  # [P]: ||r0|| per patch, 1 where it is 0
    tol: torch.Tensor
    max_iter: torch.Tensor
    k: torch.Tensor  # passes, int64
    go: torch.Tensor  # another pass: a patch is active and k < max_iter


def _pdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    P = u.shape[0]
    return (u.reshape(P, -1) * v.reshape(P, -1)).sum(dim=1)


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape((like.shape[0],) + (1,) * (like.dim() - 1))


def _safe(d: torch.Tensor) -> torch.Tensor:  # 1 where d == 0 (the quotient is then masked to 0)
    return torch.where(d != 0, d, torch.ones_like(d))


def _active(r: torch.Tensor, s) -> torch.Tensor:
    """The patches whose residual is still above ``tol`` times their
    initial one."""
    return torch.sqrt(_pdot(r, r)) / s.safe_r0n > s.tol


def bicgstab_init(op_apply: Callable, b: torch.Tensor, tol, max_iter: int) -> _Bcgs:
    """The state a solve of ``op(u_p) = b_p`` starts from."""
    x = torch.zeros_like(b)
    r = b - op_apply(x)
    r0n = torch.sqrt(_pdot(r, r))
    safe_r0n = torch.where(r0n > 0, r0n, torch.ones_like(r0n))
    rho = _pdot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    s = _Bcgs(x, r, r, rho, r, safe_r0n, torch.full((), tol, dtype=b.dtype, device=b.device),
              torch.full((), max_iter, dtype=torch.int64, device=b.device), k, None)
    return s._replace(go=_active(r, s).any() & (k < s.max_iter))


def bicgstab_step(op_apply: Callable, s: _Bcgs) -> _Bcgs:
    """One pass over every patch, the converged ones frozen: device work
    only (the recurrences of the reference's body, ``k + 1`` and the
    guard)."""
    x, r, p, rho, rhat = s[:5]
    mask = _active(r, s)
    ap = op_apply(p)
    denom = _pdot(rhat, ap)
    zero = torch.zeros_like(rho)
    alpha = torch.where(denom != 0, rho / _safe(denom), zero)
    s_ = r - _bc(alpha, r) * ap
    as_ = op_apply(s_)
    as2 = _pdot(as_, as_)
    omega = torch.where(as2 != 0, _pdot(as_, s_) / _safe(as2), zero)
    x_new = x + _bc(alpha, r) * p + _bc(omega, r) * s_
    r_new = r - _bc(alpha, r) * ap - _bc(omega, r) * as_
    rho_new = _pdot(r_new, rhat)
    beta = torch.where((rho != 0) & (omega != 0), rho_new * alpha / _safe(rho * omega), zero)
    p_new = r_new + _bc(beta, r) * (p - _bc(omega, r) * ap)
    # freeze converged patches
    mk = _bc(mask.to(x.dtype), r)
    x = x + mk * (x_new - x)
    r = r + mk * (r_new - r)
    p = p + mk * (p_new - p)
    rho = torch.where(mask, rho_new, rho)
    k = s.k + 1
    s = s._replace(x=x, r=r, p=p, rho=rho, k=k)
    return s._replace(go=_active(r, s).any() & (k < s.max_iter))


def batched_patch_bicgstab(
    op_apply: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1e-12,
    max_iter: int = 1000,
) -> torch.Tensor:
    """Solve ``op(u_p) = b_p`` independently for every patch ``p``, eagerly
    (the guard read to the host before every pass).

    ``op_apply`` must act patchwise (block-diagonal over the leading axis),
    e.g. the homogeneous patch stencil with fixed interface data folded
    into ``b`` beforehand.  A patch stops once its residual falls to
    ``tol`` times its initial one."""
    s = bicgstab_init(op_apply, b, tol, max_iter)
    passes = 0
    while read_flag(s.go):
        s = bicgstab_step(op_apply, s)
        passes += 1
    graphs.note_inner(passes)
    return s.x


class PatchBicgstab:
    """:func:`batched_patch_bicgstab` for one operator ``op_apply``, which
    must read only static buffers (the level's tables and a zero interface
    vector kept here), so that its pass can be captured once per shape and
    dtype.  A call under the capture of a piece runs the loop as a loop of
    the solve's graph; during the capture's warm-up it captures the pass
    (kept in ``loops``) and runs from its replays; else it is the plain
    version."""

    def __init__(self, op_apply: Callable, tol: float = 1e-12, max_iter: int = 1000):
        self.op_apply = op_apply
        self.tol = tol
        self.max_iter = max_iter
        self.loops: dict = {}  # (shape, dtype, device) -> graphs.PieceLoop

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        key = (tuple(b.shape), b.dtype, b.device)
        if graphs.capturing(b):
            loop = self.loops.get(key)
            if loop is None:
                raise RuntimeError("the patch BiCGStab's pass is captured in the warm-up "
                                   "of graphs.capture, before the piece that runs it")
            s = bicgstab_init(self.op_apply, b, self.tol, self.max_iter)
            return loop.captured(s).x.clone()
        if graphs.warming():
            s = bicgstab_init(self.op_apply, b, self.tol, self.max_iter)
            loop = self.loops.get(key)
            if loop is None:
                loop = self.loops[key] = graphs.PieceLoop(
                    s, lambda st: bicgstab_step(self.op_apply, st), b.device)
            return loop.replay(s).x.clone()
        return batched_patch_bicgstab(self.op_apply, b, self.tol, self.max_iter)


class BcgsPatchSolver:
    """The per-patch systems of a level's spectral patch solve, solved
    iteratively: the interface values are folded into the right-hand side,
    then the homogeneous patch stencil (``apply_with_interface`` with zero
    interface data, through the stencil kernel) is inverted by
    :func:`batched_patch_bicgstab` (:class:`PatchBicgstab`)."""

    def __init__(self, level, tol: float = 1e-12, max_iter: int = 1000):
        self.level = level
        self.tol = tol
        self.max_iter = max_iter
        self._solve: dict = {}  # dtype -> PatchBicgstab

    def patch_solve(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        lvl = self.level
        fc = lvl.fold_gamma(f, gamma)
        solve = self._solve.get(f.dtype)
        if solve is None:
            zero_gamma = lvl.gamma_zeros(f.dtype)
            solve = self._solve[f.dtype] = PatchBicgstab(
                lambda u: lvl.apply_with_interface(u, zero_gamma), self.tol, self.max_iter)
        return solve(fc)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.patch_solve(f, self.level.interpolate(u))

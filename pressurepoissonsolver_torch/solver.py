"""High-level solve driver: GMG-preconditioned BiCGStab on the composite
operator, and mixed-precision iterative refinement.

Port of ``pressurepoissonsolver_tpu.solver`` for one device:

* ``solve``: BiCGStab on ``A u = f`` preconditioned by a GMG V-cycle
  (reference ``--prec GMG --solver thunderegg``).
* ``solve_refined``: f64 iterative refinement around f32 GMG-BiCGStab
  inner solves.  The reference runs the whole outer loop in one jitted
  ``lax.while_loop``; here it is host Python with the same best-iterate,
  stagnation and breakdown rules, reading one scalar per outer round.

Not ported yet: multi-device meshes, the Schur path, CG/GMRES/Richardson,
the Schwarz preconditioner and the monitored solves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .domain import DomainHierarchy
from .gmg import CycleOpts, build_gmg
from .krylov import KrylovResult, _norm, bicgstab
from .ops.level_ops import Level


@dataclass
class SolveOptions:
    tol: float = 1e-12
    max_iter: int = 1000
    gmg: CycleOpts = field(default_factory=CycleOpts)
    precondition: bool = True
    # dtype of the preconditioner levels; float32 gives mixed precision
    precond_dtype: torch.dtype = torch.float64
    dtype: torch.dtype = torch.float64
    krylov: str = "bicgstab"  # only "bicgstab" is ported
    inner_krylov: str = "bicgstab"  # only "bicgstab" is ported
    preconditioner: str = "gmg"  # "gmg" | "none"
    patch_solver: str = "dft"  # spectral patch solves
    iface_scheme: str = "bilinear"


class PoissonSolver:
    """Composite-grid Poisson solver over a domain hierarchy, on ``device``."""

    def __init__(
        self,
        hierarchy: DomainHierarchy,
        options: Optional[SolveOptions] = None,
        mesh=None,
        *,
        device,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        self.hierarchy = hierarchy
        self.opts = options or SolveOptions()
        self.device = torch.device(device)
        o = self.opts
        for name, val, ok in (
            ("krylov", o.krylov, ("bicgstab",)),
            ("inner_krylov", o.inner_krylov, ("bicgstab",)),
            ("preconditioner", o.preconditioner, ("gmg", "none")),
            ("patch_solver", o.patch_solver, ("dft",)),
            ("iface_scheme", o.iface_scheme, ("bilinear",)),
        ):
            if val not in ok:
                raise NotImplementedError(f"{name}={val!r} is not ported yet")
        self.fine_level = Level(
            hierarchy.finest, dtype=o.dtype, device=self.device,
            iface_scheme=o.iface_scheme,
        )
        if o.preconditioner != "gmg":
            o.precondition = False
        self.gmg = None
        if o.precondition:
            same = o.precond_dtype == o.dtype
            self.gmg = build_gmg(
                hierarchy, o.gmg, dtype=o.precond_dtype, device=self.device,
                fine=self.fine_level if same else None,
            )
        self._fine_low = None

    # -- operators ----------------------------------------------------------

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self.fine_level.apply(u)

    def _preconditioner(self) -> Optional[Callable]:
        if self.gmg is None:
            return None
        pdtype, dtype = self.opts.precond_dtype, self.opts.dtype

        def M(r):
            return self.gmg.apply(r.to(pdtype)).to(dtype)

        return M

    def _as_field(self, f) -> torch.Tensor:
        return torch.as_tensor(f, dtype=self.opts.dtype, device=self.device)

    # -- solves -------------------------------------------------------------

    def solve(
        self,
        f,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
    ) -> KrylovResult:
        """GMG-preconditioned BiCGStab on ``A u = f``."""
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        return bicgstab(self.fine_level.apply, self._as_field(f),
                        M=self._preconditioner(), tol=tol, max_iter=max_iter)

    def solve_refined(
        self,
        f,
        tol: Optional[float] = None,
        inner_tol: float = 1e-5,
        max_outer: int = 12,
        inner_max_iter: int = 60,
    ):
        """Mixed-precision iterative refinement: inner GMG-BiCGStab solves
        in the preconditioner dtype (f32), residual updates in f64.

        Returns ``(u, info)`` with ``outer_iterations`` (refinement rounds),
        ``inner_iterations`` (total BiCGStab iterations), ``residual`` (the
        final relative residual) and ``outer_history``."""
        tol = self.opts.tol if tol is None else tol
        pdtype = self.opts.precond_dtype
        if self._fine_low is None:
            if self.gmg is not None and self.gmg.levels[0].dtype == pdtype:
                self._fine_low = self.gmg.levels[0]
            else:
                self._fine_low = Level(self.hierarchy.finest, dtype=pdtype,
                                       device=self.device)
        low = self._fine_low
        M = self.gmg.apply if self.gmg is not None else None
        apply64 = self.fine_level.apply

        f = self._as_field(f)
        fnorm = _norm(f)
        fnorm = torch.where(fnorm > 0, fnorm, torch.ones_like(fnorm))
        u = torch.zeros_like(f)
        r = f
        best_u, best_rel = u, math.inf
        rel = 1.0
        k = inner_total = 0
        hist = [1.0]
        while True:
            e_res = bicgstab(low.apply, r.to(pdtype), M=M, tol=inner_tol,
                             max_iter=inner_max_iter)
            e = torch.where(torch.isfinite(e_res.x), e_res.x,
                            torch.zeros_like(e_res.x))
            u_new = u + e.to(f.dtype)
            r = f - apply64(u_new)
            rel_new = float((_norm(r) / fnorm).item())
            breakdown = not math.isfinite(rel_new)
            k += 1
            inner_total += e_res.iterations
            stagnated = k > 3 and rel_new > 0.5 * best_rel and rel_new > 10 * tol
            # on breakdown, fall back to the best iterate so far
            u, rel = (best_u, best_rel) if breakdown else (u_new, rel_new)
            if rel_new < best_rel:
                best_u, best_rel = u_new, rel_new
            hist.append(rel)
            if breakdown or rel_new <= tol or stagnated or k >= max_outer:
                break
        return u, {
            "outer_iterations": k,
            "inner_iterations": inner_total,
            "residual": rel,
            "outer_history": np.asarray(hist),
        }

    # -- diagnostics --------------------------------------------------------

    def report(self, u, f, exact, neumann: bool = False) -> dict:
        """Error/residual/conservation block (``apps/2d/steady.cpp:570-606``)."""
        lvl = self.fine_level
        u, f, exact = (self._as_field(x) for x in (u, f, exact))
        au = self.apply(u)
        resid = f - au
        out = {"residual": float((_norm(resid) / _norm(f)).item())}
        err = exact - u
        if neumann:
            # compare modulo the constant nullspace: shift the error to zero
            # mean (reference apps/2d/steady.cpp:588-599)
            uavg = lvl.integrate(u) / lvl.volume
            eavg = lvl.integrate(exact) / lvl.volume
            err = err - (eavg - uavg)
        out["error"] = float((_norm(err) / _norm(exact)).item())
        out["conservation"] = float((lvl.integrate(au) - lvl.integrate(f)).item())
        return out


def shift_for_neumann(level: Level, f: torch.Tensor) -> torch.Tensor:
    """Zero the mean of f (Neumann compatibility, ``steady.cpp:330-334``)."""
    fdiff = level.integrate(f) / level.volume
    return f - fdiff.to(f.dtype)

"""Manufactured-solution problems and RHS/BC setup.

Replicates the reference apps' problem menu and boundary folding
(``apps/shared/Init.cpp:57-361``, ``apps/2d/steady.cpp:246-320``,
``apps/3d/steady.cpp:218-286``):

* ``f`` is the PDE right-hand side sampled at cell centers
  (``start + h/2 + h*i``).
* Dirichlet: boundary cells get ``f -= 2*g(x_b)/h^2`` using the exact
  solution ``g`` evaluated at the wall (cell-face) position.
* Neumann: lower sides get ``f += g_n/h``, upper sides ``f -= g_n/h`` with
  the outward... axis-aligned derivative ``g_n`` at the wall.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .domain import PatchLevel


@dataclass
class Problem:
    """Manufactured solution: u = exact, -lap? Here f = Δ(exact)."""

    ffun: Callable  # f(x...) — the RHS (Laplacian of exact)
    gfun: Callable  # exact solution
    dfuns: Tuple[Callable, ...]  # per-axis derivative of exact (for Neumann)


def get_problem(name: str, D: int) -> Problem:
    """The reference app problem menu (2D: ``apps/2d/steady.cpp:246-320``;
    3D: ``apps/3d/steady.cpp:218-286``)."""
    pi = np.pi
    if D == 2:
        if name == "trig":
            g = lambda x, y: np.sin(pi * y) * np.cos(2 * pi * x)
            f = lambda x, y: -5 * pi * pi * np.sin(pi * y) * np.cos(2 * pi * x)
            dx = lambda x, y: -2 * pi * np.sin(pi * y) * np.sin(2 * pi * x)
            dy = lambda x, y: pi * np.cos(pi * y) * np.cos(2 * pi * x)
            return Problem(f, g, (dx, dy))
        if name == "gauss":
            x0 = y0 = 0.5
            al = 1000.0
            g = lambda x, y: np.exp(-al / 2 * ((x - x0) ** 2 + (y - y0) ** 2))
            def f(x, y):
                r2 = (x - x0) ** 2 + (y - y0) ** 2
                return np.exp(-al / 2 * r2) * (al * al * r2 - 2 * al)
            dx = lambda x, y: -al * (x - x0) * g(x, y)
            dy = lambda x, y: -al * (y - y0) * g(x, y)
            return Problem(f, g, (dx, dy))
        if name == "zero":
            z = lambda x, y: np.zeros_like(x)
            return Problem(z, z, (z, z))
        if name == "trig gauss":
            g = lambda x, y: np.exp(np.cos(10 * pi * x)) - np.exp(np.cos(11 * pi * y))
            def f(x, y):
                return (
                    100 * pi * pi
                    * (np.sin(10 * pi * x) ** 2 - np.cos(10 * pi * x))
                    * np.exp(np.cos(10 * pi * x))
                    + 121 * pi * pi
                    * (np.cos(11 * pi * y) - np.sin(11 * pi * y) ** 2)
                    * np.exp(np.cos(11 * pi * y))
                )
            dx = lambda x, y: -10 * pi * np.sin(10 * pi * x) * np.exp(np.cos(10 * pi * x))
            dy = lambda x, y: 11 * pi * np.sin(11 * pi * y) * np.exp(np.cos(11 * pi * y))
            return Problem(f, g, (dx, dy))
        if name == "circle":
            def f(x, y):
                out = np.zeros_like(x)
                d = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
                out = np.where(d < 0.2, 1.0, out)
                for i in range(4):
                    th = i * pi / 2
                    d = np.sqrt((x - (0.3 * np.cos(th) + 0.5)) ** 2 + (y - (0.3 * np.sin(th) + 0.5)) ** 2)
                    out = np.where(d < 0.1, 1.0, out)
                    th = pi / 4 + i * pi / 2
                    d = np.sqrt((x - (0.275 * np.cos(th) + 0.5)) ** 2 + (y - (0.275 * np.sin(th) + 0.5)) ** 2)
                    out = np.where(d < 0.075, 1.0, out)
                return out
            z = lambda x, y: np.zeros_like(x)
            return Problem(f, z, (z, z))
        raise ValueError(f"unknown 2D problem {name!r}")
    else:
        if name == "trig":
            # apps/3d/steady.cpp:252-286 (default problem)
            sh = 0.3
            g = lambda x, y, z: (
                np.sin(pi * (x + sh))
                * np.cos(2.0 / 3 * pi * (y + sh))
                * np.sin(5.0 / 6 * pi * (z + sh))
            )
            f = lambda x, y, z: -77.0 / 36 * pi * pi * g(x, y, z)
            dx = lambda x, y, z: (
                pi
                * np.cos(pi * (x + sh))
                * np.cos(2.0 / 3 * pi * (y + sh))
                * np.sin(5.0 / 6 * pi * (z + sh))
            )
            dy = lambda x, y, z: (
                -2.0 / 3 * pi
                * np.sin(pi * (x + sh))
                * np.sin(2.0 / 3 * pi * (y + sh))
                * np.sin(5.0 / 6 * pi * (z + sh))
            )
            dz = lambda x, y, z: (
                5.0 / 6 * pi
                * np.sin(pi * (x + sh))
                * np.cos(2.0 / 3 * pi * (y + sh))
                * np.cos(5.0 / 6 * pi * (z + sh))
            )
            return Problem(f, g, (dx, dy, dz))
        if name == "gauss":
            # apps/3d/steady.cpp:229-251 ("gauss" = trig-gauss product form)
            g = lambda x, y, z: (
                np.exp(np.cos(10 * pi * x))
                - np.exp(np.cos(11 * pi * y))
                + np.exp(np.cos(12 * pi * z))
            )
            def f(x, y, z):
                return -pi * pi * (
                    100 * np.exp(np.cos(10 * pi * x)) * np.cos(10 * pi * x)
                    - 100 * np.exp(np.cos(10 * pi * x)) * np.sin(10 * pi * x) ** 2
                    - 121 * np.exp(np.cos(11 * pi * y)) * np.cos(11 * pi * y)
                    + 121 * np.exp(np.cos(11 * pi * y)) * np.sin(11 * pi * y) ** 2
                    + 144 * np.exp(np.cos(12 * pi * z)) * np.cos(12 * pi * z)
                    - 144 * np.exp(np.cos(12 * pi * z)) * np.sin(12 * pi * z) ** 2
                )
            dx = lambda x, y, z: -10 * pi * np.sin(10 * pi * x) * np.exp(np.cos(10 * pi * x))
            dy = lambda x, y, z: 11 * pi * np.sin(11 * pi * y) * np.exp(np.cos(11 * pi * y))
            dz = lambda x, y, z: -12 * pi * np.sin(12 * pi * z) * np.exp(np.cos(12 * pi * z))
            return Problem(f, g, (dx, dy, dz))
        if name == "zero":
            z = lambda x, y, zz: np.zeros_like(x)
            return Problem(z, z, (z, z, z))
        raise ValueError(f"unknown 3D problem {name!r}")


def _wall_coords(level: PatchLevel, s: int) -> Tuple[np.ndarray, ...]:
    """Coordinates of boundary-cell centers with the side's axis snapped to
    the wall position (``Init.cpp:25-52``: index -1 -> start, n -> end)."""
    D, n = level.D, level.n
    centers = level.cell_centers()  # [P, *ns, D]
    a = s // 2
    ax = 1 + (D - 1 - a)
    sl = [slice(None)] * (D + 1)
    sl[ax] = 0 if s % 2 == 0 else n - 1
    face = centers[tuple(sl + [slice(None)])]  # [P, *face_dims, D]
    coords = [face[..., d].copy() for d in range(D)]
    wall = np.where(
        s % 2 == 0, level.starts[:, a], level.starts[:, a] + level.spacings[:, a] * n
    )
    shape = (level.num_patches,) + (1,) * (D - 1)
    coords[a] = np.broadcast_to(wall.reshape(shape), coords[a].shape).copy()
    return tuple(coords)


def init_problem(
    level: PatchLevel, problem: Problem, neumann: Optional[bool] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (f, exact) patch arrays with BCs folded into f
    (``Init.cpp:57-361``).

    The BC kind of each wall is read from ``level.neumann`` (per patch
    side — mixed Dirichlet/Neumann walls fold correctly, the reference
    ``IsNeumannFunc`` semantics).  ``neumann`` is kept for API
    compatibility as an all-walls override: ``True``/``False`` force every
    physical side; ``None`` (default) derives from the level."""
    D, n = level.D, level.n
    centers = level.cell_centers()
    args = tuple(centers[..., d] for d in range(D))
    f = np.asarray(problem.ffun(*args), dtype=np.float64)
    exact = np.asarray(problem.gfun(*args), dtype=np.float64)
    if f.shape != centers.shape[:-1]:
        f = np.broadcast_to(f, centers.shape[:-1]).copy()
    if exact.shape != centers.shape[:-1]:
        exact = np.broadcast_to(exact, centers.shape[:-1]).copy()

    for s in range(2 * D):
        a = s // 2
        phys = level.nbr_type[:, s] == 0
        if not phys.any():
            continue
        wall = _wall_coords(level, s)
        ax = 1 + (D - 1 - a)
        sl = [slice(None)] * (D + 1)
        sl[ax] = 0 if s % 2 == 0 else n - 1
        sl = tuple(sl)
        h = level.spacings[:, a].reshape((level.num_patches,) + (1,) * (D - 1))
        if neumann is None:
            is_neu = phys & level.neumann[:, s]
        else:
            is_neu = phys & neumann
        shape = (level.num_patches,) + (1,) * (D - 1)
        mask_neu = is_neu.reshape(shape)
        mask_dir = (phys & ~is_neu).reshape(shape)
        if mask_neu.any():
            gn = np.asarray(problem.dfuns[a](*wall), dtype=np.float64)
            sign = 1.0 if s % 2 == 0 else -1.0
            f[sl] += np.where(mask_neu, sign * gn / h, 0.0)
        if mask_dir.any():
            g = np.asarray(problem.gfun(*wall), dtype=np.float64)
            f[sl] -= np.where(mask_dir, 2.0 * g / (h * h), 0.0)
    if level.num_real is not None:
        # padded dummy patches (sharded levels) carry zero data
        f[level.num_real:] = 0.0
        exact[level.num_real:] = 0.0
    return f, exact

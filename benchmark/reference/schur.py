"""The plain Schur-complement (interface) system, worked out again from the
leaf boxes.

A plain reference in the manner of ``composite.py``, whose neighbour
geometry it reuses: plain PyTorch in float64, importing nothing of the
program.  The reference library's interface path (``SchurHelper.h:281-317``,
``SchurWrapOp.h:47-53``) is three maps:

* ``solve(f, gamma)``: every patch solved on its own, its ghost cells closed
  by the interface values ``gamma`` of its sides (``ghost = 2 gamma - u_b``;
  ``gamma = 0`` on a Dirichlet wall), the 5-point (7-point) cell-centred
  Laplacian ``sum_axes (u_lo - 2 u + u_hi) / h^2 = f``;
* ``interp(u)``: the interface values of every patch side from the
  patches' boundary cells, by the bilinear (trilinear) closure of
  ``composite.py`` (same-size neighbour: the mean of the two boundary
  cells; a coarser neighbour: ``u_b + (u_c - mean_b) / 3``; finer
  neighbours: ``u_b / 3 + 2/3 mean_f``);
* ``S gamma = interp(solve(0, gamma))``; the interface system is ``(I - S)
  gamma = interp(solve(f, 0))`` and the answer ``u = solve(f, gamma)``.

Its fixed point ``gamma = interp(solve(f, gamma))`` makes ``u`` the
composite answer, ``A u = f`` with ``composite.CompositeOperator``'s ``A``.

Departures from ``SchurHelper.h`` / ``SchurWrapOp.h``, none of which changes
the answer:

* numbering: one interface vector entry per patch side, ``[P, 2D, n^(D-1)]``
  (zero on walls), not one per interface: the two sides of a same-size
  interface hold the same value twice, and each side of a refinement
  boundary holds its own, as the library's fine and coarse interfaces do.
  Norms of interface vectors weigh a same-size interface twice;
* patch solves: the eigenvectors of the 1D matrix of a patch row with both
  ghosts closed (``-3, 1`` at its ends, ``1, -2, 1`` inside), from
  ``torch.linalg.eigh``, in place of the library's FFTW sine transforms of
  the same operator;
* solves of the interface system: dense (:func:`SchurReference.dense_solve`,
  small sizes only) in place of a Krylov method; and no MPI scatter of the
  interface vector;
* Dirichlet walls and the bilinear closure only (no Neumann patch, no
  quadratic closure), as the benchmark's configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

from .composite import CompositeOperator

#: patches solved at a time: the work arrays of a block are a few times the
#: block's field, so that a residual fits beside nothing else on the card
BLOCK = 1 << 15


class SchurReference:
    """The three maps of the module docstring on the leaves ``(starts,
    lengths)`` (``[P, D]`` each), ``n`` cells per patch side, in float64 on
    ``device``."""

    def __init__(self, starts: np.ndarray, lengths: np.ndarray, n: int, device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.op = CompositeOperator(starts, lengths, n, device=device)
        self.P, self.D, self.n = self.op.P, self.op.D, n
        self.device = self.op.device
        t = -2.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
        t[0, 0] = t[-1, -1] = -3.0
        lam, vec = np.linalg.eigh(t)
        self.vec = torch.as_tensor(vec, dtype=torch.float64, device=self.device)
        grid = torch.as_tensor(lam, dtype=torch.float64, device=self.device)
        denom = grid
        for _ in range(self.D - 1):
            denom = denom.unsqueeze(0) + grid.reshape((-1,) + (1,) * denom.dim())
        self.denom = denom  # [n]*D: the sums of the axes' eigenvalues
        self.h2 = torch.as_tensor(np.asarray(lengths)[:, 0] / n, dtype=torch.float64,
                                  device=self.device) ** 2
        self.walls = torch.stack([s["kind"] == 0 for s in self.op.sides], dim=1)  # [P, 2D]

    # -- the three maps ------------------------------------------------------

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """``V^T`` (``V`` with ``inverse``) along every cell axis of ``x``."""
        v = self.vec if inverse else self.vec.T
        for ax in range(1, self.D + 1):
            x = torch.movedim(torch.tensordot(x, v, dims=([ax], [1])), -1, ax)
        return x

    def solve(self, f: torch.Tensor, gamma: torch.Tensor, rows=slice(None)) -> torch.Tensor:
        """``solve(f, gamma)`` of the patches ``rows``: ``f`` their
        ``[B, *(n,)*D]`` right-hand sides, ``gamma`` their ``[B, 2D, m]``
        interface values."""
        u = f.to(torch.float64).clone()
        h2 = self.h2[rows].reshape((-1,) + (1,) * self.D)
        g = gamma.to(torch.float64).reshape((u.shape[0], 2 * self.D) + (self.n,) * (self.D - 1))
        for s in range(2 * self.D):
            face = self.op._face(u, s)
            face -= 2.0 * g[:, s] / h2.reshape((-1,) + (1,) * (self.D - 1))
        return self._transform(self._transform(u * h2, False) / self.denom, True)

    def faces(self, u: torch.Tensor) -> torch.Tensor:
        """The boundary cells of every side, ``[B, 2D, *(n,)*(D-1)]``."""
        return torch.stack([self.op._face(u, s) for s in range(2 * self.D)], dim=1)

    def interp(self, faces: torch.Tensor) -> torch.Tensor:
        """``interp``: the interface values ``[P, 2D, m]`` of every patch
        side from every patch's boundary cells ``faces`` (:meth:`faces`;
        the closures read nothing else)."""
        op, D = self.op, self.D
        out = []
        for s in range(2 * D):
            t = op.sides[s]
            kind = t["kind"].reshape([-1] + [1] * (D - 1))
            ub, opp = faces[:, s], faces[:, s ^ 1]
            nbr0 = t["nbr"][:, 0]
            same = 0.5 * (ub + opp[nbr0])
            coarse = ub + (op._coarse_at_fine(opp[nbr0], t["offs"])
                           - op._up(op._block_mean(ub))) / 3.0
            fine = ub / 3.0 + (2.0 / 3.0) * self._fine_mean(opp, t["nbr"])
            gamma = torch.where(kind == 1, same, torch.where(kind == 2, coarse, fine))
            out.append(torch.where(kind == 0, torch.zeros_like(gamma), gamma))
        return torch.stack(out, dim=1).reshape(self.P, 2 * D, -1)

    def _fine_mean(self, opp: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        """``composite.CompositeOperator._fine_mean`` from the faces
        ``opp`` (each patch's face on the opposite side)."""
        parts = [self.op._block_mean(opp[nbr[:, k]]) for k in range(nbr.shape[1])]
        if self.D == 2:
            return torch.cat(parts, dim=1)
        rows = [torch.cat([parts[b0 + 2 * b1] for b1 in (0, 1)], dim=2) for b0 in (0, 1)]
        return torch.cat(rows, dim=1)

    def trace(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """``interp(solve(f, gamma))``, solved in blocks of :data:`BLOCK`
        patches, keeping only each block's boundary cells."""
        faces = []
        for a in range(0, self.P, BLOCK):
            rows = slice(a, min(a + BLOCK, self.P))
            faces.append(self.faces(self.solve(f[rows], gamma[rows], rows)))
        return self.interp(torch.cat(faces, dim=0))

    def S(self, gamma: torch.Tensor) -> torch.Tensor:
        """``S gamma = interp(solve(0, gamma))``."""
        zero = torch.zeros((self.P,) + (self.n,) * self.D, dtype=torch.float64,
                           device=self.device)
        return self.trace(zero, gamma)

    # -- the check and the small-size solve ----------------------------------

    def interface_residual(self, u: torch.Tensor, f: torch.Tensor) -> float:
        """``||interp(solve(f, interp(u))) - interp(u)|| / ||interp(solve(f,
        0))||`` of an answer ``u`` to ``A u = f``, from ``u`` alone, in this
        module's numbering: 0 at the composite answer."""
        f = f.to(device=self.device, dtype=torch.float64)
        u = u.to(device=self.device, dtype=torch.float64)
        g = self.interp(self.faces(u))
        r = self.trace(f, g) - g
        b = self.trace(f, torch.zeros_like(g))
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))

    def dense_solve(self, f: torch.Tensor) -> torch.Tensor:
        """``u = solve(f, gamma)`` with ``(I - S) gamma = interp(solve(f,
        0))`` solved densely over the sides that are not walls: ``S`` probed
        one unit vector at a time.  Small sizes only."""
        m = self.n ** (self.D - 1)
        live = (~self.walls).reshape(-1).repeat_interleave(m)  # [P * 2D * m]
        idx = torch.nonzero(live).reshape(-1)
        N = idx.numel()
        cols = []
        for j in range(N):
            e = torch.zeros(self.P * 2 * self.D * m, dtype=torch.float64, device=self.device)
            e[idx[j]] = 1.0
            cols.append(self.S(e.reshape(self.P, 2 * self.D, m)).reshape(-1)[idx])
        S = torch.stack(cols, dim=1)
        f = f.to(device=self.device, dtype=torch.float64)
        b = self.trace(f, torch.zeros((self.P, 2 * self.D, m), dtype=torch.float64,
                                      device=self.device)).reshape(-1)[idx]
        g = torch.linalg.solve(torch.eye(N, dtype=torch.float64, device=self.device) - S, b)
        gamma = torch.zeros(self.P * 2 * self.D * m, dtype=torch.float64, device=self.device)
        gamma[idx] = g
        return self.solve(f, gamma.reshape(self.P, 2 * self.D, m))

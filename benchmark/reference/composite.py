"""The plain composite-grid operator, worked out again from the leaf boxes.

This is the benchmark's plain reference: plain PyTorch, independent of the
program's tables and kernels.  It imports nothing of the program.  It takes
the leaves of the finest composite level (their lower corners and edge
lengths, in the order the program holds its patches) and the patch size
``n``, finds each patch side's neighbours by geometry, and applies the
cell-centred Laplacian with the ghost closure of the reference library
(``ghost = -u_b + 2 gamma``; ``ghost = -u_b`` on a Dirichlet wall):

    (A u)_cell = sum_axes (u_lo - 2 u + u_hi) / h_axis^2.

The interface value ``gamma`` of a side (the reference's bilinear 2D and
trilinear 3D trace interpolation, ``BilinearInterpolator.cpp``,
``TriLinInterp.cpp``; the JAX package's ``matrix.py`` writes the same
operator as ``A = L_patch + G Gamma``):

* same-size neighbour: the mean of the two boundary cells;
* coarser neighbour (this side fine): ``u_b + (u_c - mean_b) / 3``, with
  ``u_c`` the coarse boundary cell facing the fine one and ``mean_b`` the
  mean of the fine boundary cells in its block of ``2^(D-1)``;
* finer neighbours (this side coarse): ``u_b / 3 + 2/3 * mean_f``, with
  ``mean_f`` the mean of the ``2^(D-1)`` fine boundary cells facing it.
"""

from __future__ import annotations

import numpy as np
import torch


class CompositeOperator:
    """``A`` of the finest composite level of the leaves ``(starts,
    lengths)`` (``[P, D]`` each), ``n`` cells per patch side, Dirichlet on
    every wall of the unit square or cube."""

    def __init__(self, starts: np.ndarray, lengths: np.ndarray, n: int, device="cpu"):
        P, D = starts.shape
        if n % 2:
            raise ValueError("n must be even (a fine face pairs its cells)")
        if not np.all(lengths == lengths[:, :1]):
            raise ValueError("patches must be cubes")
        self.P, self.D, self.n = P, D, n
        self.device = torch.device(device)
        self.h2inv = torch.as_tensor(1.0 / (lengths / n) ** 2, dtype=torch.float64,
                                     device=self.device)  # [P, D]
        self.sides = [self._side(starts, lengths[:, 0], s) for s in range(2 * D)]

    def _side(self, starts: np.ndarray, L: np.ndarray, s: int) -> dict:
        """The neighbours of every patch across side ``s``, found by looking
        up the leaf boxes that can lie there: one of the same size, one twice
        as large, or ``2^(D-1)`` half as large (kind 1, 2, 3; 0 a wall)."""
        P, D = starts.shape
        a, upper = s // 2, s & 1
        half = 1 << (D - 1)
        # leaf corners and sizes as whole multiples of the smallest leaf side
        M = float(1.0 / L.min())
        I = np.rint(starts * M).astype(np.int64)  # [P, D]
        S = np.rint(L * M).astype(np.int64)  # [P]
        if not (np.array_equal(I / M, starts) and np.array_equal(S / M, L)):
            raise ValueError("leaf corners must lie on the grid of the smallest leaf")
        base = int(round(M)) + 1
        keys = self._keys(S, I, base)
        order = np.argsort(keys)
        sorted_keys = keys[order]

        def find(size, corner):
            k = self._keys(size, corner, base)
            pos = np.clip(np.searchsorted(sorted_keys, k), 0, P - 1)
            return np.where(sorted_keys[pos] == k, order[pos], -1)

        step = np.zeros((P, D), dtype=np.int64)
        step[:, a] = 1
        same = find(S, I + (S if upper else -S)[:, None] * step)
        S2 = 2 * S
        cI = (I // S2[:, None]) * S2[:, None]
        cI[:, a] = I[:, a] + S if upper else I[:, a] - S2
        coarse = find(S2, cI)
        tang = [d for d in range(D) if d != a]
        # face array axes run over the tangential axes from the slowest
        # (highest spatial axis) to the fastest (x)
        face_axes = tang[::-1]
        Sh = S // 2
        fine = np.empty((P, half), dtype=np.int64)
        for k in range(half):
            fI = I.copy()
            fI[:, a] = I[:, a] + S if upper else I[:, a] - Sh
            for j, d in enumerate(face_axes):
                fI[:, d] += ((k >> j) & 1) * Sh
            fine[:, k] = np.where(S % 2 == 0, find(Sh, fI), -1)
        kind = np.zeros(P, dtype=np.int64)
        nbr = np.zeros((P, half), dtype=np.int64)
        offs = np.zeros((P, D - 1), dtype=np.int64)
        is_same = same >= 0
        is_coarse = ~is_same & (coarse >= 0)
        is_fine = ~is_same & ~is_coarse & np.all(fine >= 0, axis=1)
        kind[is_same], nbr[is_same, 0] = 1, same[is_same]
        kind[is_coarse], nbr[is_coarse, 0] = 2, coarse[is_coarse]
        q = coarse[is_coarse]
        for j, d in enumerate(face_axes):
            offs[is_coarse, j] = (I[is_coarse, d] - I[q, d]) // S[is_coarse]
        kind[is_fine], nbr[is_fine] = 3, fine[is_fine]
        plane = starts[:, a] + (L if upper else 0.0)
        inner = (kind == 0) & (plane > 0.0) & (plane < 1.0)
        if inner.any():
            p = int(np.flatnonzero(inner)[0])
            raise ValueError(f"patch {p} side {s}: an inner face with no neighbour "
                             "(open, or not 2:1 balanced)")
        dev = self.device
        return {"kind": torch.as_tensor(kind, device=dev),
                "nbr": torch.as_tensor(nbr, device=dev),
                "offs": torch.as_tensor(offs, device=dev)}  # [P, D-1]

    @staticmethod
    def _keys(size: np.ndarray, corner: np.ndarray, base: int) -> np.ndarray:
        """One integer per box (side ``size``, lower corner ``corner``); a
        corner outside ``[0, base)`` gets a key no leaf has."""
        key = size.astype(np.int64).copy()
        outside = np.zeros(len(size), dtype=bool)
        for d in range(corner.shape[1]):
            c = corner[:, d]
            outside |= (c < 0) | (c >= base)
            key = key * base + c
        return np.where(outside, -1 - np.arange(len(size)), key)

    # -- faces ----------------------------------------------------------------

    def _axis(self, s: int) -> int:
        """Array axis of side ``s``'s normal (x is the last axis)."""
        return 1 + (self.D - 1 - s // 2)

    def _face(self, u: torch.Tensor, s: int) -> torch.Tensor:
        return u.select(self._axis(s), self.n - 1 if s & 1 else 0)

    def _block_mean(self, face: torch.Tensor) -> torch.Tensor:
        """Means of the 2^(D-1) blocks of a face ``[P, n(, n)]``, one value
        per block: ``[P, n/2(, n/2)]``."""
        h = self.n // 2
        if self.D == 2:
            return face.reshape(-1, h, 2).mean(2)
        return face.reshape(-1, h, 2, h, 2).mean((2, 4))

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        """Each value of a face repeated over its 2^(D-1) block."""
        for ax in range(1, self.D):
            x = x.repeat_interleave(2, dim=ax)
        return x

    def _coarse_at_fine(self, cface: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """The coarse face ``cface[p]`` (``[P, n(, n)]``) read at this fine
        face's cells: cell ``i`` reads ``(i + off * n) // 2`` on each face
        axis."""
        n = self.n
        i = torch.arange(n, device=cface.device)
        out = cface
        for j in range(self.D - 1):
            idx = (i[None, :] + offs[:, j:j + 1] * n) // 2  # [P, n]
            shape = [cface.shape[0]] + [1] * (self.D - 1)
            shape[1 + j] = n
            idx = idx.reshape(shape).expand(out.shape[:1 + j] + (n,) + out.shape[2 + j:])
            out = torch.gather(out, 1 + j, idx)
        return out

    def _fine_mean(self, u: torch.Tensor, s: int, nbr: torch.Tensor) -> torch.Tensor:
        """For a coarse side: the block means of its fine neighbours' faces,
        assembled into one face ``[P, n(, n)]``."""
        opp = s ^ 1
        parts = [self._block_mean(self._face(u, opp)[nbr[:, k]]) for k in range(nbr.shape[1])]
        if self.D == 2:
            return torch.cat(parts, dim=1)
        # bit 0 of k: offset along face axis 0, bit 1: along face axis 1
        rows = [torch.cat([parts[b0 + 2 * b1] for b1 in (0, 1)], dim=2) for b0 in (0, 1)]
        return torch.cat(rows, dim=1)

    def ghost(self, u: torch.Tensor, s: int) -> torch.Tensor:
        """The ghost layer outside side ``s`` of every patch."""
        t = self.sides[s]
        kind = t["kind"].reshape([-1] + [1] * (self.D - 1))
        ub = self._face(u, s)
        opp = self._face(u, s ^ 1)
        nbr0 = t["nbr"][:, 0]
        same = 0.5 * (ub + opp[nbr0])
        coarse = ub + (self._coarse_at_fine(opp[nbr0], t["offs"])
                       - self._up(self._block_mean(ub))) / 3.0
        fine = ub / 3.0 + (2.0 / 3.0) * self._fine_mean(u, s, t["nbr"])
        gamma = torch.where(kind == 1, same, torch.where(kind == 2, coarse, fine))
        return torch.where(kind == 0, -ub, 2.0 * gamma - ub)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """``A u`` for ``u`` of shape ``[P, *(n,)*D]``, in ``u``'s dtype."""
        D, n = self.D, self.n
        out = torch.zeros_like(u)
        for a in range(D):
            ax = 1 + (D - 1 - a)
            lo = torch.cat([self.ghost(u, 2 * a).unsqueeze(ax), u.narrow(ax, 0, n - 1)], dim=ax)
            hi = torch.cat([u.narrow(ax, 1, n - 1), self.ghost(u, 2 * a + 1).unsqueeze(ax)],
                           dim=ax)
            out += (lo - 2.0 * u + hi) * self.h2inv[:, a].to(u.dtype).reshape(
                [-1] + [1] * D)
        return out


def relative_residual(op: CompositeOperator, u: torch.Tensor, f: torch.Tensor) -> float:
    """``||f - A u||_2 / ||f||_2`` in float64."""
    u64, f64 = u.to(torch.float64), f.to(torch.float64)
    r = f64 - op.apply(u64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(f64))

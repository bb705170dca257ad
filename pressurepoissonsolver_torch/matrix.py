"""Explicit matrix assembly for the composite operator (host, numpy/scipy).

Carried from ``pressurepoissonsolver_tpu.matrix`` (the CSR assembly only):
the global CSR matrix is composed algebraically from the same host tables
the matrix-free path uses,

    ``A = L_patch + G @ Gamma``

where ``L_patch`` is the block-diagonal patch stencil (with the per-side
boundary coefficients), ``Gamma`` the trace-interpolation matrix
(u -> interface values) and ``G`` the ghost-closure injection
(``+2 gamma / h^2`` into boundary rows).  By construction the assembled
matrix is *exactly* the matrix-free operator.  Here it serves the dense
coarse-level inverse of the multigrid cycle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from .domain import PatchLevel
from .iface import IfaceTables, build_iface_tables


def _face_cell_flat(D: int, n: int, s: int, depth: int = 0) -> np.ndarray:
    """Flat in-patch cell index of each face-vector entry of side ``s``,
    ``depth`` cells inward from the boundary.

    Face vector order: lowest remaining axis fastest; patch flat order:
    C order of [z, y, x] (x fastest)."""
    a = s // 2
    fixed = depth if s % 2 == 0 else n - 1 - depth
    m = n ** (D - 1)
    idx = np.arange(m)
    coords = np.zeros((m, D), dtype=np.int64)  # coords[:, axis]
    rem = [ax for ax in range(D) if ax != a]
    for k, ax in enumerate(rem):
        coords[:, ax] = (idx // (n**k)) % n
    coords[:, a] = fixed
    flat = np.zeros(m, dtype=np.int64)
    for ax in range(D):
        flat += coords[:, ax] * (n**ax)
    return flat


def assemble_interpolation(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``Gamma``: (num_ifaces*m) x (P*n^D) trace-interpolation matrix."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    depth = getattr(t, "face_depth", 1)
    rows, cols, vals = [], [], []
    for c in range(len(t.contrib_patch)):
        p = int(t.contrib_patch[c])
        code = int(t.contrib_side[c])
        s, d = (code // depth, code % depth) if depth > 1 else (code, 0)
        i = int(t.contrib_iface[c])
        k = int(t.contrib_case[c])
        W = t.case_w[k]  # [m, K]
        S = t.case_src[k]
        face_flat = _face_cell_flat(D, n, s, d)
        for out_i in range(m):
            for kk in range(W.shape[1]):
                w = W[out_i, kk]
                if w != 0.0:
                    rows.append(i * m + out_i)
                    cols.append(p * cells + face_flat[S[out_i, kk]])
                    vals.append(w)
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(t.num_ifaces * m, level.num_patches * cells)
    )


def assemble_patch_stencil(level: PatchLevel) -> sp.csr_matrix:
    """Block-diagonal patch Laplacian with boundary-closure coefficients
    (the homogeneous part of ``StarPatchOp::applyWithInterface``)."""
    D, n = level.D, level.n
    P = level.num_patches
    cells = n**D
    rows, cols, vals = [], [], []
    coords = np.zeros((cells, D), dtype=np.int64)
    idx = np.arange(cells)
    for ax in range(D):
        coords[:, ax] = (idx // (n**ax)) % n
    for p in range(P):
        base = p * cells
        for a in range(D):
            h2inv = 1.0 / level.spacings[p, a] ** 2
            x = coords[:, a]
            # diagonal
            neum_lo = level.neumann[p, 2 * a]
            neum_hi = level.neumann[p, 2 * a + 1]
            c_lo = -1.0 if neum_lo else -3.0
            c_hi = -1.0 if neum_hi else -3.0
            diag = np.where(x == 0, c_lo, np.where(x == n - 1, c_hi, -2.0))
            rows.extend(base + idx)
            cols.extend(base + idx)
            vals.extend(diag * h2inv)
            # off-diagonals along axis a
            sel = x < n - 1
            rows.extend(base + idx[sel])
            cols.extend(base + idx[sel] + n**a)
            vals.extend(np.full(sel.sum(), h2inv))
            rows.extend(base + idx[sel] + n**a)
            cols.extend(base + idx[sel])
            vals.extend(np.full(sel.sum(), h2inv))
    return sp.csr_matrix((vals, (rows, cols)), shape=(P * cells, P * cells))


def assemble_ghost_injection(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``G``: (P*n^D) x (num_ifaces*m) injection of ``2 gamma / h^2`` into
    boundary rows of neighbored sides."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    rows, cols, vals = [], [], []
    for p in range(level.num_patches):
        for s in range(2 * D):
            if not t.iface_side_mask[p, s]:
                continue
            i = int(t.iface_side_idx[p, s])
            a = s // 2
            h2inv = 1.0 / level.spacings[p, a] ** 2
            face_flat = _face_cell_flat(D, n, s)
            rows.extend(p * cells + face_flat)
            cols.extend(i * m + np.arange(m))
            vals.extend(np.full(m, 2.0 * h2inv))
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(level.num_patches * cells, t.num_ifaces * m)
    )


def assemble_composite(level: PatchLevel, scheme: str = "bilinear") -> sp.csr_matrix:
    """The full composite-grid operator as CSR: ``A = L + G @ Gamma``.

    ``scheme="quadratic"`` assembles the 2D higher-order refinement
    closures (reference ``MatrixHelper2d.cpp:30-122``)."""
    t = build_iface_tables(level, scheme=scheme)
    L = assemble_patch_stencil(level)
    G = assemble_ghost_injection(level, t)
    Gamma = assemble_interpolation(level, t)
    return (L + G @ Gamma).tocsr()

"""Real trigonometric transforms as dense matrices.

The reference diagonalizes each patch's Laplacian with FFTW real-to-real
transforms (``PatchSolvers/FftwPatchSolver.h:111-171``) or, equivalently,
with explicit DCT/DST matrices applied by BLAS ``dgemv``
(``PatchSolvers/DftPatchSolver.h:226-347``).  The matrix form is the
natural TPU formulation: a batched patch solve becomes a handful of large
matmuls on the MXU.  We use the reference's matrix conventions exactly
(scale factor ``(2/n)**D`` applied after the inverse transform).

Transform selection per axis, by the patch's physical-BC bits
(``FftwPatchSolver.h:111-134``; interface sides count as Dirichlet):

=================  ==========  ==========
axis BCs           forward     inverse
=================  ==========  ==========
Neumann/Neumann    DCT-II      DCT-III
Neumann/other      DCT-IV      DCT-IV
other/Neumann      DST-IV      DST-IV
Dirichlet/Dir.     DST-II      DST-III
=================  ==========  ==========

Eigenvalues per axis (``FftwPatchSolver.h:136-171``)::

    lambda_k = -(4/h^2) * sin((k + delta) * pi / (2n))^2

with ``delta = 0`` (Neumann/Neumann), ``1/2`` (mixed), ``1`` (Dirichlet).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DCT_II = 0
DCT_III = 1
DCT_IV = 2
DST_II = 3
DST_III = 4
DST_IV = 5


def transform_matrix(kind: int, n: int) -> np.ndarray:
    """The n×n transform matrix ``T`` with ``y = T @ x``
    (reference ``DftPatchSolver.h:226-294``)."""
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    if kind == DCT_II:
        return np.cos(np.pi / n * (i * (j + 0.5)))
    if kind == DCT_III:
        M = np.cos(np.pi / n * ((i + 0.5) * j))
        M[:, 0] = 0.5
        return M
    if kind == DCT_IV:
        return np.cos(np.pi / n * ((i + 0.5) * (j + 0.5)))
    if kind == DST_II:
        return np.sin(np.pi / n * ((i + 1) * (j + 0.5)))
    if kind == DST_III:
        M = np.sin(np.pi / n * ((i + 0.5) * (j + 1)))
        M[:, n - 1] = 0.5 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        return M
    if kind == DST_IV:
        return np.sin(np.pi / n * ((i + 0.5) * (j + 0.5)))
    raise ValueError(kind)


def axis_transforms(neumann_lo: bool, neumann_hi: bool) -> Tuple[int, int, float]:
    """(forward kind, inverse kind, eigenvalue offset delta) for one axis."""
    if neumann_lo and neumann_hi:
        return DCT_II, DCT_III, 0.0
    if neumann_lo:
        return DCT_IV, DCT_IV, 0.5
    if neumann_hi:
        return DST_IV, DST_IV, 0.5
    return DST_II, DST_III, 1.0


def axis_eigenvalues(n: int, h: float, delta: float) -> np.ndarray:
    """``-(4/h^2) sin((k+delta) pi / (2n))^2`` for k = 0..n-1."""
    k = np.arange(n, dtype=np.float64)
    return -4.0 / (h * h) * np.sin((k + delta) * np.pi / (2 * n)) ** 2

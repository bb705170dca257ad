"""Preconditioners beyond GMG (port of ``pressurepoissonsolver_tpu.precond``).

* :func:`schwarz` — non-overlapping additive Schwarz: one sweep of exact
  patch solves with zero interface data (reference ``SchwarzPrec``,
  ``SchwarzPrec.h:29-57``).
* :func:`poly_cheb` — Chebyshev-polynomial approximate inverse of the
  Schur interface operator (reference ``PolyChebPrec.{h,cpp}``): a
  Clenshaw-style recurrence over applications of
  ``S = interp(solve(0, .))`` with the reference's 16 fixed coefficients
  and interval 0.95 (``PolyChebPrec.h:37-43``, ``PolyChebPrec.cpp:30-51``).
"""

from __future__ import annotations

from typing import Callable

import torch

from .ops.level_ops import Level

CHEB_COEFFS = (
    4.472135954953655e00, 5.675247900481234e00, 3.601012922685066e00,
    2.284885928634731e00, 1.449787551186771e00, 9.199076055378766e-01,
    5.836924189936992e-01, 3.703598469934007e-01, 2.349977690621489e-01,
    1.491089055767314e-01, 9.461139059090561e-02, 6.003206306517687e-02,
    3.809106471898141e-02, 2.416923786484517e-02, 1.533567161022980e-02,
    1.628851184599676e-02,
)
CHEB_INTERVAL = 0.95


def schwarz(level: Level) -> Callable[[torch.Tensor], torch.Tensor]:
    """One sweep of exact patch solves with zero interface data."""

    def M(r):
        return level.patch_solve(r, level.gamma_zeros(r.dtype))

    return M


def poly_cheb(level: Level) -> Callable[[torch.Tensor], torch.Tensor]:
    """Chebyshev polynomial of the Schur operator ``level.schur_S``
    (``PolyChebPrec.cpp``): 16 applications of ``S`` per call."""
    S = level.schur_S
    iv = CHEB_INTERVAL
    coeffs = CHEB_COEFFS

    def M(x):
        bk1 = torch.zeros_like(x)
        bk2 = torch.zeros_like(x)
        for i in range(len(coeffs) - 1, 0, -1):
            bk = (4.0 / iv) * S(bk1) - 2.0 * bk1
            bk = bk + coeffs[i] * x - bk2
            bk2, bk1 = bk1, bk
        b = (2.0 / iv) * S(bk1) - bk1
        return b + coeffs[0] * x - bk2

    return M

"""The table of peaks and the operation and byte counts of the rooflines.

Copied from the program's measurement code (``chip_smoke.kernel_bound`` and
``PEAK_FLOPS``; ``bench.py``'s count of the composite apply;
``utils.profiling.HBM_BYTES_PER_S``), so that a change to the program cannot
change the yardstick.  Peaks are NVIDIA's data sheet for the H100 SXM part at
its full 700 W power limit: 3.35 TB/s of HBM, 67 TFLOP/s float32 and 34
TFLOP/s float64 outside the tensor cores.
"""

from __future__ import annotations

from typing import Tuple

import torch

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"float32": 67e12, "float64": 34e12}}


def card(name: str) -> Tuple[float, dict]:
    """``(bytes/s, {dtype: flop/s})`` of the card ``name``; raises for a
    card not in the table (no guess)."""
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no data-sheet peaks for {name!r}")
    return HBM_BYTES_PER_S[name], PEAK_FLOPS[name]


def stencil_counts(D: int, P: int, n: int, itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` of one ghost-stencil call on ``[P, n^D]``: ``u``,
    the ghost faces ``gf [P, 2D, n^(D-1)]``, ``coef [P, 2D]`` and ``h2 [P,
    D]`` read once and the output written once; ``5D - 1`` flops a cell and
    3 more a ghost cell."""
    cells = P * n ** D
    nbytes = itemsize * (2 * cells + P * 2 * D * n ** (D - 1) + P * 2 * D + P * D)
    flops = P * (n ** D * (5 * D - 1) + 2 * D * n ** (D - 1) * 3)
    return nbytes, flops


def stencil_bound_s(D: int, P: int, n: int, dtype: torch.dtype, bw: float,
                    peaks: dict) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time one stencil call
    can take, and which count bounds it."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = stencil_counts(D, P, n, itemsize)
    t_bytes = nbytes / bw
    t_ops = flops / peaks[str(dtype).replace("torch.", "")]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def apply_bytes(cells: int, itemsize: int) -> int:
    """Bytes of one composite apply: ``u`` read once, ``A u`` written once."""
    return 2 * cells * itemsize


def share_pct(bound_s: float, measured_s: float) -> float:
    """The share of the roofline, in %."""
    return 100.0 * bound_s / measured_s

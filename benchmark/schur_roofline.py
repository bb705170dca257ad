"""The roofline of the program's matrix-free Schur operator
(``ops.level_ops.Level.schur_S``): its operation and byte counts, kept with
the benchmark so that a change to the program cannot change the yardstick,
and its cold device time from a profiler trace of single calls
(``benchmark/layers.py``).

One apply ``S gamma = interp(solve(0, gamma))`` of a level of ``P`` patches
of ``n^D`` cells and ``NIf`` interfaces of ``m = n^(D-1)`` values:

* bytes: ``gamma`` read once, the patch field written once by the patch
  solves and read once by the interpolation, ``S gamma`` written once;
* operations: the patch solves' transforms, ``D`` forward and ``D`` inverse
  along each axis of every patch (an ``n x n`` matrix on each line: ``2n``
  flops a cell), and the divide by the eigenvalues (one a cell).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import layers, roofline


def schur_counts(D: int, P: int, n: int, num_ifaces: int, itemsize: int) -> Tuple[int, int]:
    """``(bytes, flops)`` of one ``S`` apply (module docstring)."""
    cells = P * n ** D
    iface = num_ifaces * n ** (D - 1)
    nbytes = itemsize * (2 * iface + 2 * cells)
    flops = cells * (2 * D * 2 * n + 1)
    return nbytes, flops


def schur_bound_s(D: int, P: int, n: int, num_ifaces: int, dtype: torch.dtype, bw: float,
                  peaks: dict) -> float:
    """The least time one ``S`` apply can take: the larger of its byte
    bound at ``bw`` and its flop bound at the ``dtype`` peak."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = schur_counts(D, P, n, num_ifaces, itemsize)
    return max(nbytes / bw, flops / peaks[str(dtype).replace("torch.", "")])


def schur_S_roofline(run) -> Optional[float]:
    """The finest f64 ``S`` apply, cold (30 single calls, inputs rotated past
    the L2), as a share (%) of :func:`schur_bound_s`; None where the
    solver's finest level is not an f64 level with ``schur_S``."""
    level = getattr(getattr(run, "solver", None), "fine_level", None)
    if level is None or level.dtype != torch.float64 or not hasattr(level, "schur_S"):
        return None
    gamma = layers._random(run, (level.num_ifaces, level.m), torch.float64)
    ms = layers.device_ms(run.device, level.schur_S, (gamma,), calls=30)
    if ms is None:
        return None
    bw, peaks = roofline.card(torch.cuda.get_device_name(run.device))
    bound_s = schur_bound_s(level.D, level.P, level.n, level.num_ifaces, torch.float64, bw,
                            peaks)
    return roofline.share_pct(bound_s, ms * 1e-3)

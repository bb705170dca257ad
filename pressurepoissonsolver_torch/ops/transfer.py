"""The grid transfers of the FAC multigrid as one CUDA kernel launch each.

:func:`restrict` and :func:`prolong_add` are ``gmg.Transfer.restrict`` and
``gmg.Transfer.prolong_add`` between two 2D levels of ``n x n`` patches, n a
multiple of 4, on a card: one launch of ``csrc/transfer.cu`` each, driven
by the transfer's int32 slot tables (:class:`TransferTables`, built once in
``Transfer.__init__`` from the parent-slot arrays it already has):

* restriction: per coarse slot, the 2 x 2 average of each orthant child
  into its orthant block (a parent), its fine patch (a pass-through slot)
  or zeros (a padded slot); the fine field is read once and the coarse
  field written once;
* prolong-add: per fine slot, ``u`` plus its parent's orthant block,
  injected (``"constant"``) or interpolated (``"linear"``), plus the whole
  parent patch (a pass-through slot) or nothing (a padded slot); ``u`` is
  read once and the result written once, into a new tensor.

The plain version is ``Transfer.restrict_plain`` / ``prolong_add_plain``
(row gathers, per-orthant Kronecker or per-axis matmuls, concatenations and
a routing gather): the CPU runs it, and so does a transfer without these
tables (3D, n not a multiple of 4, another dtype).  On a CUDA tensor a
transfer with the tables always takes the kernel: an input that is not
contiguous or 16-byte aligned is copied first; one of another dtype than
f32 / f64, another device or another shape than the tables' raises.  No
switch chooses between the two versions: the tensors do.

Counters (tables of ``utils.counters``, ``transfer.kernel`` and
``transfer.plain``, so that a captured transfer counts once per replay or
per pass of its loop): ``launches`` the kernel's transfers and ``plain``
the plain chain's transfers run on a CUDA device, per dtype name;
:func:`transfers` reads them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..utils import counters

#: the kernel's transfers (a restriction or a prolong-add each) per dtype name
launches = counters.table("transfer.kernel", ("float32", "float64"))
#: the plain chain's transfers on a CUDA device, per dtype name
plain = counters.table("transfer.plain", ("float32", "float64"))

_CODES = {torch.float32: 0, torch.float64: 1}  # the kernel's dtype argument
_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_lib = None


class TransferTables(NamedTuple):
    """What the kernel reads besides the fields: ``rtab`` ``[Pc, 5]`` per
    coarse slot the fine slot of its child in each orthant (x half in bit
    0, y half in bit 1), then its pass-through fine slot; ``ptab`` ``[Pf,
    2]`` per fine slot its parent's coarse slot and its orthant (negative:
    a pass-through slot); both int32, -1 where there is none."""

    rtab: torch.Tensor
    ptab: torch.Tensor
    n: int
    linear: bool


def kernel_fits(D: int, n: int, dtype: torch.dtype, device) -> bool:
    """Whether a transfer between levels of dimension ``D``, patch size
    ``n`` and ``dtype`` on ``device`` has the kernel."""
    return (torch.device(device).type == "cuda" and D == 2 and n > 0 and n % 4 == 0
            and dtype in _CODES)


def transfer_tables(child_slot: np.ndarray, pt_slot: np.ndarray, pslots: np.ndarray,
                    orth: np.ndarray, n: int, linear: bool, device) -> TransferTables:
    """The kernel's tables from a transfer's arrays: ``child_slot`` ``[Pc,
    4]`` and ``pt_slot`` ``[Pc]`` (the fine slot count ``Pf`` where there is
    none), ``pslots`` ``[Pf]`` (-1: a padded slot) and ``orth`` ``[Pf]``
    (negative: a pass-through slot)."""
    Pf = len(pslots)
    rows = np.concatenate([child_slot, pt_slot[:, None]], axis=1)
    rtab = np.where(rows < Pf, rows, -1).astype(np.int32)
    ptab = np.stack([pslots, orth], axis=1).astype(np.int32)
    return TransferTables(rtab=torch.as_tensor(rtab, device=device),
                          ptab=torch.as_tensor(ptab, device=device), n=n, linear=linear)


def build() -> ctypes.CDLL:
    """Compile (at first use) and load ``csrc/transfer.cu``."""
    global _lib
    if _lib is None:
        lib = cuda_build.load_library("transfer")
        vp = ctypes.c_void_p
        lib.pps_transfer_restrict.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_longlong,
                                              ctypes.c_int, vp]
        lib.pps_transfer_prolong_add.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp, vp,
                                                 ctypes.c_longlong, ctypes.c_int, vp]
        for fn in (lib.pps_transfer_restrict, lib.pps_transfer_prolong_add):
            fn.restype = ctypes.c_int
        lib.pps_transfer_error_string.argtypes = [ctypes.c_int]
        lib.pps_transfer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous 16-byte aligned copy of it."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(tables: TransferTables, name: str, t: torch.Tensor, P: int,
           dtype: torch.dtype) -> None:
    if t.dtype != dtype or t.dtype not in _CODES:
        raise TypeError(f"transfer: {name} is {t.dtype}; the kernel takes float32 or "
                        f"float64, both fields of one dtype")
    if t.device != tables.rtab.device:
        raise TypeError(f"transfer: {name} is on {t.device}, the tables on "
                        f"{tables.rtab.device}")
    n = tables.n
    if tuple(t.shape) != (P, n, n):
        raise ValueError(f"transfer: {name} has the shape {tuple(t.shape)}, not {(P, n, n)}")


def _launch(fn: str, t: torch.Tensor, *args) -> None:
    """Call the C function ``fn`` on ``t``'s device and current stream, and
    raise if the launch failed."""
    lib = build()

    def call():
        return getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)

    if t.device.index == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(t.device):
            err = call()
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.pps_transfer_error_string(err).decode()} "
                           f"({err})")
    launches[_NAMES[t.dtype]] += 1


def restrict(tables: TransferTables, fine: torch.Tensor) -> torch.Tensor:
    """The cell-averaging restriction of ``fine`` ``[Pf, n, n]`` into a new
    coarse field ``[Pc, n, n]``: one launch."""
    _check(tables, "fine", fine, tables.ptab.shape[0], fine.dtype)
    fine = _fresh(fine)
    Pc, n = tables.rtab.shape[0], tables.n
    out = fine.new_empty((Pc, n, n))
    _launch("pps_transfer_restrict", fine, _CODES[fine.dtype], fine.data_ptr(),
            tables.rtab.data_ptr(), out.data_ptr(), Pc, n)
    return out


def prolong_add(tables: TransferTables, coarse: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u`` ``[Pf, n, n]`` plus the prolongation of ``coarse`` ``[Pc, n,
    n]``, as a new tensor: one launch."""
    _check(tables, "u", u, tables.ptab.shape[0], u.dtype)
    _check(tables, "coarse", coarse, tables.rtab.shape[0], u.dtype)
    coarse, u = _fresh(coarse), _fresh(u)
    out = torch.empty_like(u)
    _launch("pps_transfer_prolong_add", u, _CODES[u.dtype], int(tables.linear),
            coarse.data_ptr(), u.data_ptr(), tables.ptab.data_ptr(), out.data_ptr(),
            u.shape[0], tables.n)
    return out


def count_plain(t: torch.Tensor) -> None:
    """Count a transfer that ran the plain chain on ``t``, if on a card."""
    if t.is_cuda and t.dtype in _NAMES:
        plain[_NAMES[t.dtype]] += 1


def transfers() -> dict:
    """The transfer counters, after the launches counted on the card and
    not read yet: ``{"kernel": launches, "plain": plain}`` (copies)."""
    counters.flush()
    return {"kernel": dict(launches), "plain": dict(plain)}

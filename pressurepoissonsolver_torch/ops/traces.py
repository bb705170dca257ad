"""The per-side interface traces ``gf`` as one CUDA kernel launch a build.

A 2D level's composite operator and its block-Jacobi sweeps read, per
patch side, the interface trace ``gf[P, 2D, m]`` interpolated from the
iterate ``u``.  On a card every such build is one launch of
``csrc/traces.cu`` (:func:`build`), which reads ``u`` directly through
int32 tables built once from the level's interface tables
(:func:`trace_tables`, :func:`palette`):

* ``Level.apply``: ``w_mix * mix`` of ``Level._gf_parts`` (a direct side is
  half its neighbour's boundary row; the own half is folded into the
  stencil's ghost coefficient);
* ``Level.smooth``: ``Level._gf_faces`` (a direct side is half its own
  boundary row plus half its neighbour's);
* ``ActiveSmoother.smooth`` and ``apply_scattered``:
  ``ActiveSmoother._gamma_faces`` over the active patches' sides, from the
  whole field;

a refinement side everywhere the full interpolated trace of its interface:
its scalar contributions (normal, c2c) and its case-template contributions
(f2f, f2c, c2f).

The plain version is the chain those methods run (a stack of the faces, row
gathers, the case-template matmul, concatenations and elementwise passes):
the CPU runs it, and so does a level without these tables (3D, a face depth
above 2, more than 16 cases, a template with more than 4 nonzeros in a row,
a palette over the kernel's shared memory).  On
a CUDA tensor a level with the tables always takes the kernel: an input that
is not contiguous or 16-byte aligned is copied first; one of another dtype
than f32 / f64, another device or another shape raises.  No switch chooses
between the two versions: the tensors do.  The plain chain runs in the
span ``pps.traces.plain`` (``utils.profiling``); the kernel opens none.

Counters (tables of ``utils.counters``, ``traces.kernel`` and
``traces.plain``, so that a captured build counts once per replay or per
pass of its loop): ``launches`` the kernel's builds and ``plain`` the plain
chain's builds run on a CUDA device, per dtype name; :func:`builds` reads
them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import cuda_build
from ..utils import counters, profiling

#: the kernel's builds per dtype name
launches = counters.table("traces.kernel", ("float32", "float64"))
#: the plain chain's builds on a CUDA device, per dtype name
plain = counters.table("traces.plain", ("float32", "float64"))

_CODES = {torch.float32: 0, torch.float64: 1}  # the kernel's dtype argument
_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_MAX_CASES = 16  # an entry's 4 bits of case
_MAX_SHARED = 48 * 1024  # the kernel's staged palette
_MAX_TAPS = 4  # a template's nonzeros in a row
_lib = None


class Palette(NamedTuple):
    """A level's interpolation cases as the kernel reads them: ``cw``
    ``[ncase]`` the weight of each scalar case (0 for a template case);
    ``tw`` / ``ti`` ``[ncase, n, kt]`` each template case's nonzero taps per
    output element (weights and source elements, ascending; pads weight 0,
    source 0; all 0 for a scalar case); ``template`` ``[ncase]`` on the host.
    The weights are float64 holding the level dtype's values."""

    cw: torch.Tensor
    tw: torch.Tensor
    ti: torch.Tensor
    template: np.ndarray
    n: int
    depth: int


class TraceTables(NamedTuple):
    """One build's tables: ``rowptr`` int32 ``[R + 1]`` and ``ent`` int32
    ``[E]``, per output row ``(patch, side)`` its entries ``src << 5 | case
    << 1 | template`` with ``src = patch * 2D * depth + face row``; the
    level's palette; ``patches``, the output rows' patches (``R = 4 *
    patches``), and ``P``, the source field's patches."""

    rowptr: torch.Tensor
    ent: torch.Tensor
    pal: Palette
    patches: int
    P: int


def kernel_fits(D: int, n: int, depth: int, ncase: int, P: int, device) -> bool:
    """Whether a level of dimension ``D``, patch size ``n``, face depth
    ``depth``, ``ncase`` interpolation cases and ``P`` patches on ``device``
    has the kernel (its taps' count is checked by :func:`palette`)."""
    return (torch.device(device).type == "cuda" and D == 2 and n > 0 and depth in (1, 2)
            and 0 < ncase <= _MAX_CASES and P * 4 * depth < 1 << 26)


def palette(case_T: np.ndarray, case_scalar: list, dtype: torch.dtype,
            depth: int, device) -> Optional[Palette]:
    """The kernel's palette of a level's cases (``Level._case_T``, dense f64
    ``[ncase, m, m]``, and ``Level._case_scalar``) in ``dtype``, or ``None``
    where a template has more than 4 nonzeros in a row or the palette
    exceeds the kernel's shared memory."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    ncase, n, _ = case_T.shape
    template = np.array([s is None for s in case_scalar], dtype=bool)
    cw = np.array([0.0 if s is None else s for s in case_scalar]).astype(npdt)
    nz = (case_T != 0) & template[:, None, None]
    kt = max(int(nz.sum(axis=2).max(initial=0)), 1)
    if kt > _MAX_TAPS or 16 * 8 + ncase * n * kt * 12 > _MAX_SHARED:
        return None
    cols = np.argsort(~nz, axis=2, kind="stable")[:, :, :kt]  # nonzero columns first
    on = np.take_along_axis(nz, cols, axis=2)
    tw = np.where(on, np.take_along_axis(case_T, cols, axis=2), 0.0).astype(npdt)

    def up(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dt), device=device)

    return Palette(cw=up(cw, np.float64), tw=up(tw, np.float64),
                   ti=up(np.where(on, cols, 0), np.int32), template=template, n=n,
                   depth=depth)


def trace_tables(t, patches: np.ndarray, pal: Palette,
                 own_dropped: Optional[np.ndarray] = None) -> TraceTables:
    """The tables of the traces of ``patches``' sides from the level's
    interface tables ``t`` (``iface.IfaceTables``): each side with an
    interface reads every contribution of that interface, the scalar ones
    in contribution order, then the template ones by case and contribution
    (the plain chain's order); a side of ``own_dropped`` (bool ``[len(patches),
    2D]``, a direct side of ``Level.apply``) leaves out the contribution of
    its own face row.  Array code: sorts, counts and repeats, no loop over
    patches."""
    depth = pal.depth
    S2 = 4
    S2f = S2 * depth
    case = np.asarray(t.contrib_case, dtype=np.int64)
    iface = np.asarray(t.contrib_iface, dtype=np.int64)
    src = np.asarray(t.contrib_patch, dtype=np.int64) * S2f + np.asarray(t.contrib_side)
    tmpl = pal.template[case]
    order = np.lexsort((np.arange(len(case)), np.where(tmpl, case, 0), tmpl, iface))
    # contributions per interface; the last slot, a side without one, has none
    per_iface = np.bincount(iface, minlength=t.num_ifaces + 1)
    start = np.cumsum(per_iface) - per_iface
    # the output rows: (patch, side), patch-major
    patches = np.asarray(patches, dtype=np.int64)
    R = len(patches) * S2
    has = np.asarray(t.iface_side_mask)[patches].reshape(-1) > 0
    rows_iface = np.where(has, np.asarray(t.iface_side_idx)[patches].reshape(-1), t.num_ifaces)
    count = per_iface[rows_iface]
    row_of = np.repeat(np.arange(R), count)
    pos = np.arange(len(row_of)) - (np.cumsum(count) - count)[row_of]
    c = order[start[rows_iface[row_of]] + pos]  # the contribution of each entry
    if own_dropped is not None:
        own = (patches[:, None] * S2f + np.arange(S2) * depth).reshape(-1)
        drop = np.asarray(own_dropped, dtype=bool).reshape(-1)[row_of] & (src[c] == own[row_of])
        row_of, c = row_of[~drop], c[~drop]
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row_of, minlength=R))])
    ent = (src[c] << 5) | (case[c] << 1) | tmpl[c]
    dev = pal.cw.device
    return TraceTables(
        rowptr=torch.as_tensor(rowptr.astype(np.int32), device=dev),
        ent=torch.as_tensor(ent.astype(np.int32), device=dev),
        pal=pal, patches=len(patches), P=len(t.iface_side_idx))


def build_library() -> ctypes.CDLL:
    """Compile (at first use) and load ``csrc/traces.cu``."""
    global _lib
    if _lib is None:
        lib = cuda_build.load_library("traces")
        vp = ctypes.c_void_p
        lib.pps_traces.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
        lib.pps_traces.restype = ctypes.c_int
        lib.pps_traces_error_string.argtypes = [ctypes.c_int]
        lib.pps_traces_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build(tables: TraceTables, u: torch.Tensor) -> torch.Tensor:
    """The traces ``[patches, 4, n]`` of ``u`` ``[P, n, n]`` through
    ``tables``, as a new tensor: one launch."""
    pal = tables.pal
    n = pal.n
    if u.dtype not in _CODES:
        raise TypeError(f"traces: u is {u.dtype}; the kernel takes float32 or float64")
    if u.device != tables.ent.device:
        raise TypeError(f"traces: u is on {u.device}, the tables on {tables.ent.device}")
    if tuple(u.shape) != (tables.P, n, n):
        raise ValueError(f"traces: u has the shape {tuple(u.shape)}, not {(tables.P, n, n)}")
    if not (u.is_contiguous() and u.data_ptr() % 16 == 0):
        u = u.clone(memory_format=torch.contiguous_format)
    out = u.new_empty((tables.patches, 4, n))
    lib = build_library()
    _, _, kt = pal.tw.shape

    def call():
        return lib.pps_traces(
            _CODES[u.dtype], u.data_ptr(), tables.rowptr.data_ptr(), tables.ent.data_ptr(),
            pal.cw.data_ptr(), pal.tw.data_ptr(), pal.ti.data_ptr(), out.data_ptr(),
            tables.patches * 4, n, pal.depth - 1, len(pal.template), kt,
            torch.cuda.current_stream().cuda_stream)

    if u.device.index == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(u.device):
            err = call()
    if err != 0:
        raise RuntimeError(f"pps_traces failed: {lib.pps_traces_error_string(err).decode()} "
                           f"({err})")
    launches[_NAMES[u.dtype]] += 1
    return out


def build_or_plain(tables: Optional[TraceTables], u: torch.Tensor,
                   plain_chain: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The traces of ``u``: :func:`build` where there are ``tables`` and
    ``u`` is on a card, else ``plain_chain(u)`` in the span
    ``pps.traces.plain``, counted in :data:`plain` when it runs on a card."""
    if tables is not None and u.is_cuda:
        return build(tables, u)
    if u.is_cuda and u.dtype in _NAMES:
        plain[_NAMES[u.dtype]] += 1
    with profiling.span("pps.traces.plain"):
        return plain_chain(u)


def builds() -> dict:
    """The build counters, after the launches counted on the card and not
    read yet: ``{"kernel": launches, "plain": plain}`` (copies)."""
    counters.flush()
    return {"kernel": dict(launches), "plain": dict(plain)}

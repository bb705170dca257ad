"""The block-Jacobi sweep of exact spectral patch solves: a CUDA kernel and
its plain version.

:func:`sweep` is one sweep of a level (``Level.smooth`` / ``smooth_zero``)
or of its FAC active set (``ActiveSmoother.smooth`` / ``smooth_zero``): each
solved patch gets

    u = S^-1 (f - 2 h2 gf on its boundary cells)

(``SchurHelper::solveWithSolution``), ``S^-1`` the spectral solve of the
patch's boundary conditions (forward DST/DCT transforms, the eigen-divide,
the inverse transforms and the ``(2/n)^D`` scale,
``FftwPatchSolver.h:173-206``); with an active set every other slot of the
level keeps ``base`` (zero without one).

The plain version is the chain :func:`_fold_faces_flat` →
:func:`_spectral_apply` → :func:`_scatter` (BC-sorted groups, per-axis or,
in f32 at ``n <=`` ``level_ops.kron_max_n()``, Kronecker matmuls): the CPU
runs it, and so does a level whose tables carry no :class:`SweepTables`
(3D, or n outside ``KERNEL_N``).  The tables of a 2D level on the card at
n = 8, 16 or 32 carry them (built at set-up), and every sweep of such a
level on a CUDA tensor is one launch of ``csrc/patch_sweep.cu``,
in f32 or f64: the fold, the per-axis products, the divide, the inverse
products and the routing of an active set's rows in one pass, f read and
u written once.  An input that is not contiguous or 16-byte aligned is
copied first; one of another dtype, device or shape than the tables'
raises.  No switch chooses between the two versions: the tensors do.
:func:`sweep` runs the plain version in the span ``pps.patch_sweep.plain``
(``utils.profiling``); the kernel opens none.

Counters (tables of ``utils.counters``, ``patch_sweep.kernel`` and
``patch_sweep.plain``, so that a captured sweep counts once per replay or
per pass of its loop): ``launches`` the kernel's sweeps and ``plain`` the
plain sweeps run on a CUDA device, per dtype name; :func:`sweeps` reads
them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cuda_build
from ..utils import counters, profiling
from . import transforms as tr

#: the kernel's sweeps per dtype name ("float32", "float64")
launches = counters.table("patch_sweep.kernel", ("float32", "float64"))
#: the plain version's sweeps on a CUDA device, per dtype name
plain = counters.table("patch_sweep.plain", ("float32", "float64"))

#: patch sizes the kernel is built for
KERNEL_N = (8, 16, 32)
_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_DTYPE_OF = {"f32": "float32", "f64": "float64"}  # library suffix -> dtype name
_fns: dict = {}  # dtype name -> (launch, error string) C functions


def _arr_axis(D: int, ref_axis: int) -> int:
    """Array axis (in a [P, ...] patch array) for spatial axis ``ref_axis``."""
    return 1 + (D - 1 - ref_axis)


# -- the plain version ----------------------------------------------------------

def _fold_faces_flat(fc: torch.Tensor, gf: torch.Tensor, h2inv: torch.Tensor,
                     D: int, n: int) -> torch.Tensor:
    """``f_slice -= 2/h^2 * gf`` on every face
    (``StarPatchOp::addInterfaceToRHS``, ``StarPatchOp.h:185-203``).

    The reference's pad-spread sum, written as 2·D face-slice updates of
    one copy: each side's term lands on its boundary cells only (where
    faces meet, the terms are subtracted one by one rather than summed
    first, so edge and corner cells round differently)."""
    P = fc.shape[0]
    h2 = h2inv.to(fc.dtype)
    face = (P,) + (n,) * (D - 1)
    out = fc.clone()
    for a in range(D):
        ax = _arr_axis(D, a)
        h2a = h2[:, a].reshape((P,) + (1,) * (D - 1))
        for side, pos in ((2 * a, 0), (2 * a + 1, n - 1)):
            out.select(ax, pos).sub_(2.0 * (h2a * gf[:, side].reshape(face)))
    return out


def axis_matmul(M: torch.Tensor, x: torch.Tensor, ax: int) -> torch.Tensor:
    """Apply the n×n matrix ``M`` along array axis ``ax`` of a
    ``[P, n, n]`` or ``[P, n, n, n]`` field as one (batched) matmul, in
    full precision: the last axis as ``x @ M.T``, the one before it as
    ``M @ x``, and axis 1 of a 3D field (z) as ``M @`` the ``[P, n, n*n]``
    view."""
    if ax == x.dim() - 1:
        return torch.matmul(x, M.t())
    if ax == x.dim() - 2:
        return torch.matmul(M, x)
    return torch.matmul(M, x.reshape(x.shape[0], x.shape[1], -1)).reshape(x.shape)


def _kron_solve(kr: tuple, x: torch.Tensor, dn: torch.Tensor, pin_dc: bool,
                D: int, n: int) -> torch.Tensor:
    """One BC group's patch solves in the Kronecker form on flat ``[G,
    n^D]`` rows (``dn``: their ``[G, *ns]`` denominators): 2D ``x @ W1``,
    the divide, ``@ W2``; 3D the z transform on the ``[G, n, n^2]`` view,
    then the (y, x) pair the same way."""
    G = x.shape[0]
    if D == 2:
        y = torch.matmul(x, kr[0].to(x.dtype)) / dn.reshape(G, -1)
        if pin_dc:
            y[:, 0] = 0.0
        return torch.matmul(y, kr[1].to(x.dtype))
    W1, W2, Tz1, Tz2 = (w.to(x.dtype) for w in kr)
    y = torch.matmul(Tz1, x.reshape(G, n, n * n))
    y = torch.matmul(y, W1) / dn.reshape(G, n, n * n)
    if pin_dc:
        y[:, 0, 0] = 0.0
    return torch.matmul(torch.matmul(Tz2, y), W2).reshape(G, -1)


def _spectral_apply(st, fc: torch.Tensor, D: int, n: int) -> torch.Tensor:
    """Batched spectral patch solves with the tables ``st``
    (``level_ops._SolverTables``): per BC group, forward transforms along
    each axis, the eigen-divide, the inverse transforms and the ``(2/n)^D``
    scale (``FftwPatchSolver.h:173-206``); with ``st.kron``, the same in
    the Kronecker form (:func:`_kron_solve`).  No slot (an empty active
    set): nothing to solve."""
    if not st.groups:
        return fc.clone()
    fs = fc if st.identity_perm else fc.index_select(0, st.perm)
    denom = st.denom.to(fc.dtype)
    if st.kron is not None:
        flat = fs.reshape(fs.shape[0], -1)
        parts = [_kron_solve(kr, flat[g.start:g.stop], denom[g.start:g.stop], g.pin_dc, D, n)
                 for g, kr in zip(st.groups, st.kron)]
        us = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)).reshape(fc.shape)
        return us if st.identity_perm else us.index_select(0, st.inv_perm)
    scale = (2.0 / n) ** D
    parts = []
    for g in st.groups:
        x = fs[g.start:g.stop]
        for a in range(D):
            x = axis_matmul(st.tmats[g.fwd_kinds[a]].to(x.dtype), x, _arr_axis(D, a))
        x = x / denom[g.start:g.stop]
        if g.pin_dc:
            x[(slice(None),) + (0,) * D] = 0.0
        for a in range(D):
            x = axis_matmul(st.tmats[g.inv_kinds[a]].to(x.dtype), x, _arr_axis(D, a))
        parts.append(x * scale)
    us = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return us if st.identity_perm else us.index_select(0, st.inv_perm)


class Route(NamedTuple):
    """An active set's rows on its level: ``act`` ``[Pa]`` the level slot of
    each solve slot, ``inv`` ``[P]`` the solve slot of each level slot
    (``Pa`` where it has none), ``mask`` ``[P, 1, ..]`` the active slots."""

    act: torch.Tensor
    inv: torch.Tensor
    mask: torch.Tensor


def _scatter(sol: torch.Tensor, route: Route, base: Optional[torch.Tensor]) -> torch.Tensor:
    """Route the active solves back to their level slots (row gather, no
    scatter), leaving ``base`` elsewhere (zero when ``None``: the pad row
    the other slots read is zero)."""
    sol_pad = torch.cat([sol, sol.new_zeros((1,) + sol.shape[1:])], dim=0)
    routed = sol_pad.index_select(0, route.inv)
    return routed if base is None else torch.where(route.mask, routed, base)


def sweep_plain(st, f: torch.Tensor, gf: Optional[torch.Tensor], h2inv: torch.Tensor,
                route: Optional[Route] = None,
                base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`sweep`."""
    D, n = f.dim() - 1, f.shape[-1]
    fc = f if route is None else f.index_select(0, route.act)
    if gf is not None:
        fc = _fold_faces_flat(fc, gf, h2inv, D, n)
    sol = _spectral_apply(st, fc, D, n)
    return sol if route is None else _scatter(sol, route, base)


# -- the kernel's tables ----------------------------------------------------------

def slot_codes(neumann: np.ndarray) -> np.ndarray:
    """Per patch, from its ``[Ps, 2D]`` Neumann bits, its transforms as the
    kernel reads them (``int32``): 3 bits for the forward kind of each
    axis (x first), 3 for the inverse kind of each, then a bit for the DC
    pin of an all-Neumann patch (``transforms.axis_transforms``)."""
    nb = np.asarray(neumann, dtype=bool)
    D = nb.shape[1] // 2
    lo, hi = nb[:, 0::2], nb[:, 1::2]
    which = [lo & hi, lo, hi]
    fwd = np.select(which, [tr.DCT_II, tr.DCT_IV, tr.DST_IV], tr.DST_II)
    inv = np.select(which, [tr.DCT_III, tr.DCT_IV, tr.DST_IV], tr.DST_III)
    shifts = 3 * np.arange(2 * D)
    code = (np.concatenate([fwd, inv], axis=1).astype(np.int64) << shifts).sum(axis=1)
    return (code | (nb.all(axis=1).astype(np.int64) << (6 * D))).astype(np.int32)


@dataclass
class SweepTables:
    """What the kernel reads besides the fields, per solve slot in slot
    order (not BC-sorted): its code (:func:`slot_codes`) and its rows of
    ``lam`` for x and y; ``lam`` the per-axis eigenvalue rows (f64); the
    six transform matrices ``[6, n, n]`` in the tables' dtype."""

    codes: torch.Tensor
    lam_rows: torch.Tensor
    lam: torch.Tensor
    tmats: torch.Tensor


def kernel_fits(D: int, n: int, device) -> bool:
    """Whether a level of dimension ``D`` and patch size ``n`` on ``device``
    has the kernel."""
    return torch.device(device).type == "cuda" and D == 2 and n in KERNEL_N


def sweep_tables(neumann: np.ndarray, lam_tab: np.ndarray, lam_idx: np.ndarray,
                 inv_perm: np.ndarray, n: int, dtype: torch.dtype, device) -> SweepTables:
    """The kernel's tables for the solve slots whose Neumann bits are
    ``neumann`` ``[Ps, 4]``, from the solver tables' factored eigenvalue
    rows (``lam_idx`` per BC-sorted slot, ``inv_perm`` each slot's sorted
    place)."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    tmats = np.stack([tr.transform_matrix(k, n) for k in range(6)])
    return SweepTables(
        codes=torch.as_tensor(slot_codes(neumann), device=device),
        lam_rows=torch.as_tensor(
            np.ascontiguousarray(lam_idx[inv_perm], dtype=np.int32), device=device),
        lam=torch.as_tensor(np.ascontiguousarray(lam_tab, dtype=np.float64), device=device),
        tmats=torch.as_tensor(tmats.astype(npdt), device=device),
    )


# -- the kernel -------------------------------------------------------------------

def _load(suffix: str) -> None:
    lib = cuda_build.load_library(f"patch_sweep_{suffix}")
    fn = getattr(lib, f"pps_patch_sweep_{suffix}")
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.pps_patch_sweep_error_string.argtypes = [ctypes.c_int]
    lib.pps_patch_sweep_error_string.restype = ctypes.c_char_p
    _fns[_DTYPE_OF[suffix]] = (fn, lib.pps_patch_sweep_error_string)


def build() -> None:
    """Compile (at first use) and load ``csrc/patch_sweep.cu``: one library
    per precision (``cuda_build.build_all`` builds both side by side with
    the others at a solver's set-up)."""
    for suffix, name in _DTYPE_OF.items():
        if name not in _fns:
            _load(suffix)


def _fresh(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a contiguous 16-byte aligned copy of it."""
    if t is None or (t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel(tables: SweepTables, f, gf, h2inv, route, base) -> torch.Tensor:
    """One launch of the kernel (:func:`sweep`); inputs of another dtype,
    device or shape than the tables' raise."""
    P, n, ps = f.shape[0], tables.tmats.shape[-1], tables.codes.shape[0]
    shapes = {"f": (f, (P, n, n)), "gf": (gf, (ps, 4, n)), "h2inv": (h2inv, (ps, 2)),
              "base": (base, (P, n, n))}
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if t.dtype != tables.tmats.dtype or t.device != tables.tmats.device:
            raise TypeError(f"patch_sweep: {name} is {t.dtype} on {t.device}, the tables "
                            f"{tables.tmats.dtype} on {tables.tmats.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"patch_sweep: {name} has the shape {tuple(t.shape)}, not {shape}")
    if route is not None and (route.inv.device != f.device or route.inv.shape != (P,)):
        raise ValueError("patch_sweep: the route's slot map is not one of this level's slots")
    if route is None and P != ps:
        raise ValueError(f"patch_sweep: {P} slots and tables of {ps} without a route")
    f, gf, h2inv, base = (_fresh(t) for t in (f, gf, h2inv, base))
    build()
    out = torch.empty_like(f)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn, error_string = _fns[_NAMES[f.dtype]]

    def launch():
        return fn(
            f.data_ptr(), ptr(gf), h2inv.data_ptr(), tables.codes.data_ptr(),
            tables.lam_rows.data_ptr(), tables.lam.data_ptr(), tables.tmats.data_ptr(),
            None if route is None else route.inv.data_ptr(), ps, ptr(base), out.data_ptr(),
            P, n, torch.cuda.current_stream().cuda_stream)

    if f.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(f.device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"patch_sweep launch failed: {error_string(err).decode()} ({err})")
    launches[_NAMES[f.dtype]] += 1
    return out


def sweep(st, f: torch.Tensor, gf: Optional[torch.Tensor], h2inv: torch.Tensor,
          route: Optional[Route] = None,
          base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block-Jacobi sweep (module doc) with the solver tables ``st``
    (``level_ops._SolverTables``) of its solve slots: ``f`` ``[P, n, ..]``
    over the level's slots; ``gf`` ``[Ps, 2D, m]`` (``None``: no fold, as
    from a zero iterate) and ``h2inv`` ``[Ps, D]`` over the solve slots;
    ``route`` the active set's rows (``None``: every slot is solved) and
    ``base`` what its other slots keep (``None``: zero).  A new tensor.

    A CUDA tensor of a level whose tables carry :class:`SweepTables` always
    takes the kernel; a CPU tensor or a level without them (3D, n = 64)
    the plain chain, in the span ``pps.patch_sweep.plain``."""
    tables = getattr(st, "sweep", None)
    if tables is not None and f.is_cuda:
        return _kernel(tables, f, gf, h2inv, route, base)
    if f.is_cuda:
        plain[_NAMES[f.dtype]] += 1
    with profiling.span("pps.patch_sweep.plain"):
        return sweep_plain(st, f, gf, h2inv, route, base)


def sweeps() -> dict:
    """The sweep counters, after the launches counted on the card and not
    read yet: ``{"kernel": launches, "plain": plain}`` (copies)."""
    counters.flush()
    return {"kernel": dict(launches), "plain": dict(plain)}

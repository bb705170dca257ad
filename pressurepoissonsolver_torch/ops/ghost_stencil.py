"""The ghost-closure star stencils (2D and 3D): CUDA kernels and plain
versions.

``ghost_stencil(u, gf, coef, h2)`` (2D) and ``ghost_stencil_3d(u, gf,
coef, h2)`` (3D) compute, per patch,

    out = sum over axes a of h2[a] * (lo_a - 2 u + hi_a),

where a neighbour outside the patch is the ghost ``coef * u_b + 2 * gf``
(``level_ops._star_stencil`` of the reference; ``StarPatchOp.h:28-184``).
Shapes, all float32 or all float64:

* 2D: ``u`` ``[P, n, n]`` (x fastest), ``gf`` ``[P, 4, n]`` (sides x_lo,
  x_hi, y_lo, y_hi; x faces indexed by row y, y faces by column x),
  ``coef`` ``[P, 4]``, ``h2`` ``[P, 2]``;
* 3D: ``u`` ``[P, n, n, n]`` (z, y, x; x fastest), ``gf`` ``[P, 6, n*n]``
  (sides x_lo, x_hi, y_lo, y_hi, z_lo, z_hi; x faces flat at ``z*n + y``,
  y faces at ``z*n + x``, z faces at ``y*n + x``, as ``extract_faces``
  gives them), ``coef`` ``[P, 6]``, ``h2`` ``[P, 3]``.

On a CUDA tensor a wrapper launches its kernel (``csrc/ghost_stencil.cu``,
the port of the reference's Pallas ``pallas_stencil._kernel_2d``;
``csrc/ghost_stencil_3d.cu``, the port of ``_kernel_3d``) and counts the
launch in ``launches`` (2D) or ``launches_3d`` (3D); on a CPU tensor it
runs the plain version.  There is no size gate and no fallback: a CUDA
launch that fails raises.  Each kernel has two paths: 16-byte vectors
(``float4`` / ``double2``) when n is a multiple of the vector and ``u``,
``gf`` and ``out`` are 16-byte aligned, one element per thread otherwise.
The launcher's own rule (``pps_ghost_stencil_vector_width``, on the
launch's pointers) names the path of each launch: ``widths`` counts the
launches per path and ``last_width`` holds the last one's.
``vector_width`` is the same rule in Python.

No-gf mode: ``gf=None`` gives the stencil with the ghost ``coef * u_b``
(the kernels take a null pointer and read no face entries); those
launches are counted in ``launches``/``launches_3d`` with the others and
also in ``launches_nogf``.  :func:`add_ghost_faces` adds the face term
``2 * h2 * gf`` afterwards, so that ``add_ghost_faces(stencil(u, None),
gf, h2)`` is ``stencil(u, gf)`` up to rounding: the split the sharded
apply uses to run the stencil while its cut-face exchange is in flight.
On a CUDA tensor the face term is a kernel of its own
(``csrc/ghost_faces.cu``, one thread per boundary cell; counted in
``launches_faces``), on a CPU tensor its plain version
:func:`add_ghost_faces_plain`.

The counters are tables of ``utils.counters`` (``ghost_stencil.2d`` /
``.3d``, ``ghost_stencil.nogf_<D>d``, ``ghost_stencil.widths_<D>d``,
``ghost_faces.<D>d``), so that a captured launch is counted per replay;
:func:`counters` reads them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import cuda_build
from ..utils import counters as _counters

_DT = ("float32", "float64")
#: 2D kernel launches per dtype name ("float32", "float64")
launches = _counters.table("ghost_stencil.2d", _DT)
#: 3D kernel launches per dtype name
launches_3d = _counters.table("ghost_stencil.3d", _DT)
#: per D: the launches of the no-gf mode per dtype name (also counted above)
launches_nogf = {D: _counters.table(f"ghost_stencil.nogf_{D}d", _DT) for D in (2, 3)}
#: per D: kernel launches per elements per thread (1, 2 or 4)
widths = {D: _counters.table(f"ghost_stencil.widths_{D}d", (1, 2, 4)) for D in (2, 3)}
#: per D: elements per thread of the last launch (0 before any)
last_width = {2: 0, 3: 0}
# the kernels' largest n (3D: a row of the plane tile is at most 512
# threads; 2D: n * n fits a 32-bit int)
_MAX_N = {2: 46340, 3: 512}

_COUNTS = {2: launches, 3: launches_3d}
# per D: library name (``cuda_build.LIBRARIES``), C entry point prefix
_LIBS = {2: ("ghost_stencil", "pps_ghost_stencil_2d"),
         3: ("ghost_stencil_3d", "pps_ghost_stencil_3d")}
_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns = {}  # (D, dtype) -> ctypes function


def counters() -> list:
    """A copy of every launch counter of the module (``last_width`` is not
    one), after the reports of launches counted on the card
    (``utils.counters.flush``): the 2D and 3D launches, then ``widths``,
    ``launches_nogf`` and ``launches_faces`` per D."""
    _counters.flush()
    return [dict(c) for c in (*_COUNTS.values(), *widths.values(), *launches_nogf.values(),
                              *launches_faces.values())]


def build(D: int = 2) -> ctypes.CDLL:
    """Compile (at first use) and load the ``D``-dimensional kernel's
    library."""
    lib = cuda_build.load_library(_LIBS[D][0])
    if (D, torch.float32) not in _fns:
        for dt, fn in bind(lib, D).items():
            _fns[D, dt] = fn
    return lib


def bind(lib: ctypes.CDLL, D: int) -> dict:
    """Declare the C interface of a ``D``-dimensional kernel library; its
    launch function per dtype."""
    fns = {}
    for dt, suffix in _SUFFIX.items():
        fn = getattr(lib, f"{_LIBS[D][1]}_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    lib.pps_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pps_cuda_error_string.restype = ctypes.c_char_p
    lib.pps_ghost_stencil_vector_width.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int
    ]
    lib.pps_ghost_stencil_vector_width.restype = ctypes.c_int
    return fns


def vector_width(n: int, dtype: torch.dtype, *data_ptrs: int) -> int:
    """Elements per thread the kernels take: a 16-byte vector (4 in f32, 2
    in f64) when n is a multiple of it and every pointer (``u``, ``gf``,
    ``out``) is 16-byte aligned, else 1: the rule of the launchers in
    ``csrc/`` (``pps_ghost_stencil_vector_width``), which the card tests
    hold this function to."""
    w = 16 // dtype.itemsize
    return w if n % w == 0 and all(p % 16 == 0 for p in data_ptrs) else 1


def _plain(u, gf, coef, h2) -> torch.Tensor:
    """The reference's ``_star_stencil`` in torch, for D = ``u.dim() - 1``
    (``gf=None``: the ghost is ``coef * u_b``)."""
    D = u.dim() - 1
    P, n = u.shape[0], u.shape[-1]
    face = (P,) + (n,) * (D - 1)
    col = (P,) + (1,) * (D - 1)
    out = None
    for a in range(D):
        ax = D - a  # array axis of spatial axis a (x fastest)
        ghost_lo = coef[:, 2 * a].reshape(col) * u.select(ax, 0)
        ghost_hi = coef[:, 2 * a + 1].reshape(col) * u.select(ax, n - 1)
        if gf is not None:
            ghost_lo = ghost_lo + 2.0 * gf[:, 2 * a].reshape(face)
            ghost_hi = ghost_hi + 2.0 * gf[:, 2 * a + 1].reshape(face)
        lo = torch.cat([ghost_lo.unsqueeze(ax), u.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([u.narrow(ax, 1, n - 1), ghost_hi.unsqueeze(ax)], dim=ax)
        term = (lo - 2.0 * u + hi) * h2[:, a].reshape((P,) + (1,) * D)
        out = term if out is None else out + term
    return out


def ghost_stencil_plain(u: torch.Tensor, gf: Optional[torch.Tensor], coef: torch.Tensor,
                        h2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the 2D kernel (``_star_stencil`` at D=2)."""
    _check(2, u, gf, coef, h2)
    return _plain(u, gf, coef, h2)


def ghost_stencil_3d_plain(u: torch.Tensor, gf: Optional[torch.Tensor],
                           coef: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the 3D kernel (``_star_stencil`` at D=3)."""
    _check(3, u, gf, coef, h2)
    return _plain(u, gf, coef, h2)


def _check(D, u, gf, coef, h2) -> None:
    if u.dim() != D + 1 or len(set(u.shape[1:])) != 1:
        raise ValueError(
            f"u must be [P{', n' * D}], got {tuple(u.shape)}"
        )
    P, n = u.shape[0], u.shape[1]
    want = {"gf": (P, 2 * D, n ** (D - 1)), "coef": (P, 2 * D), "h2": (P, D)}
    named = [(k, t) for k, t in (("u", u), ("gf", gf), ("coef", coef), ("h2", h2))
             if t is not None]
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]}, got {tuple(t.shape)}"
            )
    for name, t in named:
        if t.dtype not in _NAMES or t.dtype != u.dtype:
            raise TypeError(
                f"{name}: dtype {t.dtype}; all inputs must be one of "
                "float32 / float64"
            )
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")


def _run(D, u, gf, coef, h2) -> torch.Tensor:
    _check(D, u, gf, coef, h2)
    if u.device.type == "cpu":
        return _plain(u, gf, coef, h2)
    if u.device.type != "cuda":
        raise ValueError(f"no ghost-stencil kernel for device {u.device}")
    for name, t in (("u", u), ("gf", gf), ("coef", coef), ("h2", h2)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = u.shape[1]
    if n > _MAX_N[D]:
        raise ValueError(f"n={n} exceeds the {D}D kernel's largest n, {_MAX_N[D]}")
    if (D, u.dtype) not in _fns:
        build(D)
    out = torch.empty_like(u)
    gf_ptr = 0 if gf is None else gf.data_ptr()
    width = build(D).pps_ghost_stencil_vector_width(
        u.data_ptr(), gf_ptr, out.data_ptr(), n, u.element_size())
    if u.device.index == torch.cuda.current_device():
        err = _launch(D, u, gf, coef, h2, out)
    else:
        with torch.cuda.device(u.device):
            err = _launch(D, u, gf, coef, h2, out)
    if err != 0:
        msg = build(D).pps_cuda_error_string(err).decode()
        raise RuntimeError(f"{D}D ghost_stencil launch failed: {msg} ({err})")
    _COUNTS[D][_NAMES[u.dtype]] += 1
    if gf is None:
        launches_nogf[D][_NAMES[u.dtype]] += 1
    widths[D][width] += 1
    last_width[D] = width
    return out


def ghost_stencil(u: torch.Tensor, gf: Optional[torch.Tensor], coef: torch.Tensor,
                  h2: torch.Tensor) -> torch.Tensor:
    """2D ``A_local u`` with explicit ghost faces, or none with ``gf=None``
    (see the module doc)."""
    return _run(2, u, gf, coef, h2)


def ghost_stencil_3d(u: torch.Tensor, gf: Optional[torch.Tensor], coef: torch.Tensor,
                     h2: torch.Tensor) -> torch.Tensor:
    """3D ``A_local u`` with explicit ghost faces, or none with ``gf=None``
    (see the module doc)."""
    return _run(3, u, gf, coef, h2)


def _launch(D, u, gf, coef, h2, out) -> int:
    """Launch on the current stream of the current device (u's)."""
    stream = torch.cuda.current_stream().cuda_stream
    gf_ptr = None if gf is None else gf.data_ptr()
    return _fns[D, u.dtype](u.data_ptr(), gf_ptr, coef.data_ptr(),
                            h2.data_ptr(), out.data_ptr(), u.shape[0],
                            u.shape[1], stream)



# -- the face term of the split stencil: csrc/ghost_faces.cu -------------------

#: per D: launches of the face-term kernel per dtype name
launches_faces = {D: _counters.table(f"ghost_faces.{D}d", _DT) for D in (2, 3)}
_faces_fns = {}  # (D, dtype) -> ctypes function


def build_faces() -> ctypes.CDLL:
    """Compile (at first use) and load the face-term kernels' library
    (``csrc/ghost_faces.cu``, 2D and 3D)."""
    lib = cuda_build.load_library("ghost_faces")
    if (2, torch.float32) not in _faces_fns:
        for D in (2, 3):
            for dt, suffix in _SUFFIX.items():
                fn = getattr(lib, f"pps_ghost_faces_{D}d_{suffix}")
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                       ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _faces_fns[D, dt] = fn
        lib.pps_ghost_faces_error_string.argtypes = [ctypes.c_int]
        lib.pps_ghost_faces_error_string.restype = ctypes.c_char_p
    return lib


def add_ghost_faces_plain(out: torch.Tensor, gf: torch.Tensor,
                          h2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the face-term kernel (the reference's
    ``_face_pad_sum``): the sides' terms ``h2[a] * gf[side]`` summed per
    boundary cell in side order, then ``out += 2 * sum``, in place."""
    D = _check_faces(out, gf, h2)
    P, n = out.shape[0], out.shape[-1]
    face = (P,) + (n,) * (D - 1)
    col = (P,) + (1,) * (D - 1)
    add = torch.zeros_like(out)
    for a in range(D):
        ax = D - a  # array axis of spatial axis a (x fastest)
        h2a = h2[:, a].reshape(col)
        add.select(ax, 0).addcmul_(h2a, gf[:, 2 * a].reshape(face))
        add.select(ax, n - 1).addcmul_(h2a, gf[:, 2 * a + 1].reshape(face))
    return out.add_(add, alpha=2.0)


def _check_faces(out, gf, h2) -> int:
    D = out.dim() - 1
    if D not in (2, 3) or len(set(out.shape[1:])) != 1:
        raise ValueError(f"out must be [P, n, n] or [P, n, n, n], got {tuple(out.shape)}")
    P, n = out.shape[0], out.shape[1]
    for name, t, want in (("gf", gf, (P, 2 * D, n ** (D - 1))), ("h2", h2, (P, D))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.dtype != out.dtype or out.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype}; out {out.dtype}; one of "
                            "float32 / float64")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
    return D


def add_ghost_faces(out: torch.Tensor, gf: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """``out += 2 * h2[a] * gf[side]`` on each side's boundary cells, in
    place (a neighbour outside the patch, ghost ``coef * u_b + 2 * gf``,
    adds ``2 * h2 * gf`` to its boundary cell's term): completes the no-gf
    stencil.  ``out`` ``[P, n, ..]``, ``gf`` ``[P, 2D, n**(D-1)]``, ``h2``
    ``[P, D]``, one dtype and device; returns ``out``.  On a CUDA tensor it
    launches the face-term kernel (``csrc/ghost_faces.cu``; counted in
    ``launches_faces``), on a CPU tensor it runs
    :func:`add_ghost_faces_plain`."""
    D = _check_faces(out, gf, h2)
    if out.device.type == "cpu":
        return add_ghost_faces_plain(out, gf, h2)
    if out.device.type != "cuda":
        raise ValueError(f"no face-term kernel for device {out.device}")
    for name, t in (("out", out), ("gf", gf), ("h2", h2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.shape[1] > _MAX_N[D]:
        raise ValueError(f"n={out.shape[1]} exceeds the {D}D kernel's largest n")
    lib = build_faces()

    def launch():
        return _faces_fns[D, out.dtype](out.data_ptr(), gf.data_ptr(), h2.data_ptr(),
                                        out.shape[0], out.shape[1],
                                        torch.cuda.current_stream().cuda_stream)

    if out.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(out.device):
            err = launch()
    if err != 0:
        msg = lib.pps_ghost_faces_error_string(err).decode()
        raise RuntimeError(f"{D}D ghost_faces launch failed: {msg} ({err})")
    launches_faces[D][_NAMES[out.dtype]] += 1
    return out

"""The 2D ghost-closure star stencil: CUDA kernel and plain version.

``ghost_stencil(u, gf, coef, h2)`` computes, per patch,

    out = h2x * (lo_x - 2 u + hi_x) + h2y * (lo_y - 2 u + hi_y),

where a neighbour outside the patch is the ghost ``coef * u_b + 2 * gf``
(``level_ops._star_stencil`` of the reference; ``StarPatchOp.h:28-184``).
Shapes: ``u`` ``[P, n, n]`` (x fastest), ``gf`` ``[P, 4, n]`` (sides x_lo,
x_hi, y_lo, y_hi; x faces indexed by row y, y faces by column x), ``coef``
``[P, 4]``, ``h2`` ``[P, 2]``; all float32 or all float64.

On a CUDA tensor the wrapper launches the kernel of ``csrc/ghost_stencil.cu``
(the port of the reference's Pallas ``pallas_stencil._kernel_2d``) and
counts the launch in ``launches``; on a CPU tensor it runs
:func:`ghost_stencil_plain`.  There is no size gate and no fallback: a
CUDA launch that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

#: kernel launches per dtype name ("float32", "float64")
launches = {"float32": 0, "float64": 0}

_ENTRY = {torch.float32: "pps_ghost_stencil_2d_f32",
          torch.float64: "pps_ghost_stencil_2d_f64"}
_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_fns = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = cuda_build.load_library("ghost_stencil", ["ghost_stencil.cu"])
    if not _fns:
        for dt, name in _ENTRY.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            _fns[dt] = fn
        lib.pps_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pps_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ghost_stencil_plain(u: torch.Tensor, gf: torch.Tensor, coef: torch.Tensor,
                        h2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``_star_stencil`` at D=2)."""
    P, n = u.shape[0], u.shape[-1]
    out = None
    for a in range(2):
        ax = 2 - a  # array axis of spatial axis a (x fastest)
        ghost_lo = coef[:, 2 * a, None] * u.select(ax, 0) + 2.0 * gf[:, 2 * a]
        ghost_hi = (coef[:, 2 * a + 1, None] * u.select(ax, n - 1)
                    + 2.0 * gf[:, 2 * a + 1])
        lo = torch.cat([ghost_lo.unsqueeze(ax), u.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([u.narrow(ax, 1, n - 1), ghost_hi.unsqueeze(ax)], dim=ax)
        term = (lo - 2.0 * u + hi) * h2[:, a].reshape(P, 1, 1)
        out = term if out is None else out + term
    return out


def _check(u, gf, coef, h2) -> None:
    if u.dim() != 3 or u.shape[1] != u.shape[2]:
        raise ValueError(f"u must be [P, n, n], got {tuple(u.shape)}")
    P, n = u.shape[0], u.shape[1]
    want = {"gf": (P, 4, n), "coef": (P, 4), "h2": (P, 2)}
    for name, t in (("gf", gf), ("coef", coef), ("h2", h2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]}, got {tuple(t.shape)}"
            )
    for name, t in (("u", u), ("gf", gf), ("coef", coef), ("h2", h2)):
        if t.dtype not in _ENTRY or t.dtype != u.dtype:
            raise TypeError(
                f"{name}: dtype {t.dtype}; all inputs must be one of "
                "float32 / float64"
            )
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")


def ghost_stencil(u: torch.Tensor, gf: torch.Tensor, coef: torch.Tensor,
                  h2: torch.Tensor) -> torch.Tensor:
    """``A_local u`` with explicit ghost faces (see the module doc)."""
    _check(u, gf, coef, h2)
    if u.device.type == "cpu":
        return ghost_stencil_plain(u, gf, coef, h2)
    if u.device.type != "cuda":
        raise ValueError(f"no ghost-stencil kernel for device {u.device}")
    for name, t in (("u", u), ("gf", gf), ("coef", coef), ("h2", h2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, n = u.shape[0], u.shape[1]
    if n * n > 65535 * 256:
        raise ValueError(f"patch size n={n} exceeds the kernel's grid")
    if not _fns:
        build()
    out = torch.empty_like(u)
    if u.device.index == torch.cuda.current_device():
        err = _launch(u, gf, coef, h2, out)
    else:
        with torch.cuda.device(u.device):
            err = _launch(u, gf, coef, h2, out)
    if err != 0:
        msg = build().pps_cuda_error_string(err).decode()
        raise RuntimeError(f"ghost_stencil launch failed: {msg} ({err})")
    launches[_NAMES[u.dtype]] += 1
    return out


def _launch(u, gf, coef, h2, out) -> int:
    """Launch on the current stream of the current device (u's)."""
    stream = torch.cuda.current_stream().cuda_stream
    return _fns[u.dtype](u.data_ptr(), gf.data_ptr(), coef.data_ptr(),
                         h2.data_ptr(), out.data_ptr(), u.shape[0], u.shape[1],
                         stream)

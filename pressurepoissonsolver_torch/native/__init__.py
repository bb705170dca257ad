"""ctypes bindings for the native table generator (``tablegen.cpp``).

The C++ source is this package's own copy of the reference's
``pressurepoissonsolver_tpu/native/tablegen.cpp`` (byte for byte; the tests
hold the two equal).  It is compiled with ``g++`` at first use into
``build/pps_torch_native/`` beside the package, as a library whose file
name carries a hash of the source: a build writes a temporary file of its
own and renames it into place, so processes (or threads) that build at
once never load a half written library.  Without ``g++`` (or when the
build fails) :func:`available` is False and
:class:`~pressurepoissonsolver_torch.domain.DomainHierarchy` takes the
pure-Python builders, which produce the same tables.

This is host code: it builds the numpy tables that ``Level`` uploads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "tablegen.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "pps_torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The library built from :data:`SOURCE` (built now unless present), or
    None when ``g++`` is missing or fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libtablegen-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built or loaded (tried
    once per process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.pps_build_level.restype = ctypes.c_void_p
    lib.pps_build_level.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    for name in ("pps_num_patches", "pps_num_ifaces", "pps_num_contribs"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in (
        "pps_copy_ids", "pps_copy_starts", "pps_copy_spacings",
        "pps_copy_refine_level", "pps_copy_parent_id", "pps_copy_orth_on_parent",
        "pps_copy_neumann", "pps_copy_nbr_type", "pps_copy_nbr_slot",
        "pps_copy_coarse_orth", "pps_copy_fine_nbr_slots",
        "pps_copy_iface_side_idx", "pps_copy_iface_side_mask",
        "pps_copy_contrib_patch", "pps_copy_contrib_side",
        "pps_copy_contrib_iface", "pps_copy_contrib_case",
    ):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pps_free.restype = None
    lib.pps_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_level_native(tree, tree_level: int, n: int, neumann: bool):
    """The native level extraction and interface enumeration of level
    ``tree_level``: ``(PatchLevel, IfaceTables)`` equal to
    ``domain.extract_level`` and ``iface.build_iface_tables`` (bilinear),
    or None when the library is unavailable.  ``neumann`` is one flag for
    every physical boundary."""
    lib = get_lib()
    if lib is None:
        return None
    from ..domain import PatchLevel
    from ..iface import IfaceTables, case_templates

    D = tree.D
    S, half = 2 * D, 1 << (D - 1)
    N = len(tree.nodes)
    order = sorted(tree.nodes)
    nodes = [tree.nodes[i] for i in order]
    ids = np.array(order, dtype=np.int64)
    level_arr = np.array([nd.level for nd in nodes], dtype=np.int32)
    parent = np.array([nd.parent for nd in nodes], dtype=np.int64)

    def stack(attr, dtype):
        return np.ascontiguousarray(np.stack([getattr(nd, attr) for nd in nodes]),
                                    dtype=dtype)

    starts = stack("starts", np.float64)
    lengths = stack("lengths", np.float64)
    nbr_id = stack("nbr_id", np.int64)
    child_id = stack("child_id", np.int64)

    h = lib.pps_build_level(
        N, D, n, _ptr(ids), _ptr(level_arr), _ptr(parent), _ptr(starts),
        _ptr(lengths), _ptr(nbr_id), _ptr(child_id), tree_level, int(neumann),
    )
    try:
        P = lib.pps_num_patches(h)
        C = lib.pps_num_contribs(h)

        def grab(fn, shape, dtype):
            out = np.empty(shape, dtype=dtype)
            getattr(lib, fn)(h, _ptr(out))
            return out

        pl = PatchLevel(
            D=D,
            n=n,
            tree_level=tree_level,
            ids=grab("pps_copy_ids", (P,), np.int64),
            starts=grab("pps_copy_starts", (P, D), np.float64),
            spacings=grab("pps_copy_spacings", (P, D), np.float64),
            refine_level=grab("pps_copy_refine_level", (P,), np.int32),
            parent_id=grab("pps_copy_parent_id", (P,), np.int64),
            orth_on_parent=grab("pps_copy_orth_on_parent", (P,), np.int32),
            neumann=grab("pps_copy_neumann", (P, S), np.uint8).astype(bool),
            nbr_type=grab("pps_copy_nbr_type", (P, S), np.int8),
            nbr_slot=grab("pps_copy_nbr_slot", (P, S), np.int64),
            coarse_orth=grab("pps_copy_coarse_orth", (P, S), np.int32),
            fine_nbr_slots=grab("pps_copy_fine_nbr_slots", (P, S, half), np.int64),
        )
        _, W, Src = case_templates(D, n)
        tables = IfaceTables(
            num_ifaces=int(lib.pps_num_ifaces(h)),
            m=n ** (D - 1),
            iface_side_idx=grab("pps_copy_iface_side_idx", (P, S), np.int32),
            iface_side_mask=grab("pps_copy_iface_side_mask", (P, S), np.uint8).astype(bool),
            contrib_patch=grab("pps_copy_contrib_patch", (C,), np.int32),
            contrib_side=grab("pps_copy_contrib_side", (C,), np.int32),
            contrib_iface=grab("pps_copy_contrib_iface", (C,), np.int32),
            contrib_case=grab("pps_copy_contrib_case", (C,), np.int32),
            case_w=W,
            case_src=Src,
        )
        return pl, tables
    finally:
        lib.pps_free(h)

"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled at first use from ``csrc/`` into
``build/pps_torch_kernels/`` beside the package, for ``sm_90a`` (Hopper),
as a shared library with a plain C interface: no PyTorch headers, so a
build takes seconds.
The file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

:data:`LIBRARIES` lists every library; a kernel's module loads its own
(:func:`load_library`) and binds its C signatures on it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pps_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: every kernel library: name -> (sources under ``csrc/``, ``-D`` macros)
LIBRARIES = {
    "ghost_stencil": (("ghost_stencil.cu",), ()),
    "ghost_stencil_3d": (("ghost_stencil_3d.cu",), ()),
    "ghost_faces": (("ghost_faces.cu",), ()),
    "graph_loop": (("graph_loop.cu",), ()),
    "patch_sweep_f32": (("patch_sweep.cu",), ()),
    "patch_sweep_f64": (("patch_sweep.cu",), ("PPS_SWEEP_F64",)),
    "transfer": (("transfer.cu",), ()),
}

_libs: Dict[str, ctypes.CDLL] = {}
#: per library: seconds the last build took (0.0 when loaded from the
#: build directory) and the compiler's output (register/spill report)
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """Compile the library ``name`` of :data:`LIBRARIES` (its sources, with
    its macros) into ``lib<name>-<hash>.so`` unless it exists, and load
    it."""
    if name in _libs:
        return _libs[name]
    sources, defines = LIBRARIES[name]
    paths = [CSRC / s for s in sources]
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    info = {"seconds": 0.0, "log": ""}
    if not out.exists():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *flags, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n{info['log']}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    build_info[name] = info
    _libs[name] = lib
    return lib


def build_all() -> None:
    """Build (or load) every kernel library of the package side by side,
    one nvcc per library in a thread of its own: the port's set-up on a
    card calls it before its first launch, so that a fresh checkout waits
    for the slowest build rather than for their sum."""
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(load_library, name) for name in LIBRARIES]:
            fut.result()

"""Visualization output writers (host, numpy).

Carried from ``pressurepoissonsolver_tpu.utils.writers``; the files are
byte-equal to the reference writer's for the same arrays.  Fields may be
numpy arrays or tensors on any device.

* :func:`write_claw` — ASCII Clawpack ``fort.t0000``/``fort.q0000`` patch
  output (reference ``apps/shared/Writers/ClawWriter.cpp``).
* :func:`write_vtk` — VTK XML multiblock output: one ``.vti`` ImageData
  file per patch plus a ``.vtm`` index, openable directly in ParaView
  (replacement for the reference's VTK-library-based
  ``apps/shared/Writers/VtkWriter2d.cpp``; no VTK dependency needed).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..domain import PatchLevel


def _host(x) -> np.ndarray:
    """A field as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_claw(level: PatchLevel, u, resid, directory: str = ".") -> None:
    """Clawpack ASCII output (2D).  ``u``/``resid`` are ``[P, ny, nx]``."""
    if level.D != 2:
        raise ValueError("Claw output is 2D only")
    u = _host(u)
    resid = _host(resid)
    n = level.n
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "fort.t0000"), "w") as t:
        t.write(f"{0.0}\ttime\n")
        t.write("2\tmeqn\n")
        t.write(f"{level.num_patches}\tngrids\n")
        t.write("2\tnum_aux\n")
        t.write("2\tnum_dim\n")
    with open(os.path.join(directory, "fort.q0000"), "w") as q:
        for p in range(level.num_patches):
            q.write(f"{int(level.ids[p])}\tgrid_number\n")
            q.write(f"{int(level.refine_level[p])}\tAMR_level\n")
            q.write("0\tblock_number\n")
            q.write("0\tmpi_rank\n")
            q.write(f"{n}\tmx\n")
            q.write(f"{n}\tmy\n")
            q.write(f"{level.starts[p, 0]}\txlow\n")
            q.write(f"{level.starts[p, 1]}\tylow\n")
            q.write(f"{level.spacings[p, 0]}\tdx\n")
            q.write(f"{level.spacings[p, 1]}\tdy\n\n")
            cellvol = level.spacings[p, 0] * level.spacings[p, 1]
            # reference writes x-major: loop i (x) outer, j (y) inner
            for i in range(n):
                for j in range(n):
                    q.write(f"{u[p, j, i]:.10e}\t{resid[p, j, i] * cellvol:.10e}\n")
                q.write("\n")


def write_vtk(level: PatchLevel, fields: Dict[str, object], path: str) -> None:
    """Write ``<path>.vtm`` + ``<path>/patchNNN.vti`` (cell data per patch).

    ``fields`` maps name -> ``[P, *ns]`` array (2D or 3D).
    """
    os.makedirs(path, exist_ok=True)
    base = os.path.basename(path)
    host = {k: _host(v) for k, v in fields.items()}
    blocks = []
    for p in range(level.num_patches):
        fn = f"patch{p:06d}.vti"
        _write_vti(level, p, {k: v[p] for k, v in host.items()}, os.path.join(path, fn))
        blocks.append(fn)
    with open(path + ".vtm", "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="vtkMultiBlockDataSet" version="1.0" '
            'byte_order="LittleEndian">\n'
        )
        f.write("  <vtkMultiBlockDataSet>\n")
        for i, fn in enumerate(blocks):
            f.write(
                f'    <DataSet index="{i}" file="{base}/{fn}"/>\n'
            )
        f.write("  </vtkMultiBlockDataSet>\n</VTKFile>\n")


def _write_vti(level: PatchLevel, p: int, fields: Dict[str, np.ndarray], path: str) -> None:
    D, n = level.D, level.n
    origin = list(level.starts[p]) + [0.0] * (3 - D)
    spacing = list(level.spacings[p]) + [1.0] * (3 - D)
    ext = [0, n, 0, n, 0, n if D == 3 else 0]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian">\n')
        f.write(
            f'  <ImageData WholeExtent="{ext[0]} {ext[1]} {ext[2]} {ext[3]} {ext[4]} {ext[5]}" '
            f'Origin="{origin[0]} {origin[1]} {origin[2]}" '
            f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">\n'
        )
        f.write(
            f'    <Piece Extent="{ext[0]} {ext[1]} {ext[2]} {ext[3]} {ext[4]} {ext[5]}">\n'
        )
        f.write("      <CellData>\n")
        for name, arr in fields.items():
            flat = np.asarray(arr, dtype=np.float64).ravel()  # [z,y,x] C-order = x fastest
            f.write(
                f'        <DataArray type="Float64" Name="{name}" format="ascii">\n'
            )
            f.write("          " + " ".join(f"{v:.10e}" for v in flat) + "\n")
            f.write("        </DataArray>\n")
        f.write("      </CellData>\n")
        f.write("    </Piece>\n  </ImageData>\n</VTKFile>\n")

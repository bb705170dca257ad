"""Checkpoint / resume of solver state.

The state of a solve is the mesh tree, the patch size and the patch
fields (right-hand side, iterate, exact solution, ...).  The format is the
reference's (``pressurepoissonsolver_tpu.checkpoint``): one ``.npz``
holding the tree's binary ``.bin`` bytes, ``D``, ``n`` and the arrays.  A
checkpoint written by either package loads in the other, so both solve
the identical mesh and right-hand side.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .geometry import Tree


def _tree_bytes(tree: Tree) -> bytes:
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        path = f.name
    try:
        tree.to_file(path)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def save_checkpoint(
    path: str,
    tree: Tree,
    n: int,
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict] = None,
) -> None:
    """Write solver state: mesh + patch-cell arrays (u, f, exact, ...)."""
    payload = {f"array_{k}": np.asarray(v) for k, v in arrays.items()}
    payload["tree"] = np.frombuffer(_tree_bytes(tree), dtype=np.uint8)
    payload["D"] = np.int64(tree.D)
    payload["n"] = np.int64(n)
    if meta:
        for k, v in meta.items():
            payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str) -> Tuple[Tree, int, Dict[str, np.ndarray], Dict]:
    """Read back ``(tree, n, arrays, meta)``; arrays stay numpy."""
    data = np.load(path)
    D = int(data["D"])
    n = int(data["n"])
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(data["tree"].tobytes())
        tree_path = f.name
    try:
        tree = Tree.from_file(tree_path, D)
    finally:
        os.unlink(tree_path)
    arrays = {
        k[len("array_"):]: data[k] for k in data.files if k.startswith("array_")
    }
    meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
    return tree, n, arrays, meta


def state_to_torch(
    arrays: Dict[str, np.ndarray], device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Upload checkpoint arrays: floating fields become ``dtype`` tensors
    on ``device``; integer and boolean arrays keep their type."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        dt = dtype if np.issubdtype(v.dtype, np.floating) else None
        out[k] = torch.as_tensor(v, device=device, dtype=dt)
    return out

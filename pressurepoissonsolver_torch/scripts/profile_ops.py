"""Per-op timing and roofline report on the card.

The port's counterpart of ``scripts/profile_ops.py``: the core ``Level`` ops
with a breakdown of the composite-apply pipeline (face extraction, trace
interpolation, gamma gather, the stencil kernel alone, right-hand-side
fold, spectral solve), the grid transfers and the whole V-cycle, each timed
by ``utils.profiling.measure`` (every row names its method)::

    python -m pressurepoissonsolver_torch.scripts.profile_ops

Environment knobs: ``PPS_PROFILE_DIVIDE`` (default 3: the bench's DOF at
n=16), ``PPS_PROFILE_N`` (default 16), ``PPS_PROFILE_DTYPE`` (``f32``
skips the f64 rows), ``PPS_PROFILE_OUT`` (write the report as JSON),
``PPS_PROFILE_HBM_FORCE`` (add ``<op>_hbm`` rows whose inputs rotate
through copies beyond the L2), ``PPS_BENCH_MESH`` (the 2D mesh file, as
for ``bench``), ``PPS_PROFILE_HALO`` (add the f32 rows of the sharded
halo engine on a one-rank mesh, ``halo_ndev1_f32``: the exchange-buffer
pipeline of the multi-device path with no peer, so that the sharded ops
have a measured one-card cost; the group it starts, if none is running,
ends with it).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..bench import bench_tree
from ..domain import DomainHierarchy
from ..gmg import CycleOpts, build_gmg
from ..ops.level_ops import Level, extract_faces
from ..ops.patch_sweep import _spectral_apply
from ..utils import profiling


def level_breakdown(lvl: Level, reps: int = 500, light: bool = False) -> dict:
    """Per-op table of one level, the sub-ops of ``apply`` included.

    ``light`` times only the composite-apply chain (what the IR outer loop
    runs in f64).  ``stencil_only`` is the ghost-stencil kernel alone;
    ``spectral_solve`` is the batched spectral patch solve
    (``_spectral_apply``)."""
    bw = profiling._device_bw(lvl.device)
    itemsize = torch.empty((), dtype=lvl.dtype).element_size()
    field = lvl.P * lvl.pl.cells_per_patch * itemsize
    D, n, m = lvl.D, lvl.n, lvl.m
    rng = np.random.default_rng(0)
    u = profiling.random_field(lvl, rng)
    g = torch.as_tensor(rng.standard_normal((max(lvl.num_ifaces, 1), m)),
                        dtype=lvl.dtype, device=lvl.device)
    gf = torch.as_tensor(rng.standard_normal((lvl.P, 2 * D, m)),
                         dtype=lvl.dtype, device=lvl.device)
    faces = extract_faces(u, D, n, lvl.face_depth)
    face_bytes = faces.numel() * itemsize
    nnz = (2 * D + 1) * lvl.P * lvl.pl.cells_per_patch
    B = (profiling.rotation_buffers(lvl.device, field)
         if os.environ.get("PPS_PROFILE_HBM_FORCE") else 0)

    out = {}

    def add(name, fn, args, bytes_needed, nnz_count=0):
        out[name] = profiling.timed_row(fn, args, bytes_needed, bw, reps, nnz_count)
        if B and args[0].shape == u.shape:
            out[name + "_hbm"] = profiling.timed_row(
                fn, args, bytes_needed, bw, min(reps, 100), hbm_rotate=B)

    add("extract_faces", lambda x: extract_faces(x, D, n, lvl.face_depth),
        (u,), field + face_bytes)
    if light:
        add("interpolate", lvl.interpolate, (u,), field + face_bytes)
        add("stencil_only", lambda x: lvl._stencil_with_faces(x, gf), (u,),
            2 * field, nnz)
        add("apply", lvl.apply, (u,), 2 * field, nnz)
        return out
    add("pipe_interpolate", lambda ff: lvl._pipe.interpolate(ff, m),
        (faces,), 2 * face_bytes)
    add("interpolate", lvl.interpolate, (u,), field + face_bytes)
    add("gamma_faces", lvl.gamma_faces, (g,), 2 * face_bytes)
    add("stencil_only", lambda x: lvl._stencil_with_faces(x, gf), (u,),
        2 * field, nnz)
    add("fold_rhs", lambda x: lvl._fold_faces_into_rhs(x, gf), (u,), 2 * field)
    add("spectral_solve", lambda x: _spectral_apply(lvl._st, x, D, n), (u,), 2 * field)
    # composed ops
    add("apply", lvl.apply, (u,), 2 * field, nnz)
    add("patch_solve", lambda x: lvl.patch_solve(x, g), (u,), 2 * field)
    add("smooth", lambda x: lvl.smooth(x, x), (u,), 3 * field)
    return out


def halo_rows(h: DomainHierarchy, device, bw: float) -> dict:
    """``apply``, ``smooth`` and ``interpolate`` of the f32 halo engine
    (``parallel.halo.ShardedLevel``) on a one-rank mesh."""
    from ..parallel.halo import ShardedLevel
    from ..parallel.sharding import make_mesh

    own = not dist.is_initialized()
    mesh = make_mesh(1)
    try:
        sl = ShardedLevel(Level(h.finest, dtype=torch.float32, device="cpu"), mesh,
                          device)
        u = sl.local_rows(profiling.random_field(sl, np.random.default_rng(0)))
        field = u.numel() * u.element_size()
        return {name: profiling.timed_row(fn, (u,), nbytes, bw, 200)
                for name, fn, nbytes in (
                    ("apply", sl.apply, 2 * field),
                    ("smooth", lambda x: sl.smooth(x, x), 3 * field),
                    ("interpolate", sl.interpolate, field))}
    finally:
        if own:
            dist.destroy_process_group()


def main(device="cuda") -> dict:
    """Print (and with ``PPS_PROFILE_OUT`` write) the report; return it."""
    device = torch.device(device)
    divide = int(os.environ.get("PPS_PROFILE_DIVIDE", "3"))
    n = int(os.environ.get("PPS_PROFILE_N", "16"))
    tree = bench_tree(divide)
    h = DomainHierarchy(tree, n=n)

    on_card = device.type == "cuda"
    report = {
        "divide": divide,
        "n": n,
        "device": profiling.card_line() if on_card else "cpu",
        "hbm_bytes_per_s": profiling._device_bw(device),
        # the method of a row unless the row names another
        "timing": "held_stream_device" if on_card else "cpu_wall",
    }
    variants = [(torch.float32, "f32"), (torch.float64, "f64")]
    if os.environ.get("PPS_PROFILE_DTYPE") == "f32":
        variants = variants[:1]
    out_path = os.environ.get("PPS_PROFILE_OUT")

    def dump():
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(report, fh, indent=1)

    bw = report["hbm_bytes_per_s"]
    for dtype, name in variants:
        lvl = Level(h.finest, dtype=dtype, device=device)
        print(f"== {name}: P={lvl.P} n={n} DOF={lvl.P * lvl.pl.cells_per_patch} "
              f"ifaces={lvl.num_ifaces}", flush=True)
        rep = level_breakdown(lvl, light=(name == "f64"))
        if name == "f32":
            gmg = build_gmg(h, CycleOpts(pre_sweeps=2, fac_smoothing="active"),
                            dtype=dtype, device=device, fine=lvl)
            rng = np.random.default_rng(0)
            u = profiling.random_field(lvl, rng)
            field = u.numel() * u.element_size()
            if gmg.transfers:
                tr = gmg.transfers[0]
                rep["restrict"] = profiling.timed_row(tr.restrict, (u,), 1.25 * field,
                                                      bw, 200)
                uc = profiling.random_field(gmg.levels[1], rng)
                rep["prolong"] = profiling.timed_row(lambda x: tr.prolong_add(uc, x),
                                                     (u,), 2.25 * field, bw, 200)
            t, how = profiling.measure(gmg.apply, u, reps=20, in_graph=True)
            rep["vcycle_V21_active"] = {"ms": t * 1e3, "levels": len(gmg.levels),
                                        "timing": how}
        for k, v in rep.items():
            print(f"  {k:18s} {v}", flush=True)
        report[name] = rep
        dump()
    if os.environ.get("PPS_PROFILE_HALO"):
        report["halo_ndev1_f32"] = halo_rows(h, device, bw)
        for k, v in report["halo_ndev1_f32"].items():
            print(f"  halo.{k:13s} {v}", flush=True)
        dump()
    if out_path:
        print(f"wrote {out_path}", flush=True)
    return report


if __name__ == "__main__":
    main()

"""Scaling harness: composite-apply throughput and solve time over rank
counts, through the public sharded API (``DomainHierarchy(num_shards=k)``
and ``PoissonSolver(..., mesh=make_mesh(k))``); one JSON line per
configuration, with the keys of the reference's ``scripts/scaling.py``::

    python -m pressurepoissonsolver_torch.scripts.scaling --devices 1 2 4 --solve

Each ``--devices k`` runs as a spawned world of ``k`` ranks (``spawn``
context, a ``FileStore`` in a temporary directory), one rank per card
(``cuda:rank mod cards``), under NCCL when there are at least ``k`` cards
and under gloo otherwise; ``--device cpu`` puts every rank on the CPU
under gloo (the default, ``cuda``, raises without a card); ``k = 1`` is
the plain single-device solver, as in the reference.  Several ranks on one card, or
on the CPU, share that device: such a run checks the sharded path and its
exchange volume and makes no scaling claim, as the reference says of its
virtual CPU devices.  ``--comm`` names the engines, each timed in turn:
``halo`` (the cut-face exchange) and ``pjit`` (each op all-gathers its
operand, ``parallel.gathered``); both by default, as the reference's.
At one device there is one record (``"comm": "single"``), as there.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1])
    ap.add_argument("--divide", type=int, default=1)
    ap.add_argument("-n", type=int, default=16)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--comm", type=str, nargs="+", default=["pjit", "halo"],
                    choices=["pjit", "halo"])
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks run")
    ap.add_argument("--solve", action="store_true",
                    help="also time a complete solve to 1e-6")
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling: DOF grows with the device count "
                    "(each 4x device step adds one uniform refinement, so "
                    "DOF/device is constant); reports weak efficiency vs "
                    "the first configuration and per-device comm rows")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return args


def _trees(args):
    """The mesh per device count: the bench tree with ``--divide``
    refinements, refined once more per 4x device step with ``--weak``."""
    from ..bench import bench_tree

    tree = bench_tree(args.divide)
    if not args.weak:
        return {k: tree for k in args.devices}
    out = {args.devices[0]: tree}
    for ndev in args.devices[1:]:
        ratio = ndev // args.devices[0]
        extra = 0
        while 4 ** extra < ratio:
            extra += 1
        if 4 ** extra != ratio or ndev % args.devices[0]:
            raise SystemExit(f"--weak needs device ratios that are powers of 4 "
                             f"(got {ndev}/{args.devices[0]})")
        t2 = copy.deepcopy(tree)
        for _ in range(extra):
            t2.refine_leaves()
        out[ndev] = t2
    return out


def _rank(rank, ndev, store_path, backend, args, tree, base_time, out_path):
    """One rank of a world: the records of its configurations (rank 0
    writes them)."""
    from ..domain import DomainHierarchy
    from ..problems import get_problem, init_problem
    from ..solver import PoissonSolver, SolveOptions

    device = torch.device("cpu")
    if args.device == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, ndev),
                            rank=rank, world_size=ndev)
    records = []
    try:
        from ..parallel.sharding import make_mesh

        mesh = make_mesh(ndev) if ndev > 1 else None
        dtype = torch.float32 if args.dtype == "float32" else torch.float64
        for comm in (args.comm if ndev > 1 else args.comm[:1]):
            h = DomainHierarchy(tree, n=args.n, num_shards=ndev)
            opts = SolveOptions(dtype=dtype, precond_dtype=dtype, comm=comm, tol=1e-8)
            cuda = device.type == "cuda"
            mem0 = torch.cuda.memory_allocated(device) if cuda else 0
            solver = PoissonSolver(h, opts, mesh=mesh, device=device)
            # this rank's card memory after setup (the solver's tensors)
            setup_mib = ((torch.cuda.memory_allocated(device) - mem0) / 2**20
                         if cuda else None)
            fin = h.finest
            dof = fin.real_patches * fin.cells_per_patch
            nnz = (2 * fin.D + 1) * dof
            u = solver._as_field(np.random.default_rng(0).standard_normal(
                (fin.num_patches,) + fin.ns_shape))
            A = solver.apply
            inner, reps = 50, 5

            def loop(v):
                for _ in range(inner):
                    v = A(v) * 1e-3
                return v

            def sync():
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                if mesh is not None:
                    dist.barrier()

            loop(u)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                loop(u)
            sync()
            t = (time.perf_counter() - t0) / reps / inner
            rec = {"devices": ndev, "comm": comm if ndev > 1 else "single",
                   "dof": dof, "dof_per_device": dof // ndev,
                   "apply_ms": round(t * 1e3, 4), "nnz_per_s": round(nnz / t, 1),
                   "dtype": args.dtype, "platform": device.type,
                   "backend": backend if ndev > 1 else None,
                   "setup_mib": None if setup_mib is None else round(setup_mib, 2)}
            if mesh is not None and comm == "halo":
                rec["cut_face_rows"] = solver._op.comm_rows
                rec["cut_face_rows_per_device"] = round(solver._op.comm_rows / ndev, 1)
            if args.weak:
                rec["mode"] = "weak"
                rec["weak_efficiency_apply"] = round(base_time.get("apply", t) / t, 4)
            if args.solve:
                f_np, _ = init_problem(fin, get_problem("trig", 2))
                solver.solve(f_np, tol=1e-6)
                sync()
                t0 = time.perf_counter()
                res = solver.solve(f_np, tol=1e-6)
                sync()
                rec["solve_s"] = round(time.perf_counter() - t0, 4)
                rec["iterations"] = int(res.iterations)
                if args.weak:
                    rec["weak_efficiency_solve"] = round(
                        base_time.get("solve", rec["solve_s"]) / rec["solve_s"], 4)
            records.append(rec)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump(records, fh)


def run_world(ndev, args, tree, base_time):
    """Spawn a world of ``ndev`` ranks; rank 0's records."""
    # NCCL needs a card per rank
    backend = ("nccl" if args.device == "cuda" and torch.cuda.device_count() >= ndev
               else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "records.json")
        mp.start_processes(_rank, nprocs=ndev, start_method="spawn",
                           args=(ndev, os.path.join(tmp, "store"), backend, args,
                                 tree, base_time, out_path))
        with open(out_path) as fh:
            return json.load(fh)


def main(argv=None) -> list:
    args = parse_args(argv)
    trees = _trees(args)
    base_time: dict = {}
    out = []
    for ndev in args.devices:
        for rec in run_world(ndev, args, trees[ndev], dict(base_time)):
            if args.weak:
                base_time.setdefault("apply", rec["apply_ms"] / 1e3)
                if "solve_s" in rec:
                    base_time.setdefault("solve", rec["solve_s"])
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()

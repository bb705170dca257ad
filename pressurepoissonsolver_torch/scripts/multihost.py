"""Multi-host check: the public sharded solve as a job of 2 hosts x 4 ranks.

The counterpart of the JAX package's ``scripts/multihost.py``.  The
reference's identity is ``mpirun -np N steady`` (ranks exchanging interface
data, ``apps/3d/steady.cpp:76``); here it is N ``torch.distributed`` ranks,
one per device, started the way ``torchrun --nnodes 2 --nproc-per-node 4``
starts them::

    python -m pressurepoissonsolver_torch.scripts.multihost [--device cuda|cpu]

* parent mode (no ``--worker``): builds the reference script's problem
  (``refined_tree(2, 4, 2)``, n=8, ``num_shards = 2 * 4``, ``trig``,
  ``SolveOptions(tol=1e-11)``), solves it in this process, then starts 8
  worker processes with torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
  ``MASTER_ADDR=localhost`` and a free ``MASTER_PORT``), so that
  ``make_mesh()`` and ``local_device()`` take the path of a real two-host
  job; compares rank 0's gathered solution of each engine with the
  single-process one at max-abs 1e-9 and prints the JSON report with the
  reference script's keys, also written to ``--out`` (default
  ``build/multihost.json``); exits 1 unless both engines match;
* worker mode (``--worker``): joins the job, solves with both engines
  (``comm="pjit"`` and ``"halo"``) through ``PoissonSolver.solve`` and rank
  0 prints its results, the gathered solutions included, as one JSON line.

``--device cuda`` (the default; it raises without a card) puts each rank on
``cuda:<LOCAL_RANK mod cards>``.  The two "hosts" share this machine, so
ranks of both sit on the same cards: NCCL refuses two ranks on one card,
so the job runs under gloo, its CUDA tensors staged through pinned host
buffers (``parallel.sharding.Comm``); the report's ``backend`` says so.
``--device cpu`` runs every rank on the CPU under gloo.  The script writes
no file but ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

NPROC = 2  # hosts
NDEV_PER_PROC = 4  # ranks per host
# NCCL needs a card of its own per rank; the two hosts of this job share one
# machine's cards, so the job runs under gloo
BACKEND = "gloo"
# seconds the parent waits for the job
TIMEOUT = 900
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the ranks run")
    ap.add_argument("--out", default=os.path.join("build", "multihost.json"),
                    help="where the parent writes its report")
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank of the job (set by the parent)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return args


def build_problem():
    """The reference script's problem: the hierarchy, ``f`` and the exact
    solution."""
    from ..domain import DomainHierarchy
    from ..geometry import refined_tree
    from ..problems import get_problem, init_problem

    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=NPROC * NDEV_PER_PROC)
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    return h, f, exact


def worker(args) -> None:
    import torch.distributed as dist

    from ..parallel.sharding import gather_patches, local_device, make_mesh
    from ..solver import PoissonSolver, SolveOptions

    device = local_device() if args.device == "cuda" else torch.device("cpu")
    torch.set_num_threads(1)
    mesh = make_mesh(backend=BACKEND)
    try:
        assert dist.get_world_size() == NPROC * NDEV_PER_PROC, dist.get_world_size()
        h, f, _ = build_problem()
        out = {}
        for comm in ("pjit", "halo"):
            solver = PoissonSolver(h, SolveOptions(tol=1e-11, comm=comm), mesh=mesh,
                                   device=device)
            res = solver.solve(f)
            u = gather_patches(res.x, mesh).cpu().numpy()
            out[comm] = {"iterations": int(res.iterations),
                         "residual": float(res.residual_norm / res.r0_norm),
                         "u": u.ravel().tolist()}
        out["device"] = str(device)
        out["host_staged"] = solver._op.comm.host_staged
    finally:
        dist.destroy_process_group()
    if int(os.environ["RANK"]) == 0:
        print(json.dumps(out), flush=True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent(args) -> int:
    from ..solver import PoissonSolver, SolveOptions

    device = "cuda" if args.device == "cuda" else "cpu"
    h, f, _ = build_problem()
    u_ref = PoissonSolver(h, SolveOptions(tol=1e-11), device=device).solve(f).x
    u_ref = u_ref.cpu().numpy()
    world = NPROC * NDEV_PER_PROC
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank % NDEV_PER_PROC),
                   LOCAL_WORLD_SIZE=str(NDEV_PER_PROC),
                   GROUP_RANK=str(rank // NDEV_PER_PROC), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
        # the ranks share this machine's cores: one BLAS thread each (every
        # rank inverts the coarsest level's dense matrix)
        env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pressurepoissonsolver_torch.scripts.multihost",
             "--worker", "--device", args.device],
            env=env, cwd=ROOT, stdout=subprocess.PIPE if rank == 0 else None))
    try:
        stdout, _ = procs[0].communicate(timeout=TIMEOUT)
        rc = [procs[0].returncode] + [p.wait(timeout=TIMEOUT) for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rc):
        print(f"worker exit codes: {rc}", file=sys.stderr)
        return 1
    winfo = json.loads(stdout.decode().strip().splitlines()[-1])
    staged = " (CUDA tensors staged through pinned host buffers)" if winfo[
        "host_staged"] else ""
    report = {
        "processes": NPROC,
        "devices_per_process": NDEV_PER_PROC,
        "dof": int(np.prod(f.shape)),
        "backend": (f"{BACKEND} across {world} ranks on "
                    f"{args.device}{staged}; rank 0 on {winfo['device']}"),
    }
    ok = True
    for comm in ("pjit", "halo"):
        w = winfo[comm]
        u = np.asarray(w.pop("u")).reshape(u_ref.shape)
        err = float(np.abs(u - u_ref).max())
        match = err < 1e-9
        ok = ok and match
        report[comm] = {**w, "max_abs_diff_vs_1proc": err, "match": match}
    report["ok"] = ok
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())

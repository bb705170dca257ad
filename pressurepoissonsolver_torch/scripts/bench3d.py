"""3D benchmark: time to a 1e-10 relative residual of the 3D FAC solve.

The port's counterpart of ``scripts/bench3d.py``, with its knobs and
printed keys::

    PPS_BENCH3D_MESH=<3D mesh file> python -m pressurepoissonsolver_torch.scripts.bench3d

One warm-up solve, then the best of ``PPS_BENCH3D_REPS`` synchronised
walls; the counts are read after the timing.  One JSON line.

Environment knobs (defaults in brackets):
  PPS_BENCH3D_MESH    a 3D mesh file (``Tree.from_file``) [the generated
                      bench mesh: ``refined_tree(3, 3, 2)`` refined once]
  PPS_BENCH3D_N       cells per patch side [32]
  PPS_BENCH3D_DIVIDE  uniform refinements of the mesh [0]
  PPS_BENCH3D_MODE    ir (``solve_refined``) | anything else (``solve``) [ir]
  PPS_BENCH3D_REPS    timed solves [2]
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..domain import DomainHierarchy
from ..geometry import Tree, refined_tree
from ..problems import get_problem, init_problem
from ..solver import PoissonSolver, SolveOptions
from ..utils import profiling


def bench3d_tree() -> Tree:
    """The 3D bench mesh: ``PPS_BENCH3D_MESH``, else ``refined_tree(3, 3,
    2)`` refined once."""
    path = os.environ.get("PPS_BENCH3D_MESH")
    if path:
        return Tree.from_file(path, 3)
    tree = refined_tree(3, 3, 2)
    tree.refine_leaves()
    return tree


def main(device="cuda") -> dict:
    """Run the 3D bench on ``device``, print its JSON line and return it."""
    device = torch.device(device)
    n = int(os.environ.get("PPS_BENCH3D_N", "32"))
    divide = int(os.environ.get("PPS_BENCH3D_DIVIDE", "0"))
    tree = bench3d_tree()
    for _ in range(divide):
        tree.refine_leaves()
    h = DomainHierarchy(tree, n=n)
    dof = h.finest.num_cells
    mode = os.environ.get("PPS_BENCH3D_MODE", "ir")
    s = PoissonSolver(h, SolveOptions(tol=1e-10, precond_dtype=torch.float32),
                      device=device)
    f_np, exact_np = init_problem(h.finest, get_problem("trig", 3))
    f = torch.as_tensor(f_np, device=device)
    exact = torch.as_tensor(exact_np, device=device)

    def run():
        if mode == "ir":
            u, info = s.solve_refined(f, tol=1e-10, sync=False)
            return u, info["outer_iterations"], info["inner_iterations"]
        res = s.solve(f, max_iter=100)
        return res.x, 1, res.iterations

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    sync()
    reps = int(os.environ.get("PPS_BENCH3D_REPS", "2"))
    dt = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        u, outer, inner = run()
        sync()
        dt = min(dt, time.perf_counter() - t0)
    outer, inner = int(outer), int(inner)  # read after the timing
    rep = s.report(u, f, exact)
    out = {
        "metric": "3d_adaptive_time_to_1e-10_s",
        "value": dt,
        "unit": "s",
        "dof": dof,
        "dof_per_s": dof / dt,
        "outer_iterations": outer,
        "inner_iterations": inner,
        "residual": rep["residual"],
        "error": rep["error"],
        "mode": mode,
        "device": profiling.card_line() if device.type == "cuda" else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

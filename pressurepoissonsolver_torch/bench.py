"""Benchmark: the 2D adaptive Poisson complete solve on one card.

The port's counterpart of ``bench.py``, with its knobs, defaults, modes
and printed keys::

    python -m pressurepoissonsolver_torch.bench

Headline metric: DOF/s of a complete solve (to a 1e-10 relative residual)
of the 2D multi-level adaptive problem; ``vs_baseline`` is its ratio to
the reference code's 1-core Schur+hypre complete solve (2,129,920 DOF in
6.37 s = 3.34e5 DOF/s, ``BASELINE.md``).  One warm-up solve, then the best
of ``PPS_BENCH_REPS`` synchronised walls; the iteration counts are read
after the timing.  Then the f64 and f32 composite applies (device time,
``utils.profiling``) and, unless ``PPS_BENCH_SCHUR=0``, the
Schur-complement solve.  One JSON line on standard output.

Environment knobs (defaults in brackets):
  PPS_BENCH_DIVIDE     uniform refinements of the mesh [1]
  PPS_BENCH_N          cells per patch side [64]
  PPS_BENCH_DTYPE      ir | mixed | float32 | float64 [ir]: ``ir`` is
                       ``solve_refined`` (f64 refinement around f32 inner
                       solves); ``mixed`` is ``solve`` with f64 BiCGStab
                       and an f32 cycle; ``float32`` / ``float64`` are
                       ``solve`` in one type (float32 to 1e-6)
  PPS_BENCH_PRE / _POST / _CYCLE / _COARSE_DOF / _MAX_LEVELS /
  _COARSE_SWEEPS / _FAC / _FAC_RING / _COARSE_PRE
                       the V-cycle [2 / 1 / V / 4096 / 0 / 1 / active / 1 / 0]
  PPS_BENCH_INNER      inner Krylov method [bicgstab]
  PPS_BENCH_INNER_TOL  inner tolerance of ``ir`` [1e-4]
  PPS_BENCH_REPS       timed solves [3]
  PPS_BENCH_SCHUR      0 skips the Schur solve [1]
  PPS_BENCH_MESH       a 2D mesh file (``Tree.from_file``; the reference
                       reads ``multi_refine_8.bin`` when it has one) [the
                       generated ``refined_tree(2, 5, 2)``]
"""

from __future__ import annotations

import json
import os
import time

import torch

from .domain import DomainHierarchy
from .geometry import Tree, refined_tree
from .gmg import CycleOpts
from .problems import get_problem, init_problem
from .solver import PoissonSolver, SolveOptions
from .utils import profiling

# the reference code's 1-core Schur+hypre complete solve, DOF/s
BASELINE_DOF_PER_S = 3.34e5


def bench_tree(divide: int) -> Tree:
    """The bench mesh (``PPS_BENCH_MESH``, else ``refined_tree(2, 5, 2)``)
    refined ``divide`` times."""
    path = os.environ.get("PPS_BENCH_MESH")
    tree = Tree.from_file(path, 2) if path else refined_tree(2, 5, 2)
    for _ in range(divide):
        tree.refine_leaves()
    return tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device="cuda") -> dict:
    """Run the bench on ``device``, print its JSON line and return it."""
    device = torch.device(device)
    env = os.environ.get
    divide = int(env("PPS_BENCH_DIVIDE", "1"))
    n = int(env("PPS_BENCH_N", "64"))
    dtype_name = env("PPS_BENCH_DTYPE", "ir")
    tree = bench_tree(divide)

    t_setup0 = time.perf_counter()
    hierarchy = DomainHierarchy(tree, n=n)
    dof = hierarchy.finest.num_cells
    gmg_opts = CycleOpts(
        pre_sweeps=int(env("PPS_BENCH_PRE", "2")),
        post_sweeps=int(env("PPS_BENCH_POST", "1")),
        cycle_type=env("PPS_BENCH_CYCLE", "V"),
        coarse_direct_max_dof=int(env("PPS_BENCH_COARSE_DOF", "4096")),
        max_levels=int(env("PPS_BENCH_MAX_LEVELS", "0")),
        coarse_sweeps=int(env("PPS_BENCH_COARSE_SWEEPS", "1")),
        fac_smoothing=env("PPS_BENCH_FAC", "active"),
        fac_active_ring=int(env("PPS_BENCH_FAC_RING", "1")),
        coarse_pre_sweeps=int(env("PPS_BENCH_COARSE_PRE", "0")),
    )
    inner = env("PPS_BENCH_INNER", "bicgstab")
    if dtype_name == "float32":
        opts = SolveOptions(tol=1e-6, dtype=torch.float32, precond_dtype=torch.float32,
                            gmg=gmg_opts, inner_krylov=inner)
    elif dtype_name in ("mixed", "ir"):
        opts = SolveOptions(tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
                            gmg=gmg_opts, inner_krylov=inner)
    else:
        opts = SolveOptions(tol=1e-10, dtype=torch.float64, precond_dtype=torch.float64,
                            gmg=gmg_opts, inner_krylov=inner)
    solver = PoissonSolver(hierarchy, opts, device=device)
    _sync(device)
    # host tables, uploads and the GMG hierarchy ("Domain Initialization"
    # + "GMG Setup" of the reference code)
    setup_s = time.perf_counter() - t_setup0
    f_np, exact_np = init_problem(hierarchy.finest, get_problem("trig", 2))
    f = torch.as_tensor(f_np, dtype=opts.dtype, device=device)
    exact = torch.as_tensor(exact_np, dtype=opts.dtype, device=device)
    inner_tol = float(env("PPS_BENCH_INNER_TOL", "1e-4"))

    def run_solve():
        if dtype_name == "ir":
            u, info = solver.solve_refined(f, tol=1e-10, inner_tol=inner_tol, sync=False)
            return u, {"outer": info["outer_iterations"], "inner": info["inner_iterations"]}
        res = solver.solve(f, max_iter=200)
        return res.x, {"outer": 1, "inner": res.iterations}

    def timed(run):
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        return time.perf_counter() - t0, out

    compile_and_first, _ = timed(run_solve)  # warm-up
    timed_reps = int(env("PPS_BENCH_REPS", "3"))
    solve_s = float("inf")
    for _ in range(timed_reps):
        dt, (u, iters) = timed(run_solve)
        solve_s = min(solve_s, dt)
    iters = {k: int(v) for k, v in iters.items()}  # read after the timing
    rep = solver.report(u, f, exact)

    # composite-operator device time (the "stencil applications nnz/s"
    # metric): held-stream CUDA events on the card, the method recorded
    bw = profiling._device_bw(device)
    apply64_s, how64 = profiling.measure(solver.fine_level.apply, u, reps=200,
                                         in_graph=True)
    extras = {
        "apply_f64_ms": apply64_s * 1e3,
        "apply_f64_roofline_pct": profiling.sig4(100 * (2 * dof * 8) / bw / apply64_s),
    }
    timing = {how64}
    low = solver._fine_low
    if low is not None:
        apply32_s, how32 = profiling.measure(low.apply, u.to(torch.float32), reps=200,
                                             in_graph=True)
        timing.add(how32)
        extras["apply_f32_ms"] = apply32_s * 1e3
        extras["apply_f32_roofline_pct"] = profiling.sig4(
            100 * (2 * dof * 4) / bw / apply32_s)
        nnz_per_s = 5 * dof / apply32_s
    else:
        nnz_per_s = 5 * dof / apply64_s
    extras = {"apply_timing": "+".join(sorted(timing)), **extras}

    # the Schur-complement complete solve: GMG-Woodbury-preconditioned
    # BiCGStab on the interface system, then the patch solves
    schur_extras = {}
    if env("PPS_BENCH_SCHUR", "1") != "0":
        def run_schur():
            return solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")

        timed(run_schur)  # warm-up
        schur_s = float("inf")
        for _ in range(max(timed_reps - 1, 1)):
            dt, (u_s, res_s) = timed(run_schur)
            schur_s = min(schur_s, dt)
        rep_s = solver.report(u_s, f, exact)
        schur_extras = {
            "schur_complete_solve_s": schur_s,
            "schur_dof_per_s": dof / schur_s,
            "schur_iterations": int(res_s.iterations),
            "schur_residual": rep_s["residual"],
        }

    dof_per_s = dof / solve_s
    out = {
        "metric": "2d_adaptive_complete_solve_dof_per_s",
        "value": dof_per_s,
        "unit": "DOF/s",
        "vs_baseline": dof_per_s / BASELINE_DOF_PER_S,
        "dof": dof,
        "solve_s": solve_s,
        "outer_iterations": iters["outer"],
        "inner_iterations": iters["inner"],
        "residual": rep["residual"],
        "error": rep["error"],
        "stencil_nnz_per_s": nnz_per_s,
        **extras,
        **schur_extras,
        "setup_s": setup_s,
        "compile_s": compile_and_first - solve_s,
        "dtype": dtype_name,
        "device": profiling.card_line() if device.type == "cuda" else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

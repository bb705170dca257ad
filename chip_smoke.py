#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``pressurepoissonsolver_torch``) on one
CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, any failure of which raises and exits non-zero:

1. require CUDA; turn TF32 off for matmuls and convolutions; print the
   card's name and power limit;
2. build the CUDA kernels from ``pressurepoissonsolver_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and time both with CUDA events;
4. drive the main path: the 2D adaptive composite-grid solve of
   ``bench.py`` (``refined_tree(2, 5, 2)`` refined once, n=64, 4,292,608
   DOF, ``trig`` problem) with ``PoissonSolver.solve_refined`` — f64
   iterative refinement around f32 BiCGStab preconditioned by a V(2,1)
   FAC cycle with active-set smoothing — to a relative residual of 1e-10;
   check the result against the JAX reference's numbers and check that
   the solve went through the kernels;
5. print the kernel table, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# the JAX reference on this configuration (pressurepoissonsolver_tpu,
# CPU): 3 outer / 7 inner iterations, relative error 8.931e-7; and on the
# small test mesh (refined_tree(2, 4, 2), n=8, coarse_direct_max_dof=64):
# 3 outer / 7 inner, relative error 9.151817836e-4
BENCH_ERROR = 8.931e-7
SMALL_ERROR = 9.151817836e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def stencil_shapes(solver):
    """The ``(P, n)`` shapes the bench solve gives the ghost stencil: the
    f32 composite apply on every GMG level above the coarse solve and the
    active-set residual applies; the f64 apply on the finest level."""
    gmg = solver.gmg
    n = solver.fine_level.n
    f32 = {(lvl.P, n) for lvl in gmg.levels[:-1]}
    f32 |= {(a.Pa, n) for a in gmg._aapply if a is not None}
    return {"float32": sorted(f32, reverse=True), "float64": [(solver.fine_level.P, n)]}


def check_kernels(torch, gs, timer, card, shapes):
    """Phase 3: the ghost stencil against its plain version at every shape
    of the main path and at an odd one (P=37, n=12), in f32 and f64; device
    and host-paced times at the finest shape and the odd one."""
    rng = np.random.default_rng(SEED)
    table = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = str(dtype).replace("torch.", "")
        main = shapes[name]
        for P, n in main + [(37, 12)]:
            timed = (P, n) in (main[0], (37, 12))
            u = rng.standard_normal((P, n, n))
            gf = rng.standard_normal((P, 4, n))
            coef = rng.choice([-1.0, 0.0, 1.0], size=(P, 4))
            h = 1.0 / (n * 2.0 ** rng.integers(2, 7, size=(P, 1)))
            h2 = np.repeat(1.0 / h**2, 2, axis=1)
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in (u, gf, coef, h2)]
            out_k = gs.ghost_stencil(*args)
            out_p = gs.ghost_stencil_plain(*args)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            line = (f"kernel ghost_stencil_2d {name} P={P} n={n} [{card}]: "
                    f"max_abs_err={err:.3e} max|out|={scale:.3e} (limit "
                    f"{rtol:g}*max|out|)")
            if not err <= rtol * scale:
                raise AssertionError(line)
            if not timed:
                print(line, flush=True)
                continue
            # device time (stream held until all calls are queued) and the
            # host-paced time of back-to-back calls, kernel and plain
            t = {}
            for label, fn in (("kernel", lambda: gs.ghost_stencil(*args)),
                              ("plain", lambda: gs.ghost_stencil_plain(*args))):
                for hold in (True, False):
                    t[label, hold] = timer.cuda_median_ms(fn, reps=50, hold=hold)
            ms, plain_ms = t["kernel", True], t["plain", True]
            gbs = 2 * P * n * n * out_k.element_size() / (ms * 1e-3) / 1e9
            print(f"{line}; device ms: kernel {ms:.5f} ({gbs:.0f} GB/s of "
                  f"compulsory traffic) plain {plain_ms:.5f}; host-paced ms: "
                  f"kernel {t['kernel', False]:.5f} plain "
                  f"{t['plain', False]:.5f}", flush=True)
            if (P, n) == main[0]:
                table[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return table


def solve_small(torch, port):
    """A small solve on the card, held to the reference's numbers."""
    tree = port.refined_tree(2, 4, 2)
    hier = port.DomainHierarchy(tree, n=8)
    opts = port.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
        gmg=port.CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                             coarse_direct_max_dof=64))
    solver = port.PoissonSolver(hier, opts, device="cuda")
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", 2))
    u, info = solver.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    rep = solver.report(u, f, exact)
    print(f"small solve (70 patches, n=8): outer {info['outer_iterations']} "
          f"inner {info['inner_iterations']} residual {rep['residual']:.3e} "
          f"error {rep['error']:.10e}", flush=True)
    assert info["outer_iterations"] == 3, info
    assert 6 <= info["inner_iterations"] <= 8, info
    assert rep["residual"] <= 1e-10, rep
    assert abs(rep["error"] - SMALL_ERROR) <= 1e-6 * SMALL_ERROR, rep


def setup_bench(torch, port, card):
    """The bench problem's solver, right-hand side and exact solution."""
    t0 = time.perf_counter()
    tree = port.refined_tree(2, 5, 2)
    tree.refine_leaves()
    hier = port.DomainHierarchy(tree, n=64)
    opts = port.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
        gmg=port.CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                             coarse_direct_max_dof=4096))
    solver = port.PoissonSolver(hier, opts, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dof = hier.finest.num_cells
    f_np, exact_np = port.init_problem(hier.finest, port.get_problem("trig", 2))
    f = torch.as_tensor(f_np, dtype=torch.float64, device="cuda")
    exact = torch.as_tensor(exact_np, dtype=torch.float64, device="cuda")
    print(f"bench mesh [{card}]: {dof} DOF, patches per level "
          f"{[pl.num_patches for pl in hier.levels]}, GMG levels "
          f"{len(solver.gmg.levels)}, setup {setup_s:.3f} s", flush=True)
    return solver, f, exact


def solve_bench(torch, solver, f, exact, gs, timer, card):
    """Phase 4: the bench problem through the port's main path."""
    dof = solver.fine_level.pl.num_cells
    gs.reset_launches()
    times = []
    for rep_i in range(4):  # one warm-up, three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = solver.solve_refined(f, tol=1e-10, inner_tol=1e-4)
        torch.cuda.synchronize()
        if rep_i:
            times.append(time.perf_counter() - t0)
    launches = dict(gs.launches)
    rep = solver.report(u, f, exact)
    best = min(times)
    print(f"bench solve [{card}]: outer {info['outer_iterations']} inner "
          f"{info['inner_iterations']} residual {rep['residual']:.3e} error "
          f"{rep['error']:.6e} best {best:.6f} s of {[round(t, 6) for t in times]}"
          f" -> {dof / best:.1f} DOF/s; kernel launches in the 4 solves "
          f"{launches}", flush=True)
    assert tuple(u.shape) == (solver.fine_level.P, 64, 64)
    assert bool(torch.isfinite(u).all())
    assert rep["residual"] <= 1e-10, rep
    assert info["outer_iterations"] == 3, info
    assert 6 <= info["inner_iterations"] <= 8, info
    assert abs(rep["error"] - BENCH_ERROR) <= 0.01 * BENCH_ERROR, rep
    for name, cnt in launches.items():
        assert cnt > 0, f"the solve launched no {name} ghost_stencil kernel"

    # whole composite applies (gf gathers + kernel) at the bench size:
    # device time and host-paced time
    low = solver._fine_low
    u32 = u.to(torch.float32)
    for name, lvl, x in (("f32", low, u32), ("f64", solver.fine_level, u)):
        dev_ms = timer.cuda_median_ms(lambda: lvl.apply(x), reps=50, hold=True)
        host_ms = timer.cuda_median_ms(lambda: lvl.apply(x), reps=50)
        print(f"apply {name} [{card}]: device {dev_ms:.5f} ms, host-paced "
              f"{host_ms:.5f} ms", flush=True)

    # cost of the per-iteration host read of BiCGStab's stop test: the
    # same 7 inner iterations with and without a scalar read after each
    from pressurepoissonsolver_torch import krylov

    r32 = f.to(torch.float32)
    walls = {}
    for mode in ("read", "noread") * 4:
        st, r0 = krylov.bicgstab_init(low.apply, r32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(7):
            st = krylov.bicgstab_step(low.apply, solver.gmg.apply, st)
            if mode == "read":
                bool((krylov._norm(st.r) / r0 > 1e-4).item())
        torch.cuda.synchronize()
        walls.setdefault(mode, []).append(time.perf_counter() - t0)
    rd, nr = statistics.median(walls["read"]), statistics.median(walls["noread"])
    print(f"bicgstab 7 iterations [{card}]: median of 4 with a read per "
          f"iteration {rd:.6f} s {[round(w, 6) for w in walls['read']]}, "
          f"without {nr:.6f} s {[round(w, 6) for w in walls['noread']]}",
          flush=True)

    profile_solve(torch, solver, f, card)
    return launches


def profile_solve(torch, solver, f, card) -> None:
    """Device busy share and kernel-time breakdown of one bench solve
    (torch.profiler; diagnostic only — reported as not measured if the
    profiler gives no device time)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve_refined(f, tol=1e-10, inner_tol=1e-4)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = []
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                kern.append((float(us), int(e.count), e.key))
    except Exception as exc:  # diagnostic phase: the solve itself is checked above
        print(f"profile [{card}]: not measured ({type(exc).__name__}: {exc})", flush=True)
        return
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        print(f"profile [{card}]: not measured (no device time reported)", flush=True)
        return
    print(f"profile [{card}]: one solve (profiled) wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% "
          f"({100 - 100 * busy / wall_us:.1f}% idle), "
          f"{sum(k[1] for k in kern)} kernel launches", flush=True)
    for us, cnt, key in sorted(kern, reverse=True)[:12]:
        print(f"  {us / 1e3:9.3f} ms {cnt:6d}x  {key[:100]}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    from pressurepoissonsolver_torch import cuda_build
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.geometry import refined_tree
    from pressurepoissonsolver_torch.gmg import CycleOpts
    from pressurepoissonsolver_torch.ops import ghost_stencil as gs
    from pressurepoissonsolver_torch.problems import get_problem, init_problem
    from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
    from pressurepoissonsolver_torch.utils import timer

    port = types.SimpleNamespace(
        DomainHierarchy=DomainHierarchy, refined_tree=refined_tree,
        CycleOpts=CycleOpts, get_problem=get_problem, init_problem=init_problem,
        PoissonSolver=PoissonSolver, SolveOptions=SolveOptions)

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    # phase 2
    t0 = time.perf_counter()
    gs.build()
    info = cuda_build.build_info["ghost_stencil"]
    print(f"built ghost_stencil in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info['seconds']:.2f} s)", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # phases 3 and 4 (the kernels are checked at the bench solver's shapes)
    solver, f, exact = setup_bench(torch, port, card)
    table = check_kernels(torch, gs, timer, card, stencil_shapes(solver))
    solve_small(torch, port)
    launches = solve_bench(torch, solver, f, exact, gs, timer, card)

    # phase 5
    kernels = [
        {
            "name": f"ghost_stencil_2d_{name}",
            "route": "cuda",
            "source": "pressurepoissonsolver_torch/csrc/ghost_stencil.cu",
            "replaces": "pressurepoissonsolver_tpu/ops/pallas_stencil.py:87",
            "launches": launches[name],
            **table[name],
        }
        for name in ("float32", "float64")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

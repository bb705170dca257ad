#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``pressurepoissonsolver_torch``) on one
CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, any failure of which raises and exits non-zero:

1. require CUDA; turn TF32 off for matmuls and convolutions; print the
   card's name and power limit and the CUDA driver's version;
2. build the CUDA kernels from ``pressurepoissonsolver_torch/csrc``, one
   ``nvcc`` per source (the 2D and 3D stencils, the split stencil's face
   term and the WHILE nodes' guard), all started together;
3. 2D: hold the 2D kernel against its plain PyTorch version on the card,
   at the main path's shapes, at odd shapes and with ``u`` at an element
   offset (the one-element-per-thread path), and time both with CUDA
   events, cold (inputs rotated so that each call reads them from device
   memory) and warm (the same inputs every call); drive the 2D
   main path: the adaptive composite-grid solve of ``bench.py``
   (``refined_tree(2, 5, 2)`` refined once, n=64, 4,292,608 DOF, ``trig``
   problem) with ``PoissonSolver.solve_refined`` — f64 iterative
   refinement around f32 BiCGStab preconditioned by a V(2,1) FAC cycle
   with active-set smoothing — to a relative residual of 1e-10; check the
   result against the JAX reference's numbers and check that the solve
   went through the 2D kernel; then the Schur-complement path of
   ``bench.py``: the identity ``apply_with_interface(patch_solve(f, g), g)
   = f`` through the kernel at the bench level, every Schur preconditioner,
   GMRES, the Schwarz preconditioner and the per-patch BiCGStab on a small
   mesh against the reference's iteration counts, the probed Schur matrix
   at the bench size (timed), and the bench Schur solve
   (``solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")``) held
   to the reference and to the composite solve's solution, then profiled;
   the block-Jacobi sweep kernel (``csrc/patch_sweep.cu``) against its
   plain version at the benchmark's level shapes (``SWEEP_SHAPES``),
   timed cold and warm against its bound (``sweep_kernels``); the grid
   transfers' kernel (``csrc/transfer.cu``) against the plain chain on the
   benchmark cells' hierarchies (``TRANSFER_SHAPES``), timed cold and warm
   against its byte bound, and the plain chain at the 2D cell's last
   transfer profiled kernel by kernel (``transfer_kernels``); a main-path
   solve at n=16 whose every sweep and transfer takes its kernel;
4. 3D: the same for the 3D kernel and the 3D FAC solve of
   ``scripts/bench3d.py`` with its defaults, on a generated mesh
   (``refined_tree(3, 3, 2)`` refined once, n=32, 624 patches, 20,447,232
   DOF, V(1,1) with full FAC smoothing, ``trig`` problem); then a profile
   of one 3D solve; every launch of the bench solves must take the
   kernels' vector path, by the launcher's own rule; a small 3D Schur
   solve; then time both kernels at realistic patch sizes off the vector
   path (``WIDTH1_SHAPES``);
5. the command-line apps (``cli.main``, in-process): the 2D bench mesh and
   the 3D bench mesh written with ``Tree.to_file``, every run of
   ``CLI_BENCH_2D`` (the CLI default, the IR variants: inner CG,
   Richardson, the W-cycle, linear prolongation, the quadratic closures;
   weighted CG; the Schur path) and the 3D bench through ``steady3d``, each
   held to the JAX reference's CLI, with its linear-solve wall and its
   stencil launches (each on the vector path); profiles of three of them;
   then small runs (``CLI_SMALL``: the monitored solves, the assembled and
   pointer-block operators, every Schur preconditioner, Neumann walls,
   per-patch BiCGStab, the output files and a config round trip);
6. the port's measurement scripts, each driven with the launch counts set
   to 0 just before it: ``bench.main()`` at its defaults (the 2D bench
   configuration of phase 3, its Schur solve and the apply times), held to
   the reference's keys, counts and errors; ``scripts/bench3d.main()`` on
   the 3D bench mesh written with ``Tree.to_file``; the op report
   (``scripts/profile_ops.main()`` at divide 1, n=64, whose f32
   ``stencil_only`` row must agree with phase 3's warm kernel time within
   1.5x, then ``utils.profiling.op_report``); the native table generator
   held equal to the Python builders on both bench meshes, with both
   builders' seconds and the bench's set-up seconds with each;
7. the patch-sharded solve (``DomainHierarchy(num_shards=k)``,
   ``PoissonSolver(mesh=make_mesh(k))``, with both engines: the cut-face
   halo engine of ``parallel.halo`` and the gathered engine of
   ``parallel.gathered``, ``comm="pjit"``), each part driven with the
   launch counts set to 0 just before it: (a) a world of one rank under
   NCCL in this process, the 2D bench through ``solve_refined`` and
   ``solve_schur(gmg)`` with each engine (phase 3's counts and errors, and
   its solutions within 1e-8 of max|u|; each engine's card MiB after
   setup) and the 3D bench (halo); (b) the kernels' no-gf mode, which the
   halo apply runs while its exchange is in flight, and the face-term
   kernel it adds after, each against its plain version at the bench
   shapes, timed against its bound, and the fused launch timed against
   the split one (no-gf launch and face term); (c) a world of four ranks
   spawned on the one card under gloo (NCCL refuses two ranks on one GPU;
   the exchanges are staged through pinned host buffers), rendezvousing
   through a ``FileStore``: the 2D bench with each engine and a small 3D
   mesh (halo) on every rank, held to the same counts and errors, rank 0's
   gathered fields to phase 3's, aligned by patch id, the padded patches
   exactly 0, ``0 < comm_rows <= cut faces``, the halo engine's no-gf
   and face-term launches counted (one of each per split apply); the
   production configuration ``examples/ir_sharded_2d.ini`` through
   ``cli.main`` with ``--shards 4`` (its cycle on the Kronecker forms on
   every rank), held to the JAX CLI's counts and error; one halo
   apply profiled on rank 0: its base kernel must be launched while the
   exchange is outstanding (after every offset is posted, before the
   first wait); the kernel's device interval against the exchange's
   in-flight window and the first wait against a settled exchange's are
   printed; a correctness run, not a scaling one; (d) ``cli.main`` with
   ``--shards 1`` against phase 5's ``--solver ir`` run; every stencil
   launch on the vector path; (e) ``scripts.multihost --device cuda`` (2
   "hosts" x 4 ranks, every rank on the one card under gloo), both engines
   matching the single-process solve; (f) the no-gf mode and the
   face-term kernel against their plain versions, and the split launch
   against the fused one, at every per-rank shape that (c) and (e) gave
   them (2D n=64 and n=8, 3D n=8), in f32 and f64;
8. the f32 Kronecker forms of the spectral patch solve and the grid
   transfers (``PPS_KRON_MAX_N``, default 16, read when the tables are
   built): (a) through ``cli.main`` (counts set to 0 just before, read just
   after), the production configuration ``examples/ir_sharded_2d.ini``
   (n=16, 262,144 DOF) and the same with ``--divide 2`` (4,194,304 DOF),
   each on one device and with ``--shards 1``, and the 3D CLI at its
   default n=16 (2,097,152 DOF), each with the knob at its default and at
   0, held to the JAX CLI's counts and error for that setting; then both
   settings set up again, to assert that the cycle took the Kronecker
   forms everywhere (default) or nowhere (0), their solves timed in turns
   and one of each profiled (walls, launches per solve, stencil
   launches); (b) the spectral patch solve,
   ``restrict`` and ``prolong_add`` on both forms at n = 8, 16, 32 (about
   4M DOF in 2D, 2M in 3D), held to each other, with device ms cold and
   warm and bounds;
9. (a) the solve loops from captured CUDA graphs: single-device solves
   run their loops as one graph launch by default (so do phases 3-8);
   five solves (the 2D bench IR and Schur solves, the 3D bench IR solve,
   the CLI's default solve on the 2D bench mesh, the production
   configuration) are run captured (the per-step replay: a host read
   of the guard between replays) and eager in turns (``solver._graphs``), every one with the
   launch counts set to 0 just
   before it and read just after: the counts, the iterates (bit for bit)
   and the stencil launch counts must agree; the median walls, the
   capture seconds, the card MiB after capture and one profiled solve per
   mode (host launch calls, kernels run, idle share; no trace may hold
   more stencil kernels than counted, and the captured step's graph must
   hold as many stencil kernel nodes as the accounting adds per step),
   and for the two CLI cells the first solve of a fresh set-up per mode;
   the cost of a host read per step against a WHILE pass (7 steps of the
   bench IR's inner loop);
10. (a) the solves as one graph launch with WHILE nodes
   (``csrc/graph_loop.cu``, ``utils.graphs.GraphLoop``): the five cells of
   9 (a) on the same set-ups, and two GMRES cells at full width (the bench
   Schur solve with ``krylov="gmres"`` and ``apps.steady2d --solver gmres``
   on the 2D bench mesh, held to the JAX package's counts and errors),
   each in three modes (one graph launch, the per-step replay, eager), a
   first solve and ``LOOP_TURNS`` solves each in turns, every one with the
   launch counts set to 0 just before it and read just after: bit-equal
   iterates, equal counts and stencil launches, one graph launch and one
   host read (``krylov.reads``) per one-launch solve, none inside an IR
   ``solve_refined(sync=False)``, and the stencil kernel nodes of each
   WHILE body (read back through the driver API) equal to the launches the
   accounting adds per pass; median walls, capture and build seconds, card
   MiB after the build, graph nodes per Arnoldi step, and one profiled
   one-launch solve per cell (busy and idle share, kernels, the stencils
   its trace names, reported: the trace misnames some kernels that run
   inside WHILE bodies); then the cells of the loops inside pieces and of
   the monitored and assembled-matrix solves (``SMALL_BCGS``: bcgs
   ``solve``, ``solve_refined`` and ``solve_schur`` on the small Schur
   mesh; ``cli-small-crs``; at full width ``FULL_CELLS``: cli-2d-bcgs,
   cli-2d-monitor, cli-2d-monitor-cg, cli-2d-schur-pbm), held the same way
   and to their references, with the patch passes per solve (equal in the
   three modes), the largest patch loop, and each patch loop's pass graph
   holding its accounted stencil nodes; (b) the guard kernel
   against its plain version (a host read per pass), timed per pass;
11. print the kernel table (its launches include phases 7-10; each
   stencil entry also has the no-gf mode's times, bound and launches; the
   face-term kernel has entries of its own, with the sector bound beside
   the element bound; the guard kernel's launches are its runs in phase
   10), the card line, and last the result line ``{"ok": true,
   "device": {...}}``.
"""

import contextlib
import io
import json
import os
import re
import statistics
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# the JAX reference on the 2D configuration (pressurepoissonsolver_tpu,
# CPU): 3 outer / 7 inner iterations, relative error 8.931e-7; and on the
# small 2D test mesh (refined_tree(2, 4, 2), n=8, coarse_direct_max_dof=64):
# 3 outer / 7 inner, relative error 9.151817836e-4
BENCH_ERROR = 8.931e-7
SMALL_ERROR = 9.151817836e-4
# the JAX reference on the 3D configuration (CPU): 2 outer / 7 inner,
# relative error 8.968628605e-6; and on the small 3D mesh (the same tree
# without the refinement, n=8, 78 patches): 2 / 7, error 5.739378412e-4
BENCH3D_ERROR = 8.968628605e-6
SMALL3D_ERROR = 5.739378412e-4
# the JAX reference (CPU, jax_enable_x64) on the Schur path of the 2D bench
# configuration, solve_schur(f, tol=1e-10, max_iter=60,
# preconditioner="gmg") with the phase-3 options: 5 iterations, residual
# 2.826e-13, relative error 8.931338e-07, and a largest difference from
# the solve_refined solution of 8.27e-11 of max|u|
SCHUR_BENCH_ITERS = 5
SCHUR_BENCH_ERROR = 8.931338e-7
# the small Schur mesh: refined_tree(2, 3, 1), n=8 (19 patches), trig,
# tol 1e-10, f64 solves with the f32 V(2,1) FAC cycle of SCHUR_SMALL_GMG;
# the JAX reference's iterations per run (solve_schur per preconditioner
# and Krylov method; solve with Schwarz, and with "bcgs" patch solves and
# an f64 cycle) and the error every run reaches.
# tests/test_torch_krylov.py holds these to the reference.
SCHUR_SMALL_GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                       coarse_direct_max_dof=64)
SCHUR_SMALL_ITERS = {"none": 35, "cheb": 4, "blockjacobi": 28, "gmg": 5,
                     "gmres-none": 57, "gmres-gmg": 12, "schwarz": 35, "bcgs": 6}
SCHUR_SMALL_ERROR = 3.5642034506e-3
# how far a run's count may move from the reference's: one with an f32
# V-cycle; three for BiCGStab with no or a one-sweep preconditioner, whose
# count moves with rounding (perturbing f by 1e-14 of itself moves the
# port's count of those two runs over 32-35 on the CPU)
SCHUR_SMALL_BAND = {"gmg": 1, "gmres-gmg": 1, "none": 3, "schwarz": 3}
# the small 3D Schur solve: refined_tree(3, 3, 2), n=8, "gmg", the small
# 3D solve's options: the JAX reference takes 6 iterations to the error
# of the composite solve (5.739378371e-4)
SCHUR3D_SMALL_ITERS = 6
SCHUR3D_SMALL_ERROR = 5.739378371e-4

# the keys the JAX reference's bench.py (IR, Schur on) and
# scripts/bench3d.py print; the port's bench prints each of them.  Its
# default run is the bench configuration of phase 3 (BENCH_ERROR).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "dof", "solve_s",
              "outer_iterations", "inner_iterations", "residual", "error",
              "stencil_nnz_per_s", "apply_timing", "apply_f64_ms",
              "apply_f64_roofline_pct", "apply_f32_ms", "apply_f32_roofline_pct",
              "schur_complete_solve_s", "schur_dof_per_s", "schur_iterations",
              "schur_residual", "setup_s", "compile_s", "dtype", "device")
BENCH3D_KEYS = ("metric", "value", "unit", "dof", "dof_per_s", "outer_iterations",
                "inner_iterations", "residual", "error", "mode", "device")

# the command-line apps at full width: the JAX reference's CLI
# (pressurepoissonsolver_tpu.cli on the CPU, jax_enable_x64) on the 2D bench
# mesh (refined_tree(2, 5, 2) refined once) written with Tree.to_file, argv
# "--mesh <file> -n 64 -t 1e-10" plus each run's flags: its iterations
# ((iterations,) or (outer, inner)) and relative error.  CLI_IR with
# "--inner-solver bicgstab" is the bench configuration above (3 / 7, error
# 8.931193e-07, to the digit); the other CLI_IR runs change one option.
CLI_IR = ["--solver", "ir", "--inner-solver", "bicgstab", "--gmg-pre-sweeps", "2",
          "--gmg-fac-smoothing", "active", "--inner-tol", "1e-4"]
CLI_BENCH_2D = {
    "default": ([], (5,), 8.931020e-07),
    "ir": (["--solver", "ir"], (2, 10), 8.931244e-07),
    "ir-bicgstab": (CLI_IR, (3, 7), 8.931193e-07),
    "ir-cg": (CLI_IR + ["--inner-solver", "cg"], (3, 12), 8.931192e-07),
    "ir-richardson": (CLI_IR + ["--inner-solver", "richardson"], (3, 16), 8.931193e-07),
    "ir-w": (CLI_IR + ["--gmg-cycle-type", "W"], (3, 38), 8.931218e-07),
    "ir-linear": (CLI_IR + ["--gmg-interpolator", "linear"], (2, 4), 8.931174e-07),
    "ir-quadratic": (CLI_IR + ["--iface-interp", "quadratic"], (6, 12), 8.920172e-07),
    "cg-mixed": (["--solver", "cg", "--dtype", "mixed"], (9,), 8.931166e-07),
    "schur-gmg": (["--schur", "--prec", "GMG"], (5,), 8.931391e-07),
}
# the runs with all-f64 vectors, held to the reference's count exactly; the
# others (an f32 cycle inside) to their outer rounds exactly and to their
# inner (or CG) iterations within one
CLI_F64_RUNS = ("default", "schur-gmg")
# weighted CG stops on the volume-weighted norm, so the plain relative
# residual the CLI reports may exceed -t (the reference's: 3.241e-10)
CLI_RESIDUAL_LIMIT = {"cg-mixed": 1e-9}
# the 3D bench (scripts/bench3d.py's configuration) through steady3d:
# "--mesh <3D bench mesh> -n 32 -t 1e-10 --solver ir --inner-solver bicgstab"
CLI_BENCH_3D = (["--solver", "ir", "--inner-solver", "bicgstab"], (2, 7), BENCH3D_ERROR)
# profiled at full width (the W-cycle run is not: about 2e6 launches)
CLI_PROFILED = ("default", "cg-mixed", "ir-quadratic")
# small CLI runs on the small Schur mesh (refined_tree(2, 3, 1), n=8) with
# "-t 1e-10 --gmg-coarse-direct-dof 64": the JAX reference's CLI on the CPU
# (iterations and relative error); each run is held within one iteration
# and to 1e-6 of the error
CLI_SMALL = {
    "monitor-bicgstab": (["--monitor"], (6,), 3.5642034555e-3),
    "monitor-cg": (["--solver", "cg", "--monitor"], (11,), 3.5642034501e-3),
    "monitor-gmres": (["--solver", "gmres", "--monitor"], (11,), 3.5642034524e-3),
    "monitor-ir": (["--solver", "ir", "--monitor"], (2, 12), 3.5642034496e-3),
    "crs": (["--matrix-type", "crs"], (6,), 3.5642034555e-3),
    "schur-crs": (["--schur", "--matrix-type", "crs"], (5,), 3.5642034483e-3),
    "schur-pbm": (["--schur", "--matrix-type", "pbm"], (5,), 3.5642034483e-3),
    "schur-cheb": (["--schur", "--prec", "cheb"], (4,), 3.5642034506e-3),
    "schur-blockjacobi": (["--schur", "--prec", "BlockJacobi"], (28,), 3.5642034218e-3),
    "neumann": (["--neumann"], (7,), 2.9782726796e-3),
    "neumann-sides": (["--neumann-sides", "x_lo,y_hi"], (6,), 3.3503959269e-3),
    "bcgs": (["--patch_solver", "bcgs"], (6,), 3.5642034555e-3),
}

# phase 8, the f32 Kronecker forms of the spectral patch solve and the grid
# transfers (PPS_KRON_MAX_N, default 16): the production configuration
# examples/ir_sharded_2d.ini (n=16, --uniform 6: 1,024 patches, 262,144 DOF;
# f32 IR with BiCGStab; --comm halo), the same with "--divide 2" (16,384
# patches, 4,194,304 DOF), and the 3D CLI at its default n=16 (512 patches,
# 2,097,152 DOF): per knob setting ("default": unset; "0": the forms off),
# the JAX reference's CLI on the CPU (jax_enable_x64) with the same argv and
# "--shards 0" (the ini sets 8): (outer, inner) and relative error
PRODUCTION_INI = os.path.join(ROOT, "examples", "ir_sharded_2d.ini")
CLI_KRON = {
    "production": (2, ["--config", PRODUCTION_INI], {
        "default": ((2, 7), 1.4278066468455637e-05),
        "0": ((2, 7), 1.4278066669890718e-05)}),
    "production-divide2": (2, ["--config", PRODUCTION_INI, "--divide", "2"], {
        "default": ((2, 7), 8.923628515902486e-07),
        "0": ((2, 7), 8.923624640511542e-07)}),
    "3d-n16": (3, ["--uniform", "4", "-n", "16", "--solver", "ir", "--inner-solver",
                   "bicgstab", "-t", "1e-10"], {
        "default": ((2, 7), 4.747903762859404e-05),
        "0": ((2, 7), 4.747903717611914e-05)}),
}
# the knob's value per setting (None: unset)
KRON_KNOBS = {"default": None, "0": "0"}
# the engines of each run: one device ("--shards 0" overrides the ini's 8)
# and, in 2D, a one-rank NCCL group ("--shards 1")
KRON_ENGINES = {2: {"single": ["--shards", "0"], "shards1": ["--shards", "1"]},
                3: {"single": []}}
# op times, Kronecker against per-axis form: per dimension, n -> the levels
# of the uniform tree of about 4M DOF in 2D (4,194,304) and 2M in 3D
# (2,097,152; the next 3D tree holds 16.8M)
KRON_OP_TREES = {2: {8: 9, 16: 8, 32: 7}, 3: {8: 5, 16: 4, 32: 3}}

# H100 SXM: peak rates outside the tensor cores (NVIDIA's data sheet: 67
# TFLOP/s float32, 34 TFLOP/s float64); the memory rate per card is
# utils.profiling.HBM_BYTES_PER_S
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# the Pallas kernel each CUDA kernel replaces, per dimension
REPLACES = {2: "pressurepoissonsolver_tpu/ops/pallas_stencil.py:87",
            3: "pressurepoissonsolver_tpu/ops/pallas_stencil.py:231"}
SOURCES = {2: "pressurepoissonsolver_torch/csrc/ghost_stencil.cu",
           3: "pressurepoissonsolver_torch/csrc/ghost_stencil_3d.cu"}
# the face term of the halo apply's split stencil: a kernel of the port with
# no Pallas counterpart; in the JAX halo engine it is XLA code (the face-pad
# sum of ShardedLevel._stencil_local)
FACES_SOURCE = "pressurepoissonsolver_torch/csrc/ghost_faces.cu"
FACES_REPLACES = "pressurepoissonsolver_tpu/parallel/halo.py:626"
# the guard kernel of the WHILE nodes: a kernel of the port with no Pallas
# counterpart; it stands for the condition of the reference's lax.while_loop
GUARD_SOURCE = "pressurepoissonsolver_torch/csrc/graph_loop.cu"
GUARD_REPLACES = "pressurepoissonsolver_tpu/krylov.py:213"
# the block-Jacobi sweep kernel: a kernel of the port with no Pallas
# counterpart; it stands for the reference's sweep as XLA ops
SWEEP_SOURCE = "pressurepoissonsolver_torch/csrc/patch_sweep.cu"
SWEEP_REPLACES = "pressurepoissonsolver_tpu/ops/level_ops.py::_spectral_apply"
# the grid transfers' kernel: a kernel of the port with no Pallas
# counterpart; it stands for the reference's transfers as XLA ops
TRANSFER_SOURCE = "pressurepoissonsolver_torch/csrc/transfer.cu"
TRANSFER_REPLACES = "pressurepoissonsolver_tpu/gmg.py::Transfer"
# patch shapes (P, n) off the main path, checked against the plain version;
# n=6 in f32 and n=1 take the kernels' one-element-per-thread path
ODD_SHAPES = {2: [(37, 12), (37, 6), (3, 1)], 3: [(37, 6), (3, 1)]}
# patch shapes off the vector path, checked and timed: n a multiple of 2 but
# not 4 (one element per thread in f32, a vector in f64) and odd n (one
# element per thread in both types), at the bench's patch counts and at a
# small one
WIDTH1_SHAPES = {2: [(1048, 62), (1048, 63), (37, 7)], 3: [(624, 30), (624, 31), (37, 7)]}


def stencil_shapes(solver):
    """The ``(P, n)`` shapes the bench solve gives the ghost stencil: the
    f32 composite apply on every GMG level above the coarse solve and the
    active-set residual applies; the f64 apply on the finest level."""
    gmg = solver.gmg
    n = solver.fine_level.n
    f32 = {(lvl.P, n) for lvl in gmg.levels[:-1]}
    f32 |= {(a.Pa, n) for a in gmg._aapply if a is not None}
    return {"float32": sorted(f32, reverse=True), "float64": [(solver.fine_level.P, n)]}


def kernel_bound(D, args, out, bw):
    """(ms, "bytes" | "operations"): the least time the card could take for
    one call, from the bytes it must move (each input read once, the output
    written once) at ``bw`` bytes/s and the flops it does (5D - 1 per cell,
    3 more per ghost)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, out))
    P, n = args[0].shape[0], args[0].shape[1]
    flops = P * (n**D * (5 * D - 1) + 2 * D * n ** (D - 1) * 3)
    name = str(out.dtype).replace("torch.", "")
    t_bytes = nbytes / bw
    t_ops = flops / PEAK_FLOPS[name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, gs, timer, card, bw, D, shapes):
    """The ``D``-dimensional ghost stencil against its plain version at
    every shape of the main path and at an odd one, in f32 and f64; device
    and host-paced times at the finest shape and the odd one.  At the finest
    shape the device times are also taken cold: the calls rotate over copies
    of the inputs that together exceed the L2 four times, so each call reads
    from device memory, as the bound assumes."""
    kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
    plain = gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain
    rng = np.random.default_rng(SEED)
    table = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = str(dtype).replace("torch.", "")
        main = shapes[name]
        for P, n in main + ODD_SHAPES[D] + WIDTH1_SHAPES[D]:
            timed = (P, n) in (main[0], ODD_SHAPES[D][0])
            args = stencil_args(torch, rng, D, P, n, dtype)
            out_k = kernel(*args)
            width = gs.last_width[D]
            out_p = plain(*args)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            line = (f"kernel ghost_stencil_{D}d {name} P={P} n={n} width={width} "
                    f"[{card}]: max_abs_err={err:.3e} max|out|={scale:.3e} (limit "
                    f"{rtol:g}*max|out|)")
            if not err <= rtol * scale:
                raise AssertionError(line)
            if not timed:
                print(line, flush=True)
                continue
            # device time (stream held until all calls are queued) and the
            # host-paced time of back-to-back calls, kernel and plain, on the
            # same tensors (warm where they fit in the L2)
            t = {}
            for label, fn in (("kernel", lambda: kernel(*args)),
                              ("plain", lambda: plain(*args))):
                for hold in (True, False):
                    t[label, hold] = timer.cuda_median_ms(fn, reps=50, hold=hold)
            warm_ms, plain_warm_ms = t["kernel", True], t["plain", True]
            bound_ms, bound_by = kernel_bound(D, args, out_k, bw)
            nbytes = (2 * P * n**D + 2 * D * P * n ** (D - 1)) * out_k.element_size()
            msg = (f"{line}; device ms warm: kernel {warm_ms:.5f} "
                   f"({nbytes / (warm_ms * 1e-3) / 1e9:.0f} GB/s of u, gf and "
                   f"out) plain {plain_warm_ms:.5f}; bound {bound_ms:.5f} ms by "
                   f"{bound_by}; host-paced ms: kernel {t['kernel', False]:.5f} "
                   f"plain {t['plain', False]:.5f}")
            if (P, n) != main[0]:
                print(msg, flush=True)
                continue
            set_bytes = sum(a.numel() * a.element_size() for a in (*args, out_k))
            k = timer.cold_sets(set_bytes)
            sets = [args] + [[a.clone() for a in args] for _ in range(k - 1)]
            ms = timer.cold_median_ms(kernel, sets)
            plain_ms = timer.cold_median_ms(plain, sets)
            del sets
            shifted_ms = check_shifted(torch, gs, timer, kernel, args, out_p, rtol, scale)
            print(f"{msg}; device ms cold ({k} sets of {set_bytes / 1e6:.1f} MB): "
                  f"kernel {ms:.5f} ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
                  f"{100 * bound_ms / ms:.1f}% of the bound) plain {plain_ms:.5f}; "
                  f"u at a one-element offset (width 1): max_abs_err within the "
                  f"limit, device ms warm {shifted_ms:.5f}", flush=True)
            # no single PyTorch call computes the ghost-closure stencil
            table[name] = {"max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": None,
                           "vector_width": width}
    return table


# the transfer kernel: the benchmark cells' 2D mesh (benchmark/configs/
# poisson2d-amr*.json: 16 x 16 leaves, the leaves inside the corner squares
# of these sides refined once each, 2:1 balanced, then every leaf divided)
# at n=16; (label, divide, transfer) of its timed shapes: transfers 0-3 of
# the divide-4 cell (the first three mostly pass-through rows, the fourth
# all parents) and 0 and 6 of the divide-2 cell (6: 64 -> 16 patches, the
# last before the coarse solve)
CELL_CORNERS = (0.375, 0.1875, 0.0625)
TRANSFER_SHAPES = [("d4-T0", 4, 0), ("d4-T1", 4, 1), ("d4-T2", 4, 2), ("d4-T3", 4, 3),
                   ("2d-T0", 2, 0), ("2d-T6", 2, 6)]


def cell_tree(divide):
    """The benchmark cells' 2D mesh at ``divide``, built with the port's
    own geometry (``CELL_CORNERS``) and read back from a mesh file, as the
    benchmark hands it to the program (the file sets the tree's levels)."""
    from pressurepoissonsolver_torch import geometry

    t = geometry.uniform_tree(2, 5)
    for side in CELL_CORNERS:
        for nid in sorted(t.leaves()):
            node = t.nodes[nid]
            if not node.has_children() and np.all(node.starts + node.lengths <= side):
                geometry._refine_with_balance(t, nid)
    for _ in range(divide):
        t.refine_leaves()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.bin")
        t.to_file(path)
        return geometry.Tree.from_file(path, 2)


def level_stub(torch, pl, dtype, device):
    """What ``gmg.Transfer`` reads of a level, without building one."""
    return types.SimpleNamespace(pl=pl, P=pl.num_patches, D=pl.D, n=pl.n, dtype=dtype,
                                 device=torch.device(device))


def transfer_bytes(P_out, P_in, n, itemsize, prolong):
    """Bytes one transfer must move: restriction the fine field read and the
    coarse one written, with its ``[Pc, 5]`` table; prolong-add ``u`` read,
    the result written and the coarse field read, with its ``[Pf, 2]``
    table (``P_out`` the output's slots, ``P_in`` the other field's)."""
    cells = n * n * itemsize
    if prolong:
        return 2 * P_out * cells + P_in * cells + 8 * P_out
    return P_in * cells + P_out * cells + 20 * P_out


def profile_kernels(torch, fn, reps=3):
    """``fn()`` ``reps`` times under ``torch.profiler``: per kernel of the
    last call, in launch order, its name, device microseconds, grid and
    block, read from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    per = len(kernels) // reps if reps else 0
    return [{"name": e["name"], "us": e["dur"], "grid": e.get("args", {}).get("grid"),
             "block": e.get("args", {}).get("block")} for e in kernels[-per:]] if per else []


def transfer_kernels(torch, timer, card, bw, shapes=TRANSFER_SHAPES) -> dict:
    """The transfer kernel against the plain chain (``Transfer.restrict_plain``
    / ``prolong_add_plain``) on the transfers of ``shapes``, f32, both
    directions, constant prolongation (the cells' cycle): the restriction
    within 1e-6 of max|out|, the prolong-add bit for bit; device ms cold
    (inputs rotated over copies exceeding 4x the L2) and warm, kernel and
    plain, against the byte bound (``transfer_bytes`` at ``bw``); then the
    f64 and linear instances checked at the 2D shapes, and the plain chain
    at the 2D cell's last transfer profiled kernel by kernel (GEMM tiles,
    grids, split-K).  Runs alone::

        python3 -c "import torch, chip_smoke as c; from
        pressurepoissonsolver_torch.utils import profiling, timer;
        c.transfer_kernels(torch, timer, profiling.card_line(),
        profiling._device_bw('cuda'))"
    """
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.gmg import Transfer
    from pressurepoissonsolver_torch.ops import transfer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    hier = {d: DomainHierarchy(cell_tree(d), n=16) for d in sorted({d for _, d, _ in shapes})}
    print(f"transfer kernel: cell hierarchies {[[pl.num_patches for pl in h.levels] for h in hier.values()]} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    table = {}
    for label, divide, k in shapes:
        h = hier[divide]
        n = h.levels[k].n
        for dtype, modes in ((torch.float32, ("constant",)),
                             (torch.float64, ("constant", "linear")),
                             (torch.float32, ("linear",))):
            for mode in modes:
                timed = dtype == torch.float32 and mode == "constant"
                if not timed and divide == 4:
                    continue  # the other instances at the 2D shapes only
                fine, coarse = (level_stub(torch, h.levels[i], dtype, dev) for i in (k, k + 1))
                t = Transfer(fine, coarse, prolong_mode=mode)
                assert t._kt is not None, label

                def inputs():
                    return [torch.randn(fine.P, n, n, device=dev, dtype=dtype),
                            torch.randn(coarse.P, n, n, device=dev, dtype=dtype)]

                x, c = inputs()
                before = transfer.transfers()
                got_r, got_p = t.restrict(x), t.prolong_add(c, x)
                torch.cuda.synchronize()
                after = transfer.transfers()
                name = str(dtype).replace("torch.", "")
                assert after["kernel"][name] == before["kernel"][name] + 2, label
                assert after["plain"] == before["plain"], label
                ref_r, ref_p = t.restrict_plain(x), t.prolong_add_plain(c, x)
                err_r = float((got_r - ref_r).abs().max() / ref_r.abs().max())
                err_p = float((got_p - ref_p).abs().max() / ref_p.abs().max())
                line = (f"kernel transfer {label} {name} {mode} Pf={fine.P} Pc={coarse.P} n={n} "
                        f"[{card}]: restrict max|err|/max = {err_r:.3e}, prolong_add "
                        f"{err_p:.3e}")
                tol = 1e-6 if dtype == torch.float32 else 1e-14
                if not (err_r <= tol and (err_p == 0 if mode == "constant" else err_p <= tol)):
                    raise AssertionError(line)
                if not timed:
                    print(line, flush=True)
                    continue
                row = {"Pf": fine.P, "Pc": coarse.P, "n": n, "max_rel_err_restrict": err_r}
                for op, P_out, P_in, fn_k, fn_p in (
                        ("restrict", coarse.P, fine.P, lambda a, b: t.restrict(a),
                         lambda a, b: t.restrict_plain(a)),
                        ("prolong", fine.P, coarse.P, lambda a, b: t.prolong_add(b, a),
                         lambda a, b: t.prolong_add_plain(b, a))):
                    nbytes = transfer_bytes(P_out, P_in, n, 4, op == "prolong")
                    sets = [[x, c]] + [inputs() for _ in range(timer.cold_sets(nbytes) - 1)]
                    r = {"bytes": nbytes, "bound_ms": 1e3 * nbytes / bw}
                    for which, fn in (("kernel", fn_k), ("plain", fn_p)):
                        r[f"{which}_ms"] = timer.cold_median_ms(fn, sets)
                        r[f"{which}_warm_ms"] = timer.cuda_median_ms(lambda: fn(x, c), reps=50,
                                                                     hold=True)
                    row[op] = r
                    del sets
                    line += (f"; {op} device ms cold: kernel {r['kernel_ms']:.5f} "
                             f"({100 * r['bound_ms'] / r['kernel_ms']:.1f}% of the bound "
                             f"{r['bound_ms']:.5f}, {nbytes / 1e6:.1f} MB) plain "
                             f"{r['plain_ms']:.5f}; warm kernel {r['kernel_warm_ms']:.5f} "
                             f"plain {r['plain_warm_ms']:.5f}")
                print(line, flush=True)
                print("TRANSFER_JSON " + json.dumps({"label": label, "card": card, **row}),
                      flush=True)
                table[label] = row
                if label == "2d-T6":
                    for op, fn in (("restrict", lambda: t.restrict_plain(x)),
                                   ("prolong", lambda: t.prolong_add_plain(c, x))):
                        ks = profile_kernels(torch, fn)
                        print(f"plain {op} at {label} (Pf={fine.P}, Pc={coarse.P}), kernel by "
                              f"kernel: " + json.dumps(ks), flush=True)
                        row[f"plain_{op}_kernels"] = ks
                del x, c, got_r, got_p, ref_r, ref_p
    return table


# (label, level slots, active slots or None, n) of the sweep kernel's
# timed shapes: level 0 of the benchmark's 2D cells (divide 2 and 4) and
# level 2 of the divide-4 cell (its FAC active set, 16 x the divide-2
# level's 5,824 slots and 624 active); at f32, full Dirichlet-type slots
SWEEP_SHAPES = [("2d-L0", 8320, None, 16), ("d4-L0", 133120, None, 16),
                ("d4-L2-active", 93184, 9984, 16)]


def sweep_bytes(P, Pa, n, itemsize, gf=True):
    """Bytes one sweep must move: f of the solved slots, their gf, h2,
    code and rows of lam, the base of the other slots and the slot map
    (an active set), and u written once."""
    Pa = P if Pa is None else Pa
    cells = n * n
    per_solved = (cells + (4 * n if gf else 0) + 2) * itemsize + 3 * 4
    routed = 0 if Pa == P else (P - Pa) * cells * itemsize + 8 * P
    return Pa * per_solved + routed + P * cells * itemsize


def sweep_kernels(torch, timer, card, bw, shapes=SWEEP_SHAPES) -> dict:
    """The sweep kernel against its plain version (the fold, the spectral
    solves and the routing as PyTorch ops) at ``shapes``, f32, a full sweep
    with faces (``Level.smooth``) and, for an active set, from a base
    (``ActiveSmoother.smooth``): max |kernel - plain| within 1e-5 of
    max|u|, the untouched slots bit for bit the base; device ms cold (the
    inputs rotated over copies exceeding 4x the L2) and warm, kernel and
    plain, against the bound (``sweep_bytes`` at ``bw``, or 8n flops a
    solved cell at 67 TFLOP/s).  Runs alone::

        python3 -c "import torch, chip_smoke as c; from
        pressurepoissonsolver_torch.utils import profiling, timer;
        c.sweep_kernels(torch, timer, profiling.card_line(),
        profiling._device_bw('cuda'))"
    """
    import types

    from pressurepoissonsolver_torch.ops import patch_sweep
    from pressurepoissonsolver_torch.ops.level_ops import _build_solver_tables

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    table = {}
    for label, P, Pa, n in shapes:
        na = P if Pa is None else Pa
        act = np.sort(rng.choice(P, na, replace=False)) if Pa is not None else np.arange(P)
        pl = types.SimpleNamespace(D=2, n=n, neumann=np.zeros((P, 4), dtype=bool),
                                   spacings=np.full((P, 2), 1.0 / (16 * n)))
        st = _build_solver_tables(pl, torch.float32, act, dev)
        route = None
        if Pa is not None:
            inv = np.full(P, na, dtype=np.int64)
            inv[act] = np.arange(na)
            route = patch_sweep.Route(
                torch.as_tensor(act, device=dev), torch.as_tensor(inv, device=dev),
                torch.as_tensor(np.isin(np.arange(P), act).reshape(P, 1, 1), device=dev))

        def inputs():
            f = torch.randn(P, n, n, device=dev)
            gf = torch.randn(na, 4, n, device=dev)
            h2 = torch.full((na, 2), float((16 * n) ** 2), device=dev)
            return [st, f, gf, h2, route, None if Pa is None else torch.randn_like(f)]

        args = inputs()
        got = patch_sweep.sweep(*args)
        ref = patch_sweep.sweep_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        line = f"kernel patch_sweep {label} float32 P={P} active={na} n={n} [{card}]"
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{line}: max_abs_err={err:.3e} max|u|={scale:.3e}")
        if route is not None:
            keep = ~route.mask.reshape(-1)
            assert torch.equal(got[keep], args[5][keep]), line
        nbytes = sweep_bytes(P, Pa, n, 4)
        bound_ms = 1e3 * max(nbytes / bw, 8 * n * na * n * n / PEAK_FLOPS["float32"])
        k = timer.cold_sets(nbytes)
        sets = [args] + [inputs() for _ in range(k - 1)]
        row = {"max_abs_err": err, "bound_ms": bound_ms, "bytes": nbytes}
        for name, fn in (("kernel", patch_sweep.sweep), ("plain", patch_sweep.sweep_plain)):
            row[f"{name}_ms"] = timer.cold_median_ms(fn, sets)
            row[f"{name}_warm_ms"] = timer.cuda_median_ms(lambda: fn(*args), reps=50,
                                                          hold=True)
        del sets
        print(f"{line}: max_abs_err={err:.3e} max|u|={scale:.3e}; device ms cold "
              f"({k} sets of {nbytes / 1e6:.1f} MB): kernel {row['kernel_ms']:.5f} "
              f"({100 * bound_ms / row['kernel_ms']:.1f}% of the bound, "
              f"{nbytes / (row['kernel_ms'] * 1e-3) / 1e9:.0f} GB/s) plain "
              f"{row['plain_ms']:.5f}; warm: kernel {row['kernel_warm_ms']:.5f} plain "
              f"{row['plain_warm_ms']:.5f}; bound {bound_ms:.5f} ms", flush=True)
        print("SWEEP_JSON " + json.dumps({"label": label, "P": P, "active": na, "n": n,
                                          "card": card, **row}), flush=True)
        table[label] = row
        del args, got, ref
    return table


def sweep_solve(torch, port, gs) -> dict:
    """The sweep and transfer kernels' launches in a main-path solve:
    ``solve_refined`` (one graph launch) of a 2D adaptive mesh at the cells'
    n=16 with their cycle (f32 V(2,1), FAC active sets), every launch count
    set to 0 just before it and read just after; every sweep and every
    transfer takes its kernel.  ``{"sweeps": ..., "transfers": ...}``."""
    from pressurepoissonsolver_torch.ops import patch_sweep, transfer

    hier = port.DomainHierarchy(port.refined_tree(2, 4, 2), n=16)
    opts = port.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
        gmg=port.CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                             coarse_direct_max_dof=64))
    solver = port.PoissonSolver(hier, opts, device="cuda")
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", 2))
    reset_counters()
    u, info = solver.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    counts = {"sweeps": patch_sweep.sweeps(), "transfers": transfer.transfers()}
    rep = solver.report(u, f, exact)
    print(f"sweep solve (n=16, one graph launch): outer {info['outer_iterations']} inner "
          f"{info['inner_iterations']} residual {rep['residual']:.3e}; {counts}",
          flush=True)
    assert rep["residual"] <= 1e-10, rep
    for c in counts.values():
        assert c["kernel"]["float32"] > 0 and not any(c["plain"].values()), counts
    return counts


def stencil_args(torch, rng, D, P, n, dtype):
    """Random ``u, gf, coef, h2`` on the card for ``P`` patches of ``n``
    cells a side: coef in {-1, 0, 1}, h2 of cells 1/(4n) .. 1/(64n)."""
    u = rng.standard_normal((P,) + (n,) * D)
    gf = rng.standard_normal((P, 2 * D, n ** (D - 1)))
    coef = rng.choice([-1.0, 0.0, 1.0], size=(P, 2 * D))
    h = 1.0 / (n * 2.0 ** rng.integers(2, 7, size=(P, 1)))
    h2 = np.repeat(1.0 / h**2, D, axis=1)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (u, gf, coef, h2)]


def width1_ms(torch, gs, timer, card):
    """Warm device ms (held stream, median of 50) of each kernel at
    ``WIDTH1_SHAPES`` in f32 and f64, printed and returned as
    ``{"<D>d <dtype> P=<P> n=<n>": ms}``.  It calls only the wrappers
    ``gs.ghost_stencil`` / ``gs.ghost_stencil_3d`` and
    ``timer.cuda_median_ms``, so it times an older version of the package
    the same way when that package comes first on ``sys.path``::

        python3 -c "import sys; sys.path[:0] = ['OLD', '.']; import torch,
        chip_smoke as c; from pressurepoissonsolver_torch.ops import
        ghost_stencil as gs; from pressurepoissonsolver_torch.utils import
        timer; c.width1_ms(torch, gs, timer, 'old package')"
    """
    rng = np.random.default_rng(SEED + 1)
    times = {}
    for D in (2, 3):
        kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
        for dtype in (torch.float32, torch.float64):
            for P, n in WIDTH1_SHAPES[D]:
                args = stencil_args(torch, rng, D, P, n, dtype)
                key = f"{D}d {str(dtype)[6:]} P={P} n={n}"
                times[key] = timer.cuda_median_ms(lambda: kernel(*args), reps=50,
                                                  hold=True)
                print(f"kernel ghost_stencil_{key} [{card}]: device ms warm "
                      f"{times[key]:.5f}", flush=True)
                del args
    return times


def check_shifted(torch, gs, timer, kernel, args, ref, rtol, scale):
    """The kernel on a contiguous copy of ``u`` one element past a 16-byte
    boundary, which takes the one-element-per-thread path: checked against
    the plain version's output ``ref``; its warm device ms."""
    u = args[0]
    buf = torch.empty(u.numel() + 1, dtype=u.dtype, device=u.device)
    shifted = buf[1:].view(u.shape)
    shifted.copy_(u)
    sargs = [shifted, *args[1:]]
    out = kernel(*sargs)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if gs.last_width[u.dim() - 1] != 1 or not err <= rtol * scale:
        raise AssertionError(f"shifted u: width {gs.last_width[u.dim() - 1]}, "
                             f"max_abs_err {err:.3e}, max|out| {scale:.3e}")
    return timer.cuda_median_ms(lambda: kernel(*sargs), reps=50, hold=True)


def solve_small(torch, port):
    """A small 2D solve on the card, held to the reference's numbers."""
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


def solve_small_3d(torch, port):
    """A small 3D solve on the card with the 3D bench's options, held to
    the reference's numbers."""
    hier = port.DomainHierarchy(port.refined_tree(3, 3, 2), n=8)
    opts = port.SolveOptions(tol=1e-10, dtype=torch.float64,
                             precond_dtype=torch.float32)
    solver = port.PoissonSolver(hier, opts, device="cuda")
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", 3))
    u, info = solver.solve_refined(f, tol=1e-10)
    rep = solver.report(u, f, exact)
    print(f"small 3D solve (78 patches, n=8): outer {info['outer_iterations']} "
          f"inner {info['inner_iterations']} residual {rep['residual']:.3e} "
          f"error {rep['error']:.10e}", flush=True)
    assert tuple(u.shape) == (78, 8, 8, 8)
    assert info["outer_iterations"] == 2, info
    assert 6 <= info["inner_iterations"] <= 8, info
    assert rep["residual"] <= 1e-10, rep
    assert abs(rep["error"] - SMALL3D_ERROR) <= 1e-6 * SMALL3D_ERROR, rep


def setup_bench(torch, port, card, D, base, corner, n, gmg):
    """A bench problem's solver, right-hand side and exact solution: the
    tree ``refined_tree(D, base, corner)`` refined once, at patch size n."""
    t0 = time.perf_counter()
    tree = port.refined_tree(D, base, corner)
    tree.refine_leaves()
    hier = port.DomainHierarchy(tree, n=n)
    opts = port.SolveOptions(tol=1e-10, dtype=torch.float64,
                             precond_dtype=torch.float32, gmg=gmg)
    solver = port.PoissonSolver(hier, opts, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dof = hier.finest.num_cells
    f_np, exact_np = port.init_problem(hier.finest, port.get_problem("trig", D))
    f = torch.as_tensor(f_np, dtype=torch.float64, device="cuda")
    exact = torch.as_tensor(exact_np, dtype=torch.float64, device="cuda")
    label = "bench mesh" if D == 2 else "3D bench mesh"
    print(f"{label} [{card}]: {dof} DOF, patches per level "
          f"{[pl.num_patches for pl in hier.levels]}, GMG levels "
          f"{len(solver.gmg.levels)}, setup {setup_s:.3f} s", flush=True)
    return solver, f, exact, setup_s


def timed_solves(torch, solver, f, exact, card, label, gs, D, **kw):
    """One warm-up and three timed ``solve_refined`` calls, with every
    launch count set to 0 just before them; the last solution, its info
    and report, and the ``D``-dimensional kernel's launches per dtype and
    per width as read just after the solves."""
    reset_counters()
    times = []
    for rep_i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = solver.solve_refined(f, tol=1e-10, **kw)
        torch.cuda.synchronize()
        if rep_i:
            times.append(time.perf_counter() - t0)
    launches = dict(gs.launches if D == 2 else gs.launches_3d)
    widths = dict(gs.widths[D])
    rep = solver.report(u, f, exact)
    dof = solver.fine_level.pl.num_cells
    best = min(times)
    print(f"{label} [{card}]: outer {info['outer_iterations']} inner "
          f"{info['inner_iterations']} residual {rep['residual']:.3e} error "
          f"{rep['error']:.6e} best {best:.6f} s of {[round(t, 6) for t in times]}"
          f" -> {dof / best:.1f} DOF/s", flush=True)
    print(f"{label} kernel launches in the 4 solves: {launches}; per elements "
          f"per thread {widths}", flush=True)
    # every launch of the solves takes the vector path
    assert widths[1] == 0 and sum(widths.values()) == sum(launches.values()), widths
    return u, info, rep, launches


def time_applies(torch, solver, u, timer, card, label):
    """Whole composite applies (gf gathers + kernel) at the bench size:
    device time and host-paced time."""
    u32 = u.to(torch.float32)
    for name, lvl, x in (("f32", solver._fine_low, u32), ("f64", solver.fine_level, u)):
        dev_ms = timer.cuda_median_ms(lambda: lvl.apply(x), reps=50, hold=True)
        host_ms = timer.cuda_median_ms(lambda: lvl.apply(x), reps=50)
        print(f"{label} {name} [{card}]: device {dev_ms:.5f} ms, host-paced "
              f"{host_ms:.5f} ms", flush=True)


def solve_bench(torch, solver, f, exact, gs, timer, card):
    """The 2D bench problem through the port's main path."""
    u, info, rep, launches = timed_solves(torch, solver, f, exact, card,
                                          "bench solve", gs, 2, inner_tol=1e-4)
    assert tuple(u.shape) == (solver.fine_level.P, 64, 64)
    assert bool(torch.isfinite(u).all())
    assert rep["residual"] <= 1e-10, rep
    assert info["outer_iterations"] == 3, info
    assert 6 <= info["inner_iterations"] <= 8, info
    assert abs(rep["error"] - BENCH_ERROR) <= 0.01 * BENCH_ERROR, rep
    for name, cnt in launches.items():
        assert cnt > 0, f"the solve launched no {name} ghost_stencil kernel"
    assert not any(gs.launches_3d.values()), "the 2D solves launched a 3D kernel"

    time_applies(torch, solver, u, timer, card, "apply")

    # cost of the per-iteration host read of BiCGStab's stop test: the
    # same 7 inner iterations with and without a scalar read after each
    from pressurepoissonsolver_torch import krylov

    low = solver._fine_low
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

    profile_solve(torch, card, "profile",
                  lambda: solver.solve_refined(f, tol=1e-10, inner_tol=1e-4))
    return u, launches


def check_identity(torch, solver, gs, card):
    """``apply_with_interface(patch_solve(f, g), g) = f`` at the bench level
    in f64 (the solver's level) and f32 (the V-cycle's finest level), for
    seeded f and g, through the 2D kernel on its vector path.  The limit is
    relative to the folded right-hand side ``f - G g`` the solve sees (its
    ghost terms ``2 g / h^2`` dwarf f)."""
    rng = np.random.default_rng(SEED + 2)
    reset_counters()
    for lvl, rtol in ((solver.fine_level, 1e-12), (solver._fine_low, 1e-5)):
        f = torch.as_tensor(rng.standard_normal((lvl.P,) + lvl.pl.ns_shape),
                            dtype=lvl.dtype, device="cuda")
        g = torch.as_tensor(rng.standard_normal((lvl.num_ifaces, lvl.m)),
                            dtype=lvl.dtype, device="cuda")
        back = lvl.apply_with_interface(lvl.patch_solve(f, g), g)
        err = float((back - f).abs().max())
        scale = float(lvl.fold_gamma(f, g).abs().max())
        line = (f"identity apply_with_interface(patch_solve(f, g), g) = f "
                f"{str(lvl.dtype)[6:]} P={lvl.P} interfaces={lvl.num_ifaces} [{card}]: "
                f"max_abs_err={err:.3e} max|f - G g|={scale:.3e} (limit {rtol:g}*)")
        print(line, flush=True)
        assert err <= rtol * scale, line
    widths = dict(gs.widths[2])
    assert gs.launches == {"float32": 1, "float64": 1}, gs.launches
    assert widths[1] == 0 and not any(gs.launches_3d.values()), widths


# the small-mesh Schur runs: (key, solver options, preconditioner of
# solve_schur, or None for solve)
SCHUR_SMALL_RUNS = (
    ("none", {}, None), ("cheb", {}, "cheb"), ("blockjacobi", {}, "blockjacobi"),
    ("gmg", {}, "gmg"), ("gmres-none", {"krylov": "gmres"}, None),
    ("gmres-gmg", {"krylov": "gmres"}, "gmg"),
    ("schwarz", {"preconditioner": "schwarz"}, "solve"),
    ("bcgs", {"patch_solver": "bcgs", "precond_dtype": "float64"}, "solve"),
)


def schur_small(torch, port, gs, card):
    """Every Schur preconditioner and Krylov method, and ``solve`` with the
    Schwarz preconditioner and with per-patch BiCGStab solves, on the small
    Schur mesh, held to the reference's iteration counts and error."""
    hier = port.DomainHierarchy(port.refined_tree(2, 3, 1), n=8)
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", 2))
    for key, kw, prec in SCHUR_SMALL_RUNS:
        kw = dict(kw)
        pdtype = getattr(torch, kw.pop("precond_dtype", "float32"))
        solver = port.PoissonSolver(hier, port.SolveOptions(
            tol=1e-10, dtype=torch.float64, precond_dtype=pdtype,
            gmg=port.CycleOpts(**SCHUR_SMALL_GMG), **kw), device="cuda")
        reset_counters()
        if prec == "solve":
            res = solver.solve(f, max_iter=300)
            u = res.x
        else:
            u, res = solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
        torch.cuda.synchronize()
        launches, widths = dict(gs.launches), dict(gs.widths[2])
        rep = solver.report(u, f, exact)
        ref = SCHUR_SMALL_ITERS[key]
        band = SCHUR_SMALL_BAND.get(key, 0)
        line = (f"small Schur mesh (19 patches, n=8) {key} [{card}]: iterations "
                f"{res.iterations} (reference {ref}, within {band}) residual "
                f"{rep['residual']:.3e} error {rep['error']:.10e}; launches {launches}")
        print(line, flush=True)
        assert abs(res.iterations - ref) <= band, line
        assert abs(rep["error"] - SCHUR_SMALL_ERROR) <= 1e-6 * SCHUR_SMALL_ERROR, line
        assert widths[1] == 0, widths
        # the V-cycle, the composite apply and the per-patch BiCGStab go
        # through the kernel; the other Schur runs never apply the stencil
        if "gmg" in key:
            assert launches["float32"] > 0, line
        if key in ("schwarz", "bcgs"):
            assert launches["float64"] > 0, line


def solve_bench_schur(torch, solver, f, exact, u_ir, gs, card):
    """The Schur path of ``bench.py`` (``bench.py:171-191``) on the bench
    solver: one warm-up and two timed ``solve_schur(f, tol=1e-10,
    max_iter=60, preconditioner="gmg")``, held to the reference and to the
    composite solve's solution ``u_ir``; then the probed Schur matrix
    (timed) and a profile of one Schur solve."""
    from pressurepoissonsolver_torch import matrix

    reset_counters()
    times = []
    for rep_i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, res = solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
        torch.cuda.synchronize()
        if rep_i:
            times.append(time.perf_counter() - t0)
    launches, widths = dict(gs.launches), dict(gs.widths[2])
    rep = solver.report(u, f, exact)
    dof = solver.fine_level.pl.num_cells
    best = min(times)
    diff = float((u - u_ir).abs().max() / u_ir.abs().max())
    print(f"bench Schur solve [{card}]: {dof} DOF, {solver.fine_level.num_ifaces} "
          f"interfaces of m={solver.fine_level.m}: iterations {res.iterations} "
          f"residual {rep['residual']:.3e} error {rep['error']:.6e} "
          f"conservation {rep['conservation']:.3e} best {best:.6f} s of "
          f"{[round(t, 6) for t in times]} -> {dof / best:.1f} DOF/s; "
          f"max|u_schur - u_refined| / max|u_refined| = {diff:.3e}", flush=True)
    print(f"bench Schur solve kernel launches in the 3 solves: {launches}; per "
          f"elements per thread {widths}", flush=True)
    assert tuple(u.shape) == tuple(u_ir.shape) and bool(torch.isfinite(u).all())
    assert abs(res.iterations - SCHUR_BENCH_ITERS) <= 1, res.iterations
    assert rep["residual"] <= 1e-10, rep
    assert abs(rep["error"] - SCHUR_BENCH_ERROR) <= 0.01 * SCHUR_BENCH_ERROR, rep
    assert diff <= 1e-9, diff
    # the Woodbury preconditioner's f32 V-cycles go through the kernel
    assert launches["float32"] > 0 and widths[1] == 0, (launches, widths)
    assert not any(gs.launches_3d.values()), "the 2D Schur solve launched a 3D kernel"

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_S = matrix.assemble_schur(solver.fine_level)
    assemble_s = time.perf_counter() - t0
    print(f"assemble_schur at the bench size [{card}]: {A_S.shape[0]} rows, "
          f"{A_S.nnz} nonzeros, {assemble_s:.3f} s", flush=True)
    del A_S

    profile_solve(torch, card, "Schur profile",
                  lambda: solver.solve_schur(f, tol=1e-10, max_iter=60,
                                             preconditioner="gmg"))
    return u


def schur_small_3d(torch, port, gs, card):
    """A small 3D Schur solve with the 3D bench's options, held to the
    reference's numbers; its V-cycles go through the 3D kernel."""
    hier = port.DomainHierarchy(port.refined_tree(3, 3, 2), n=8)
    solver = port.PoissonSolver(hier, port.SolveOptions(
        tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32), device="cuda")
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", 3))
    reset_counters()
    u, res = solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
    torch.cuda.synchronize()
    launches, widths = dict(gs.launches_3d), dict(gs.widths[3])
    rep = solver.report(u, f, exact)
    line = (f"small 3D Schur solve (78 patches, n=8) [{card}]: iterations "
            f"{res.iterations} (reference {SCHUR3D_SMALL_ITERS}) residual "
            f"{rep['residual']:.3e} error {rep['error']:.10e}; launches {launches}")
    print(line, flush=True)
    assert tuple(u.shape) == (78, 8, 8, 8)
    assert abs(res.iterations - SCHUR3D_SMALL_ITERS) <= 1, line
    assert abs(rep["error"] - SCHUR3D_SMALL_ERROR) <= 1e-6 * SCHUR3D_SMALL_ERROR, line
    assert launches["float32"] > 0 and widths[1] == 0, (launches, widths)


def solve_bench_3d(torch, solver, f, exact, gs, timer, card):
    """The 3D bench problem (``scripts/bench3d.py``) through the port."""
    u, info, rep, launches = timed_solves(torch, solver, f, exact, card,
                                          "3D bench solve", gs, 3)
    n = solver.fine_level.n
    assert tuple(u.shape) == (solver.fine_level.P, n, n, n)
    assert bool(torch.isfinite(u).all())
    assert rep["residual"] <= 1e-10, rep
    assert info["outer_iterations"] == 2, info
    assert 6 <= info["inner_iterations"] <= 8, info
    assert abs(rep["error"] - BENCH3D_ERROR) <= 0.01 * BENCH3D_ERROR, rep
    for name, cnt in launches.items():
        assert cnt > 0, f"the 3D solve launched no {name} 3D ghost_stencil kernel"
    assert not any(gs.launches.values()), "the 3D solves launched a 2D kernel"

    time_applies(torch, solver, u, timer, card, "3D apply")
    # the refinement-boundary case-template matmul inside each finest apply
    for lvl in (solver._fine_low, solver.fine_level):
        pipe = lvl._gf_ref_pipe
        gm = torch.randn(pipe.idx_m.shape[0], lvl.m, dtype=lvl.dtype, device="cuda")
        ms = timer.cuda_median_ms(lambda: torch.matmul(gm, pipe.mm_W), reps=50, hold=True)
        print(f"3D case-template matmul {str(lvl.dtype)[6:]} "
              f"[{gm.shape[0]}, {lvl.m}] @ {list(pipe.mm_W.shape)} [{card}]: "
              f"device {ms:.5f} ms", flush=True)

    profile_solve(torch, card, "3D profile", lambda: solver.solve_refined(f, tol=1e-10))
    return launches


def cli_run(torch, cli, gs, D, argv):
    """``cli.main(D, argv)`` in-process with every launch count set to 0
    just before it and read just after; its out-json (written into the
    directory of ``argv``'s ``--out-json``), printed lines, and the
    ``D``-dimensional kernel's launches per dtype and per width, and the
    other dimension's launches."""
    reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(D, argv, device="cuda")
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli.main({D}, {argv}) returned {rc}")
    out = json.loads(open(argv[argv.index("--out-json") + 1]).read())
    launches = dict(gs.launches if D == 2 else gs.launches_3d)
    other = dict(gs.launches_3d if D == 2 else gs.launches)
    return out, buf.getvalue().splitlines(), launches, dict(gs.widths[D]), other


def _counts(out):
    return tuple(out[k] for k in ("iterations", "outer_iterations", "inner_iterations")
                 if k in out)


def check_cli_run(label, out, lines, launches, widths, other, ref, f64, error,
                  residual_limit, card):
    """Print a CLI run's result lines and hold it to the reference: counts
    (exactly when ``f64``, else the first exactly and the last within
    one), the residual, the error within 1%; every launch of the run went
    to the kernel of its dimension, on the vector path."""
    got = _counts(out)
    line = (f"CLI {label} [{card}]: iterations {got} (reference {ref}) residual "
            f"{out['residual']:.3e} error {out['error']:.6e} (reference {error:.6e}) "
            f"conservation {out['conservation']:.3e} dof {out['dof']}; linear solve {out['linear_solve_s']:.6f} s; stencil "
            f"launches {launches} per elements per thread {widths}")
    print(line, flush=True)
    for text in lines:
        if text.startswith(("Iterations", "Error", "Residual")):
            print(f"  {text}", flush=True)
    ok_counts = (got == ref if f64 else
                 len(got) == len(ref) and got[:-1] == ref[:-1] and abs(got[-1] - ref[-1]) <= 1)
    if not ok_counts:
        raise AssertionError(line)
    assert out["residual"] <= residual_limit, line
    assert abs(out["error"] - error) <= 0.01 * error, line
    assert sum(launches.values()) > 0 and widths[1] == 0, line
    assert not any(other.values()), f"{line}: launched the other dimension's kernel"


def cli_bench(torch, port, cli, gs, timer, card, tmp):
    """The command-line apps at full width: every run of ``CLI_BENCH_2D`` on
    the 2D bench mesh and the 3D bench through ``steady3d``, each written
    with ``Tree.to_file`` and read through ``--mesh``; then profiles of the
    ``CLI_PROFILED`` solves; every kernel must have been launched."""
    meshes = {}
    for D, base, corner in ((2, 5, 2), (3, 3, 2)):
        tree = port.refined_tree(D, base, corner)
        tree.refine_leaves()
        meshes[D] = os.path.join(tmp, f"bench{D}d.bin")
        tree.to_file(meshes[D])
    head = {2: ["--mesh", meshes[2], "-n", "64", "-t", "1e-10"],
            3: ["--mesh", meshes[3], "-n", "32", "-t", "1e-10"]}
    js = os.path.join(tmp, "bench.json")
    total = {(D, dt): 0 for D in (2, 3) for dt in ("float32", "float64")}
    runs = [(2, label, *spec) for label, spec in CLI_BENCH_2D.items()]
    runs.append((3, "3d-ir-bicgstab", *CLI_BENCH_3D))
    outs = {}
    for D, label, flags, ref, error in runs:
        res = cli_run(torch, cli, gs, D, head[D] + flags + ["--out-json", js])
        check_cli_run(label, *res, ref, label in CLI_F64_RUNS, error,
                      CLI_RESIDUAL_LIMIT.get(label, 1e-10), card)
        outs[label] = res[0]
        for dt, cnt in res[2].items():
            total[D, dt] += cnt
    for label in CLI_PROFILED:
        # the run's set-up, then one warm-up and one profiled linear solve
        # (cli.solve prints nothing without --monitor)
        _, args = cli.parse_args(2, head[2] + CLI_BENCH_2D[label][0])
        run = cli.setup(2, args, device="cuda", timer=timer.Timer())
        cli.solve(run, args, timer.Timer("cuda"))
        profile_solve(torch, card, f"CLI {label} profile",
                      lambda: cli.solve(run, args, timer.Timer("cuda")))
        del run
    print(f"CLI full-width runs: stencil launches per (D, dtype) {total}", flush=True)
    assert all(total.values()), total
    return head, outs


def cli_small(torch, port, cli, gs, card, tmp):
    """Small CLI runs on the small Schur mesh, held to the reference's CLI
    (``CLI_SMALL``): the monitored solves (their history lines too), the
    assembled and pointer-block operators, the interface preconditioners,
    Neumann walls, per-patch BiCGStab; then the output files and a config
    round trip."""
    import scipy.sparse as sp

    mesh = os.path.join(tmp, "small2d.bin")
    port.refined_tree(2, 3, 1).to_file(mesh)
    js = os.path.join(tmp, "small.json")
    base = ["--mesh", mesh, "-n", "8", "-t", "1e-10", "--gmg-coarse-direct-dof", "64"]
    for label, (flags, ref, error) in CLI_SMALL.items():
        out, lines, launches, widths, other = cli_run(
            torch, cli, gs, 2, base + flags + ["--out-json", js])
        got = _counts(out)
        line = (f"CLI small {label} [{card}]: iterations {got} (reference {ref}) residual "
                f"{out['residual']:.3e} error {out['error']:.10e}; launches {launches}")
        print(line, flush=True)
        assert len(got) == len(ref) and all(abs(a - b) <= 1 for a, b in zip(got, ref)), line
        assert out["residual"] <= 1e-10, line
        assert abs(out["error"] - error) <= 1e-6 * error, line
        assert widths[1] == 0 and not any(other.values()), line
        if "--monitor" in flags:
            hist = [float(t.split()[-1]) for t in lines if "rel residual" in t]
            assert len(hist) == got[0] + 1 and hist[0] == 1.0 and hist[-1] <= 1e-10, line
    # the output files of the default run, and the config round trip
    outd = os.path.join(tmp, "outputs")
    files = ["--out-claw", os.path.join(outd, "claw"), "--out-vtk", os.path.join(outd, "vtk"),
             "--out-rhs", os.path.join(outd, "rhs.npy"), "--out-gamma",
             os.path.join(outd, "gamma.npy"), "--out-matrix", os.path.join(outd, "A.npz"),
             "--output-config", os.path.join(outd, "run.ini")]
    os.makedirs(outd)
    first = cli_run(torch, cli, gs, 2, base + files + ["--out-json", js])[0]
    again = cli_run(torch, cli, gs, 2, ["--config", os.path.join(outd, "run.ini"),
                                         "--out-json", js])[0]
    P = first["dof"] // 64
    rhs, gamma = np.load(os.path.join(outd, "rhs.npy")), np.load(os.path.join(outd, "gamma.npy"))
    vti = [f for f in os.listdir(os.path.join(outd, "vtk")) if f.endswith(".vti")]
    A = sp.load_npz(os.path.join(outd, "A.npz"))
    line = (f"CLI small outputs [{card}]: rhs {rhs.shape}, gamma {gamma.shape}, {len(vti)} "
            f"vti files, matrix {A.shape} with {A.nnz} nonzeros; config round trip "
            f"iterations {first['iterations']} / {again['iterations']}, error "
            f"{first['error']:.10e} / {again['error']:.10e}")
    print(line, flush=True)
    assert rhs.shape == (P, 8, 8) and np.isfinite(gamma).all() and gamma.shape[1] == 8, line
    assert len(vti) == P and A.shape == (P * 64, P * 64), line
    assert os.path.getsize(os.path.join(outd, "claw", "fort.q0000")) > 0, line
    assert again["iterations"] == first["iterations"], line
    assert abs(again["error"] - first["error"]) <= 1e-12 * first["error"], line


def profile_solve(torch, card, label, solve, top=12):
    """Device busy share and kernel-time breakdown (the ``top`` kernels,
    then the stencil's) of one solve (torch.profiler); ``(wall ms, busy
    ms, kernel launches)``."""
    from torch.profiler import ProfilerActivity, profile

    from pressurepoissonsolver_torch.utils.profiling import kernel_times

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = kernel_times(prof)
    busy = sum(k[0] for k in kern)
    assert busy > 0, f"{label}: the profiler reported no device time"
    print(f"{label} [{card}]: one solve (profiled) wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% "
          f"({100 - 100 * busy / wall_us:.1f}% idle), "
          f"{sum(k[1] for k in kern)} kernel launches", flush=True)
    ranked = sorted(kern, reverse=True)
    for us, cnt, key in ranked[:top] + [k for k in ranked[top:] if "ghost_stencil" in k[2]]:
        print(f"  {us / 1e3:9.3f} ms {cnt:6d}x  {key[:100]}", flush=True)
    return wall_us / 1e3, busy / 1e3, sum(k[1] for k in kern)


@contextlib.contextmanager
def environ(**kw):
    """``os.environ`` with ``kw`` set (a ``None`` value unset), restored
    afterwards."""
    old = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_json(fn):
    """``fn()`` with its standard output captured: the JSON object of its
    last line (printed here too) and ``fn``'s own return value."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn()
    lines = buf.getvalue().splitlines()
    for text in lines:
        print(f"  {text}", flush=True)
    return json.loads(lines[-1]), ret


def bench_2d(torch, gs, card, warm_f32_ms):
    """``bench.main()`` at its defaults (n=64, divide 1, IR, Schur, 3
    reps), with the launch counts set to 0 just before it and read just
    after: the reference's keys, counts and error; both applies contain the
    kernel, so neither is faster than its warm time."""
    from pressurepoissonsolver_torch import bench

    reset_counters()
    out, ret = run_json(bench.main)
    torch.cuda.synchronize()
    # counters() also reads the launches its sync=False solves left on the card
    launches = gs.counters()[0]
    line = (f"bench.py (port) [{card}]: outer {out['outer_iterations']} inner "
            f"{out['inner_iterations']} residual {out['residual']:.3e} error "
            f"{out['error']:.6e} solve_s {out['solve_s']:.6f} setup_s "
            f"{out['setup_s']:.3f}; Schur {out['schur_iterations']} residual "
            f"{out['schur_residual']:.3e}; apply ms f32 {out['apply_f32_ms']:.5f} f64 "
            f"{out['apply_f64_ms']:.5f} ({out['apply_timing']}); stencil launches "
            f"{launches}")
    print(line, flush=True)
    missing = set(BENCH_KEYS) - set(out)
    assert not missing and set(out) == set(ret), (missing, line)
    assert out["outer_iterations"] == 3 and 6 <= out["inner_iterations"] <= 8, line
    assert out["residual"] <= 1e-10, line
    assert abs(out["error"] - BENCH_ERROR) <= 0.01 * BENCH_ERROR, line
    assert abs(out["schur_iterations"] - SCHUR_BENCH_ITERS) <= 1, line
    assert out["schur_residual"] <= 1e-10, line
    for key in ("apply_f32_ms", "apply_f64_ms"):
        assert np.isfinite(out[key]) and out[key] >= warm_f32_ms, line
    assert all(launches.values()) and not any(gs.launches_3d.values()), line
    return out


def bench_3d(torch, port, gs, card, tmp):
    """``scripts/bench3d.main()`` on the generated 3D bench mesh written
    with ``Tree.to_file`` (n=32), counts set to 0 just before it."""
    from pressurepoissonsolver_torch.scripts import bench3d

    tree = port.refined_tree(3, 3, 2)
    tree.refine_leaves()
    mesh = os.path.join(tmp, "bench3d_mesh.bin")
    tree.to_file(mesh)
    reset_counters()
    with environ(PPS_BENCH3D_MESH=mesh):
        out, _ = run_json(bench3d.main)
    torch.cuda.synchronize()
    # counters() also reads the launches its sync=False solves left on the card
    launches = gs.counters()[1]
    line = (f"bench3d (port) [{card}]: {out['dof']} DOF, outer "
            f"{out['outer_iterations']} inner {out['inner_iterations']} residual "
            f"{out['residual']:.3e} error {out['error']:.6e} value {out['value']:.6f} s; "
            f"3D stencil launches {launches}")
    print(line, flush=True)
    assert not set(BENCH3D_KEYS) - set(out), line
    assert out["outer_iterations"] == 2 and 6 <= out["inner_iterations"] <= 8, line
    assert out["residual"] <= 1e-10, line
    assert abs(out["error"] - BENCH3D_ERROR) <= 0.01 * BENCH3D_ERROR, line
    assert all(launches.values()) and not any(gs.launches.values()), line


def op_reports(torch, port, card, warm_f32_ms):
    """``profile_ops.main()`` at the bench's cutting, every row printed;
    the f32 ``stencil_only`` row times the same launch as phase 3's warm 2D
    f32 kernel time at (1048, 64); then ``op_report`` of that level."""
    from pressurepoissonsolver_torch.bench import bench_tree
    from pressurepoissonsolver_torch.ops.level_ops import Level
    from pressurepoissonsolver_torch.scripts import profile_ops
    from pressurepoissonsolver_torch.utils import profiling

    with environ(PPS_PROFILE_DIVIDE="1", PPS_PROFILE_N="64"):
        rep = profile_ops.main()
    row = rep["f32"]["stencil_only"]
    ratio = row["ms"] / warm_f32_ms
    line = (f"op report f32 stencil_only [{card}]: {row['ms']:.5f} ms "
            f"({row['timing']}) against the kernel's warm {warm_f32_ms:.5f} ms: "
            f"{ratio:.3f}x")
    print(line, flush=True)
    assert row["timing"] == "held_stream_device" and 1 / 1.5 <= ratio <= 1.5, line
    for name in ("f32", "f64"):
        for key, r in rep[name].items():
            assert np.isfinite(r["ms"]) and r["ms"] > 0, (name, key, r)
    hier = port.DomainHierarchy(bench_tree(1), n=64)
    lvl = Level(hier.finest, torch.float32, device="cuda")
    for key, r in profiling.op_report(lvl, hbm_force=True).items():
        print(f"op_report f32 (P={lvl.P}, n=64) [{card}]: {key:16s} {r}", flush=True)
        assert np.isfinite(r["ms"]) and r["roofline_pct"] > 0, (key, r)


def native_tables(torch, port, card):
    """The native table generator against the Python builders on the 2D
    and 3D bench meshes (every table equal), both builders' seconds, and
    the bench's set-up seconds (hierarchy + solver) with each."""
    from pressurepoissonsolver_torch import iface, native
    from pressurepoissonsolver_torch.solver import SolveOptions

    assert native.available(), "the native table generator did not build"
    pl_fields = ("ids", "starts", "spacings", "refine_level", "parent_id",
                 "orth_on_parent", "neumann", "nbr_type", "nbr_slot", "coarse_orth",
                 "fine_nbr_slots")
    if_fields = ("num_ifaces", "m", "iface_side_idx", "iface_side_mask", "contrib_patch",
                 "contrib_side", "contrib_iface", "contrib_case", "case_w", "case_src")
    for D, base, corner, n in ((2, 5, 2, 64), (3, 3, 2, 32)):
        tree = port.refined_tree(D, base, corner)
        tree.refine_leaves()
        secs, built = {}, {}
        for use in (True, False):
            t0 = time.perf_counter()
            hier = port.DomainHierarchy(tree, n=n, use_native=use)
            tables = [pl.prebuilt_iface_tables or iface.build_iface_tables(pl)
                      for pl in hier.levels]
            secs[hier.builder] = time.perf_counter() - t0
            built[hier.builder] = (hier, tables)
        (hn, tn), (hp, tp) = built["native"], built["python"]
        for a, b, ta, tb in zip(hn.levels, hp.levels, tn, tp):
            for k in pl_fields:
                assert np.array_equal(getattr(a, k), getattr(b, k)), (D, k)
            for k in if_fields:
                assert np.array_equal(getattr(ta, k), getattr(tb, k)), (D, k)
        setup = {}
        if D == 2:
            opts = SolveOptions(tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
                                gmg=port.CycleOpts(pre_sweeps=2, post_sweeps=1,
                                                   fac_smoothing="active"))
            for use in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hier = port.DomainHierarchy(tree, n=n, use_native=use)
                port.PoissonSolver(hier, opts, device="cuda")
                torch.cuda.synchronize()
                setup[hier.builder] = time.perf_counter() - t0
        print(f"native tables {D}D bench mesh ({len(hn.levels)} levels, "
              f"{hn.finest.num_patches} patches, n={n}) [{card}]: equal to the Python "
              f"builder's; hierarchy + tables: native {secs['native']:.3f} s, python "
              f"{secs['python']:.3f} s"
              + (f"; bench setup_s: native {setup['native']:.3f} s, python "
                 f"{setup['python']:.3f} s" if setup else ""), flush=True)


def bench_phase(torch, port, gs, card, tmp, warm_f32_ms):
    """Phase 6: the port's bench scripts, op report and native tables."""
    t0 = time.perf_counter()
    bench_2d(torch, gs, card, warm_f32_ms)
    bench_3d(torch, port, gs, card, tmp)
    op_reports(torch, port, card, warm_f32_ms)
    native_tables(torch, port, card)
    print(f"bench phase {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 7: the patch-sharded solve -----------------------------------------

# the world spawned on the one card (NCCL refuses two ranks on one GPU, so
# it runs under gloo, its exchanges staged through pinned host buffers)
SHARDED_WORLD = 4
# seconds the parent waits for the spawned world, and for the multihost job
SHARDED_TIMEOUT = 420
MULTIHOST_TIMEOUT = 420


def sharded_setup(torch, port, D, base, corner, n, gmg, mesh, refine=True, comm="halo"):
    """A bench-style problem on ``mesh``: the tree ``refined_tree(D, base,
    corner)`` (refined once with ``refine``) at patch size n, sharded over
    the mesh's ranks through the engine ``comm``; the solver and the global
    right-hand side and exact solution."""
    tree = port.refined_tree(D, base, corner)
    if refine:
        tree.refine_leaves()
    hier = port.DomainHierarchy(tree, n=n, num_shards=mesh.size())
    opts = port.SolveOptions(tol=1e-10, dtype=torch.float64,
                             precond_dtype=torch.float32, gmg=gmg, comm=comm)
    solver = port.PoissonSolver(hier, opts, mesh=mesh, device="cuda")
    f, exact = port.init_problem(hier.finest, port.get_problem("trig", D))
    return solver, f, exact


def _rel_diff(u, ref) -> float:
    return float(np.abs(u - ref).max() / np.abs(ref).max())


def sharded_world1(torch, port, gs, card, u_ir, u_schur):
    """Phase 7 (a): a world of one rank under NCCL, in this process, at
    full width: the 2D bench through ``solve_refined`` and ``solve_schur``
    with each engine (held to phase 3's counts, errors and solutions), then
    the 3D bench (halo); every stencil launch through the kernels' vector
    path.  The stencil launches per dimension and dtype."""
    import torch.distributed as dist

    from pressurepoissonsolver_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(1)
    assert dist.get_backend() == "nccl", dist.get_backend()
    launches = {2: {"float32": 0, "float64": 0}}
    try:
        for comm in ("halo", "pjit"):
            t1 = time.perf_counter()
            mem0 = torch.cuda.memory_allocated()
            solver, f, exact = sharded_setup(
                torch, port, 2, 5, 2, 64, port.CycleOpts(
                    pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                    coarse_direct_max_dof=4096), mesh, comm=comm)
            op = solver._op
            assert type(op).__name__ == {"halo": "ShardedLevel",
                                         "pjit": "GatheredLevel"}[comm]
            print(f"sharded world 1 (nccl) {comm} [{card}]: 2D bench, {op.P} patches, "
                  f"engine {type(op).__name__}, host-staged {op.comm.host_staged}; "
                  f"setup {time.perf_counter() - t1:.3f} s, "
                  f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB on the card",
                  flush=True)
            label = f"sharded world 1 {comm} bench solve"
            u, info, rep, ir = timed_solves(torch, solver, f, exact, card, label, gs, 2,
                                            inner_tol=1e-4)
            diff = _rel_diff(u.cpu().numpy(), u_ir)
            print(f"{label}: launches per solve { {k: v / 4 for k, v in ir.items()} }; "
                  f"max|u - u_phase3| / max|u_phase3| = {diff:.3e}", flush=True)
            assert info["outer_iterations"] == 3 and 6 <= info["inner_iterations"] <= 8, info
            assert rep["residual"] <= 1e-10, rep
            assert abs(rep["error"] - BENCH_ERROR) <= 0.01 * BENCH_ERROR, rep
            assert diff <= 1e-8, diff
            assert all(ir.values()), ir
            assert not any(gs.launches_nogf[2].values()), "world 1 split an apply"
            assert not any(gs.launches_faces[2].values()), "world 1 split an apply"

            reset_counters()
            times = []
            for rep_i in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                u, res = solver.solve_schur(f, tol=1e-10, max_iter=60,
                                            preconditioner="gmg")
                torch.cuda.synchronize()
                if rep_i:
                    times.append(time.perf_counter() - t1)
            schur_launches, widths = dict(gs.launches), dict(gs.widths[2])
            rep = solver.report(u, f, exact)
            diff = _rel_diff(u.cpu().numpy(), u_schur)
            line = (f"sharded world 1 {comm} bench Schur solve [{card}]: iterations "
                    f"{res.iterations} residual {rep['residual']:.3e} error "
                    f"{rep['error']:.6e} best {min(times):.6f} s of "
                    f"{[round(t, 6) for t in times]}; launches per solve "
                    f"{ {k: v / 3 for k, v in schur_launches.items()} }, per elements "
                    f"per thread {widths}; max|u - u_phase3| / max|u_phase3| = "
                    f"{diff:.3e}")
            print(line, flush=True)
            assert abs(res.iterations - SCHUR_BENCH_ITERS) <= 1, line
            assert rep["residual"] <= 1e-10, line
            assert abs(rep["error"] - SCHUR_BENCH_ERROR) <= 0.01 * SCHUR_BENCH_ERROR, line
            assert diff <= 1e-8, line
            assert schur_launches["float32"] > 0 and widths[1] == 0, line
            for k, v in (*ir.items(), *schur_launches.items()):
                launches[2][k] += v
            del solver, f, exact, u, op

        solver, f, exact = sharded_setup(torch, port, 3, 3, 2, 32, port.CycleOpts(), mesh)
        u, info, rep, launches[3] = timed_solves(
            torch, solver, f, exact, card, "sharded world 1 3D bench solve", gs, 3)
        print(f"sharded world 1 3D bench solve: launches per solve "
              f"{ {k: v / 4 for k, v in launches[3].items()} }", flush=True)
        assert info["outer_iterations"] == 2 and 6 <= info["inner_iterations"] <= 8, info
        assert rep["residual"] <= 1e-10, rep
        assert abs(rep["error"] - BENCH3D_ERROR) <= 0.01 * BENCH3D_ERROR, rep
        assert all(launches[3].values()), launches[3]
        del solver, f, exact, u
    finally:
        dist.destroy_process_group()
    print(f"sharded world 1 phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# the bench shape of each dimension's no-gf check
NOGF_SHAPES = {2: (1048, 64), 3: (624, 32)}


def nogf_kernels(torch, gs, timer, card, bw):
    """Phase 7 (b): each kernel's no-gf mode (``gf=None``: ghost ``coef *
    u_b``, no face entry read) at the bench shape, in f32 and f64, against
    its plain version; device ms cold and warm and its bound (the bytes of
    u, coef, h2 and out); the fused launch (with the faces) against the
    split one (no-gf launch, then ``add_ghost_faces``), warm, both held to
    each other; the face-term kernel the split adds (``check_faces``).
    These comparison launches are not counted: every path resets the
    counts before it runs.  ``({D: {dtype: no-gf numbers}}, {D: {dtype:
    face-term kernel numbers}})``."""
    rng = np.random.default_rng(SEED + 1)
    out, faces = {}, {}
    for D, (P, n) in NOGF_SHAPES.items():
        kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
        plain = gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain
        out[D], faces[D] = {}, {}
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            name = str(dtype).replace("torch.", "")
            u, gf, coef, h2 = stencil_args(torch, rng, D, P, n, dtype)
            base = kernel(u, None, coef, h2)
            width = gs.last_width[D]
            ref = plain(u, None, coef, h2)
            torch.cuda.synchronize()
            err = float((base - ref).abs().max())
            scale = float(ref.abs().max())
            fused = kernel(u, gf, coef, h2)
            split = gs.add_ghost_faces(base.clone(), gf, h2)
            split_err = float((split - fused).abs().max())
            line = (f"kernel ghost_stencil_{D}d {name} no-gf P={P} n={n} width={width} "
                    f"[{card}]: max_abs_err={err:.3e} max|out|={scale:.3e} (limit "
                    f"{rtol:g}*max|out|); split - fused max_abs {split_err:.3e}")
            assert width > 1 and err <= rtol * scale, line
            assert split_err <= rtol * float(fused.abs().max()), line
            args = [u, None, coef, h2]
            bound_ms, bound_by = kernel_bound(D, [u, coef, h2], base, bw)
            set_bytes = sum(a.numel() * a.element_size() for a in (u, coef, h2, base))
            sets = [args] + [[u.clone(), None, coef.clone(), h2.clone()]
                             for _ in range(timer.cold_sets(set_bytes) - 1)]
            ms = timer.cold_median_ms(kernel, sets)
            plain_ms = timer.cold_median_ms(plain, sets)
            del sets
            warm = {lab: timer.cuda_median_ms(fn, reps=50, hold=True) for lab, fn in (
                ("nogf", lambda: kernel(u, None, coef, h2)),
                ("fused", lambda: kernel(u, gf, coef, h2)),
                ("split", lambda: gs.add_ghost_faces(kernel(u, None, coef, h2), gf, h2)))}
            print(f"{line}; device ms cold: no-gf kernel {ms:.5f} ({100 * bound_ms / ms:.1f}% "
                  f"of its bound {bound_ms:.5f} ms by {bound_by}) plain {plain_ms:.5f}; "
                  f"warm: no-gf {warm['nogf']:.5f}, fused {warm['fused']:.5f}, split "
                  f"(no-gf + face term) {warm['split']:.5f}", flush=True)
            out[D][name] = {"nogf_ms": ms, "nogf_warm_ms": warm["nogf"],
                            "nogf_plain_ms": plain_ms, "nogf_bound_ms": bound_ms,
                            "nogf_max_abs_err": err, "fused_warm_ms": warm["fused"],
                            "split_warm_ms": warm["split"]}
            faces[D][name] = check_faces(torch, gs, timer, card, bw, D, base, gf, h2, rtol)
    return out, faces


def faces_bound(D, out, gf, h2, bw):
    """(ms, "bytes" | "operations") of one face-term call: gf and h2 read
    once, each boundary cell of out read and written once; at most 2 flops
    per side term and 2 per cell."""
    P, n = out.shape[0], out.shape[1]
    nb = 1 if n == 1 else (4 * n - 4 if D == 2 else 2 * n * n + (n - 2) * (4 * n - 4))
    nbytes = (gf.numel() + h2.numel() + 2 * P * nb) * out.element_size()
    flops = P * (2 * gf.shape[1] * gf.shape[2] + 2 * nb)
    name = str(out.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / bw, flops / PEAK_FLOPS[name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def faces_sector_bytes(out, gf, h2):
    """The bytes one face-term call moves counted in the card's 32-byte
    memory sectors: every sector of ``out`` that holds a boundary cell read
    and written once (an inner row's x-face cells each cost a sector of
    their own), gf and h2 read once.  The sector bound is these bytes over
    the memory rate."""
    P, n, D = out.shape[0], out.shape[1], out.dim() - 1
    idx = np.indices((n,) * D).reshape(D, -1)
    cells = np.flatnonzero(((idx == 0) | (idx == n - 1)).any(axis=0))
    offs = (np.arange(P)[:, None] * n ** D + cells) * out.element_size()
    sectors = (out.data_ptr() % 32 + offs.ravel()) // 32  # ascending
    count = 1 + int(np.count_nonzero(np.diff(sectors)))
    return 2 * 32 * count + (gf.numel() + h2.numel()) * out.element_size()


def check_faces(torch, gs, timer, card, bw, D, base, gf, h2, rtol):
    """The face-term kernel (``add_ghost_faces`` on the card) against its
    plain version on the no-gf stencil's output at the bench shape; device
    ms cold and warm (in place: the repeated calls keep adding) and its
    bound.  The kernel table entry's numbers."""
    name = str(base.dtype).replace("torch.", "")
    got = gs.add_ghost_faces(base.clone(), gf, h2)
    want = gs.add_ghost_faces_plain(base.clone(), gf, h2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    line = (f"kernel ghost_faces_{D}d {name} P={base.shape[0]} n={base.shape[1]} [{card}]: "
            f"max_abs_err={err:.3e} max|out|={scale:.3e} (limit {rtol:g}*max|out|)")
    assert err <= rtol * scale, line
    bound_ms, bound_by = faces_bound(D, base, gf, h2, bw)
    set_bytes = sum(a.numel() * a.element_size() for a in (base, gf, h2))
    sets = [[base.clone(), gf, h2]] + [[base.clone(), gf.clone(), h2.clone()]
                                       for _ in range(timer.cold_sets(set_bytes) - 1)]
    ms = timer.cold_median_ms(gs.add_ghost_faces, sets)
    plain_ms = timer.cold_median_ms(gs.add_ghost_faces_plain, sets)
    del sets
    out = base.clone()
    warm_ms = timer.cuda_median_ms(lambda: gs.add_ghost_faces(out, gf, h2), reps=50,
                                   hold=True)
    sector_ms = 1e3 * faces_sector_bytes(base, gf, h2) / bw
    print(f"{line}; device ms cold: kernel {ms:.5f} ({100 * bound_ms / ms:.1f}% of its "
          f"bound {bound_ms:.5f} ms by {bound_by}; {100 * sector_ms / ms:.1f}% of its "
          f"sector bound {sector_ms:.5f} ms) plain {plain_ms:.5f}; warm kernel "
          f"{warm_ms:.5f} ({100 * sector_ms / warm_ms:.1f}% of the sector bound)",
          flush=True)
    # no single PyTorch call computes the face term
    return {"max_abs_err": err, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "sector_bound_ms": sector_ms,
            "library_ms": None}


def split_shapes(solver):
    """The per-rank ``(P, n)`` shapes at which a halo-engine solver with
    more than one rank splits its applies (no-gf launch, then the face
    term): its fine level and every GMG level."""
    return sorted({(lvl.Pl, lvl.n) for lvl in [solver._op, *solver.gmg.levels]},
                  reverse=True)


def check_path_shapes(torch, gs, card, shapes):
    """Phase 7 (f): the no-gf mode and the face-term kernel against their
    plain versions, and the split launch against the fused one, at every
    per-rank shape ``shapes[D]`` that (c) and (e) gave them, in f32 and
    f64 (the kernels take another tile and lane layout at another n).
    ``{D: {dtype: (no-gf max_abs_err, face-term max_abs_err)}}``, the
    largest over the shapes."""
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for D, sh in sorted(shapes.items()):
        kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
        plain = gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain
        out[D] = {}
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            name = str(dtype).replace("torch.", "")
            worst = [0.0, 0.0, 0.0]  # relative: no-gf, face term, split - fused
            errs = [0.0, 0.0]
            for P, n in sh:
                u, gf, coef, h2 = stencil_args(torch, rng, D, P, n, dtype)
                base = kernel(u, None, coef, h2)
                ref = plain(u, None, coef, h2)
                got = gs.add_ghost_faces(base.clone(), gf, h2)
                want = gs.add_ghost_faces_plain(base.clone(), gf, h2)
                fused = kernel(u, gf, coef, h2)
                torch.cuda.synchronize()
                e = [float((base - ref).abs().max()), float((got - want).abs().max()),
                     float((got - fused).abs().max())]
                scale = [float(x.abs().max()) for x in (ref, want, fused)]
                for i in range(3):
                    worst[i] = max(worst[i], e[i] / scale[i])
                errs = [max(errs[0], e[0]), max(errs[1], e[1])]
            line = (f"kernels at the path's per-rank shapes, {D}D {name} [{card}]: (P, n) "
                    f"{sh}; largest max_abs_err / max|out|: no-gf {worst[0]:.3e}, face "
                    f"term {worst[1]:.3e}, split - fused {worst[2]:.3e} (limit {rtol:g})")
            print(line, flush=True)
            assert max(worst) <= rtol, line
            out[D][name] = tuple(errs)
    return out


def overlap_text(ov) -> str:
    """One line of :func:`halo_overlap`'s numbers."""
    (ls, le), (xs, ws) = ov["launch_us"], ov["outstanding_us"]
    return (f"base launch on the host {ls - xs:.1f} us after the exchange was posted "
            f"and {ws - le:.1f} us before its first wait (overlap with the "
            f"outstanding window {ov['launch_overlap_us']:.1f} us); base kernel "
            f"{ov['kernel_name']} {ov['kernel_device_us']:.1f} us on the card, starting "
            f"{-ov['kernel_lead_us']:+.1f} us from the first wait's start, overlap with the "
            f"in-flight window ({ov['in_flight_span_us']:.1f} us, posting to the last "
            f"wait's end) {ov['overlap_us']:.1f} us; first wait {ov['first_wait_us']:.1f} "
            f"us, a settled exchange's longest {ov['settled_wait_us']:.1f} us")


def halo_overlap(torch, dist, op, u, rank):
    """One profiled halo ``apply`` (every rank calls it; rank 0 profiles),
    read on one clock (the profiler puts the device activity on the
    host's).  The schedule: the host span of the no-gf base launch (marked
    here for the profiled call) against the window in which the exchange
    is outstanding, from the end of ``pps.halo.exchange_start`` (every
    offset posted) to the start of the first ``pps.halo.exchange_wait``
    (the waits alone).  On the device: the base kernel's interval and its
    overlap with the in-flight window (posting to the end of the last
    wait); how long the first wait blocked, beside the longest wait of a
    settled exchange of the same rows (posted by every rank before a
    barrier and waited for 50 ms later, when its rows have arrived): a
    first wait longer than that finds rows not yet arrived.  ``None`` on
    the other ranks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pressurepoissonsolver_torch.ops import level_ops
    from pressurepoissonsolver_torch.utils import profiling

    rows = u.new_zeros(op.exchange.n_local, op.m)

    def settled():
        started = op.exchange.start(rows)
        dist.barrier()
        time.sleep(0.05)
        with record_function("smoke.settled_exchange"):
            op.exchange.finish(started)
        torch.cuda.synchronize()

    op.apply(u)
    torch.cuda.synchronize()
    dist.barrier()
    if rank:
        op.apply(u)
        torch.cuda.synchronize()
        settled()
        return None
    launch = level_ops._STENCIL[2]

    def marked(u, gf, coef, h2):
        if gf is not None:
            return launch(u, gf, coef, h2)
        with record_function("smoke.base_launch"):
            return launch(u, gf, coef, h2)

    level_ops._STENCIL[2] = marked
    profiling.enable()  # the exchange's spans into the trace
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            op.apply(u)
            torch.cuda.synchronize()
            settled()
    finally:
        level_ops._STENCIL[2] = launch
        profiling.disable()
    evs = prof.events()

    def spans(name):
        # the host's spans (a span also shows as an annotation of the device)
        return sorted((e.time_range.start, e.time_range.end) for e in evs
                      if e.name == name and e.device_type == DeviceType.CPU)

    post = spans("pps.halo.exchange_start")
    settle = spans("smoke.settled_exchange")
    marks = spans("smoke.base_launch")
    kern = [e for e in evs if e.device_type == DeviceType.CUDA
            and "ghost_stencil_2d_kernel" in e.name and "false>" in e.name]
    assert len(post) == len(settle) == len(marks) == len(kern) == 1, (
        post, settle, marks, [e.name for e in kern])
    waits = spans("pps.halo.exchange_wait")
    calm = [w for w in waits if settle[0][0] <= w[0] <= settle[0][1]]
    mine = [w for w in waits if w[0] < settle[0][0]]
    noffsets = len(op.exchange.offsets)
    assert len(mine) == len(calm) == noffsets, (waits, settle, noffsets)
    (ls, le), (ks, ke) = marks[0], (kern[0].time_range.start, kern[0].time_range.end)
    xs, ws, xe = post[0][1], mine[0][0], mine[-1][1]
    return {"launch_us": [ls, le], "outstanding_us": [xs, ws],
            "launch_overlap_us": max(0.0, min(le, ws) - max(ls, xs)),
            "kernel_us": [ks, ke], "in_flight_us": [xs, xe],
            "kernel_name": re.search(r"ghost_stencil_2d_kernel<[^>]*>", kern[0].name)[0],
            "overlap_us": max(0.0, min(ke, xe) - max(ks, xs)),
            "in_flight_span_us": xe - xs, "kernel_device_us": ke - ks,
            "first_wait_us": mine[0][1] - mine[0][0],
            "settled_wait_us": max(w[1] - w[0] for w in calm),
            "kernel_lead_us": ws - ks}


def sharded_rank(rank, world, tmp):
    """One rank of phase 7 (c), spawned: gloo over a ``FileStore`` in
    ``tmp``, on ``cuda:0`` with the kernels phase 2 built.  The 2D bench
    through ``solve_refined`` and ``solve_schur`` with each engine, one
    profiled halo apply, and the small 3D mesh through ``solve_refined``
    (halo); rank 0 checks the gathered fields against phase 3's (aligned by
    patch id) and every rank writes its numbers to ``tmp/rank<r>.json``.
    Prints only lines that start with its rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from pressurepoissonsolver_torch import cli
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.geometry import refined_tree
    from pressurepoissonsolver_torch.gmg import CycleOpts
    from pressurepoissonsolver_torch.ops import ghost_stencil as gs
    from pressurepoissonsolver_torch.parallel.partition import block_partition, cut_faces
    from pressurepoissonsolver_torch.parallel.sharding import gather_patches, make_mesh
    from pressurepoissonsolver_torch.problems import get_problem, init_problem
    from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
    from pressurepoissonsolver_torch.utils.timer import Timer

    port = types.SimpleNamespace(
        DomainHierarchy=DomainHierarchy, refined_tree=refined_tree,
        CycleOpts=CycleOpts, get_problem=get_problem, init_problem=init_problem,
        PoissonSolver=PoissonSolver, SolveOptions=SolveOptions)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gs.build(2)
    gs.build(3)
    gs.build_faces()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    out = {"rank": rank}

    def say(text):
        # one write per line: the ranks share the parent's output
        sys.stdout.write(f"[rank {rank}] {text}\n")
        sys.stdout.flush()

    def timed(fn, reps=2):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            ret = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return ret, walls

    def counts(D):
        return {"launches": dict(gs.launches if D == 2 else gs.launches_3d),
                "nogf": dict(gs.launches_nogf[D]), "faces": dict(gs.launches_faces[D]),
                "widths": dict(gs.widths[D])}

    try:
        mesh = make_mesh(world)
        ref = np.load(os.path.join(tmp, "phase3.npz")) if rank == 0 else None
        for comm in ("halo", "pjit"):
            t0 = time.perf_counter()
            mem0 = torch.cuda.memory_allocated()
            solver, f, exact = sharded_setup(
                torch, port, 2, 5, 2, 64, CycleOpts(
                    pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                    coarse_direct_max_dof=4096), mesh, comm=comm)
            op = solver._op
            o = out[comm] = {"setup_s": time.perf_counter() - t0,
                             "setup_mib": (torch.cuda.memory_allocated() - mem0) / 2**20,
                             "host_staged": op.comm.host_staged,
                             "backend": op.comm.backend}
            text = ""
            if comm == "halo":
                o["split_shapes"] = split_shapes(solver)
                o["comm_rows"], o["offsets"] = op.comm_rows, list(op.exchange.offsets)
                o["cut_faces"] = cut_faces(op.pl, block_partition(op.P, world))
                text = (f", offsets {op.exchange.offsets} rows per offset "
                        f"{op.exchange.widths}, comm_rows {op.comm_rows} (cut faces "
                        f"{o['cut_faces']})")
            say(f"2D bench, {comm}: {op.Pl} of {op.P} patches, backend {op.comm.backend}, "
                f"host-staged {op.comm.host_staged}{text}, setup {o['setup_s']:.2f} s, "
                f"{o['setup_mib']:.1f} MiB on the card")

            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            (u, info), walls = timed(lambda: solver.solve_refined(f, tol=1e-10,
                                                                  inner_tol=1e-4))
            # the solves' peak, which holds the gathered operands whole
            o["peak_mib"] = (torch.cuda.max_memory_allocated() - mem0) / 2**20
            o["ir"] = {"info": {k: v for k, v in info.items() if k != "outer_history"},
                       "walls": walls, **counts(2), "report": solver.report(u, f, exact)}
            say(f"2D bench solve_refined, {comm}: {info['outer_iterations']} / "
                f"{info['inner_iterations']}, error {o['ir']['report']['error']:.6e}, "
                f"walls {[round(w, 3) for w in walls]} s, stencil launches in the 2 "
                f"solves {o['ir']['launches']} (no-gf {o['ir']['nogf']}), per width "
                f"{o['ir']['widths']}")
            ug = gather_patches(u, mesh).cpu().numpy()

            reset_counters()
            (us, res), walls = timed(lambda: solver.solve_schur(
                f, tol=1e-10, max_iter=60, preconditioner="gmg"))
            o["schur"] = {"iterations": res.iterations, "walls": walls, **counts(2),
                          "report": solver.report(us, f, exact)}
            say(f"2D bench solve_schur(gmg), {comm}: {res.iterations} iterations, error "
                f"{o['schur']['report']['error']:.6e}, walls "
                f"{[round(w, 3) for w in walls]} s, stencil launches in the 2 solves "
                f"{o['schur']['launches']} (no-gf {o['schur']['nogf']})")
            usg = gather_patches(us, mesh).cpu().numpy()
            if rank == 0:
                ids = op.pl.ids[: op.pl.real_patches]
                order = np.argsort(ref["ids"])
                pos = order[np.searchsorted(ref["ids"][order], ids)]
                assert np.array_equal(ref["ids"][pos], ids)
                nr = op.pl.real_patches
                o["ir"]["diff"] = _rel_diff(ug[:nr], ref["u_ir"][pos])
                o["schur"]["diff"] = _rel_diff(usg[:nr], ref["u_schur"][pos])
                o["dummy_2d"] = [int(op.P - nr), float(np.abs(ug[nr:]).max(initial=0.0)),
                                 float(np.abs(usg[nr:]).max(initial=0.0))]
            if comm == "halo":
                reset_counters()
                ov = halo_overlap(torch, dist, op, u.to(torch.float64), rank)
                o["overlap"] = {**(ov or {}), **counts(2)}
                if ov:
                    say(f"profiled halo apply (f64): {overlap_text(ov)}")
            del solver, f, exact, u, us, op

        reset_counters()
        solver, f, exact = sharded_setup(torch, port, 3, 3, 2, 8, CycleOpts(), mesh,
                                         refine=False)
        (u, info), walls = timed(lambda: solver.solve_refined(f, tol=1e-10), reps=1)
        rep = solver.report(u, f, exact)
        pl = solver.fine_level.pl
        ug = gather_patches(u, mesh).cpu().numpy()
        out["small3d"] = {"info": {k: v for k, v in info.items() if k != "outer_history"},
                          "walls": walls, "report": rep, **counts(3),
                          "comm_rows": solver._op.comm_rows,
                          "split_shapes": split_shapes(solver),
                          "dummy": [int(pl.num_patches - pl.real_patches),
                                    float(np.abs(ug[pl.real_patches:]).max(initial=0.0))]}
        say(f"small 3D (78 patches, n=8): {info['outer_iterations']} / "
            f"{info['inner_iterations']}, error {rep['error']:.10e}, wall "
            f"{walls[0]:.3f} s, 3D launches {out['small3d']['launches']} (no-gf "
            f"{out['small3d']['nogf']})")

        # the production configuration through the CLI (the halo engine of
        # its ini; its Kronecker prolongation through ShardedTransfer), then
        # set up again for the forms its cycle built
        js = os.path.join(tmp, "production.json")
        argv = CLI_KRON["production"][1] + ["--shards", str(world)]
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(2, argv + ["--out-json", js], device="cuda:0")
        torch.cuda.synchronize()
        prod = out["production"] = {"rc": rc, "wall": time.perf_counter() - t0, **counts(2)}
        _, args = cli.parse_args(2, argv)
        prod["forms"] = kron_forms(cli.setup(2, args, device="cuda:0", timer=Timer(),
                                             mesh=mesh).solver.gmg)
        if rank == 0:
            with open(js) as fh:
                prod["cli"] = json.load(fh)
        say(f"production configuration (--shards {world}): rc {rc}, wall "
            f"{prod['wall']:.3f} s, Kronecker tables and transfers {prod['forms']}, "
            f"stencil launches {prod['launches']} (no-gf {prod['nogf']})")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def sharded_world4(torch, hier_ids, u_ir, u_schur, card, tmp):
    """Phase 7 (c): ``SHARDED_WORLD`` ranks spawned on the one card, each
    held to the single-device counts and errors with each engine; any
    rank's failure fails the phase.  The stencil launches summed over the
    ranks, and the no-gf ones."""
    import multiprocessing

    t0 = time.perf_counter()
    wdir = os.path.join(tmp, "world")
    os.makedirs(wdir)
    np.savez(os.path.join(wdir, "phase3.npz"), ids=hier_ids, u_ir=u_ir, u_schur=u_schur)
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=sharded_rank, args=(r, SHARDED_WORLD, wdir))
             for r in range(SHARDED_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * SHARDED_WORLD, f"the spawned world's exit codes: {codes}"
    outs = [json.load(open(os.path.join(wdir, f"rank{r}.json")))
            for r in range(SHARDED_WORLD)]
    r0 = outs[0]
    launches = {D: {"float32": 0, "float64": 0} for D in (2, 3)}
    nogf = {D: {"float32": 0, "float64": 0} for D in (2, 3)}
    faces = {D: {"float32": 0, "float64": 0} for D in (2, 3)}

    def add(D, run):
        # every split apply launches the face-term kernel once
        assert run["faces"] == run["nogf"], run
        for dt, c in run["launches"].items():
            launches[D][dt] += c
        for dt, c in run["nogf"].items():
            nogf[D][dt] += c
            faces[D][dt] += c

    for o in outs:
        for comm in ("halo", "pjit"):
            e = o[comm]
            assert e["backend"] == "gloo" and e["host_staged"], e
            info, rep = e["ir"]["info"], e["ir"]["report"]
            assert info["outer_iterations"] == 3, (comm, o["rank"], info)
            assert abs(info["inner_iterations"] - 7) <= 1, (comm, o["rank"], info)
            assert rep["residual"] <= 1e-10, (comm, rep)
            assert abs(rep["error"] - BENCH_ERROR) <= 0.01 * BENCH_ERROR, (comm, rep)
            assert abs(e["schur"]["iterations"] - SCHUR_BENCH_ITERS) <= 1, e["schur"]
            assert e["schur"]["report"]["residual"] <= 1e-10, e["schur"]
            assert (abs(e["schur"]["report"]["error"] - SCHUR_BENCH_ERROR)
                    <= 0.01 * SCHUR_BENCH_ERROR)
            for run in (e["ir"], e["schur"]):
                assert run["widths"]["1"] == 0 and run["launches"]["float32"] > 0, run
                add(2, run)
            # the halo engine splits every world-4 apply; the gathered one never
            split = sum(e["ir"]["nogf"].values())
            assert (split > 0) if comm == "halo" else (split == 0), (comm, e["ir"])
        assert 0 < o["halo"]["comm_rows"] <= o["halo"]["cut_faces"], o["halo"]
        add(2, o["halo"]["overlap"])
        s3 = o["small3d"]
        info, rep = s3["info"], s3["report"]
        assert info["outer_iterations"] == 2 and abs(info["inner_iterations"] - 7) <= 1
        assert rep["residual"] <= 1e-10, rep
        assert abs(rep["error"] - SMALL3D_ERROR) <= 1e-6 * SMALL3D_ERROR, rep
        assert s3["widths"]["1"] == 0 and sum(s3["launches"].values()) and sum(
            s3["nogf"].values()), s3
        add(3, s3)
        assert s3["dummy"][0] > 0 and s3["dummy"][1] == 0.0, s3
        prod = o["production"]
        kt, nt, kx, nx = prod["forms"]
        assert prod["rc"] == 0 and nt and nx and (kt, kx) == (nt, nx), (o["rank"], prod)
        assert prod["widths"]["1"] == 0 and prod["launches"]["float32"] > 0, prod
        add(2, prod)
    for comm in ("halo", "pjit"):
        e = r0[comm]
        assert e["ir"]["diff"] <= 1e-8 and e["schur"]["diff"] <= 1e-8, (comm, e)
        assert e["dummy_2d"][1:] == [0.0, 0.0], (comm, e["dummy_2d"])
    prod, (ref, error) = r0["production"]["cli"], CLI_KRON["production"][2]["default"]
    got = _counts(prod)
    line = (f"production configuration at world {SHARDED_WORLD} (halo, gloo, one card) "
            f"[{card}]: iterations {got} (reference {ref}) residual {prod['residual']:.3e} "
            f"error {prod['error']:.6e} (reference {error:.6e}); linear solve "
            f"{prod['linear_solve_s']:.3f} s, cli.main walls per rank "
            f"{[round(o['production']['wall'], 3) for o in outs]} s; Kronecker tables and "
            f"transfers per rank {[o['production']['forms'] for o in outs]}")
    print(line, flush=True)
    assert got[0] == ref[0] and abs(got[1] - ref[1]) <= 1, line
    assert prod["residual"] <= 1e-10 and abs(prod["error"] - error) <= 0.01 * error, line
    ov = r0["halo"]["overlap"]
    line = (f"sharded world {SHARDED_WORLD} (gloo, one card) [{card}]: counts and errors "
            f"as phase 3 on every rank with both engines; rank 0: max|u - u_phase3| / "
            f"max|u_phase3| IR halo {r0['halo']['ir']['diff']:.3e} pjit "
            f"{r0['pjit']['ir']['diff']:.3e}, Schur halo "
            f"{r0['halo']['schur']['diff']:.3e} pjit {r0['pjit']['schur']['diff']:.3e}; "
            f"2D dummy patches {r0['halo']['dummy_2d'][0]}, small 3D dummy patches "
            f"{r0['small3d']['dummy'][0]} (exactly 0); comm_rows per rank "
            f"{[o['halo']['comm_rows'] for o in outs]} (cut faces "
            f"{r0['halo']['cut_faces']}), offsets {r0['halo']['offsets']}; MiB on the "
            f"card after setup per rank: halo "
            f"{[round(o['halo']['setup_mib'], 1) for o in outs]}, pjit "
            f"{[round(o['pjit']['setup_mib'], 1) for o in outs]}, peak in the IR solves "
            f"halo {[round(o['halo']['peak_mib'], 1) for o in outs]}, pjit "
            f"{[round(o['pjit']['peak_mib'], 1) for o in outs]}; IR walls per rank: "
            f"halo {[[round(w, 3) for w in o['halo']['ir']['walls']] for o in outs]} s, "
            f"pjit {[[round(w, 3) for w in o['pjit']['ir']['walls']] for o in outs]} s; "
            f"Schur walls rank 0: halo {[round(w, 3) for w in r0['halo']['schur']['walls']]}"
            f" pjit {[round(w, 3) for w in r0['pjit']['schur']['walls']]} s; stencil "
            f"launches of the world {launches}, no-gf {nogf}, face-term kernel "
            f"{faces}; profiled halo apply on rank 0: {overlap_text(ov)}; phase "
            f"{time.perf_counter() - t0:.1f} s (a correctness run: the ranks share one "
            f"card)")
    print(line, flush=True)
    # the base kernel was launched while the exchange was outstanding:
    # after every offset was posted, before the first wait (launched after
    # the waits, or with the waits inside the start, it lies outside)
    (ls, le), (xs, ws) = ov["launch_us"], ov["outstanding_us"]
    assert xs <= ls and le <= ws and ov["launch_overlap_us"] > 0, ov
    shapes = {2: {tuple(x) for o in outs for x in o["halo"]["split_shapes"]},
              3: {tuple(x) for o in outs for x in o["small3d"]["split_shapes"]}}
    return launches, nogf, faces, shapes


def multihost_check(card, tmp):
    """Phase 7 (e): ``scripts.multihost --device cuda`` in a process group
    of its own (killed whole on a timeout); both engines must match the
    single-process solve.  The per-rank 2D ``(P, n)`` shapes of its
    solves."""
    import signal
    import subprocess

    from pressurepoissonsolver_torch.scripts import multihost

    t0 = time.perf_counter()
    out = os.path.join(tmp, "multihost.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pressurepoissonsolver_torch.scripts.multihost",
         "--device", "cuda", "--out", out], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=MULTIHOST_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with open(out) as fh:
        rep = json.load(fh)
    print(f"multihost [{card}]: {rep['processes']} hosts x {rep['devices_per_process']} "
          f"ranks, {rep['dof']} DOF, backend {rep['backend']!r}; pjit "
          f"{rep['pjit']['iterations']} iterations, max|u - u_1proc| "
          f"{rep['pjit']['max_abs_diff_vs_1proc']:.3e}; halo {rep['halo']['iterations']} "
          f"iterations, {rep['halo']['max_abs_diff_vs_1proc']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert rep["ok"] and rep["pjit"]["match"] and rep["halo"]["match"], rep
    # the per-rank shapes of the job's halo solves: every level of its
    # hierarchy over its ranks
    h, _, _ = multihost.build_problem()
    k = multihost.NPROC * multihost.NDEV_PER_PROC
    return {(h[i].num_patches // k, h[i].n) for i in range(len(h))}


def sharded_cli(torch, cli, gs, card, head, phase5):
    """Phase 7 (c): ``cli.main(2, <bench mesh> --solver ir --shards 1)``
    in-process (a one-rank NCCL group of its own), held to phase 5's
    ``--solver ir`` run."""
    import torch.distributed as dist

    js = os.path.join(os.path.dirname(head[1]), "shards1.json")
    out, lines, launches, widths, other = cli_run(
        torch, cli, gs, 2, head + ["--solver", "ir", "--shards", "1", "--out-json", js])
    ref = phase5["ir"]
    check_cli_run("ir --shards 1", out, lines, launches, widths, other, _counts(ref),
                  False, ref["error"], 1e-10, card)
    print(f"CLI ir --shards 1 against phase 5's ir run: iterations {_counts(out)} / "
          f"{_counts(ref)}, error {out['error']:.13e} / {ref['error']:.13e} "
          f"(relative difference {abs(out['error'] - ref['error']) / ref['error']:.3e})",
          flush=True)
    assert _counts(out) == _counts(ref), (out, ref)
    assert abs(out["error"] - ref["error"]) <= 1e-4 * ref["error"], (out, ref)
    assert not dist.is_initialized()
    return launches


def sharded_phase(torch, port, cli, gs, timer, card, bw, tmp, u_ir, u_schur, hier_ids,
                  head, phase5):
    """Phase 7: the patch-sharded solve (a) to (f); the stencil launches of
    the phase per dimension and dtype, the no-gf ones, the no-gf numbers
    of (b) and the face-term kernel's table entries (launches from (c);
    the largest errors of (b) and (f), and the shapes checked)."""
    t0 = time.perf_counter()
    launches = sharded_world1(torch, port, gs, card, u_ir, u_schur)
    table, faces_table = nogf_kernels(torch, gs, timer, card, bw)
    w4, nogf, faces, shapes = sharded_world4(torch, hier_ids, u_ir, u_schur, card, tmp)
    for D, per in w4.items():
        for dt, c in per.items():
            launches[D][dt] += c
    for dt, c in sharded_cli(torch, cli, gs, card, head[2], phase5).items():
        launches[2][dt] += c
    shapes[2] |= multihost_check(card, tmp)
    shapes = {D: sorted(sh, reverse=True) for D, sh in shapes.items()}
    for D, per in check_path_shapes(torch, gs, card, shapes).items():
        for name, (nogf_err, faces_err) in per.items():
            t, f = table[D][name], faces_table[D][name]
            t["nogf_max_abs_err"] = max(t["nogf_max_abs_err"], nogf_err)
            f["max_abs_err"] = max(f["max_abs_err"], faces_err)
            t["nogf_shapes"] = f["shapes"] = [list(NOGF_SHAPES[D])] + [
                list(x) for x in shapes[D]]
    print(f"sharded phase {time.perf_counter() - t0:.1f} s; stencil launches "
          f"{launches}, no-gf {nogf}, face-term kernel {faces}", flush=True)
    for D in (2, 3):
        for name, cnt in faces[D].items():
            faces_table[D][name]["launches"] = cnt
    return launches, nogf, table, faces_table


# -- phase 8: the f32 Kronecker forms (PPS_KRON_MAX_N) -------------------------


def kron_forms(gmg):
    """``(spectral tables on the Kronecker form, spectral tables, transfers
    on it, transfers)`` of a multigrid cycle of any engine: the tables of
    its levels and active-set smoothers, and its transfers."""
    tables = [s._st for s in [*gmg.levels, *gmg._asmooth]
              if s is not None and getattr(s, "_st", None) is not None]
    return (sum(st.kron is not None for st in tables), len(tables),
            sum(t._Wp is not None for t in gmg.transfers), len(gmg.transfers))


def kron_solves(torch, cli, timer, card, D, argv, label, pairs=4):
    """``argv`` set up twice through ``cli.setup``, with the knob at its
    default and at 0 (with ``--shards`` in one one-rank group of its own,
    ended after): per setting the forms its cycle built
    (:func:`kron_forms`), the walls of ``2 * pairs`` solves taken in turns
    (default, 0, 0, default, ...), and one profiled solve
    (:func:`profile_solve`)."""
    import torch.distributed as dist

    from pressurepoissonsolver_torch.parallel.sharding import make_mesh

    _, args = cli.parse_args(D, argv)
    own = bool(args.shards) and not dist.is_initialized()
    mesh = make_mesh(args.shards) if args.shards else None
    try:
        runs = {}
        for knob, value in KRON_KNOBS.items():
            with environ(PPS_KRON_MAX_N=value):
                runs[knob] = cli.setup(D, args, device="cuda:0" if mesh else "cuda",
                                       timer=timer.Timer(), mesh=mesh)
        out = {knob: {"forms": kron_forms(run.solver.gmg), "walls": []}
               for knob, run in runs.items()}
        for knob in runs:  # warm-up
            cli.solve(runs[knob], args, timer.Timer("cuda"))
        for knob in ["default", "0", "0", "default"] * (pairs // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.solve(runs[knob], args, timer.Timer("cuda"))
            torch.cuda.synchronize()
            out[knob]["walls"].append(time.perf_counter() - t0)
        for knob, run in runs.items():
            out[knob]["profile"] = profile_solve(
                torch, card, f"{label} PPS_KRON_MAX_N={knob} profile",
                lambda: cli.solve(run, args, timer.Timer("cuda")), top=3)
        del runs
    finally:
        if own:
            dist.destroy_process_group()
    return out


def kron_cli(torch, cli, gs, timer, card, tmp):
    """Phase 8 (a): every run of ``CLI_KRON`` with each engine of
    ``KRON_ENGINES`` and each knob setting: ``cli.main`` (the launch counts
    set to 0 just before it and read just after), held to the JAX CLI's
    counts and error; then both settings set up again, the cycle entirely
    on the Kronecker form with the default knob and not at all with 0, and
    their solves timed in turns and profiled (:func:`kron_solves`).  The
    stencil launches of the ``cli.main`` runs per dimension and dtype."""
    t0 = time.perf_counter()
    js = os.path.join(tmp, "kron.json")
    total = {D: {"float32": 0, "float64": 0} for D in (2, 3)}
    for label, (D, flags, refs) in CLI_KRON.items():
        for engine, extra in KRON_ENGINES[D].items():
            name = f"{label} {engine}"
            main = {}
            for knob, (ref, error) in refs.items():
                with environ(PPS_KRON_MAX_N=KRON_KNOBS[knob]):
                    res = cli_run(torch, cli, gs, D, flags + extra + ["--out-json", js])
                check_cli_run(f"{name} PPS_KRON_MAX_N={knob}", *res, ref, False, error,
                              1e-10, card)
                for dt, c in res[2].items():
                    total[D][dt] += c
                main[knob] = (res[0]["linear_solve_s"], res[2])
            runs = kron_solves(torch, cli, timer, card, D, flags + extra, name)
            d, z = runs["default"], runs["0"]
            line = (f"Kronecker forms, {name} [{card}], default / PPS_KRON_MAX_N=0: "
                    f"Kronecker tables and transfers (on the form, of) {d['forms']} / "
                    f"{z['forms']}; cli.main linear solve s {main['default'][0]:.6f} / "
                    f"{main['0'][0]:.6f}; solve walls s in turns "
                    f"{[round(w, 6) for w in d['walls']]} / "
                    f"{[round(w, 6) for w in z['walls']]} (median "
                    f"{statistics.median(d['walls']):.6f} / "
                    f"{statistics.median(z['walls']):.6f}); profiled solve wall ms "
                    f"{d['profile'][0]:.3f} / {z['profile'][0]:.3f}, device busy ms "
                    f"{d['profile'][1]:.3f} / {z['profile'][1]:.3f}, launches per solve "
                    f"{d['profile'][2]} / {z['profile'][2]}; stencil launches of cli.main "
                    f"{main['default'][1]} / {main['0'][1]}")
            print(line, flush=True)
            kt, nt, kx, nx = d["forms"]
            assert nt and nx and (kt, kx) == (nt, nx), line
            assert z["forms"] == (0, nt, 0, nx), line
    print(f"Kronecker CLI runs {time.perf_counter() - t0:.1f} s; stencil launches {total}",
          flush=True)
    return total


def kron_op_flops(op, form, D, n):
    """Flops per patch row of an op (the matmuls, and the divide or add
    per cell): the Kronecker form's grow as n^2 per cell (2D), the
    per-axis form's as n."""
    cells = n ** D
    if op == "spectral":  # forward and inverse transforms
        mm = 2 * (2 * n ** 4 if D == 2 else 2 * n ** 4 + 2 * n ** 5) if form == "kron" \
            else 2 * D * 2 * n ** (D + 1)
    else:  # one orthant's transfer matrices
        mm = (2 * n ** 4 if D == 2 else 2 * n ** 4 + 2 * n ** 5) if form == "kron" \
            else D * 2 * n ** (D + 1)
    return mm + cells


def kron_op_times(torch, port, card, bw):
    """Phase 8 (b): the spectral patch solve of the finest level and its
    plain ``restrict`` and ``prolong_add`` (constant; ``restrict_plain`` /
    ``prolong_add_plain``, the chain the transfer kernel replaces on a
    2D card level) on the Kronecker form (the
    knob raised to n at n=32) against the per-axis form (knob 0), f32, on
    uniform trees of ``KRON_OP_TREES``: the two forms agree within 1e-5 of
    max|out|; device ms cold (inputs rotated beyond the L2) and warm, in
    turns (Kronecker, per-axis, per-axis, Kronecker; the mean of each
    form's two), and the bound: the larger of
    the bytes (the fields in and out, the tables, the matrices) over the
    memory rate and the flops over 67 TFLOP/s.  The rows."""
    from pressurepoissonsolver_torch.geometry import uniform_tree
    from pressurepoissonsolver_torch.gmg import Transfer
    from pressurepoissonsolver_torch.ops.level_ops import Level, _build_solver_tables
    from pressurepoissonsolver_torch.ops.patch_sweep import _spectral_apply
    from pressurepoissonsolver_torch.utils import profiling

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    rows = []

    def nbytes(*objs):
        ts = [t for o in objs for t in (o if isinstance(o, (list, tuple)) else [o])
              for t in (t if isinstance(t, tuple) else (t,))]
        return sum(t.numel() * t.element_size() for t in ts)

    for D, per in KRON_OP_TREES.items():
        for n, L in per.items():
            h = port.DomainHierarchy(uniform_tree(D, L), n=n)
            fine, coarse = (Level(h[i], torch.float32, device="cuda") for i in (0, 1))
            x = profiling.random_field(fine, rng)
            uc = profiling.random_field(coarse, rng)
            field = x.numel() * 4
            ops = {}
            for form, knob in (("kron", str(max(n, 16))), ("axis", "0")):
                with environ(PPS_KRON_MAX_N=knob):
                    st = _build_solver_tables(h[0], torch.float32,
                                              np.arange(fine.P, dtype=np.int64), "cuda")
                    t = Transfer(fine, coarse)
                assert (st.kron is not None) == (t._Wp is not None) == (form == "kron")
                mats = (st.kron or list(st.tmats.values()), t._Wr or t._wrstr,
                        t._Wp or t._wprol)
                ops[form] = {
                    "spectral": (lambda v, st=st: _spectral_apply(st, v, D, n),
                                 3 * field + nbytes(mats[0]), fine.P),
                    "restrict": (t.restrict_plain, field + uc.numel() * 4 + nbytes(mats[1]),
                                 fine.P),
                    "prolong": (lambda v, t=t: t.prolong_add_plain(uc, v),
                                2 * field + uc.numel() * 4 + nbytes(mats[2]), fine.P)}
            B = profiling.rotation_buffers("cuda", field)
            for op in ("spectral", "restrict", "prolong"):
                ref = ops["axis"][op][0](x)
                got = ops["kron"][op][0](x)
                err = float((got - ref).abs().max() / ref.abs().max())
                res = {f: {"ms": [], "warm_ms": []} for f in ops}
                for form in ("kron", "axis", "axis", "kron"):
                    fn = ops[form][op][0]
                    ms, how = profiling.measure(fn, x, reps=50, in_graph=True, hbm_rotate=B)
                    warm, how_w = profiling.measure(fn, x, reps=50, in_graph=True)
                    res[form]["ms"].append(ms * 1e3)
                    res[form]["warm_ms"].append(warm * 1e3)
                    res[form]["timing"] = how if how == how_w else f"{how} / {how_w}"
                for form, (fn, nb, P) in ((f, ops[f][op]) for f in ops):
                    flops = P * kron_op_flops(op, form, D, n)
                    t_b, t_o = nb / bw, flops / PEAK_FLOPS["float32"]
                    r = res[form]
                    rows.append({
                        "D": D, "n": n, "P": P, "dof": x.numel(), "op": op, "form": form,
                        "ms": statistics.mean(r["ms"]), "warm_ms": statistics.mean(r["warm_ms"]),
                        "timing": r["timing"], "bound_ms": 1e3 * max(t_b, t_o),
                        "bound_by": "bytes" if t_b >= t_o else "operations",
                        "mbytes": nb / 1e6, "gflop": flops / 1e9, "max_rel_diff": err})
                k, a = rows[-2], rows[-1]
                line = (f"Kronecker op {op} {D}D n={n} P={k['P']} ({k['dof']} DOF) [{card}]: "
                        f"device ms cold / warm: Kronecker {k['ms']:.5f} / {k['warm_ms']:.5f} "
                        f"(bound {k['bound_ms']:.5f} by {k['bound_by']}), per-axis "
                        f"{a['ms']:.5f} / {a['warm_ms']:.5f} (bound {a['bound_ms']:.5f} by "
                        f"{a['bound_by']}); "
                        f"max|kron - axis| / max|axis| = {err:.3e} ({k['timing']})")
                print(line, flush=True)
                assert err <= 1e-5, line
                assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in (k, a)), line
            del fine, coarse, x, uc, ops
    print(json.dumps({"kron_op_times": rows}), flush=True)
    print(f"Kronecker op times {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def kron_phase(torch, port, cli, gs, timer, card, bw, tmp):
    """Phase 8: (a) the CLI runs of ``CLI_KRON`` with both knob settings
    (:func:`kron_cli`), (b) the op times of both forms
    (:func:`kron_op_times`).  The stencil launches of (a)."""
    t0 = time.perf_counter()
    launches = kron_cli(torch, cli, gs, timer, card, tmp)
    kron_op_times(torch, port, card, bw)
    print(f"Kronecker phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- phase 9: the solve loops from captured CUDA graphs ------------------------

# solves per mode and cell after the warm-up, taken in turns (captured,
# eager, eager, captured, captured, eager)
GRAPH_TURNS = 2
# phase 9's captured mode (``solver._graphs``): the captured step replayed
# once per step, with a host read of the guard between replays (the
# earlier design, kept for comparison); phase 10 runs the default, one launch.  A
# profiler trace of a one-launch solve names some kernels that ran inside
# WHILE bodies wrongly (the 2D bench IR: 132 f32 stencils traced against
# 112 f32 and 3 f64 launched, while the graph holds exactly the counted
# nodes), so the trace is held to the counts here, and the one-launch
# solves to their graphs' nodes in phase 10
CAPTURED = "steps"
# the host calls that put work on the card, as the profiler names them
# (a graph's replay is one cudaGraphLaunch)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")


def traced_stencils(kern, D) -> dict:
    """The ``D``-dimensional stencil kernels among the profiler's device
    rows ``kern`` (``kernel_times``), per dtype name: the rows named by the
    kernel's ``__global__`` (``ghost_stencil_2d_kernel<float, ...>``),
    whether launched from the host or from a graph."""
    out = {"float32": 0, "float64": 0}
    for _, count, name in kern:
        if f"ghost_stencil_{D}d_kernel<" in name:
            out["float64" if "_kernel<double" in name else "float32"] += count
    return out


# the driver's node types (CUgraphNodeType) by number
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semaphore_signal",
              9: "ext_semaphore_wait", 10: "mem_alloc", 11: "mem_free",
              12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph, bodies=None) -> tuple:
    """The nodes of a CUDA graph, read from the graph itself through the
    driver API: ``graph`` a captured ``torch.cuda.CUDAGraph`` (one made
    with ``keep_graph=True``, as ``utils.graphs.capture`` makes it) or a
    raw ``CUgraph`` pointer.  Child graphs are descended into; so are
    conditional (WHILE) nodes when ``bodies`` maps their node pointers to
    their body graphs (``GraphLoop.loop_nodes``), else each counts as one
    node.  ``(kernel names, node counts by type name)``."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")])

    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        assert rc == 0, f"{fn} returned CUresult {rc}"

    names, kinds = [], {}

    def walk(g):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
        for node in nodes:
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            name = NODE_TYPES.get(kind.value, str(kind.value))
            kinds[name] = kinds.get(name, 0) + 1
            if kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node),
                     ctypes.byref(child))
                walk(child)
            elif kind.value == 13 and bodies is not None:
                walk(ctypes.c_void_p(bodies[node]))
            elif kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                p = KernelNodeParams()
                call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
                name = ctypes.c_char_p()
                if p.func:
                    call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
                else:
                    call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
                names.append(name.value.decode())

    raw = graph if isinstance(graph, int) else graph.raw_cuda_graph()
    walk(ctypes.c_void_p(raw))
    return names, kinds


def graph_kernel_names(graph, bodies=None) -> list:
    """The mangled names of the kernel nodes of a graph (``graph_nodes``),
    child graphs included, and WHILE bodies with ``bodies``."""
    return graph_nodes(graph, bodies)[0]


def stencil_nodes(names, D) -> dict:
    """The ``D``-dimensional stencil kernels among mangled kernel names,
    per dtype name."""
    out = {"float32": 0, "float64": 0}
    for name in names:
        if f"ghost_stencil_{D}d_kernelI" in name:
            out["float64" if f"ghost_stencil_{D}d_kernelId" in name else "float32"] += 1
    return out


def graph_stencils(graph, D, bodies=None) -> dict:
    """The ``D``-dimensional stencil kernel nodes of a graph
    (``graph_kernel_names``; each WHILE body once with ``bodies``) per
    dtype name: for a captured piece, what one replay launches."""
    return stencil_nodes(graph_kernel_names(graph, bodies), D)


def delta_stencils(delta, D) -> dict:
    """The ``D``-dimensional stencil launches of a captured piece's counts
    (a ``utils.counters.minus``), per dtype name."""
    got = delta.get(f"ghost_stencil.{D}d", {})
    return {dt: got.get(dt, 0) for dt in ("float32", "float64")}


def level_launches(loop) -> dict:
    """Per level of a composed ``utils.graphs.GraphLoop`` (``"root"`` or a
    loop slot): the stencil launches of the pieces directly in it, per
    dimension and dtype name, which the stencil kernel nodes of that
    level's graph (``graph_levels``) must equal."""
    from pressurepoissonsolver_torch.utils import graphs

    out = {}

    def walk(tree, level):
        acc = out.setdefault(level, {D: {"float32": 0, "float64": 0} for D in (2, 3)})
        for item in tree:
            if isinstance(item, graphs._Loop):
                walk(item.body, item.index)
            else:
                for D in (2, 3):
                    for dt, v in delta_stencils(item.launches, D).items():
                        acc[D][dt] += v

    walk(loop.tree, "root")
    return out


def graph_levels(loop) -> dict:
    """Per level of a composed ``utils.graphs.GraphLoop`` (``"root"`` and
    each WHILE body by its loop slot): the stencil kernel nodes per
    dimension and dtype name in that level's graph, child graphs included
    and nested WHILE bodies not (each level's nodes run once per pass of
    its loop), its node counts by type, and the guard kernel nodes."""
    levels = {"root": loop.root, **loop.bodies}
    out = {}
    for level, raw in levels.items():
        names, kinds = graph_nodes(raw)
        out[level] = {"stencils": {D: stencil_nodes(names, D) for D in (2, 3)},
                      "kinds": kinds,
                      "guards": sum("pps_set_conditional" in n for n in names)}
    return out


def profile_launches(torch, gs, solve, D):
    """One solve under ``torch.profiler``, with the launch counts set to 0
    just before it and read just after: ``(wall ms, device busy ms,
    kernels run on the card, host launch calls per LAUNCH_CALLS name,
    stencil kernels in the trace per dtype name, the launch counters)``."""
    from torch.profiler import ProfilerActivity, profile

    from pressurepoissonsolver_torch.utils.profiling import kernel_times

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counters = gs.counters()
    kern = kernel_times(prof)
    calls = {}
    for e in prof.key_averages():
        if e.key in LAUNCH_CALLS:
            calls[e.key] = calls.get(e.key, 0) + int(e.count)
    return (wall_ms, sum(k[0] for k in kern) / 1e3, sum(k[1] for k in kern), calls,
            traced_stencils(kern, D), counters)


def graph_cell(torch, gs, card, label, solver, solve, D, cold=None):
    """One cell of phase 9: ``solve()`` (``(u, counts)``) on ``solver``
    with its loops captured (``CAPTURED``: the per-step replay) and eager:
    a captured first solve (the capture in its wall), an eager one, then ``GRAPH_TURNS`` of each in turns, then
    one profiled solve per mode, every one with the launch counts set to 0
    just before it and read just after; the counts, the iterate (bit for
    bit) and every stencil launch counter must agree between the modes and
    across repeats, the captured graph must hold as many stencil kernel
    nodes as the replay accounting adds per replay, and no profiled trace
    more stencil kernels than counted.  ``cold``: the walls of the first
    solve of a fresh solver per mode, when the caller took them.  The row,
    with ``read_launches``: the stencil launches per dtype name summed
    over every counter read here."""
    rec = {True: {"walls": [], "runs": []}, False: {"walls": [], "runs": []}}
    mib0 = torch.cuda.memory_allocated() / 2**20
    first = None
    for mode in [True, False] + [True, False, False, True, True, False][:2 * GRAPH_TURNS]:
        solver._graphs = CAPTURED if mode else False
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, counts = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if first is None:
            first = wall
            mib = (torch.cuda.memory_allocated() / 2**20,
                   torch.cuda.memory_reserved() / 2**20)
        else:
            rec[mode]["walls"].append(wall)
        rec[mode]["runs"].append((counts, gs.counters()))
        rec[mode]["u"] = u
    runs = rec[True]["runs"] + rec[False]["runs"]
    same = all(r == runs[0] for r in runs)
    equal = torch.equal(rec[True]["u"], rec[False]["u"])
    diff = float((rec[True]["u"] - rec[False]["u"]).abs().max()
                 / rec[False]["u"].abs().max())
    counts, counters = runs[0]
    stencil = dict(counters[D - 2])
    prof = {}
    for mode in (True, False):
        solver._graphs = CAPTURED if mode else False
        prof[mode] = profile_launches(torch, gs, solve, D)
    solver._graphs = True
    read = [r[1] for r in runs] + [prof[m][5] for m in prof]
    traced = {m: prof[m][4] for m in prof}
    entry = next(iter(solver._captured.values()))
    nodes = graph_stencils(entry.graph, D)
    per_step = delta_stencils(entry.launches, D)
    profiled_same = all(prof[m][5] == counters for m in prof)
    read_launches = {dt: sum(c[D - 2][dt] for c in read) for dt in stencil}
    cap_s = sum(e.capture_s for e in solver._captured.values())
    med = {m: statistics.median(rec[m]["walls"]) for m in rec}
    row = {"cell": label, "counts": list(counts), "bit_equal": equal,
           "max_rel_diff": diff, "stencil_launches": stencil,
           "graphs": len(solver._captured), "capture_s": cap_s,
           "first_captured_s": first, "median_s": {"captured": med[True], "eager": med[False]},
           "walls_s": {"captured": rec[True]["walls"], "eager": rec[False]["walls"]},
           "mib_after_capture": mib[0], "mib_reserved_after_capture": mib[1],
           "mib_before": mib0, "traced_stencils": {"captured": traced[True],
                                                   "eager": traced[False]},
           "graph_stencil_nodes": nodes, "accounted_per_replay": per_step,
           "read_launches": read_launches}
    if cold:
        row["cold_s"] = cold
    for m, name in ((True, "captured"), (False, "eager")):
        wall, busy, kernels, calls = prof[m][:4]
        row[f"profile_{name}"] = {"wall_ms": wall, "busy_ms": busy,
                                  "idle_share": 1 - busy / wall, "kernels": kernels,
                                  "host_launch_calls": sum(calls.values()),
                                  "graph_launches": calls.get("cudaGraphLaunch", 0),
                                  "calls": calls}
    pc, pe = row["profile_captured"], row["profile_eager"]
    line = (f"graphs {label} [{card}]: counts {counts} in every solve of both modes "
            f"({same}); iterates bit-equal {equal} (max rel diff {diff:.3e}); stencil "
            f"launches per solve {stencil} in both; median wall s captured / eager "
            f"{med[True]:.6f} / {med[False]:.6f} ({[round(w, 6) for w in rec[True]['walls']]}"
            f" / {[round(w, 6) for w in rec[False]['walls']]}); first captured solve "
            f"{first:.6f} s, capture {cap_s:.3f} s in {len(solver._captured)} graph(s); "
            f"card MiB after capture {mib[0]:.0f} allocated, {mib[1]:.0f} reserved "
            f"({mib0:.0f} before); profiled captured / eager: wall ms {pc['wall_ms']:.3f} / "
            f"{pe['wall_ms']:.3f}, busy ms {pc['busy_ms']:.3f} / {pe['busy_ms']:.3f}, idle "
            f"{100 * pc['idle_share']:.1f}% / {100 * pe['idle_share']:.1f}%, host launch "
            f"calls {pc['host_launch_calls']} ({pc['graph_launches']} graph launches) / "
            f"{pe['host_launch_calls']}, kernels run {pc['kernels']} / {pe['kernels']}; "
            f"launch counters of the profiled solves as the turns' {profiled_same}, stencil "
            f"kernels in their traces captured / eager {traced[True]} / {traced[False]}; "
            f"stencil kernel nodes of the graph {nodes}, accounted per replay {per_step}")
    if cold:
        line += f"; cold first solve s captured / eager {cold['captured']:.6f} / {cold['eager']:.6f}"
    print(line, flush=True)
    assert same and equal and profiled_same, line
    assert sum(stencil.values()) > 0 and len(solver._captured) == 1, line
    # the replay accounting against the graph the card replays: each replay
    # runs every node, so the accounting is exact when the step's recorded
    # launches are the graph's stencil nodes.  The profiler's traces are a
    # lower bound only: they lose a record now and then, in either mode
    # (one of 80 launched in an eager trace), never add one
    assert nodes == per_step and sum(nodes.values()) > 0, line
    assert all(t[dt] <= stencil[dt] for t in traced.values() for dt in stencil), line
    return row


def graph_reads(torch, card, solver, f):
    """The cost of a host read per step against a WHILE node's pass: the
    bench IR's inner BiCGStab captured as a loop of its own
    (``utils.graphs.CapturedLoop``, on ``f`` in f32) and run for 7 steps
    (``tol`` 0, ``max_iter`` 7), 4 times each in turns: its init then 7
    replays of the step with the guard read after each, the same without
    the reads, and one launch of the composed graph (7 WHILE passes); the
    launch counters are set to 0 after (no solve runs)."""
    from pressurepoissonsolver_torch.krylov import bicgstab_loop
    from pressurepoissonsolver_torch.utils.graphs import CapturedLoop

    b = f.to(torch.float32)
    cap = CapturedLoop(bicgstab_loop(solver._fine_low.apply, solver.gmg.apply), b, 0.0, 7)
    cap.b.copy_(b)
    cap.graphs.launch()  # composed and instantiated before the timing
    walls = {}
    for mode in ("read", "noread", "while") * 4:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "while":
            cap.graphs.launch()
        else:
            cap.graphs.init.graph.replay()
            for _ in range(7):
                cap.graph.replay()
                if mode == "read":
                    bool(cap.state.go.item())
        torch.cuda.synchronize()
        walls.setdefault(mode, []).append(time.perf_counter() - t0)
    assert int(cap.state.k) == 7 and int(cap.graphs.runs[0]) == 7
    med = {m: statistics.median(w) for m, w in walls.items()}
    print(f"graphs 7 captured steps [{card}]: median of 4 with a read per step "
          f"{med['read']:.6f} s {[round(w, 6) for w in walls['read']]}, without "
          f"{med['noread']:.6f} s {[round(w, 6) for w in walls['noread']]}, as one launch "
          f"with 7 WHILE passes {med['while']:.6f} s {[round(w, 6) for w in walls['while']]}",
          flush=True)
    gs_reset()
    return med


def reset_counters():
    """Every kernel's launch counter set to 0 (``utils.counters``)."""
    from pressurepoissonsolver_torch.utils import counters

    counters.reset()


def gs_reset():
    """Every launch counter of the port set to 0: the kernels'
    (``utils.counters``) and ``utils.graphs.launches``."""
    from pressurepoissonsolver_torch.utils import graphs

    reset_counters()
    graphs.reset_launches()


# -- phase 10: the solves as one graph launch (WHILE nodes) --------------------

# the modes of a solver's loops (``solver._graphs``) and their names
LOOP_MODES = {True: "one_launch", "steps": "per_step", False: "eager"}
# solves per mode and cell after the first, in turns
LOOP_TURNS = 3
LOOP_ORDER = (True, "steps", False, False, "steps", True, True, "steps", False)
# the GMRES cells' references: the JAX package on the CPU (jax_enable_x64).
# The bench Schur solve with krylov="gmres" (the phase-3 options,
# solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")): iterations
# and relative error; its interface vectors are f64 and its preconditioner
# holds an f32 V-cycle, so the count is held within one.  The JAX CLI
# "--mesh <2D bench mesh> -n 64 -t 1e-10 --solver gmres" (all f64): its
# iterations, held exactly, and error.
GMRES_SCHUR_REF = ((13,), 8.931334605e-07)
GMRES_CLI_REF = ((10,), 8.930985482e-07)
# the JAX references' errors are held within this share
GMRES_ERROR_RTOL = 0.01
# passes of the guard kernel's timing loop
GUARD_PASSES = 1000


def loop_entry(solver):
    """The solver's one composed loop (its only ``_captured`` entry)."""
    (entry,) = solver._captured.values()
    return entry.graphs


def loop_cell(torch, gs, card, label, solver, solve, D, sync_false=None, ref=None,
              f64=True, error=None):
    """One cell of phase 10: ``solve()`` (``(u, counts)``) on ``solver`` in
    the three modes of its loops (one graph launch, the per-step replay,
    eager), a first solve each then ``LOOP_TURNS`` each in turns, every
    solve with every launch counter set to 0 just before it and read just
    after, and the host reads made inside it counted (``krylov.reads``, the
    port's read points).  Held: the counts, the iterate (bit for bit) and
    every stencil launch counter equal across all solves; a one-launch
    solve makes 1 graph launch and 1 host read, the others none; with
    ``sync_false`` (an IR cell) a ``solve_refined(sync=False)`` makes no
    host read inside and gives the same iterate, counts and launches; the
    stencil kernel nodes of every level of the composed graph equal the
    launches the accounting adds per pass of that level (``graph_levels``);
    with ``ref`` ((counts, error) of the JAX reference) the counts exactly
    (``f64``) or within one, and ``error()`` within ``GMRES_ERROR_RTOL`` of
    the reference's.  The passes of the loops inside pieces (the bcgs
    patch solves, ``graphs.inner``) must be equal in every solve too, and
    the stencil kernel nodes of each such loop's pass graph its accounted
    launches.  The row, with the stencil launches, guard runs and passes
    summed over the counters read."""
    from pressurepoissonsolver_torch import krylov
    from pressurepoissonsolver_torch.utils import graphs

    t0 = time.perf_counter()
    mib = (torch.cuda.memory_allocated() / 2**20, torch.cuda.memory_reserved() / 2**20)
    rec = {m: {"walls": [], "runs": []} for m in LOOP_MODES}
    first, u_ref = {}, None
    read = {"stencils": {"float32": 0, "float64": 0}, "guard": 0, "passes": 0}

    def counted(fn):
        gs_reset()
        reads = krylov.reads["host"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        u, counts = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        reads = krylov.reads["host"] - reads
        launched, loops = gs.counters(), dict(graphs.launches)
        loops["inner"] = dict(graphs.inner)
        for dt in read["stencils"]:
            read["stencils"][dt] += launched[D - 2][dt]
        read["guard"] += loops["guard"]
        read["passes"] += loops["passes"]
        return u, counts, launched, loops, reads, wall

    for i, mode in enumerate((True, "steps", False) + LOOP_ORDER[:3 * LOOP_TURNS]):
        solver._graphs = mode
        u, counts, launched, loops, reads, wall = counted(solve)
        if i < 3:
            first[LOOP_MODES[mode]] = wall
        else:
            rec[mode]["walls"].append(wall)
        rec[mode]["runs"].append((counts, launched, loops, reads))
        if u_ref is None:
            u_ref = u
        assert torch.equal(u, u_ref), (label, mode)
    solver._graphs = True
    runs = [r for m in rec for r in rec[m]["runs"]]
    counts, launched = runs[0][:2]
    inner = runs[0][2]["inner"]
    same = all(r[0] == counts and r[1] == launched and r[2]["inner"] == inner for r in runs)
    one = [r[2:] for r in rec[True]["runs"]]
    one_ok = all(lp["graph"] == 1 and rd == 1 and lp["guard"] > lp["passes"] > 0
                 for lp, rd in one)
    others_ok = all(r[2]["graph"] == 0 and r[2]["guard"] == 0
                    for m in ("steps", False) for r in rec[m]["runs"])
    step_reads = rec["steps"]["runs"][0][3]
    # one profiled one-launch solve: what the trace shows of it (reported;
    # its kernel names inside WHILE bodies are not reliable, see CAPTURED)
    wall_ms, busy_ms, kernels, calls, traced, prof_counts = profile_launches(
        torch, gs, solve, D)
    profiled = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                "kernels": kernels, "host_launch_calls": sum(calls.values()),
                "graph_launches": calls.get("cudaGraphLaunch", 0),
                "traced_stencils": traced, "counted_stencils": prof_counts[D - 2]}
    gs_reset()
    gl = loop_entry(solver)
    nosync = None
    if sync_false is not None:
        u2, c2, l2, loops2, reads2, _ = counted(sync_false)
        nosync = {"reads": reads2, "bit_equal": bool(torch.equal(u2, u_ref)),
                  "counts": list(c2), "launches_equal": l2 == launched,
                  "graph_launches": loops2["graph"]}
    levels = graph_levels(gl)
    want = level_launches(gl)
    levels_ok = all(levels[lv]["stencils"] == want[lv] for lv in levels)
    # each loop inside a piece: its pass graph (the body of its WHILE
    # nodes) against its accounted launches
    piece_loops = {slot: (graph_stencils(pl.graph, D), delta_stencils(pl.launches, D))
                   for slot, pl in gl.inner}
    levels_ok = levels_ok and all(a == b for a, b in piece_loops.values())
    allowed = {"kernel", "memcpy", "memset", "graph", "empty", "conditional"}
    kinds_ok = all(set(levels[lv]["kinds"]) <= allowed for lv in levels)
    med = {LOOP_MODES[m]: statistics.median(rec[m]["walls"]) for m in rec}
    row = {"cell": label, "counts": list(counts), "bit_equal": True, "same_counts": same,
           "stencil_launches": launched[D - 2], "host_reads_one_launch": one[0][1],
           "host_reads_per_step": step_reads, "graph_launches_one_launch": one[0][0]["graph"],
           "guard_runs": one[0][0]["guard"], "while_passes": one[0][0]["passes"],
           "median_s": med, "walls_s": {LOOP_MODES[m]: rec[m]["walls"] for m in rec},
           "first_s": first, "capture_s": gl.capture_s, "build_s": gl.build_s,
           "mib_after_build": mib[0], "mib_reserved_after_build": mib[1],
           "levels": {str(lv): {"stencils": levels[lv]["stencils"][D],
                                "accounted": want[lv][D], "kinds": levels[lv]["kinds"],
                                "guards": levels[lv]["guards"]} for lv in levels},
           "sync_false": nosync, "read": read, "profile_one_launch": profiled,
           "patch_passes": inner["passes"], "patch_loop_runs": inner["runs"],
           "largest_patch_loop": inner["largest"], "piece_loop_slots": len(gl.inner)}
    line = (f"loops {label} [{card}]: counts {counts} in every solve of the three modes "
            f"({same}); iterates bit-equal; stencil launches per solve {launched[D - 2]}; "
            f"median wall s one launch / per step / eager {med['one_launch']:.6f} / "
            f"{med['per_step']:.6f} / {med['eager']:.6f} "
            f"({[round(w, 6) for m in rec for w in rec[m]['walls']]}); first solve s "
            f"{first['one_launch']:.6f} / {first['per_step']:.6f} / {first['eager']:.6f}; "
            f"graph launches per one-launch solve {one[0][0]['graph']}, host reads "
            f"{one[0][1]} (per step: {step_reads}); WHILE passes {one[0][0]['passes']}, "
            f"guard runs {one[0][0]['guard']}; capture {gl.capture_s:.3f} s, build "
            f"{gl.build_s:.3f} s; card MiB after the build {mib[0]:.0f} allocated, "
            f"{mib[1]:.0f} reserved; levels (stencil nodes = accounted per pass: "
            f"{levels_ok}; node kinds {kinds_ok}); profiled one-launch solve: wall ms "
            f"{wall_ms:.3f}, busy ms {busy_ms:.3f}, idle {100 * profiled['idle_share']:.1f}%, "
            f"kernels run {kernels}, host launch calls {profiled['host_launch_calls']} "
            f"({profiled['graph_launches']} graph launches), stencil kernels in its trace "
            f"{traced} against {prof_counts[D - 2]} counted; patch passes per solve "
            f"{inner['passes']} in {inner['runs']} runs of {len(gl.inner)} loops inside "
            f"pieces, the largest run {inner['largest']} (pass graphs' stencil nodes = "
            f"accounted: { {k: v[0] == v[1] for k, v in piece_loops.items()} }); levels "
            f"{ {str(lv): (levels[lv]['stencils'][D], levels[lv]['kinds']) for lv in levels} }")
    if nosync is not None:
        line += (f"; sync=False: host reads inside {nosync['reads']}, iterate bit-equal "
                 f"{nosync['bit_equal']}, counts {nosync['counts']}, launches equal "
                 f"{nosync['launches_equal']}")
    if ref is not None:
        err = error(u_ref)
        row["error"], row["reference"] = err, {"counts": list(ref[0]), "error": ref[1]}
        line += (f"; error {err:.9e} against the reference's {ref[1]:.9e}, counts "
                 f"{counts} against {ref[0]}")
    print(line, flush=True)
    print(f"loops {label}: phase 10 cell {time.perf_counter() - t0:.1f} s", flush=True)
    assert same and one_ok and others_ok and step_reads > 1, line
    assert prof_counts[D - 2] == launched[D - 2], line
    assert levels_ok and kinds_ok and sum(launched[D - 2].values()) > 0, line
    if nosync is not None:
        assert (nosync["reads"] == 0 and nosync["bit_equal"] and nosync["launches_equal"]
                and nosync["counts"] == list(counts) and nosync["graph_launches"] == 1), line
    if ref is not None:
        if f64:
            assert tuple(counts) == tuple(ref[0]), line
        else:
            assert all(abs(a - b) <= 1 for a, b in zip(counts, ref[0])), line
        assert abs(row["error"] - ref[1]) <= GMRES_ERROR_RTOL * ref[1], line
    return row


def arnoldi_nodes(solver) -> dict:
    """Graph nodes per Arnoldi step of a GMRES solver's composed loop: the
    node counts by type of its Gram-Schmidt and Givens pieces
    (``graph_nodes`` of each captured piece)."""
    gl = loop_entry(solver)
    out = {}
    for fn, piece in gl.pieces.items():
        name = getattr(fn, "__name__", "")
        if name in ("gram_schmidt", "givens"):
            out[name] = graph_nodes(piece.graph)[1]
    return out


def counter_loop(torch, passes, nodes):
    """A loop of ``passes`` passes of a counter piece (``nodes - 1`` adds on
    a scalar, then ``k + 1`` and ``go = k + 1 < passes``) as a
    ``utils.graphs.GraphLoop`` on the card."""
    from typing import NamedTuple

    from pressurepoissonsolver_torch.krylov import While
    from pressurepoissonsolver_torch.utils import graphs

    class Count(NamedTuple):
        k: object
        x: object
        go: object

    n = torch.full((), passes, dtype=torch.int64, device="cuda")

    def init(n_):
        k = torch.zeros((), dtype=torch.int64, device="cuda")
        return Count(k, torch.zeros((), device="cuda"), k < n_)

    def step(st):
        x = st.x
        for _ in range(nodes - 1):
            x = x + 1
        k = st.k + 1
        return Count(k, x, k < n)

    return graphs.GraphLoop((n,), init, (While(lambda st: st.go, (step,)),),
                            lambda: init(n), step, "cuda")


def guard_timing(torch, card, bw) -> dict:
    """The guard kernel against its plain version: a loop of
    ``GUARD_PASSES`` passes of a counter piece (:func:`counter_loop`, one
    add) as one graph launch (a guard node and the piece per pass) and
    piece by piece (a replay and a host read of the flag per pass), the
    same final state from both, timed with CUDA events, 4 turns each; ms
    per pass, its bound (the guard reads the flag and updates its 8-byte
    counter: 17 bytes) and the difference of the final states.  Then the
    cost of a pass against the body's size: 100 passes of a piece of 1,
    100 and 1,000 kernels, per pass as one launch, piece by piece with a
    host read per pass, and the piece's graph replayed back to back with
    no read."""
    gl = counter_loop(torch, GUARD_PASSES, 2)
    res = {"one": [], "plain": []}
    final = {"one": [], "plain": []}

    def timed(fn, reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for mode in ("one", "plain", "plain", "one") * 2:
        res[mode].append(timed(gl.launch if mode == "one" else gl.replay, GUARD_PASSES))
        final[mode].append((int(gl.state.k), int(gl.state.go)))
    assert int(gl.runs[0]) == GUARD_PASSES
    err = max(abs(a[i] - b[i]) for a in final["one"] for b in final["plain"] for i in (0, 1))
    assert final["one"][0] == (GUARD_PASSES, 0) and err == 0, final
    sweep = {}
    for nodes in (1, 100, 1000):
        sl = counter_loop(torch, 100, nodes)
        sl.launch()
        t = {"one": [], "read": [], "noread": []}

        def noread(sl=sl):
            for _ in range(100):
                sl.graph.replay()

        for mode in ("one", "read", "noread") * 3:
            fn = {"one": sl.launch, "read": sl.replay, "noread": noread}[mode]
            t[mode].append(timed(fn, 100))
        sweep[nodes] = {m: statistics.median(v) for m, v in t.items()}
    gs_reset()
    out = {"ms": statistics.median(res["one"]), "plain_ms": statistics.median(res["plain"]),
           "bound_ms": 1e3 * 17 / bw, "bound_by": "bytes", "max_abs_err": float(err),
           "ms_turns": res["one"], "plain_ms_turns": res["plain"], "body_sweep_ms": sweep}
    print(f"guard kernel [{card}]: {GUARD_PASSES} WHILE passes of a counter piece: "
          f"ms per pass one launch {out['ms']:.6f} ({[round(v, 6) for v in res['one']]}), "
          f"piece by piece with a host read per pass {out['plain_ms']:.6f} "
          f"({[round(v, 6) for v in res['plain']]}); bound {out['bound_ms']:.3e} ms by "
          f"bytes; the same final state in both; ms per pass of a body of n kernels "
          f"(one launch / a read per pass / replays with no read): "
          + "; ".join(f"n={n} {v['one']:.6f} / {v['read']:.6f} / {v['noread']:.6f}"
                      for n, v in sweep.items()), flush=True)
    return out


def graph_phase(torch, port, cli, gs, timer, card, head):
    """Phases 9 (a) and 10 on shared set-ups: per cell of phase 9 (the 2D
    bench IR and Schur solves, the 3D bench IR solve, the CLI's default
    solve on the 2D bench mesh and the production configuration
    (``--shards 0``, one device)) its solves captured and eager
    (:func:`graph_cell`; for the two CLI cells also the wall of the first
    solve of a fresh set-up per mode), then phase 10's cell on the same
    solver (:func:`loop_cell`); then phase 10's GMRES cells: the bench
    Schur solve with ``krylov="gmres"`` and ``apps.steady2d --solver
    gmres`` on the 2D bench mesh.  The stencil launches per dimension and
    dtype, and phase 10's guard runs and passes."""
    t0 = time.perf_counter()
    rows, loop_rows = [], []
    launches = {D: {"float32": 0, "float64": 0} for D in (2, 3)}
    guard = {"launches": 0, "passes": 0}

    def add(D, row, extra=()):
        rows.append(row)
        for dt, c in row["read_launches"].items():
            launches[D][dt] += c + sum(e[dt] for e in extra)

    def add_loop(D, row):
        loop_rows.append(row)
        for dt, c in row["read"]["stencils"].items():
            launches[D][dt] += c
        guard["launches"] += row["read"]["guard"]
        guard["passes"] += row["read"]["passes"]

    solver, f, exact, _ = setup_bench(
        torch, port, card, 2, 5, 2, 64,
        port.CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                       coarse_direct_max_dof=4096))

    def ir(sync=True):
        u, info = solver.solve_refined(f, tol=1e-10, inner_tol=1e-4, sync=sync)
        return u, (int(info["outer_iterations"]), int(info["inner_iterations"]))

    add(2, graph_cell(torch, gs, card, "bench-2d-adaptive-ir", solver, ir, 2))
    add_loop(2, loop_cell(torch, gs, card, "bench-2d-adaptive-ir", solver, ir, 2,
                          sync_false=lambda: ir(sync=False)))
    reads = graph_reads(torch, card, solver, f)
    solver._captured.clear()

    def schur():
        u, res = solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
        return u, (res.iterations,)

    add(2, graph_cell(torch, gs, card, "bench-2d-schur-gmg", solver, schur, 2))
    add_loop(2, loop_cell(torch, gs, card, "bench-2d-schur-gmg", solver, schur, 2))
    solver._captured.clear()
    solver.opts.krylov = "gmres"

    def error(u):
        return solver.report(u, f, exact)["error"]

    add_loop(2, loop_cell(torch, gs, card, "bench-2d-schur-gmres", solver, schur, 2,
                          ref=GMRES_SCHUR_REF, f64=False, error=error))
    nodes = {"bench-2d-schur-gmres": arnoldi_nodes(solver)}
    del solver, f, exact

    solver, f, exact, _ = setup_bench(torch, port, card, 3, 3, 2, 32, port.CycleOpts())

    def ir3(sync=True):
        u, info = solver.solve_refined(f, tol=1e-10, sync=sync)
        return u, (int(info["outer_iterations"]), int(info["inner_iterations"]))

    add(3, graph_cell(torch, gs, card, "bench-3d-fac-ir", solver, ir3, 3))
    add_loop(3, loop_cell(torch, gs, card, "bench-3d-fac-ir", solver, ir3, 3,
                          sync_false=lambda: ir3(sync=False)))
    del solver, f, exact

    cells = (("cli-2d-default", head[2], False),
             ("cli-2d-production-n16", ["--config", PRODUCTION_INI, "--shards", "0"], False),
             ("cli-2d-gmres", head[2] + ["--solver", "gmres"], True))
    for label, argv, gmres_cell in cells:
        _, args = cli.parse_args(2, argv)
        cold, runs, extra = {}, {}, []
        for mode in (False, True)[1 if gmres_cell else 0:]:
            run = cli.setup(2, args, device="cuda", timer=timer.Timer())
            run.solver._graphs = mode
            reset_counters()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cli.solve(run, args, timer.Timer("cuda"))
            torch.cuda.synchronize()
            cold["captured" if mode else "eager"] = time.perf_counter() - t1
            extra.append(gs.counters()[0])
            runs[mode] = run
        run = runs[True]
        runs.clear()

        def cli_solve(run=run, args=args):
            u, res, _, _ = cli.solve(run, args, timer.Timer("cuda"))
            counts = ((res["outer_iterations"], res["inner_iterations"])
                      if isinstance(res, dict) else (res.iterations,))
            return u, counts

        if gmres_cell:
            for e in extra:
                for dt, c in e.items():
                    launches[2][dt] += c

            def cli_error(u, run=run):
                return run.solver.report(u, run.f, run.exact)["error"]

            add_loop(2, loop_cell(torch, gs, card, label, run.solver, cli_solve, 2,
                                  ref=GMRES_CLI_REF, f64=True, error=cli_error))
            nodes[label] = arnoldi_nodes(run.solver)
            print(f"loops GMRES cold first solve s (capture and build in it) "
                  f"{cold['captured']:.6f}", flush=True)
        else:
            run.solver._captured.clear()
            add(2, graph_cell(torch, gs, card, label, run.solver, cli_solve, 2, cold=cold),
                extra)
            sync_false = None
            if args.solver == "ir":
                def sync_false(run=run, args=args):
                    u, info = run.solver.solve_refined(run.f, tol=args.tolerance,
                                                       inner_tol=args.inner_tol, sync=False)
                    return u, (int(info["outer_iterations"]), int(info["inner_iterations"]))
            add_loop(2, loop_cell(torch, gs, card, label, run.solver, cli_solve, 2,
                                  sync_false=sync_false))
        del run
    for row in piece_loop_cells(torch, port, cli, gs, timer, card, head):
        add_loop(2, row)
    print(f"loops GMRES graph nodes per Arnoldi step, by type: {nodes}", flush=True)
    print(json.dumps({"graph_solves": rows}), flush=True)
    print(json.dumps({"loop_solves": loop_rows, "arnoldi_nodes": nodes,
                      "graph_reads_s": reads}), flush=True)
    print(f"graphs and loops phases {time.perf_counter() - t0:.1f} s; phase 10 guard "
          f"runs {guard['launches']}, WHILE passes {guard['passes']}", flush=True)
    assert guard["launches"] > guard["passes"] > 0
    return launches, guard


# phase 10's cells of the loops inside pieces, the monitored solves and the
# assembled-matrix solves.  The small Schur mesh (refined_tree(2, 3, 1),
# n=8, SCHUR_SMALL_GMG, tol 1e-10) with patch_solver="bcgs": per cell the
# options, the entry point and the JAX package's counts and error on the
# CPU (jax_enable_x64): solve with an f64 cycle (the finest level smooths
# with the bcgs patch solves), solve_refined (its f32 cycle's levels are
# spectral) and solve_schur(preconditioner="gmg") with an f32 cycle (the
# Schur operator, its right-hand side and the recovery take the bcgs patch
# solves)
SMALL_BCGS = {
    "small-bcgs-solve": ("float64", "solve", ((6,), 3.5642034504e-3)),
    "small-bcgs-refined": ("float32", "refined", ((3, 7), 3.5642034504e-3)),
    "small-bcgs-schur": ("float32", "schur", ((5,), 3.5642034489e-3)),
}
# the full-width CLI cells on the 2D bench mesh ("--mesh <file> -n 64 -t
# 1e-10" plus the flags): label, flags, the reference ((counts), error) or
# None, and whether the counts are held exactly.  cli-2d-monitor: counts
# (iterations, history length); the JAX CLI's --monitor runs the default
# solve's BiCGStab recurrences (the converged state frozen), so its count
# and error are the default run's.  cli-2d-monitor-cg: the weighted CG's
# history, held to a history of count + 1 entries ending at or below -t
# and to the default run's error within GMRES_ERROR_RTOL.
# cli-2d-schur-pbm: the probed pointer-block operator (the same S as the
# matrix-free Schur solve), held to CLI_BENCH_2D "schur-gmg" within one
# iteration.  cli-2d-bcgs: the CLI defaults with bcgs patch solves (to
# 1e-12 per patch, 500 passes at most); the JAX CLI at this size
# (4,292,608 DOF, a few hundred patch passes per smoothing) is not run on
# a CPU, so the cell is held to the dft run's count and error
# (CLI_BENCH_2D "default"), which the bcgs smoothing reproduces to
# round-off (the small mesh gives 6 iterations and error 3.5642034555e-3
# either way, CLI_SMALL).
FULL_CELLS = (
    ("cli-2d-monitor", ["--monitor"], ((5, 6), CLI_BENCH_2D["default"][2]), True),
    ("cli-2d-monitor-cg", ["--solver", "cg", "--monitor"], None, True),
    ("cli-2d-schur-pbm", ["--schur", "--matrix-type", "pbm"], CLI_BENCH_2D["schur-gmg"][1:],
     False),
    # last: the profile of its solve (over 300,000 kernels) leaves the
    # traces of the cells after it empty
    ("cli-2d-bcgs", ["--patch_solver", "bcgs"], CLI_BENCH_2D["default"][1:], True),
)


def piece_loop_cells(torch, port, cli, gs, timer, card, head):
    """Phase 10's cells (:func:`loop_cell`) of the loops inside pieces
    (``SMALL_BCGS``, cli-2d-bcgs), of the monitored BiCGStab and CG and of
    the assembled-matrix solves (``--matrix-type crs`` on the small mesh,
    ``CLI_SMALL["crs"]``; ``pbm`` at full width), each held to its
    reference; a full-width cell's set-up seconds are printed.  The rows."""
    rows = []
    hier = port.DomainHierarchy(port.refined_tree(2, 3, 1), n=8)
    f, exact = (torch.as_tensor(a, device="cuda")
                for a in port.init_problem(hier.finest, port.get_problem("trig", 2)))
    for label, (pdtype, how, ref) in SMALL_BCGS.items():
        solver = port.PoissonSolver(hier, port.SolveOptions(
            tol=1e-10, dtype=torch.float64, precond_dtype=getattr(torch, pdtype),
            gmg=port.CycleOpts(**SCHUR_SMALL_GMG), patch_solver="bcgs"), device="cuda")

        def small(solver=solver, how=how, sync=True):
            if how == "solve":
                res = solver.solve(f)
                return res.x, (res.iterations,)
            if how == "refined":
                u, info = solver.solve_refined(f, tol=1e-10, inner_tol=1e-4, sync=sync)
                return u, (int(info["outer_iterations"]), int(info["inner_iterations"]))
            u, res = solver.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
            return u, (res.iterations,)

        def error(u, solver=solver):
            return solver.report(u, f, exact)["error"]

        rows.append(loop_cell(
            torch, gs, card, label, solver, small, 2, ref=ref, f64=pdtype == "float64",
            error=error, sync_false=(lambda s=small: s(sync=False)) if how == "refined"
            else None))
    with tempfile.TemporaryDirectory() as tmp:
        mesh = os.path.join(tmp, "small2d.bin")
        port.refined_tree(2, 3, 1).to_file(mesh)
        flags, counts, err = CLI_SMALL["crs"]
        small_cell = ("cli-small-crs", ["--mesh", mesh, "-n", "8", "-t", "1e-10",
                                        "--gmg-coarse-direct-dof", "64"] + flags,
                      (counts, err), True)
        for label, argv, ref, f64 in (small_cell,) + tuple(
                (lb, head[2] + fl, rf, ex) for lb, fl, rf, ex in FULL_CELLS):
            _, args = cli.parse_args(2, argv)
            t0 = time.perf_counter()
            run = cli.setup(2, args, device="cuda", timer=timer.Timer())
            setup_s = time.perf_counter() - t0
            monitored = args.monitor

            def cli_solve(run=run, args=args, monitored=monitored):
                if monitored:  # the CLI's call, without its printed lines
                    u, res, hist = run.solver.solve_monitored(run.f,
                                                              max_iter=args.max_iterations)
                    run.hist = hist
                    return u, (res.iterations, len(hist))
                u, res, _, _ = cli.solve(run, args, timer.Timer("cuda"))
                return u, (res.iterations,)

            def cli_error(u, run=run):
                return run.solver.report(u, run.f, run.exact)["error"]

            row = loop_cell(torch, gs, card, label, run.solver, cli_solve, 2, ref=ref,
                            f64=f64, error=cli_error)
            row["setup_s"] = setup_s
            line = f"loops {label}: set-up {setup_s:.1f} s"
            if monitored:
                row["history_last"] = float(run.hist[-1])
                line += f", history {len(run.hist)} entries, last {run.hist[-1]:.6e}"
            print(line, flush=True)
            if monitored:
                assert len(run.hist) == row["counts"][0] + 1 and run.hist[-1] <= 1e-10, line
            if ref is None:  # the error of the cell's own iterate
                err = row["error"] = cli_error(cli_solve()[0])
                assert abs(err - CLI_BENCH_2D["default"][2]) <= (
                    GMRES_ERROR_RTOL * CLI_BENCH_2D["default"][2]), line
            rows.append(row)
            del run
    return rows


def build_kernels(cuda_build) -> None:
    """Phase 2: one nvcc per kernel library, all started together
    (``cuda_build.build_all``)."""
    from pressurepoissonsolver_torch.utils import graphs

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the seven kernel libraries in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for lib in cuda_build.LIBRARIES:
        info = cuda_build.build_info[lib]
        print(f"  {lib}: nvcc {info['seconds']:.2f} s", flush=True)
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"  graph_loop: CUDA driver / runtime version (cudaDriverGetVersion, "
          f"cudaRuntimeGetVersion) {graphs.cuda_versions()}", flush=True)


def driver_version() -> int:
    """The CUDA driver's version (``cuDriverGetVersion``, which
    ``cudaDriverGetVersion`` returns)."""
    import ctypes

    v = ctypes.c_int(0)
    rc = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(v))
    assert rc == 0, f"cuDriverGetVersion returned {rc}"
    return v.value


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    from pressurepoissonsolver_torch import cli, cuda_build
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.geometry import refined_tree
    from pressurepoissonsolver_torch.gmg import CycleOpts
    from pressurepoissonsolver_torch.ops import ghost_stencil as gs
    from pressurepoissonsolver_torch.problems import get_problem, init_problem
    from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
    from pressurepoissonsolver_torch.utils import profiling, timer

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
    card = profiling.card_line()
    bw = profiling._device_bw("cuda")
    print(f"card: {card}; memory rate {bw:.4g} B/s; CUDA driver version "
          f"{driver_version()} (cuDriverGetVersion)", flush=True)

    # phase 2
    build_kernels(cuda_build)

    # phase 3: 2D (the kernel is checked at the bench solver's shapes)
    solver, f, exact, _ = setup_bench(
        torch, port, card, 2, 5, 2, 64,
        CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                  coarse_direct_max_dof=4096))
    tables = {2: check_kernels(torch, gs, timer, card, bw, 2, stencil_shapes(solver))}
    sweep_table = sweep_kernels(torch, timer, card, bw)
    transfer_table = transfer_kernels(torch, timer, card, bw)
    solve_counts = sweep_solve(torch, port, gs)
    sweep_counts = solve_counts["sweeps"]
    solve_small(torch, port)
    u_ir, launches2 = solve_bench(torch, solver, f, exact, gs, timer, card)
    launches = {2: launches2}
    # the Schur path of bench.py on the same solver
    check_identity(torch, solver, gs, card)
    schur_small(torch, port, gs, card)
    u_schur = solve_bench_schur(torch, solver, f, exact, u_ir, gs, card)
    # phase 7 holds the sharded solves to these
    phase3 = dict(hier_ids=solver.fine_level.pl.ids.copy(), u_ir=u_ir.cpu().numpy(),
                  u_schur=u_schur.cpu().numpy())
    del solver, f, exact, u_ir, u_schur

    # phase 4: 3D, the defaults of scripts/bench3d.py
    solver, f, exact, setup_s = setup_bench(torch, port, card, 3, 3, 2, 32, CycleOpts())
    assert setup_s < 60, f"3D setup took {setup_s:.1f} s"
    tables[3] = check_kernels(torch, gs, timer, card, bw, 3, stencil_shapes(solver))
    solve_small_3d(torch, port)
    launches[3] = solve_bench_3d(torch, solver, f, exact, gs, timer, card)
    del solver, f, exact
    schur_small_3d(torch, port, gs, card)
    width1_ms(torch, gs, timer, card)

    # phase 5: the command-line apps, in-process
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        head, phase5 = cli_bench(torch, port, cli, gs, timer, card, tmp)
        cli_small(torch, port, cli, gs, card, tmp)
        print(f"CLI phase {time.perf_counter() - t0:.1f} s", flush=True)

        # phase 6: the bench scripts, the op report, the native tables
        bench_phase(torch, port, gs, card, tmp, tables[2]["float32"]["warm_ms"])

        # phase 7: the patch-sharded solve, each part driven with the
        # launch counts set to 0 just before it and read just after
        sharded, nogf, nogf_table, faces_table = sharded_phase(
            torch, port, cli, gs, timer, card, bw, tmp, head=head, phase5=phase5,
            **phase3)
        for D in (2, 3):
            for name, cnt in sharded[D].items():
                launches[D][name] += cnt

        # phase 8: the Kronecker forms, the CLI runs driven as in phase 5
        for D, per in kron_phase(torch, port, cli, gs, timer, card, bw, tmp).items():
            for name, cnt in per.items():
                launches[D][name] += cnt

        # phases 9 (a) and 10: the solve loops captured against eager, then
        # as one graph launch against the per-step replay and eager, each
        # solve driven with the launch counts set to 0 just before it
        per_phase, guard = graph_phase(torch, port, cli, gs, timer, card, head)
        for D, per in per_phase.items():
            for name, cnt in per.items():
                launches[D][name] += cnt
    # phase 10 (b): the guard kernel against its plain version
    guard_table = guard_timing(torch, card, bw)

    # phase 11
    kernels = [
        {
            "name": f"ghost_stencil_{D}d_{name}",
            "route": "cuda",
            "source": SOURCES[D],
            "replaces": REPLACES[D],
            "launches": launches[D][name],
            **tables[D][name],
            # the no-gf mode (the halo apply's base stencil): its launches
            # are counted in "launches" too
            "nogf_launches": nogf[D][name],
            **nogf_table[D][name],
        }
        for D in (2, 3)
        for name in ("float32", "float64")
    ] + [
        {
            "name": f"ghost_faces_{D}d_{name}",
            "route": "cuda",
            "source": FACES_SOURCE,
            "replaces": FACES_REPLACES,
            **faces_table[D][name],
        }
        for D in (2, 3)
        for name in ("float32", "float64")
    ] + [
        {
            "name": "graph_loop_guard",
            "route": "cuda",
            "source": GUARD_SOURCE,
            "replaces": GUARD_REPLACES,
            # the guard's runs in phase 10 (one ahead of each entry of a
            # WHILE node, one per pass) and the passes
            "launches": guard["launches"],
            "while_passes": guard["passes"],
            **{k: v for k, v in guard_table.items()
               if not k.endswith("_turns") and k != "body_sweep_ms"},
            "library_ms": None,
        }
    ] + [
        {
            "name": "patch_sweep_float32",
            "route": "cuda",
            "source": SWEEP_SOURCE,
            "replaces": SWEEP_REPLACES,
            # the sweeps of the main-path solve at n=16 (sweep_solve)
            "launches": sweep_counts["kernel"]["float32"],
            "plain_launches": sweep_counts["plain"]["float32"],
            # cold, at the d4 cell's level-0 shape; every shape below
            "ms": sweep_table["d4-L0"]["kernel_ms"],
            "warm_ms": sweep_table["d4-L0"]["kernel_warm_ms"],
            "plain_ms": sweep_table["d4-L0"]["plain_ms"],
            "bound_ms": sweep_table["d4-L0"]["bound_ms"],
            "max_abs_err": sweep_table["d4-L0"]["max_abs_err"],
            "shapes": sweep_table,
        }
    ] + [
        {
            "name": f"transfer_{op}_float32",
            "route": "cuda",
            "source": TRANSFER_SOURCE,
            "replaces": TRANSFER_REPLACES,
            # the transfers of the main-path solve at n=16 (sweep_solve),
            # restrictions and prolong-adds together
            "launches": solve_counts["transfers"]["kernel"]["float32"],
            "plain_launches": solve_counts["transfers"]["plain"]["float32"],
            # cold, at the d4 cell's first transfer; every shape below
            "ms": transfer_table["d4-T0"][op]["kernel_ms"],
            "warm_ms": transfer_table["d4-T0"][op]["kernel_warm_ms"],
            "plain_ms": transfer_table["d4-T0"][op]["plain_ms"],
            "bound_ms": transfer_table["d4-T0"][op]["bound_ms"],
            "shapes": {label: row[op] for label, row in transfer_table.items()},
        }
        for op in ("restrict", "prolong")
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

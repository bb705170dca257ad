"""Command-line driver (the reference ``steady`` apps), on one device.

Port of ``pressurepoissonsolver_tpu.cli`` with the same flags, checks,
printed lines and output files: mesh file + uniform divides, problem
selection, BC choice, solver/preconditioner/patch-solver selection, the
GMG cycle options, tolerance, outputs, and ini config read/write
(``apps/2d/steady.cpp:70-200``, ``apps/3d/steady.cpp:74-200``).  The solve
runs on the CUDA card unless ``main`` is given another ``device``.

``--shards N`` runs the solve patch-sharded over N ranks, one per device,
through the cut-face halo engine (``--comm auto|halo``) or the gathered
engine (``--comm pjit``, whose ops all-gather their operands): launch it
as ``torchrun --nproc-per-node N -m
pressurepoissonsolver_torch.apps.steady2d --shards N ...``; ``--shards 1``
without ``torchrun`` starts a one-rank group of its own.  Rank 0 alone
prints and writes the outputs.  :func:`parse_args`, :func:`setup` and
:func:`solve` are the steps of :func:`main`, for callers that drive or
time a step alone.
"""

from __future__ import annotations

import argparse
import configparser
import contextlib
import json
import os
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from .domain import DomainHierarchy
from .geometry import Tree, uniform_tree
from .gmg import CycleOpts
from .matrix import assemble_composite, assemble_schur, bcoo_matvec, pbm_matvec
from .parallel.sharding import local_device, make_mesh
from .problems import get_problem, init_problem
from .solver import PoissonSolver, SolveOptions
from .utils.timer import Timer
from .utils.writers import write_claw, write_vtk


def build_parser(D: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Solve the {D}D steady Poisson problem "
        "(PyTorch/CUDA pressurePoissonSolver)"
    )
    p.add_argument("--mesh", type=str, default=None, help="mesh tree file (.bin)")
    p.add_argument("--uniform", type=int, default=None, metavar="L",
                   help="use a uniform tree with L levels instead of a mesh file")
    p.add_argument("-n", type=int, default=16, help="cells per patch side")
    p.add_argument("--divide", type=int, default=0, help="extra uniform refinements")
    p.add_argument("--neumann", action="store_true", help="Neumann BCs on all walls")
    p.add_argument("--neumann-sides", type=str, default=None, metavar="SIDES",
                   help="comma-separated walls with Neumann BCs, e.g. "
                   "'x_lo,y_hi' — the rest stay Dirichlet (per-side "
                   "IsNeumannFunc parity, PatchInfo.h:684-697)")
    p.add_argument("--schur", action="store_true",
                   help="solve the Schur-complement interface system")
    p.add_argument("--problem", type=str, default="trig",
                   help="trig|gauss|zero|circle|'trig gauss' (2D) / trig|gauss|zero (3D)")
    p.add_argument("--solver", type=str, default="bicgstab",
                   choices=["bicgstab", "cg", "gmres", "ir"],
                   help="Krylov method; 'ir' = mixed-precision iterative "
                   "refinement (f32 inner Krylov + f64 residual updates)")
    p.add_argument("--inner-solver", type=str, default="cg",
                   choices=["cg", "bicgstab", "richardson"],
                   help="inner Krylov method of the ir solver")
    p.add_argument("--prec", type=str, default="GMG",
                   choices=["GMG", "Schwarz", "cheb", "BlockJacobi", "none"],
                   help="preconditioner (cheb/BlockJacobi apply to --schur; "
                   "GMG preconditions the composite solve, or with --schur "
                   "the interface system via the Woodbury identity "
                   "(I-S)^-1 = I - trace(GMG(inject(.))))")
    p.add_argument("--patch_solver", type=str, default="dft",
                   choices=["dft", "fftw", "bcgs"],
                   help="per-patch solver (fftw is an alias of the spectral dft)")
    p.add_argument("--iface-interp", dest="iface_interp", type=str,
                   default="bilinear", choices=["bilinear", "quadratic"],
                   help="refinement-boundary closure (quadratic = the 2D "
                   "higher-order StencilHelper2d closures)")
    p.add_argument("--matrix-type", dest="matrix_type", type=str, default="wrap",
                   choices=["wrap", "crs", "pbm"],
                   help="operator form: matrix-free ('wrap'), assembled "
                   "CRS SpMV ('crs'), or the pointer-block Schur operator "
                   "('pbm', --schur only; reference Experimental/PBMatrix)")
    p.add_argument("--shards", type=int, default=0,
                   help="shard the solve over this many ranks, one per device "
                   "(0 = single device; N > 1: launch with torchrun "
                   "--nproc-per-node N)")
    p.add_argument("--comm", type=str, default="auto",
                   choices=["auto", "pjit", "halo"],
                   help="multi-device communication schedule (with --shards); "
                   "auto = halo, the cut-face exchange; pjit = each op "
                   "all-gathers its operand")
    p.add_argument("-t", "--tolerance", type=float, default=1e-12)
    p.add_argument("--max_iterations", type=int, default=1000)
    p.add_argument("--dtype", type=str, default="float64",
                   choices=["float64", "float32", "mixed"])
    p.add_argument("--nozerof", action="store_true",
                   help="do not shift f to zero mean for Neumann")
    # GMG cycle options (reference GMG subcommand)
    p.add_argument("--gmg-max-levels", type=int, default=0)
    p.add_argument("--gmg-patches-per-shard", type=float, default=0)
    p.add_argument("--gmg-pre-sweeps", type=int, default=1)
    p.add_argument("--gmg-post-sweeps", type=int, default=1)
    p.add_argument("--gmg-mid-sweeps", type=int, default=1)
    p.add_argument("--gmg-coarse-sweeps", type=int, default=1)
    p.add_argument("--gmg-cycle-type", type=str, default="V", choices=["V", "W"])
    p.add_argument("--gmg-fac-smoothing", type=str, default="full",
                   choices=["full", "active"],
                   help="relax whole coarse levels (reference behavior) or "
                   "only the FAC active set (newly-coarsened region)")
    p.add_argument("--gmg-fac-ring", type=int, default=1,
                   help="rings of neighbors around the active set to relax")
    p.add_argument("--gmg-coarse-direct-dof", type=int, default=4096,
                   help="stop the hierarchy and solve directly (dense "
                   "inverse) once a level has at most this many DOF; 0 "
                   "disables the direct coarse solve")
    p.add_argument("--inner-tol", type=float, default=1e-5,
                   help="inner Krylov relative tolerance of the ir solver")
    p.add_argument("--gmg-interpolator", type=str, default="constant",
                   choices=["constant", "linear"],
                   help="interlevel prolongation (DrctIntp / TriLinIntp)")
    # outputs
    p.add_argument("--out-claw", type=str, default=None, metavar="DIR",
                   help="write Clawpack fort.* output to DIR (2D)")
    p.add_argument("--out-vtk", type=str, default=None, metavar="PATH",
                   help="write VTK multiblock output to PATH.vtm")
    p.add_argument("--out-json", type=str, default=None,
                   help="write solve metrics to a JSON file")
    p.add_argument("--out-matrix", type=str, default=None,
                   help="write the assembled operator (scipy .npz CSR)")
    p.add_argument("--out-rhs", type=str, default=None,
                   help="write the RHS vector (.npy)")
    p.add_argument("--out-gamma", type=str, default=None,
                   help="write the interface (gamma) vector (.npy): the "
                   "converged gamma with --schur, else the interpolated "
                   "traces of the solution (apps/3d/steady.cpp:570-574)")
    p.add_argument("--config", type=str, default=None, help="read options from ini file")
    p.add_argument("--output-config", type=str, default=None,
                   help="write the effective options to an ini file")
    p.add_argument("--loop", type=int, default=1, help="repeat the solve N times")
    p.add_argument("--monitor", action="store_true",
                   help="print the per-iteration relative residual norms "
                   "(bicgstab/cg/gmres: per Krylov iteration; ir: per "
                   "outer refinement round)")
    return p


def apply_config_file(parser: argparse.ArgumentParser, args, path: str, argv=None):
    """Load defaults from an ini file, then re-parse so CLI flags win."""
    cp = configparser.ConfigParser()
    cp.read(path)
    defaults = {}
    for section in cp.sections():
        for k, v in cp.items(section):
            defaults[k.replace("-", "_")] = v
    if cp.defaults():
        for k, v in cp.defaults().items():
            defaults[k.replace("-", "_")] = v
    parser.set_defaults(**{k: _coerce(parser, k, v) for k, v in defaults.items()
                           if hasattr(args, k)})
    return parser.parse_args(argv)


def _coerce(parser, key, val):
    for a in parser._actions:
        if a.dest == key:
            if a.type is int:
                return int(val)
            if a.type is float:
                return float(val)
            if isinstance(a.const, bool) or a.nargs == 0:
                return val.lower() in ("1", "true", "yes", "on")
            return val
    return val


def write_config_file(args, path: str) -> None:
    cp = configparser.ConfigParser()
    cp["solve"] = {
        k.replace("_", "-"): str(v)
        for k, v in vars(args).items()
        if v is not None and k not in ("config", "output_config")
    }
    with open(path, "w") as f:
        cp.write(f)


def parse_args(D: int, argv=None):
    """Parse ``argv`` (with ``--config`` defaults), write ``--output-config``
    and reject the invalid combinations, as the reference does
    (``apps/3d/steady.cpp:389-392``); returns ``(parser, args)``."""
    parser = build_parser(D)
    args = parser.parse_args(argv)
    if args.config:
        args = apply_config_file(parser, args, args.config, argv)
    if args.output_config:
        write_config_file(args, args.output_config)

    if args.iface_interp == "quadratic" and D != 2:
        parser.error("--iface-interp quadratic is 2D only "
                     "(reference StencilHelper2d)")
    if args.prec in ("cheb", "BlockJacobi") and not args.schur:
        parser.error(
            f"--prec {args.prec} preconditions the Schur interface system; "
            "it requires --schur"
        )
    if args.solver == "ir" and args.schur:
        parser.error("--solver ir applies to the composite solve, not --schur")
    if args.prec == "Schwarz" and args.schur:
        parser.error("--prec Schwarz applies to the composite solve, not --schur")
    if args.monitor and args.matrix_type == "crs":
        parser.error("--monitor applies to the matrix-free paths")
    if args.matrix_type == "crs" and args.solver == "ir":
        parser.error(
            "--matrix-type crs is not implemented for --solver ir "
            "(the IR outer loop is matrix-free); drop one of the two"
        )
    if args.matrix_type == "pbm" and not args.schur:
        parser.error(
            "--matrix-type pbm is the pointer-block form of the probed "
            "Schur matrix (reference Experimental/PBMatrix); it requires "
            "--schur"
        )
    if args.matrix_type == "pbm" and args.shards:
        parser.error(
            "--matrix-type pbm is single-device only (unsharded gamma "
            "layout); drop --shards or use the matrix-free Schur path"
        )
    if args.matrix_type == "crs" and args.schur and args.shards:
        parser.error(
            "--matrix-type crs with --schur is single-device only (the "
            "assembled interface system uses the unsharded gamma layout); "
            "drop --shards or use the matrix-free Schur path"
        )
    if args.shards:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if args.shards != world:
            parser.error(
                f"--shards {args.shards} but the world has {world} rank(s); "
                f"launch with torchrun --nproc-per-node {args.shards}")
    if args.neumann and args.neumann_sides:
        parser.error("--neumann and --neumann-sides are exclusive")
    return parser, args


def setup(D: int, args, *, device, timer: Timer, mesh=None) -> SimpleNamespace:
    """The timed set-up sections of a run: the hierarchy, the solver (on
    ``mesh`` with ``--shards``), the global right-hand side and exact
    solution on ``device`` (f shifted to zero mean under ``--neumann``),
    and the assembled operators of ``--matrix-type crs|pbm``."""
    timer.start("Domain Initialization")
    if args.mesh:
        tree = Tree.from_file(args.mesh, D)
    else:
        tree = uniform_tree(D, args.uniform or 3)
    for _ in range(args.divide):
        tree.refine_leaves()
    neumann_spec = args.neumann
    if args.neumann_sides:
        neumann_spec = [t.strip() for t in args.neumann_sides.split(",") if t.strip()]
    hierarchy = DomainHierarchy(tree, n=args.n, neumann=neumann_spec,
                                num_shards=args.shards or 1)

    gmg_opts = CycleOpts(
        max_levels=args.gmg_max_levels,
        patches_per_shard=args.gmg_patches_per_shard,
        pre_sweeps=args.gmg_pre_sweeps,
        post_sweeps=args.gmg_post_sweeps,
        mid_sweeps=args.gmg_mid_sweeps,
        coarse_sweeps=args.gmg_coarse_sweeps,
        cycle_type=args.gmg_cycle_type,
        interpolator=args.gmg_interpolator,
        fac_smoothing=args.gmg_fac_smoothing,
        fac_active_ring=args.gmg_fac_ring,
        coarse_direct=args.gmg_coarse_direct_dof > 0,
        coarse_direct_max_dof=args.gmg_coarse_direct_dof or 4096,
    )
    dtype = torch.float32 if args.dtype == "float32" else torch.float64
    pdtype = torch.float32 if args.dtype in ("float32", "mixed") else torch.float64
    if args.solver == "ir":
        dtype, pdtype = torch.float64, torch.float32
    prec_map = {"GMG": "gmg", "Schwarz": "schwarz", "cheb": "none",
                "BlockJacobi": "none", "none": "none"}
    opts = SolveOptions(
        tol=args.tolerance,
        max_iter=args.max_iterations,
        gmg=gmg_opts,
        precondition=(args.prec == "GMG" and not args.schur),
        preconditioner="none" if args.schur else prec_map[args.prec],
        krylov="bicgstab" if args.solver == "ir" else args.solver,
        inner_krylov=args.inner_solver,
        patch_solver="dft" if args.patch_solver == "fftw" else args.patch_solver,
        dtype=dtype,
        precond_dtype=pdtype,
        comm=args.comm,
        iface_scheme=args.iface_interp,
    )
    timer.stop("Domain Initialization")

    name = "GMG Setup" if args.prec == "GMG" else "Preconditioner Setup"
    timer.start(name)
    solver = PoissonSolver(hierarchy, opts, mesh=mesh, device=device)
    timer.stop(name)

    timer.start("Linear System Setup")
    # BC folding is derived per patch side from the level's Neumann table
    f_np, exact_np = init_problem(hierarchy.finest, get_problem(args.problem, D))
    f = torch.as_tensor(f_np, dtype=dtype, device=device)
    exact = torch.as_tensor(exact_np, dtype=dtype, device=device)
    if args.neumann and not args.nozerof:
        fdiff = float(solver._op.integrate(solver._as_field(f)) / solver._op.volume)
        print(f"Fdiff: {fdiff}")
        f = f - fdiff

    crs_A = crs_S = None
    if args.matrix_type == "crs":
        timer.start("Matrix Formation")
        if args.schur:
            crs_S = bcoo_matvec(assemble_schur(solver.fine_level), dtype=dtype,
                                device=device)
        else:
            crs_A = bcoo_matvec(
                assemble_composite(hierarchy.finest, scheme=args.iface_interp),
                dtype=dtype, device=device,
            )
        timer.stop("Matrix Formation")
    elif args.matrix_type == "pbm":
        timer.start("Matrix Formation")
        crs_S = pbm_matvec(solver.fine_level)
        timer.stop("Matrix Formation")
    timer.stop("Linear System Setup")
    return SimpleNamespace(hierarchy=hierarchy, solver=solver, f=f, exact=exact,
                           crs_A=crs_A, crs_S=crs_S)


def _solve_crs(solver, f, A_mv, args):
    """Composite solve through the assembled CRS operator
    (reference ``--matrix_type crs``, ``apps/3d/steady.cpp:364-379``); with
    ``--shards`` the global matrix multiplies the gathered vector and each
    rank keeps its rows."""
    M = solver._preconditioner()
    f = solver._as_field(f)
    if solver.mesh is not None:
        op, mv = solver._op, A_mv

        def A_mv(x):
            return op.local_rows(mv(op.gather(x)))

    method = args.solver if args.solver in ("cg", "gmres") else "bicgstab"
    weight = solver._volume_weight(solver.opts.dtype) if method == "cg" else None
    return solver.solve_matrix("crs", A_mv, f, method, M=M, weight=weight,
                               tol=args.tolerance, max_iter=args.max_iterations)


def _print_monitor(hist) -> None:
    """Per-iteration relative residual norms (the --monitor output)."""
    for k, r in enumerate(hist):
        print(f"  iter {k:4d}  rel residual {float(r):.6e}")


def _solve_schur_crs(solver, f, S_mv, args, schur_prec):
    """Schur interface solve through the assembled (probed) Schur matrix
    (reference ``SchurMatrixHelper``, ``apps/3d/steady.cpp:364-367``)."""
    M = solver._schur_preconditioner(schur_prec)
    method = "gmres" if args.solver == "gmres" else "bicgstab"
    prepare, finish = solver._schur_ends()
    res, u = solver.solve_matrix(f"schur-{args.matrix_type}", S_mv, f, method, M=M,
                                 tol=args.tolerance, max_iter=args.max_iterations,
                                 prepare=prepare, finish=finish)
    return u, res


def solve(run: SimpleNamespace, args, timer: Timer):
    """One timed linear solve of a :func:`setup` ``run`` with the method
    ``args`` selects (printing the ``--monitor`` lines); returns ``(u,
    result, iter_line, gamma)``: ``result`` the ``KrylovResult`` or, for
    ``--solver ir``, the info dict; ``gamma`` the interface vector of a
    ``--schur`` solve, else ``None``."""
    solver, f = run.solver, run.f
    gamma = None
    timer.start("Linear Solve")
    if args.schur:
        schur_prec = {"cheb": "cheb", "BlockJacobi": "blockjacobi",
                      "GMG": "gmg"}.get(args.prec)
        if run.crs_S is not None:
            u, res = _solve_schur_crs(solver, f, run.crs_S, args, schur_prec)
        elif args.monitor:
            u, res, hist = solver.solve_monitored(
                f, max_iter=args.max_iterations, schur=True,
                schur_preconditioner=schur_prec,
            )
            _print_monitor(hist)
        else:
            u, res = solver.solve_schur(f, preconditioner=schur_prec)
        timer.stop("Linear Solve")
        # recover u from the converged interface values — the section the
        # reference times as "Patch Solve" (apps/3d/steady.cpp:433-439)
        timer.start("Patch Solve")
        gamma = res.x
        u = solver._op.patch_solve(solver._as_field(f), res.x)
        timer.stop("Patch Solve")
        return u, res, f"Iterations: {res.iterations}", gamma
    if args.solver == "ir":
        u, info = solver.solve_refined(f, tol=args.tolerance, inner_tol=args.inner_tol)
        timer.stop("Linear Solve")
        if args.monitor:
            # per-outer-round relative residuals (inner iterations are
            # aggregated in the count below)
            for k, r in enumerate(info["outer_history"]):
                print(f"  outer {k:3d}  rel residual {float(r):.6e}")
        return u, info, (f"Iterations: {info['outer_iterations']} outer / "
                         f"{info['inner_iterations']} inner"), None
    if run.crs_A is not None:
        res = _solve_crs(solver, f, run.crs_A, args)
    elif args.monitor:
        _, res, hist = solver.solve_monitored(f, max_iter=args.max_iterations)
        _print_monitor(hist)
    else:
        res = solver.solve(f)
    timer.stop("Linear Solve")
    return res.x, res, f"Iterations: {res.iterations}", None


def main(D: int, argv=None, *, device="cuda") -> int:
    """Run the CLI with ``argv`` (``sys.argv[1:]`` when None) on
    ``device``; with ``--shards`` on this rank's card when ``device`` names
    none (``cuda:<LOCAL_RANK>``; it raises without a card).  A process group this call starts (the
    one-rank group of ``--shards 1`` without ``torchrun``) ends with it."""
    _, args = parse_args(D, argv)
    mesh, own_group = None, False
    if args.shards:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            device = local_device()
        own_group = not dist.is_initialized()
        mesh = make_mesh(args.shards)
    try:
        if mesh is not None and dist.get_rank() != 0:
            with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
                return _run(D, args, device, mesh, write=False)
        return _run(D, args, device, mesh, write=True)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(D: int, args, device, mesh, write: bool) -> int:
    """The set-up, solves, report and outputs of :func:`main`; the outputs
    are written only when ``write`` (rank 0)."""
    timer = Timer(device)
    run = setup(D, args, device=device, timer=timer, mesh=mesh)
    hierarchy, solver, f, exact = run.hierarchy, run.solver, run.f, run.exact

    rep = {}
    for _loop in range(args.loop):
        u, res, iter_line, gamma_out = solve(run, args, timer)
        print(iter_line)
        rep = solver.report(u, f, exact, neumann=args.neumann)

    print(f"Error: {rep['error']:.13e}")
    print(f"Residual: {rep['residual']:.13e}")
    print(f"ΣAu-Σf: {rep['conservation']:.13e}")
    print(f"Total cells: {hierarchy.finest.num_cells}")

    resid_arr = f - solver.gather(solver.apply(u))
    u = solver.gather(u)
    if args.out_gamma:
        if gamma_out is None:  # composite path: interpolate the traces of u
            gamma_out = solver._op.interpolate(solver._as_field(u))
        gamma_out = (solver._op.gamma_global(gamma_out) if mesh is not None
                     else gamma_out.cpu().numpy())
    if not write:
        return 0
    if args.out_claw and D == 2:
        write_claw(hierarchy.finest, u, resid_arr, args.out_claw)
    if args.out_vtk:
        write_vtk(
            hierarchy.finest,
            {
                "Solution": u,
                "Error": exact - u,
                "Residual": resid_arr,
                "RHS": f,
                "Exact": exact,
            },
            args.out_vtk,
        )
    if args.out_matrix:
        sp.save_npz(args.out_matrix, assemble_composite(hierarchy.finest))
    if args.out_rhs:
        np.save(args.out_rhs, f.cpu().numpy())
    if args.out_gamma:
        np.save(args.out_gamma, gamma_out)
    if args.out_json:
        if args.solver == "ir":
            iters = {
                "outer_iterations": res["outer_iterations"],
                "inner_iterations": res["inner_iterations"],
            }
        else:
            iters = {"iterations": res.iterations}
        with open(args.out_json, "w") as fh:
            json.dump(
                {
                    **iters,
                    **rep,
                    "dof": hierarchy.finest.num_cells,
                    "linear_solve_s": timer["Linear Solve"],
                },
                fh,
            )
    print(timer)
    return 0

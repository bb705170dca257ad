"""Spawned ``torch.distributed`` worlds for the sharded parity tests.

A test module starts its world once (:class:`World`): ``k`` processes
from the ``spawn`` context, each on the CPU under gloo, rendezvousing
through a ``FileStore`` in the test's temporary directory.  Each rank runs
one battery of this module on the same inputs (made from numpy seeds) and
pickles what it returns; the parent reads the results and the test
functions assert on them.  This module and the batteries import torch,
numpy and the port only: no JAX, so the children never start it.
"""

import contextlib
import io
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# per rank, how long the parent waits for the world (s)
TIMEOUT = 240


def _child(rank, world, tmp, battery, kw):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        from pressurepoissonsolver_torch.parallel.sharding import make_mesh

        mesh = make_mesh(world)
        out = BATTERIES[battery](mesh, tmp, **kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


class World:
    """``battery(mesh, tmp, **kw)`` started on ``world`` spawned gloo
    ranks; :meth:`wait` returns every rank's result, in rank order, and
    raises when a rank fails or the world hangs.  The parent is free to
    work (the reference's side) until it waits."""

    def __init__(self, world, tmp, battery, **kw):
        self.world, self.tmp = world, str(tmp)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_child, args=(r, world, self.tmp, battery, kw))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def close(self):
        """Kill the ranks still running; the processes that were."""
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        return alive

    def wait(self):
        for p in self.procs:
            p.join(TIMEOUT)
        alive = self.close()
        codes = [p.exitcode for p in self.procs]
        if alive or any(codes):
            raise RuntimeError(f"world of {self.world}: exit codes {codes}")
        out = []
        for r in range(self.world):
            with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def run_world(world, tmp, battery, **kw):
    """:class:`World` ``(world, tmp, battery, **kw).wait()``."""
    return World(world, tmp, battery, **kw).wait()


def trees():
    """The small meshes of the batteries (built in code)."""
    from pressurepoissonsolver_torch.geometry import refined_tree

    return {"2d": refined_tree(2, 3, 1), "3d": refined_tree(3, 2, 1),
            "2d-deep": refined_tree(2, 4, 2)}


def field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _np(x):
    return x.detach().cpu().numpy()


def _tables(sl):
    """The host tables of a ShardedLevel the reference also has."""
    ex = {name: {"offsets": list(e.offsets), "widths": list(e.widths),
                 "comm_rows": e.comm_rows, "buf_rows": e.buf_rows,
                 "send_tbl": [t.copy() for t in e.send_tbl]}
          for name, e in (("faces", sl.exchange), ("gamma", sl.ex_gamma))}
    return {"exchange": ex, "owned_ids": sl._owned_ids, "NOg": sl.NOg, "NIg": sl.NIg,
            "NRg": sl.NRg, "comm_rows": sl.comm_rows,
            **{k: getattr(sl, k).copy() for k in (
                "_own_pos", "_gifidx", "_ifidx", "_imask", "_gfsrc", "_gfw_own",
                "_gfw_mix")}}


def tensor_bytes(obj, skip=("base", "mesh", "comm")) -> int:
    """Bytes of the distinct storages of the tensors ``obj`` holds: its
    attributes, through lists, tuples, dicts and the port's own objects,
    less the attributes named in ``skip``."""
    seen, objs = set(), set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                return st.nbytes()
            return 0
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if type(x).__module__.startswith("pressurepoissonsolver_torch") and id(x) not in objs:
            objs.add(id(x))
            return sum(walk(v) for k, v in vars(x).items() if k not in skip)
        return 0

    return walk(obj)


def level_battery(mesh, tmp, n=8):
    """The halo engine's level, transfer and smoother ops at the world's
    size, each on the same inputs as the reference's single-device ops;
    every result gathered to the global layout."""
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.gmg import Transfer
    from pressurepoissonsolver_torch.ops.level_ops import Level
    from pressurepoissonsolver_torch.parallel import halo
    from pressurepoissonsolver_torch.parallel.partition import block_partition, cut_faces
    from pressurepoissonsolver_torch.parallel.sharding import shard_patch_array

    k = mesh.size()
    tr = trees()
    out = {}
    cpu = torch.device("cpu")

    def level(h, i=0):
        return Level(h[i], dtype=torch.float64, device=cpu)

    def loc(x, sl):
        return shard_patch_array(x, sl.mesh).clone()

    # 2D: refined_tree(2, 3, 1) at n, Dirichlet and all-Neumann walls
    for neumann in (False, True):
        key = "2d-neumann" if neumann else "2d"
        # the Python builder, as the reference's side (the native tables
        # number the interfaces in the unsharded slot order)
        h = DomainHierarchy(tr["2d"], n=n, neumann=neumann, num_shards=k,
                            use_native=False)
        lvl = level(h)
        sl = halo.ShardedLevel(lvl, mesh)
        P = lvl.P
        u, f = field(11, (P, n, n)), field(1, (P, n, n))
        res = {"tables": _tables(sl),
               "bytes": (tensor_bytes(sl), tensor_bytes(lvl)),
               "cuts": cut_faces(h.finest, block_partition(P, k)),
               "apply": _np(sl.gather(sl.apply(loc(u, sl)))),
               "smooth": _np(sl.gather(sl.smooth(loc(f, sl), loc(u, sl)))),
               "smooth_zero": _np(sl.gather(sl.smooth_zero(loc(f, sl))))}
        if not neumann:
            g = field(7, (lvl.num_ifaces, lvl.m))
            NOg = max(sl.NOg, 1)
            g_own = np.zeros((NOg, lvl.m))
            for j, i in enumerate(sl._owned_ids[sl.me]):
                g_own[j] = g[i]
            g_own = torch.as_tensor(g_own)
            res["interpolate"] = sl.gamma_global(sl.interpolate(loc(u, sl)))
            res["patch_solve"] = _np(sl.gather(sl.patch_solve(loc(f, sl), g_own)))
            res["fold_gamma"] = _np(sl.gather(sl.fold_gamma(loc(f, sl), g_own)))
            res["schur_S"] = sl.gamma_global(sl.schur_S(g_own))
            res["halo_apply"] = _np(sl.gather(halo.HaloApply(lvl, mesh)(loc(u, sl))))
            res["integrate"] = float(sl.integrate(loc(u, sl)))
            # zero data on the padded patches stays exactly zero there
            real = (np.arange(P) < h.finest.real_patches).reshape(-1, 1, 1)
            u0, f0 = (loc(np.where(real, x, 0.0), sl) for x in (u, f))
            res["dummy"] = _np(sl.gather(torch.stack([
                sl.apply(u0), sl.smooth(f0, u0), sl.smooth_zero(f0),
                sl.patch_solve(f0, sl.gamma_zeros())], dim=1)))[h.finest.real_patches:]
            # transfers, both prolongation modes
            coarse = level(h, 1)
            sc = halo.ShardedLevel(coarse, mesh)
            uf, uc = field(3, (P, n, n)), field(4, (coarse.P, n, n))
            for mode in ("constant", "linear"):
                st = halo.ShardedTransfer(Transfer(lvl, coarse, prolong_mode=mode), sl, sc)
                res[f"restrict_{mode}"] = _np(sc.gather(st.restrict(loc(uf, sl))))
                res[f"prolong_{mode}"] = _np(sl.gather(
                    st.prolong_add(loc(uc, sc), loc(uf, sl))))
                res["transfer_tables"] = {
                    "comm_rows": st.comm_rows,
                    "child_src": st._child_src.copy(), "pt_src": st._pt_src.copy(),
                    **{name: (list(e.offsets), [t.copy() for t in e.send_tbl])
                       for name, e in (("pool", st.ex_pool), ("full", st.ex_full),
                                       ("par", st.ex_par))}}
        out[key] = res

    # 3D: refined_tree(3, 2, 1) at n = 4
    h3 = DomainHierarchy(tr["3d"], n=4, num_shards=k)
    lvl3 = level(h3)
    sl3 = halo.ShardedLevel(lvl3, mesh)
    u3 = field(6, (lvl3.P, 4, 4, 4))
    out["3d"] = {"apply": _np(sl3.gather(sl3.apply(loc(u3, sl3))))}

    # the FAC active-set smoothers on a level whose active set is proper
    h = DomainHierarchy(tr["2d-deep"], n=n, num_shards=k)
    from pressurepoissonsolver_torch.gmg import _expand_ring, _fac_active_mask

    fine, coarse = level(h, 0), level(h, 1)
    mask = _fac_active_mask(Transfer(fine, coarse), 1)
    ring = _expand_ring(h[1], mask, 1)
    sc = halo.ShardedLevel(coarse, mesh)
    sm = halo.ShardedActiveSmoother(sc, mask)
    sa = halo.ShardedActiveSmoother(sc, ring)
    f, u = field(8, (coarse.P, n, n)), field(9, (coarse.P, n, n))
    u0 = np.where(mask.reshape(-1, 1, 1), u, 0.0)
    out["active"] = {
        "mask": mask, "ring": ring,
        "smooth": _np(sc.gather(sm.smooth(loc(f, sc), loc(u, sc)))),
        "smooth_zero": _np(sc.gather(sm.smooth_zero(loc(f, sc)))),
        "apply_scattered": _np(sc.gather(sa.apply_scattered(loc(u0, sc)))),
        "counts": [sm.Pa]}
    return out


# the multigrid of the public solves: a V(1,1) cycle down to a 64-DOF
# direct solve, so that the transfers and coarse levels run sharded
SMALL_GMG = dict(coarse_direct_max_dof=64)
# the CLI run, with and without --shards
CLI_ARGV = ["--uniform", "3", "-n", "8", "-t", "1e-10", "--gmg-coarse-direct-dof", "256"]


def _solver(mesh, h, **opts):
    from pressurepoissonsolver_torch.gmg import CycleOpts
    from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions

    gmg = opts.pop("gmg", {})
    return PoissonSolver(h, SolveOptions(gmg=CycleOpts(**gmg), **opts), mesh=mesh,
                         device="cpu")


def solve_battery(mesh, tmp, n=8):
    """The public sharded solves and the sharded CLI at the world's size;
    solutions gathered to the global layout."""
    from pressurepoissonsolver_torch import cli
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.parallel.sharding import gather_patches
    from pressurepoissonsolver_torch.problems import get_problem, init_problem

    k = mesh.size()
    tree = trees()["2d"]
    out = {}

    def problem(h):
        return init_problem(h.finest, get_problem("trig", 2))

    h = DomainHierarchy(tree, n=n, num_shards=k)
    f, exact = problem(h)
    s = _solver(mesh, h, tol=1e-11, gmg=SMALL_GMG)
    r = s.solve(f)
    out["solve"] = {"x": _np(gather_patches(r.x, mesh)), "iterations": r.iterations,
                    "rel": float(r.residual_norm / r.r0_norm)}
    u, r, hist = s.solve_monitored(f, max_iter=60)
    out["monitored"] = {"x": _np(gather_patches(u, mesh)), "iterations": r.iterations,
                        "hist": hist}
    for krylov in ("gmres", "cg"):  # the Arnoldi and the weighted dots
        r = _solver(mesh, h, tol=1e-11, krylov=krylov, gmg=SMALL_GMG).solve(f)
        out[f"solve_{krylov}"] = {"x": _np(gather_patches(r.x, mesh)),
                                  "iterations": r.iterations,
                                  "rel": float(r.residual_norm / r.r0_norm)}

    hm = DomainHierarchy(tree, n=n, neumann=["x_lo", "y_hi"], num_shards=k)
    fm, _ = problem(hm)
    r = _solver(mesh, hm, tol=1e-11, gmg=SMALL_GMG).solve(fm)
    out["solve_mixed"] = {"x": _np(gather_patches(r.x, mesh)),
                          "iterations": r.iterations,
                          "rel": float(r.residual_norm / r.r0_norm)}

    s = _solver(mesh, h, tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
                gmg=dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                         coarse_direct_max_dof=64))
    u, info = s.solve_refined(f, tol=1e-10)
    out["refined"] = {"x": _np(gather_patches(u, mesh)),
                      "info": {kk: v for kk, v in info.items() if kk != "outer_history"},
                      "report": s.report(u, f, exact)}

    s = _solver(mesh, h, tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
                gmg=dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                         coarse_direct_max_dof=64))
    for prec in ("gmg", "blockjacobi"):
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
        out[f"schur_{prec}"] = {"x": _np(gather_patches(u, mesh)),
                                "iterations": res.iterations,
                                "report": s.report(u, f, exact)}

    # the CLI, every rank in-process; rank 0 writes the out-json
    js = os.path.join(tmp, "cli.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(2, CLI_ARGV + ["--shards", str(k), "--out-json", js],
                      device="cpu")
    out["cli"] = {"rc": rc, "stdout": buf.getvalue()}
    dist.barrier()
    if mesh.get_local_rank("p") == 0:
        with open(js) as fh:
            out["cli"]["json"] = json.load(fh)
    return out


def _owned_block(sl, g):
    """This rank's block of the single-device interface vector ``g`` in
    the gathered engine's layout (rows ``me*NIb ..``, zero past ``NIf``)."""
    k, NIb = sl.ndev, sl.NIb
    full = np.zeros((k * NIb,) + g.shape[1:])
    full[: len(g)] = g
    return full[sl.me * NIb:(sl.me + 1) * NIb]


def _count_nogf(calls):
    """Wrap the stencil of each dimension so that each call appends whether
    it ran in the no-gf mode; the originals, to restore."""
    from pressurepoissonsolver_torch.ops import level_ops

    orig = dict(level_ops._STENCIL)

    def wrap(fn):
        def call(u, gf, coef, h2):
            calls.append(gf is None)
            return fn(u, gf, coef, h2)
        return call

    level_ops._STENCIL.update({d: wrap(fn) for d, fn in orig.items()})
    return orig


def gathered_battery(mesh, tmp, n=8):
    """The gathered engine's (``comm="pjit"``) level, Schur and transfer
    ops at the world's size in f64 and f32, and the halo engine's
    overlapped apply, each gathered to the global layout."""
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.gmg import Transfer
    from pressurepoissonsolver_torch.ops import level_ops
    from pressurepoissonsolver_torch.ops.level_ops import Level
    from pressurepoissonsolver_torch.parallel import halo
    from pressurepoissonsolver_torch.parallel.gathered import (GatheredLevel,
                                                               GatheredTransfer)
    from pressurepoissonsolver_torch.parallel.sharding import shard_patch_array

    k = mesh.size()
    cpu = torch.device("cpu")
    out = {}

    def loc(x, dtype):
        return shard_patch_array(torch.as_tensor(x, dtype=dtype), mesh).clone()

    h = DomainHierarchy(trees()["2d"], n=n, num_shards=k, use_native=False)
    for dtype in (torch.float64, torch.float32):
        lvl = Level(h[0], dtype=dtype, device=cpu)
        coarse = Level(h[1], dtype=dtype, device=cpu)
        gl, gc = GatheredLevel(lvl, mesh), GatheredLevel(coarse, mesh)
        P = lvl.P
        u, f = field(11, (P, n, n)), field(1, (P, n, n))
        g = torch.as_tensor(_owned_block(gl, field(7, (lvl.num_ifaces, lvl.m))),
                            dtype=dtype)
        res = {"apply": _np(gl.gather(gl.apply(loc(u, dtype)))),
               "smooth": _np(gl.gather(gl.smooth(loc(f, dtype), loc(u, dtype)))),
               "smooth_zero": _np(gl.gather(gl.smooth_zero(loc(f, dtype)))),
               "interpolate": gl.gamma_global(gl.interpolate(loc(u, dtype))),
               "patch_solve": _np(gl.gather(gl.patch_solve(loc(f, dtype), g))),
               "fold_gamma": _np(gl.gather(gl.fold_gamma(loc(f, dtype), g))),
               "schur_S": gl.gamma_global(gl.schur_S(g)),
               "integrate": float(gl.integrate(loc(u, dtype))),
               "bytes": (tensor_bytes(gl), tensor_bytes(lvl))}
        uf, uc = field(3, (P, n, n)), field(4, (coarse.P, n, n))
        for mode in ("constant", "linear"):
            gt = GatheredTransfer(Transfer(lvl, coarse, prolong_mode=mode), gl, gc)
            res[f"restrict_{mode}"] = _np(gc.gather(gt.restrict(loc(uf, dtype))))
            res[f"prolong_{mode}"] = _np(gl.gather(
                gt.prolong_add(loc(uc, dtype), loc(uf, dtype))))
        # the halo engine's apply: no-gf stencil while the exchange is in
        # flight, then the face term
        calls = []
        orig = _count_nogf(calls)
        try:
            sl = halo.ShardedLevel(lvl, mesh)
            res["halo_apply"] = _np(sl.gather(sl.apply(loc(u, dtype))))
        finally:
            level_ops._STENCIL.update(orig)
        res["halo_nogf"] = calls
        # zero data on the padded patches stays exactly zero there
        real = (np.arange(P) < h.finest.real_patches).reshape(-1, 1, 1)
        u0, f0 = (loc(np.where(real, x, 0.0), dtype) for x in (u, f))
        res["dummy"] = _np(gl.gather(torch.stack([
            gl.apply(u0), gl.smooth(f0, u0), gl.smooth_zero(f0),
            gl.patch_solve(f0, gl.gamma_zeros(dtype)),
            sl.apply(u0)], dim=1)))[h.finest.real_patches:]
        out[str(dtype).replace("torch.", "")] = res

    h3 = DomainHierarchy(trees()["3d"], n=4, num_shards=k)
    lvl3 = Level(h3[0], dtype=torch.float64, device=cpu)
    u3 = field(6, (lvl3.P, 4, 4, 4))
    g3, s3 = GatheredLevel(lvl3, mesh), halo.ShardedLevel(lvl3, mesh)
    out["3d"] = {"apply": _np(g3.gather(g3.apply(loc(u3, torch.float64)))),
                 "halo_apply": _np(s3.gather(s3.apply(loc(u3, torch.float64))))}
    return out


def gathered_solve_battery(mesh, tmp, n=8):
    """``PoissonSolver(comm="pjit")``'s public solves, the three FAC
    active-set cycles (masked, subset, single-device) and the CLI's
    ``--comm pjit`` at the world's size; fields gathered to the global
    layout."""
    from pressurepoissonsolver_torch import cli
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.gmg import CycleOpts, build_gmg
    from pressurepoissonsolver_torch.parallel.gathered import MaskedSmoother
    from pressurepoissonsolver_torch.parallel.halo import ShardedActiveSmoother
    from pressurepoissonsolver_torch.parallel.sharding import (gather_patches,
                                                               shard_patch_array)
    from pressurepoissonsolver_torch.problems import get_problem, init_problem

    k = mesh.size()
    out = {}
    h = DomainHierarchy(trees()["2d"], n=n, num_shards=k)
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    r = _solver(mesh, h, tol=1e-11, comm="pjit", gmg=SMALL_GMG).solve(f)
    out["solve"] = {"x": _np(gather_patches(r.x, mesh)), "iterations": r.iterations,
                    "rel": float(r.residual_norm / r.r0_norm)}
    s = _solver(mesh, h, tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32,
                comm="pjit", gmg=dict(pre_sweeps=2, post_sweeps=1,
                                      fac_smoothing="active", coarse_direct_max_dof=64))
    out["masked_levels"] = sum(isinstance(a, MaskedSmoother) for a in s.gmg._asmooth)
    u, info = s.solve_refined(f, tol=1e-10)
    out["refined"] = {"x": _np(gather_patches(u, mesh)),
                      "info": {kk: v for kk, v in info.items() if kk != "outer_history"},
                      "report": s.report(u, f, exact)}
    for prec in ("gmg", "blockjacobi"):
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
        out[f"schur_{prec}"] = {"x": _np(gather_patches(u, mesh)),
                                "iterations": res.iterations,
                                "report": s.report(u, f, exact)}

    # one V(2,1) FAC cycle with active-set smoothing through each engine, on
    # a tree whose coarse levels have proper active sets
    hd = DomainHierarchy(trees()["2d-deep"], n=n, num_shards=k)
    opts = CycleOpts(pre_sweeps=2, fac_smoothing="active", coarse_direct_max_dof=64)
    fd = field(5, (hd.finest.num_patches, n, n))
    fd[hd.finest.real_patches:] = 0.0
    fd = shard_patch_array(torch.as_tensor(fd), mesh).clone()
    out["cycles"] = {}
    for comm, kind in (("pjit", MaskedSmoother), ("halo", ShardedActiveSmoother)):
        g = build_gmg(hd, opts, dtype=torch.float64, device="cpu", mesh=mesh, comm=comm)
        out["cycles"][comm] = {
            "x": _np(gather_patches(g.apply(fd), mesh)),
            "kinds": [type(a).__name__ for a in g._asmooth if a is not None],
            "of_kind": sum(isinstance(a, kind) for a in g._asmooth)}

    js = os.path.join(tmp, "cli.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(2, CLI_ARGV + ["--shards", str(k), "--comm", "pjit",
                                     "--out-json", js], device="cpu")
    out["cli"] = {"rc": rc, "stdout": buf.getvalue()}
    dist.barrier()
    if mesh.get_local_rank("p") == 0:
        with open(js) as fh:
            out["cli"]["json"] = json.load(fh)
    return out


def reads_kron(fn, mats) -> bool:
    """Whether ``fn()`` reads the Kronecker matrices ``mats`` (per group or
    orthant a tensor or a tuple of them): NaN written into them reaches
    its result.  The matrices are spoilt after."""
    for m in mats:
        for w in (m if isinstance(m, tuple) else (m,)):
            w.fill_(float("nan"))
    return bool(torch.isnan(fn()).any())


def kron_inputs(fine, coarse):
    """The seeded f32 inputs of :func:`kron_battery` for one mesh: the
    fine level's right-hand side and field, and the coarse field."""
    n, D = fine.n, fine.D
    return tuple(field(seed, (lvl.P,) + (n,) * D).astype(np.float32)
                 for seed, lvl in ((21, fine), (22, fine), (23, coarse)))


def kron_hierarchy(key, k):
    """The all-Neumann-wall hierarchy of :func:`kron_battery` (several BC
    groups per rank, a pinned one on the coarsest level): 2D at n=8, 3D at
    n=4, padded for ``k`` ranks."""
    from pressurepoissonsolver_torch.domain import DomainHierarchy

    tree, n = {"2d": (trees()["2d"], 8), "3d": (trees()["3d"], 4)}[key]
    return DomainHierarchy(tree, n=n, neumann=True, num_shards=k, use_native=False)


def kron_battery(mesh, tmp):
    """The halo engine's f32 ops that take the Kronecker form at n <= 16:
    the rank solves (``smooth_zero`` of the finest level and of an
    active-set smoother on the next) and both prolongations (the wrapped
    transfer's Kronecker matrices) beside the restriction (slice adds);
    per mesh, whether each built its Kronecker tables, and every result
    gathered to the global layout."""
    from pressurepoissonsolver_torch.gmg import Transfer, _fac_active_mask
    from pressurepoissonsolver_torch.ops.level_ops import Level
    from pressurepoissonsolver_torch.parallel import halo
    from pressurepoissonsolver_torch.parallel.sharding import shard_patch_array

    out = {}
    for key in ("2d", "3d"):
        h = kron_hierarchy(key, mesh.size())
        fine, coarse = (Level(h[i], dtype=torch.float32, device="cpu") for i in (0, 1))
        sf, sc = halo.ShardedLevel(fine, mesh), halo.ShardedLevel(coarse, mesh)
        f, uf, uc = (shard_patch_array(x, mesh).clone() for x in kron_inputs(fine, coarse))
        sm = halo.ShardedActiveSmoother(sc, _fac_active_mask(Transfer(fine, coarse), 1))
        res = {"solve": _np(sf.gather(sf.smooth_zero(f))),
               "active_solve": _np(sc.gather(sm.smooth_zero(uc)))}
        for mode in ("constant", "linear"):
            st = halo.ShardedTransfer(Transfer(fine, coarse, prolong_mode=mode), sf, sc)
            res[f"prolong_{mode}"] = _np(sf.gather(st.prolong_add(uc, uf)))
            res[f"restrict_{mode}"] = _np(sc.gather(st.restrict(uf)))
            # every rank runs the exchange of the poisoned call
            reads = st._Wp is not None and reads_kron(lambda: st.prolong_add(uc, uf), st._Wp)
            res[mode] = None if all(o is None for o, _ in st._pseg) else reads
        # whether each op read its Kronecker matrices (None: no active
        # patch, or no child of an orthant, on this rank)
        res["kron"] = {
            "level": sf._st.kron is not None and reads_kron(lambda: sf.smooth_zero(f),
                                                            sf._st.kron),
            "active": None if not sm.Pa else (
                sm._st.kron is not None and reads_kron(lambda: sm.smooth_zero(uc),
                                                       sm._st.kron)),
            **{mode: res.pop(mode) for mode in ("constant", "linear")}}
        out[key] = res
    return out


BATTERIES = {"level": level_battery, "solve": solve_battery,
             "gathered": gathered_battery, "gathered_solve": gathered_solve_battery,
             "kron": kron_battery}

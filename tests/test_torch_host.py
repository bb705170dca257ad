"""Host-side parity of the PyTorch port: the numpy tables the port builds
(patch levels, interface tables, transforms, the assembled operator, the
problem data) equal the JAX reference's exactly, checkpoints cross between
the packages, and the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.checkpoint as jckpt
import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.iface as jiface
import pressurepoissonsolver_tpu.matrix as jmatrix
import pressurepoissonsolver_tpu.ops.transforms as jtr
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_torch.checkpoint as tckpt
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.iface as tiface
import pressurepoissonsolver_torch.matrix as tmatrix
import pressurepoissonsolver_torch.ops.transforms as ttr
import pressurepoissonsolver_torch.problems as tprob

from _torch_parity import hierarchies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PL_FIELDS = ("D", "n", "tree_level", "ids", "starts", "spacings",
             "refine_level", "parent_id", "orth_on_parent", "neumann",
             "nbr_type", "nbr_slot", "coarse_orth", "fine_nbr_slots",
             "num_real")
IFACE_FIELDS = ("num_ifaces", "m", "iface_side_idx", "iface_side_mask",
                "contrib_patch", "contrib_side", "contrib_iface",
                "contrib_case", "case_w", "case_src", "face_depth")
NEUMANN = [False, True, ("x_lo", "y_hi")]


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("neumann", NEUMANN, ids=str)
def test_patch_levels_equal(neumann):
    jh, th = hierarchies(neumann)
    assert len(jh) == len(th) == 6
    for jl, tl in zip(jh.levels, th.levels):
        for name in PL_FIELDS:
            assert _same(getattr(jl, name), getattr(tl, name)), name


@pytest.mark.parametrize("neumann", NEUMANN, ids=str)
def test_iface_tables_equal(neumann):
    jh, th = hierarchies(neumann)
    for jl, tl in zip(jh.levels, th.levels):
        jt = jiface.build_iface_tables(jl)
        tt = tiface.build_iface_tables(tl)
        for name in IFACE_FIELDS:
            assert _same(getattr(jt, name), getattr(tt, name)), name


@pytest.mark.parametrize("n", [8, 12, 64])
def test_case_templates_and_transforms_equal(n):
    for a, b in zip(jiface.case_templates(2, n), tiface.case_templates(2, n)):
        if isinstance(a, dict):
            assert a == b
        else:
            assert _same(a, b)
    for kind in range(6):
        assert _same(jtr.transform_matrix(kind, n), ttr.transform_matrix(kind, n))
    for flags in ((False, False), (True, False), (False, True), (True, True)):
        assert jtr.axis_transforms(*flags) == ttr.axis_transforms(*flags)
        delta = ttr.axis_transforms(*flags)[2]
        assert _same(jtr.axis_eigenvalues(n, 1.0 / 96, delta),
                     ttr.axis_eigenvalues(n, 1.0 / 96, delta))


@pytest.mark.parametrize("neumann", NEUMANN, ids=str)
def test_assemble_composite_equal(neumann):
    jh, th = hierarchies(neumann)
    for jl, tl in zip(jh.levels, th.levels):
        A = jmatrix.assemble_composite(jl)
        B = tmatrix.assemble_composite(tl)
        assert A.shape == B.shape
        assert (A != B).nnz == 0


@pytest.mark.parametrize("name", ["trig", "gauss", "zero"])
def test_problem_data_equal(name):
    jh, th = hierarchies(("y_lo",))
    fj, ej = jprob.init_problem(jh.finest, jprob.get_problem(name, 2))
    ft, et = tprob.init_problem(th.finest, tprob.get_problem(name, 2))
    assert _same(fj, ft) and _same(ej, et)


def test_unported_options_raise():
    """The quadratic closures are ported in 2D (tables held to the
    reference in test_torch_variants.py); in 3D and for unknown schemes
    the port raises as the reference does."""
    _, th = hierarchies()
    assert tiface.build_iface_tables(th.finest, scheme="quadratic").face_depth == 2
    _, th3 = hierarchies(D=3)
    for pl, scheme in ((th3.finest, "quadratic"), (th.finest, "cubic")):
        with pytest.raises(ValueError):
            tiface.build_iface_tables(pl, scheme=scheme)


def _trees_equal(a, b):
    assert a.D == b.D and a.root == b.root and a.num_levels == b.num_levels
    assert sorted(a.nodes) == sorted(b.nodes)
    for nid in a.nodes:
        x, y = a.nodes[nid], b.nodes[nid]
        assert (x.id, x.level, x.parent) == (y.id, y.level, y.parent)
        for f in ("lengths", "starts", "nbr_id", "child_id"):
            assert np.array_equal(getattr(x, f), getattr(y, f))


def test_jax_checkpoint_loads_into_port(tmp_path):
    jh, _ = hierarchies()
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    path = str(tmp_path / "state.npz")
    jckpt.save_checkpoint(path, jh.tree, jh.n, {"f": f, "exact": exact},
                          meta={"tol": 1e-10})
    tree, n, arrays, meta = tckpt.load_checkpoint(path)
    _trees_equal(jh.tree, tree)
    assert n == jh.n and float(meta["tol"]) == 1e-10
    assert _same(arrays["f"], f) and _same(arrays["exact"], exact)
    # the loaded mesh rebuilds the reference's hierarchy
    th = tdomain.DomainHierarchy(tree, n=n)
    for jl, tl in zip(jh.levels, th.levels):
        assert _same(jl.ids, tl.ids) and _same(jl.nbr_slot, tl.nbr_slot)
    state = tckpt.state_to_torch(arrays, device="cpu", dtype=torch.float32)
    assert state["f"].dtype == torch.float32 and state["f"].shape == f.shape
    assert np.array_equal(state["f"].numpy(), f.astype(np.float32))


def test_port_checkpoint_loads_into_jax(tmp_path):
    tree = tgeo.refined_tree(2, 3, 1)
    u = np.random.default_rng(0).standard_normal((7, 8, 8))
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, tree, 8, {"u": u})
    jtree, n, arrays, _ = jckpt.load_checkpoint(path)
    _trees_equal(tree, jtree)
    assert n == 8 and _same(arrays["u"], u)


def test_port_never_imports_jax():
    """Import every module of the port and chip_smoke, run a tiny CPU
    solve, Schur solves with the GMG and block-Jacobi preconditioners and
    with GMRES, a 3D apply, four CLI runs (two sharded over a one-rank
    group, one per engine), a tiny bench and an op report on natively
    built tables, and check that JAX was never loaded."""
    code = """
import sys
import numpy as np
import torch
import pressurepoissonsolver_torch
from pressurepoissonsolver_torch import checkpoint, cli, cuda_build, domain, geometry, gmg, iface, krylov, matrix, precond, problems, solver
from pressurepoissonsolver_torch.apps import steady2d, steady3d
from pressurepoissonsolver_torch.ops import ghost_stencil, level_ops, patch_bcgs, transforms
from pressurepoissonsolver_torch.utils import profiling, timer, writers
from pressurepoissonsolver_torch import bench, native
from pressurepoissonsolver_torch.scripts import bench3d, multihost, one_card_backends, profile_ops, scaling
from pressurepoissonsolver_torch.parallel import gathered, halo, partition, sharding
import os
import chip_smoke
os.environ.update(PPS_BENCH_N="4", PPS_BENCH_DIVIDE="0", PPS_BENCH_COARSE_DOF="16",
                  PPS_BENCH_REPS="1")
out = bench.main(device="cpu")
assert out["residual"] <= 1e-10 and out["schur_residual"] <= 1e-10, out
assert cli.main(2, ["--uniform", "3", "-n", "4", "-t", "1e-8", "--solver", "ir",
                    "--inner-solver", "richardson", "--gmg-cycle-type", "W"], device="cpu") == 0
assert cli.main(2, ["--uniform", "3", "-n", "4", "-t", "1e-8", "--schur",
                    "--matrix-type", "pbm", "--monitor"], device="cpu") == 0
assert cli.main(2, ["--uniform", "3", "-n", "4", "-t", "1e-8", "--shards", "1"],
                device="cpu") == 0
assert cli.main(2, ["--uniform", "3", "-n", "4", "-t", "1e-8", "--shards", "1",
                    "--comm", "pjit"], device="cpu") == 0
h = domain.DomainHierarchy(geometry.refined_tree(2, 3, 1), n=4)
s = solver.SolveOptions(tol=1e-8, precond_dtype=torch.float32,
                        gmg=gmg.CycleOpts(coarse_direct_max_dof=16, fac_smoothing="active"))
ps = solver.PoissonSolver(h, s, device="cpu")
f, exact = problems.init_problem(h.finest, problems.get_problem("trig", 2))
u, info = ps.solve_refined(f, tol=1e-8)
assert info["residual"] <= 1e-8, info
for prec in ("gmg", "blockjacobi"):
    us, res = ps.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
    assert ps.report(us, f, exact)["residual"] <= 1e-8, prec
s.krylov = "gmres"
pg = solver.PoissonSolver(h, s, device="cpu")
us, res = pg.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
assert pg.report(us, f, exact)["residual"] <= 1e-8
h3 = domain.DomainHierarchy(geometry.refined_tree(3, 2, 1), n=4)
lvl3 = level_ops.Level(h3.finest, torch.float32, device="cpu")
au = lvl3.apply(torch.ones((h3.finest.num_patches, 4, 4, 4)))
assert au.shape == (h3.finest.num_patches, 4, 4, 4) and bool(torch.isfinite(au).all())
assert h3.builder == ("native" if native.available() else "python")
assert set(profiling.op_report(lvl3, reps=1)) == {"interpolate", "apply", "patch_solve", "smooth"}
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "pressurepoissonsolver_tpu")))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


# --- 3D: refined_tree(3, 3, 2) at n=4 ------------------------------------

NEUMANN_3D = [False, True, ("x_lo", "y_hi", "z_lo")]


@pytest.mark.parametrize("neumann", NEUMANN_3D, ids=str)
def test_patch_levels_equal_3d(neumann):
    jh, th = hierarchies(neumann, D=3)
    assert len(jh) == len(th) == 5
    assert [l.num_patches for l in th.levels] == [78, 71, 64, 8, 1]
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.D == 3
        for name in PL_FIELDS:
            assert _same(getattr(jl, name), getattr(tl, name)), name
    for k in range(len(th) - 1):
        assert _same(jdomain.parent_slots(jh[k], jh[k + 1]),
                     tdomain.parent_slots(th[k], th[k + 1]))


@pytest.mark.parametrize("neumann", NEUMANN_3D, ids=str)
def test_iface_tables_equal_3d(neumann):
    jh, th = hierarchies(neumann, D=3)
    for jl, tl in zip(jh.levels, th.levels):
        jt = jiface.build_iface_tables(jl)
        tt = tiface.build_iface_tables(tl)
        for name in IFACE_FIELDS:
            assert _same(getattr(jt, name), getattr(tt, name)), name


@pytest.mark.parametrize("n", [4, 6, 32])
def test_case_templates_equal_3d(n):
    """The 3D f2f 11/12 and f2c 1/6 templates among them."""
    a, b = jiface.case_templates(3, n), tiface.case_templates(3, n)
    assert a[0] == b[0] and len(a[0]) == 11
    assert _same(a[1], b[1]) and _same(a[2], b[2])
    assert a[1].shape == (11, n * n, 4)
    f2f = b[1][b[0]["f2f"]]
    assert np.allclose(f2f[:, 0], 11.0 / 12.0) and np.allclose(f2f[:, 1:], -1.0 / 12.0)
    f2c = b[1][b[0]["f2c0"]]  # a quarter of the coarse face, 4 sources each
    assert np.allclose(f2c[f2c != 0.0], 1.0 / 6.0)
    assert (f2c != 0.0).sum() == n * n


@pytest.mark.parametrize("neumann", NEUMANN_3D, ids=str)
def test_assemble_composite_equal_3d(neumann):
    jh, th = hierarchies(neumann, D=3)
    for jl, tl in zip(jh.levels, th.levels):
        A = jmatrix.assemble_composite(jl)
        B = tmatrix.assemble_composite(tl)
        assert A.shape == B.shape == (tl.num_cells, tl.num_cells)
        assert (A != B).nnz == 0


@pytest.mark.parametrize("name", ["trig", "gauss", "zero"])
def test_problem_data_equal_3d(name):
    jh, th = hierarchies(("y_lo", "z_hi"), D=3)
    fj, ej = jprob.init_problem(jh.finest, jprob.get_problem(name, 3))
    ft, et = tprob.init_problem(th.finest, tprob.get_problem(name, 3))
    assert ft.shape == (78, 4, 4, 4)
    assert _same(fj, ft) and _same(ej, et)


def test_jax_checkpoint_3d_loads_into_port(tmp_path):
    jh, _ = hierarchies(D=3)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 3))
    path = str(tmp_path / "state3d.npz")
    jckpt.save_checkpoint(path, jh.tree, jh.n, {"f": f, "exact": exact})
    tree, n, arrays, _ = tckpt.load_checkpoint(path)
    _trees_equal(jh.tree, tree)
    th = tdomain.DomainHierarchy(tree, n=n)
    for jl, tl in zip(jh.levels, th.levels):
        assert _same(jl.ids, tl.ids) and _same(jl.nbr_slot, tl.nbr_slot)
    for dt in (torch.float32, torch.float64):
        state = tckpt.state_to_torch(arrays, device="cpu", dtype=dt)
        assert state["f"].dtype == dt and tuple(state["f"].shape) == f.shape
        assert np.array_equal(state["exact"].numpy(), exact.astype(state["exact"].numpy().dtype))

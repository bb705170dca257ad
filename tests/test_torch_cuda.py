"""The port on a CUDA card: the 2D and 3D ghost-stencil kernels against
their plain versions, the composite apply, the active-set residual apply and
the Schur path's ``apply_with_interface`` and per-patch BiCGStab through the
kernels against the CPU, the kernels' no-gf mode and the face-term kernel, small 2D and 3D solves (``solve_refined`` and
``solve_schur``), and the measurement surface: the bench scripts at a small
size, ``time_op``'s held device time and its fallback, a trace and the op
report; the solve loops run from captured CUDA graphs against the
eager loops (counts, bit-equal iterates, launch counts, the graph's
stencil nodes against the replay accounting, a false guard, a new
``tol``, unaliased results, a capture that cannot be made); and the
solves as one graph launch with WHILE nodes (``csrc/graph_loop.cu``)
against the per-step replay and the eager loops, GMRES and the nested
refinement loop included (bit-equal iterates, equal counts and launches,
one graph launch and one host read per solve, none with
``solve_refined(sync=False)``, zero steps on a zero right-hand side, the
step limits, new inputs without a new capture, the stencil nodes of each
WHILE body against the accounting); the block-Jacobi sweep kernel
(``csrc/patch_sweep.cu``) against its plain version, for every wall set,
n, dtype, full and active sweeps, and its nodes inside WHILE bodies; the
grid transfers' kernel (``csrc/transfer.cu``) against the plain chain on
every transfer of the benchmark cells' hierarchy at divide 0 and 1, both
prolongation modes and dtypes, its copies of strided inputs and its
refusals, and the transfers of one-launch solves all on the kernel; the
per-side trace kernel (``csrc/traces.cu``) against the plain chain on every
level and active set of a small hierarchy, one kernel node a build, its
copies and refusals, no plain build on the card, and every build of a
one-launch solve on the kernel.

Every test here needs a card and skips without one (the CUDA kernel has no
CPU mode).  This file imports no JAX, so it runs on a machine without it;
there, skip the JAX-based ``tests/conftest.py``::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.gmg import CycleOpts, build_gmg
from pressurepoissonsolver_torch.ops import ghost_stencil as gs
from pressurepoissonsolver_torch.ops import level_ops, patch_sweep, transfer
from pressurepoissonsolver_torch.ops.level_ops import ActiveSmoother, Level, extract_faces
from pressurepoissonsolver_torch.ops.patch_sweep import _spectral_apply
from pressurepoissonsolver_torch.problems import get_problem, init_problem
from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
from pressurepoissonsolver_torch.utils import counters

DTYPES = {"f32": torch.float32, "f64": torch.float64}
RTOL = {"f32": 1e-5, "f64": 1e-12}


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((ref - got).abs().max() / ref.abs().max())


def _hierarchy():
    return DomainHierarchy(refined_tree(2, 4, 2), n=8)


def _width(n, dt):
    """The path a launch on fresh (16-byte aligned) tensors takes: a 16-byte
    vector per thread when n is a multiple of it, else one element."""
    w = 16 // DTYPES[dt].itemsize
    return w if n % w == 0 else 1


def _launch_takes(D, want, launch):
    """Run ``launch()`` and check that it was one launch of the ``D``-dim
    kernel on the path with ``want`` elements per thread, as the launcher's
    rule names it."""
    before = dict(gs.widths[D])
    out = launch()
    torch.cuda.synchronize()
    assert gs.last_width[D] == want
    assert gs.widths[D] == {w: c + (w == want) for w, c in before.items()}
    return out


def _stencil_args(D, P, n, dt, device, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((P,) + (n,) * D),
            rng.standard_normal((P, 2 * D, n ** (D - 1))),
            rng.choice([-1.0, 0.0, 1.0], size=(P, 2 * D)),
            rng.uniform(1e2, 1e6, size=(P, D)))
    return [torch.as_tensor(a, dtype=DTYPES[dt], device=device) for a in arrs]


# the bench shape and a row of a whole warp or more take the vector path;
# (37, 6) in f32, (3, 1) and (1048, 63) take one element per thread; (37, 12)
# vectors that do not fill a warp's lanes
@pytest.mark.parametrize("shape", [(1048, 64), (37, 12), (3, 1), (37, 6), (8, 128),
                                   (1048, 63)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_kernel_matches_plain(cuda, dt, shape):
    P, n = shape
    args = _stencil_args(2, P, n, dt, cuda, 0)
    name = str(DTYPES[dt]).replace("torch.", "")
    before = gs.launches[name]
    out = _launch_takes(2, _width(n, dt), lambda: gs.ghost_stencil(*args))
    assert gs.launches[name] == before + 1
    if shape in ((1048, 64), (8, 128)):
        assert gs.last_width[2] > 1
    assert _rel(gs.ghost_stencil_plain(*args), out) <= RTOL[dt]


# the per-rank shapes of the sharded solves that split their applies: the
# 2D bench at world 4 (262 and 16 patches per rank, n=64), the multihost
# job at world 8 (9 patches, n=8), the small 3D mesh at world 4 (20 and 2
# patches, n=8)
PATH_SHAPES = [(2, (262, 64)), (2, (16, 64)), (2, (9, 8)), (3, (20, 8)), (3, (2, 8))]
# the no-gf mode at the bench shapes, off the vector path and at those
NOGF_SHAPES = [(2, (1048, 64)), (2, (37, 7)), (3, (624, 32)), (3, (37, 7))] + PATH_SHAPES


@pytest.mark.parametrize("D, shape", NOGF_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_no_gf_kernel_matches_plain(cuda, dt, D, shape):
    """``gf=None``: the kernel reads no face entry (ghost ``coef * u_b``),
    equals its plain version, is counted with the others and in
    ``launches_nogf``, and with the face term added equals the launch with
    the faces."""
    P, n = shape
    u, gf, coef, h2 = _stencil_args(D, P, n, dt, cuda, 8)
    kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
    plain = gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain
    name = str(DTYPES[dt]).replace("torch.", "")
    counts = gs.launches if D == 2 else gs.launches_3d
    before, nogf = counts[name], gs.launches_nogf[D][name]
    base = _launch_takes(D, _width(n, dt), lambda: kernel(u, None, coef, h2))
    assert (counts[name], gs.launches_nogf[D][name]) == (before + 1, nogf + 1)
    assert _rel(plain(u, None, coef, h2), base) <= RTOL[dt]
    full = kernel(u, gf, coef, h2)
    assert gs.launches_nogf[D][name] == nogf + 1
    assert _rel(full, gs.add_ghost_faces(base, gf, h2)) <= RTOL[dt]


# the face-term kernel at the bench shapes, odd n, the smallest patches and
# the path's per-rank shapes
FACE_SHAPES = [(2, (1048, 64)), (2, (37, 7)), (2, (3, 1)), (2, (5, 2)),
               (3, (624, 32)), (3, (37, 7)), (3, (3, 1)), (3, (5, 2))] + PATH_SHAPES


@pytest.mark.parametrize("D, shape", FACE_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_face_term_kernel_matches_plain(cuda, dt, D, shape):
    """``add_ghost_faces`` on the card: one launch of the face-term kernel,
    in place, equal to its plain version, every interior cell untouched."""
    P, n = shape
    u, gf, _, h2 = _stencil_args(D, P, n, dt, cuda, 9)
    name = str(DTYPES[dt]).replace("torch.", "")
    before = gs.launches_faces[D][name]
    out = u.clone()
    got = gs.add_ghost_faces(out, gf, h2)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert gs.launches_faces[D][name] == before + 1
    assert _rel(gs.add_ghost_faces_plain(u.clone(), gf, h2), got) <= RTOL[dt]
    inner = (slice(None),) + (slice(1, n - 1),) * D
    assert torch.equal(got[inner], u[inner])


@pytest.mark.parametrize("D, shape", [(2, (1048, 64)), (3, (624, 32)), (3, (37, 7))])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_kernel_on_shifted_u_takes_width_1(cuda, dt, D, shape):
    """A contiguous ``u`` one element past a 16-byte boundary (at odd n its
    planes start at a different offset from a 16-byte boundary each)."""
    P, n = shape
    args = _stencil_args(D, P, n, dt, cuda, 6)
    buf = torch.empty(args[0].numel() + 1, dtype=DTYPES[dt], device=cuda)
    shifted = buf[1:].view(args[0].shape)
    shifted.copy_(args[0])
    kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
    plain = gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain
    out = _launch_takes(D, 1, lambda: kernel(shifted, *args[1:]))
    assert _rel(plain(*args), out) <= RTOL[dt]


@pytest.mark.parametrize("D", [2, 3])
def test_vector_width_matches_launcher(cuda, D):
    """The wrapper's rule is the one the C launcher applies."""
    lib = gs.build(D)
    buf = torch.empty(1 << 12, dtype=torch.float64, device=cuda)
    base = buf.data_ptr()
    for dtype in (torch.float32, torch.float64):
        for n in (1, 2, 4, 6, 12, 32, 37, 64):
            for shift in range(4):
                ptrs = (base + shift * dtype.itemsize, base, base)
                assert (lib.pps_ghost_stencil_vector_width(*ptrs, n, dtype.itemsize)
                        == gs.vector_width(n, dtype, *ptrs))


@pytest.mark.parametrize("side", range(4))
def test_kernel_2d_face_order(cuda, side):
    """A face entry lands on the boundary cell ``extract_faces`` reads."""
    P, n = 2, 8
    zeros = torch.zeros((P, n, n), dtype=torch.float64, device=cuda)
    for k in (0, 3, n - 1):
        gf = torch.zeros((P, 4, n), dtype=torch.float64, device=cuda)
        gf[1, side, k] = 1.0
        out = _launch_takes(2, 2, lambda: gs.ghost_stencil(
            zeros, gf, torch.zeros(P, 4, dtype=torch.float64, device=cuda),
            torch.ones(P, 2, dtype=torch.float64, device=cuda)))
        hit = torch.nonzero(out).cpu()
        assert hit.shape[0] == 1
        cell = tuple(int(i) for i in hit[0])
        assert float(out[cell]) == 2.0
        onehot = torch.zeros((P, n, n), dtype=torch.float64)
        onehot[cell] = 1.0
        assert float(extract_faces(onehot, 2, n)[1, side, k]) == 1.0


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_level_apply_on_card_matches_cpu(cuda, dt):
    h = _hierarchy()
    rng = np.random.default_rng(1)
    for pl in h.levels:
        u = torch.as_tensor(rng.standard_normal((pl.num_patches, 8, 8)),
                            dtype=DTYPES[dt])
        ref = Level(pl, DTYPES[dt], device="cpu").apply(u)
        got = Level(pl, DTYPES[dt], device=cuda).apply(u.to(cuda))
        assert _rel(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_active_apply_scattered_on_card_matches_cpu(cuda, dt):
    h = _hierarchy()
    opts = CycleOpts(fac_smoothing="active", coarse_direct_max_dof=64)
    cpu = build_gmg(h, opts, DTYPES[dt], device="cpu")
    gpu = build_gmg(h, opts, DTYPES[dt], device=cuda)
    rng = np.random.default_rng(2)
    seen = 0
    for k, (a, b) in enumerate(zip(cpu._aapply, gpu._aapply)):
        if a is None:
            continue
        seen += 1
        u = torch.as_tensor(rng.standard_normal((a.level.P, 8, 8)), dtype=DTYPES[dt])
        before = dict(gs.launches)
        got = b.apply_scattered(u.to(cuda))
        assert gs.launches != before
        assert _rel(a.apply_scattered(u), got) <= RTOL[dt]
        assert isinstance(b, ActiveSmoother)
    assert seen == 2


def test_small_solve_on_card_matches_cpu(cuda):
    h = _hierarchy()
    opts = SolveOptions(tol=1e-10, precond_dtype=torch.float32,
                        gmg=CycleOpts(pre_sweeps=2, post_sweeps=1,
                                      fac_smoothing="active",
                                      coarse_direct_max_dof=64))
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    out = {}
    counters.reset()
    for dev in ("cpu", cuda):
        s = PoissonSolver(h, opts, device=dev)
        u, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
        out[str(dev)] = (u.cpu(), info, s.report(u, f, exact))
    assert gs.launches["float32"] > 0 and gs.launches["float64"] > 0
    (uc, ic, rc), (ug, ig, rg) = out["cpu"], out["cuda"]
    assert ig["outer_iterations"] == ic["outer_iterations"] == 3
    assert abs(ig["inner_iterations"] - ic["inner_iterations"]) <= 3
    assert rg["residual"] <= 1e-10
    assert float((ug - uc).norm() / uc.norm()) <= 1e-9
    assert abs(rg["error"] - rc["error"]) <= 1e-6 * rc["error"]


# --- 3D -------------------------------------------------------------------


def _hierarchy_3d(n=4):
    return DomainHierarchy(refined_tree(3, 3, 2), n=n)


# the bench shape and (4, 64) (a row of 16 / 32 vectors, a plane tile of
# several warps, two y tiles in f64) take the vector path; (37, 6) and
# (624, 30) in f32, (3, 1), (624, 31) and (1, 255) one element per thread;
# (1, 255) has rows that cross warps, one-row tiles, planes at a different
# offset from a 16-byte boundary each and, in f64, a ring above 48 KB of
# shared memory; (624, 31) a last thread row with rows past the patch (f32)
# and two y tiles (f64); the small P ones thinner slabs
@pytest.mark.parametrize("shape", [(624, 32), (37, 6), (3, 1), (37, 12), (4, 64),
                                   (1, 255), (624, 30), (624, 31)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_kernel_3d_matches_plain(cuda, dt, shape):
    P, n = shape
    args = _stencil_args(3, P, n, dt, cuda, 3)
    name = str(DTYPES[dt]).replace("torch.", "")
    before = (gs.launches_3d[name], dict(gs.launches))
    out = _launch_takes(3, _width(n, dt), lambda: gs.ghost_stencil_3d(*args))
    assert (gs.launches_3d[name], gs.launches) == (before[0] + 1, before[1])
    if shape in ((624, 32), (4, 64)):
        assert gs.last_width[3] > 1
    assert _rel(gs.ghost_stencil_3d_plain(*args), out) <= RTOL[dt]


@pytest.mark.parametrize("side", range(6))
def test_kernel_3d_face_order(cuda, side):
    """A face entry lands on the boundary cell ``extract_faces`` reads."""
    P, n = 2, 5
    zeros = torch.zeros((P, n, n, n), dtype=torch.float64, device=cuda)
    for k in (0, 3, 7, n * n - 1):
        gf = torch.zeros((P, 6, n * n), dtype=torch.float64, device=cuda)
        gf[1, side, k] = 1.0
        out = gs.ghost_stencil_3d(zeros, gf,
                                  torch.zeros(P, 6, dtype=torch.float64, device=cuda),
                                  torch.ones(P, 3, dtype=torch.float64, device=cuda))
        hit = torch.nonzero(out).cpu()
        assert hit.shape[0] == 1
        cell = tuple(int(i) for i in hit[0])
        assert float(out[cell]) == 2.0
        onehot = torch.zeros((P, n, n, n), dtype=torch.float64)
        onehot[cell] = 1.0
        assert float(extract_faces(onehot, 3, n)[1, side, k]) == 1.0


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_level_apply_3d_on_card_matches_cpu(cuda, dt):
    rng = np.random.default_rng(4)
    for pl in _hierarchy_3d().levels:
        u = torch.as_tensor(rng.standard_normal((pl.num_patches, 4, 4, 4)),
                            dtype=DTYPES[dt])
        ref = Level(pl, DTYPES[dt], device="cpu").apply(u)
        name = str(DTYPES[dt]).replace("torch.", "")
        before = gs.launches_3d[name]
        got = Level(pl, DTYPES[dt], device=cuda).apply(u.to(cuda))
        assert gs.launches_3d[name] == before + 1
        assert _rel(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_active_apply_scattered_3d_on_card_matches_cpu(cuda, dt):
    h = _hierarchy_3d()
    opts = CycleOpts(fac_smoothing="active", coarse_direct_max_dof=64)
    cpu = build_gmg(h, opts, DTYPES[dt], device="cpu")
    gpu = build_gmg(h, opts, DTYPES[dt], device=cuda)
    rng = np.random.default_rng(5)
    seen = 0
    for a, b in zip(cpu._aapply, gpu._aapply):
        if a is None:
            continue
        seen += 1
        u = torch.as_tensor(rng.standard_normal((a.level.P, 4, 4, 4)), dtype=DTYPES[dt])
        before = dict(gs.launches_3d)
        got = b.apply_scattered(u.to(cuda))
        assert gs.launches_3d != before
        assert _rel(a.apply_scattered(u), got) <= RTOL[dt]
    assert seen >= 1


def test_small_3d_solve_on_card_matches_cpu(cuda):
    """The 3D bench's options on its small mesh (n=8, 78 patches)."""
    h = _hierarchy_3d(8)
    opts = SolveOptions(tol=1e-10, precond_dtype=torch.float32)
    f, exact = init_problem(h.finest, get_problem("trig", 3))
    out = {}
    counters.reset()
    for dev in ("cpu", cuda):
        s = PoissonSolver(h, opts, device=dev)
        u, info = s.solve_refined(f, tol=1e-10)
        out[str(dev)] = (u.cpu(), info, s.report(u, f, exact))
    assert gs.launches_3d["float32"] > 0 and gs.launches_3d["float64"] > 0
    assert not any(gs.launches.values())
    (uc, ic, rc), (ug, ig, rg) = out["cpu"], out["cuda"]
    assert ig["outer_iterations"] == ic["outer_iterations"] == 2
    assert abs(ig["inner_iterations"] - ic["inner_iterations"]) <= 2
    assert rg["residual"] <= 1e-10
    assert float((ug - uc).norm() / uc.norm()) <= 1e-9
    assert abs(rg["error"] - rc["error"]) <= 1e-6 * rc["error"]


# --- the Schur path ---------------------------------------------------------


def _schur_mesh(D):
    """The small Schur meshes: 2D refined_tree(2, 3, 1) at n=8, 3D
    refined_tree(3, 3, 2) at n=4."""
    if D == 2:
        return DomainHierarchy(refined_tree(2, 3, 1), n=8), 8
    return _hierarchy_3d(), 4


def _field_and_gamma(lvl, seed):
    rng = np.random.default_rng(seed)
    f = torch.as_tensor(rng.standard_normal((lvl.P,) + lvl.pl.ns_shape), dtype=lvl.dtype)
    g = torch.as_tensor(rng.standard_normal((lvl.num_ifaces, lvl.m)), dtype=lvl.dtype)
    return f, g


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_apply_with_interface_on_card_matches_cpu(cuda, dt, D):
    """``apply_with_interface`` through the kernel (on the vector path:
    ``gamma_faces`` is a fresh tensor) against the CPU, and the identity
    ``apply_with_interface(patch_solve(f, g), g) = f`` on the card, to the
    rounding of the folded right-hand side ``f - G g``."""
    h, n = _schur_mesh(D)
    cpu = Level(h.finest, DTYPES[dt], device="cpu")
    gpu = Level(h.finest, DTYPES[dt], device=cuda)
    f, g = _field_and_gamma(cpu, 8)
    fg, gg = f.to(cuda), g.to(cuda)
    got = _launch_takes(D, _width(n, dt), lambda: gpu.apply_with_interface(fg, gg))
    assert _rel(cpu.apply_with_interface(f, g), got) <= RTOL[dt]
    back = _launch_takes(D, _width(n, dt),
                         lambda: gpu.apply_with_interface(gpu.patch_solve(fg, gg), gg))
    scale = float(gpu.fold_gamma(fg, gg).abs().max())
    assert float((back - fg).abs().max()) <= RTOL[dt] * scale


@pytest.mark.parametrize("D", [2, 3])
def test_bcgs_patch_solve_on_card_matches_cpu(cuda, D):
    """The batched per-patch BiCGStab solve (two kernel launches per
    iteration) on the card against the spectral solve on the CPU."""
    h, n = _schur_mesh(D)
    cpu = Level(h.finest, device="cpu")
    gpu = Level(h.finest, device=cuda, patch_solver="bcgs")
    f, g = _field_and_gamma(cpu, 9)
    name = "launches" if D == 2 else "launches_3d"
    before = getattr(gs, name)["float64"], gs.widths[D][1]
    got = gpu.patch_solve(f.to(cuda), g.to(cuda))
    assert getattr(gs, name)["float64"] > before[0] + 2
    assert gs.widths[D][1] == before[1]
    assert _rel(cpu.patch_solve(f, g), got) <= 1e-8


@pytest.mark.parametrize("D", [2, 3])
def test_solve_schur_gmg_on_card_matches_cpu(cuda, D):
    """``solve_schur`` with the Woodbury GMG preconditioner (f32 V-cycle,
    f64 interface BiCGStab) on the card against the CPU."""
    h, _ = _schur_mesh(D)
    gmg = (CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                     coarse_direct_max_dof=64) if D == 2 else CycleOpts())
    opts = SolveOptions(tol=1e-10, precond_dtype=torch.float32, gmg=gmg)
    f, exact = init_problem(h.finest, get_problem("trig", D))
    name = "launches" if D == 2 else "launches_3d"
    out = {}
    for dev in ("cpu", cuda):
        s = PoissonSolver(h, opts, device=dev)
        counters.reset()
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
        out[str(dev)] = (u.cpu(), res.iterations, s.report(u, f, exact))
    assert getattr(gs, name)["float32"] > 0 and gs.widths[D][1] == 0
    (uc, ic, rc), (ug, ig, rg) = out["cpu"], out["cuda"]
    assert abs(ig - ic) <= 1
    assert rg["residual"] <= max(1e-10, 2 * rc["residual"])
    assert float((ug - uc).abs().max() / uc.abs().max()) <= 1e-8
    assert abs(rg["error"] - rc["error"]) <= 1e-6 * rc["error"]


# --- the CLI and its options --------------------------------------------------


@pytest.mark.parametrize("D, argv", [
    (2, ["--solver", "ir", "--inner-solver", "bicgstab", "--gmg-pre-sweeps", "2",
         "--gmg-fac-smoothing", "active", "--inner-tol", "1e-4"]),
    (2, ["--solver", "cg", "--dtype", "mixed", "--monitor"]),
    (2, ["--schur", "--matrix-type", "pbm"]),
    (3, ["--solver", "ir", "--inner-solver", "bicgstab"]),
], ids=["2d-ir", "2d-cg-monitor", "2d-schur-pbm", "3d-ir"])
def test_cli_on_card_matches_cpu(cuda, D, argv, tmp_path):
    """``cli.main`` on the card and on the CPU: the same counts (inner
    iterations within one: f32 cycles), the error to 1e-6 of itself, the
    residual <= tol; the card run launched the kernel of its dimension on
    the vector path."""
    import json

    from pressurepoissonsolver_torch import cli

    mesh = str(tmp_path / "mesh.bin")
    (refined_tree(2, 3, 1) if D == 2 else refined_tree(3, 3, 2)).to_file(mesh)
    base = ["--mesh", mesh, "-n", "8", "-t", "1e-10", "--gmg-coarse-direct-dof", "64"]
    out = {}
    for dev in ("cpu", "cuda"):
        path = tmp_path / f"{dev}.json"
        counters.reset()
        assert cli.main(D, base + argv + ["--out-json", str(path)], device=dev) == 0
        out[dev] = json.loads(path.read_text())
    launches = gs.launches if D == 2 else gs.launches_3d
    assert sum(launches.values()) > 0 and gs.widths[D][1] == 0
    c, g = out["cpu"], out["cuda"]
    for key in ("iterations", "outer_iterations"):
        if key in c:
            assert g[key] == c[key], key
    if "inner_iterations" in c:
        assert abs(g["inner_iterations"] - c["inner_iterations"]) <= 1
    assert g["residual"] <= 1e-9 and abs(g["error"] - c["error"]) <= 1e-6 * c["error"]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_quadratic_level_apply_on_card_matches_cpu(cuda, dt):
    """The quadratic closures at face depth 2 through the 2D kernel."""
    h = _hierarchy()
    rng = np.random.default_rng(12)
    cpu = Level(h.finest, DTYPES[dt], device="cpu", iface_scheme="quadratic")
    gpu = Level(h.finest, DTYPES[dt], device=cuda, iface_scheme="quadratic")
    assert gpu.face_depth == 2
    u = torch.as_tensor(rng.standard_normal((cpu.P, 8, 8)), dtype=DTYPES[dt])
    got = _launch_takes(2, _width(8, dt), lambda: gpu.apply(u.to(cuda)))
    assert _rel(cpu.apply(u), got) <= RTOL[dt]
    assert _rel(cpu.interpolate(u), gpu.interpolate(u.to(cuda))) <= RTOL[dt]


def test_w_cycle_apply_on_card(cuda):
    """One W-cycle apply on the card against the CPU; its stencil launches
    are the residual applies of every level visit: level k is visited 2^k
    times, with two residuals per visit (the first skipped where nothing
    was pre-smoothed)."""
    h = _hierarchy()
    opts = CycleOpts(cycle_type="W", pre_sweeps=2, fac_smoothing="active",
                     coarse_direct_max_dof=64)
    cpu = build_gmg(h, opts, torch.float32, device="cpu")
    gpu = build_gmg(h, opts, torch.float32, device=cuda)
    f = torch.as_tensor(np.random.default_rng(13).standard_normal((cpu.levels[0].P, 8, 8)),
                        dtype=torch.float32)
    counters.reset()
    got = gpu.apply(f.to(cuda))
    torch.cuda.synchronize()
    L = len(gpu.levels)
    want = sum(2**k * (2 - (gpu._skip[k] or gpu._pre(k) <= 0)) for k in range(L - 1))
    assert gs.launches["float32"] == want == 2 * (2 ** (L - 1) - 1)
    assert gs.widths[2][1] == 0
    assert _rel(cpu.apply(f), got) <= 1e-5


@pytest.mark.parametrize("D", [2, 3])
def test_sparse_operators_on_card_match_cpu(cuda, D):
    """``pbm_matvec`` and ``bcoo_matvec`` (the probed Schur matrix, and the
    composite operator) on the card against the CPU."""
    from pressurepoissonsolver_torch import matrix

    h, n = _schur_mesh(D)
    cpu = Level(h.finest, device="cpu")
    gpu = Level(h.finest, device=cuda)
    f, g = _field_and_gamma(cpu, 14)
    ref = matrix.pbm_matvec(cpu)(g)
    assert _rel(ref, matrix.pbm_matvec(gpu)(g.to(cuda))) <= 1e-12
    A_S = matrix.assemble_schur(cpu)
    assert _rel(ref, matrix.bcoo_matvec(A_S, device=cuda)(g.to(cuda))) <= 1e-12
    A = matrix.assemble_composite(h.finest)
    assert _rel(cpu.apply(f), matrix.bcoo_matvec(A, device=cuda)(f.to(cuda))) <= 1e-12


# --- the measurement surface: bench scripts, time_op, trace ----------------


def test_small_bench_on_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """The port's ``bench`` and ``bench3d`` at a small size on the card
    against the same runs on the CPU: counts, errors; the apply rows are
    device times."""
    from pressurepoissonsolver_torch import bench
    from pressurepoissonsolver_torch.scripts import bench3d

    for k, v in {"PPS_BENCH_N": "8", "PPS_BENCH_DIVIDE": "0",
                 "PPS_BENCH_COARSE_DOF": "64", "PPS_BENCH_REPS": "1",
                 "PPS_BENCH3D_N": "4", "PPS_BENCH3D_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    mesh = str(tmp_path / "mesh3d.bin")
    refined_tree(3, 3, 2).to_file(mesh)
    monkeypatch.setenv("PPS_BENCH3D_MESH", mesh)
    outs = {}
    for main in (bench.main, bench3d.main):
        ref, got = main(device="cpu"), main(device=cuda)
        assert got["dof"] == ref["dof"] and got["outer_iterations"] == ref["outer_iterations"]
        assert abs(got["inner_iterations"] - ref["inner_iterations"]) <= 1
        assert got["residual"] <= 1e-10
        assert abs(got["error"] - ref["error"]) <= 1e-6 * ref["error"]
        assert got["device"] != "cpu" and set(got) == set(ref)
        outs[main] = got
    got = outs[bench.main]
    assert got["apply_timing"] == "held_stream_device"
    assert 0 < got["apply_f32_ms"] and 0 < got["apply_f64_ms"]
    assert abs(got["schur_iterations"] - 5) <= 1 and got["schur_residual"] <= 1e-10


def test_time_op_held_against_a_synchronised_wall(cuda):
    """A held device time of one apply is device time: no longer than the
    synchronised wall of back-to-back calls (which adds the host's pace)."""
    from pressurepoissonsolver_torch.utils import profiling

    lvl = Level(_hierarchy().finest, torch.float32, device=cuda)
    u = torch.randn((lvl.P, 8, 8), device=cuda)
    held, how = profiling.measure(lvl.apply, u, reps=50, in_graph=True)
    wall, how_wall = profiling.measure(lvl.apply, u, reps=50)
    assert (how, how_wall) == ("held_stream_device", "synchronised_wall")
    assert 0 < held <= wall
    assert profiling.time_op(lvl.apply, u, reps=50, in_graph=True, hbm_rotate=3) > 0


def test_time_op_reports_profiler_busy_when_the_hold_cannot_cover(cuda, monkeypatch):
    """A hold too short for the enqueue is detected, never reported as held
    device time: the row falls back to the profiler's device busy time."""
    from pressurepoissonsolver_torch.utils import profiling, timer

    monkeypatch.setattr(timer, "HOLD_CYCLES", 1)
    monkeypatch.setattr(timer, "HOLD_MAX_CYCLES", 1)
    x = torch.ones(1 << 20, device=cuda)

    def many(v):
        for _ in range(64):
            v = v + 1.0
        return v

    with pytest.raises(timer.HostPaced):
        timer.cuda_median_ms(lambda: many(x), reps=20, hold=True)
    t, how = profiling.measure(many, x, reps=20, in_graph=True)
    assert how == "profiler_device_busy" and 0 < t < 1.0


def test_trace_and_op_report_on_card(cuda, tmp_path):
    """A trace of a composite apply on the card names the stencil kernel;
    the op report's rows are held device times with nonzero shares."""
    import json

    from pressurepoissonsolver_torch.utils import profiling

    lvl = Level(_hierarchy().finest, torch.float32, device=cuda)
    u = torch.randn((lvl.P, 8, 8), device=cuda)
    with profiling.trace(str(tmp_path)):
        with profiling.span("pps_card_apply"):
            lvl.apply(u)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "pps_card_apply" in names
    assert any("ghost_stencil_2d_kernel" in nm for nm in names)
    rep = profiling.op_report(lvl, reps=20)
    for row in rep.values():
        assert row["timing"] == "held_stream_device" and row["roofline_pct"] > 0


@pytest.fixture
def mesh1(cuda):
    """A one-rank NCCL mesh on the card, ended with the test."""
    import torch.distributed as dist

    from pressurepoissonsolver_torch.parallel.sharding import make_mesh

    mesh = make_mesh(1)
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sharded_world1_apply_on_card_matches_level(mesh1, dt):
    """The halo engine's apply on a one-rank NCCL mesh (its global level on
    the host) equals the level's, through the 2D kernel on its vector
    path."""
    from pressurepoissonsolver_torch.parallel.halo import ShardedLevel

    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    rng = np.random.default_rng(4)
    for pl in h.levels:
        lvl = Level(pl, DTYPES[dt], device="cuda")
        sl = ShardedLevel(Level(pl, DTYPES[dt], device="cpu"), mesh1, "cuda")
        assert not sl.comm.host_staged and sl.exchange.offsets == []
        u = torch.as_tensor(rng.standard_normal((pl.num_patches, 8, 8)),
                            dtype=DTYPES[dt], device="cuda")
        before = gs.launches[str(DTYPES[dt])[6:]]
        got = _launch_takes(2, _width(8, dt), lambda: sl.apply(u))
        assert gs.launches[str(DTYPES[dt])[6:]] == before + 1
        assert _rel(lvl.apply(u), got) <= RTOL[dt]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sharded_world1_apply_scattered_on_card_matches_level(mesh1, dt):
    """The sharded active-set residual apply (one-rank NCCL mesh) equals
    the single-device one and launches the kernel."""
    from pressurepoissonsolver_torch.parallel.halo import ShardedActiveSmoother

    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    opts = CycleOpts(fac_smoothing="active", coarse_direct_max_dof=64)
    plain = build_gmg(h, opts, DTYPES[dt], device="cuda")
    sharded = build_gmg(h, opts, DTYPES[dt], device="cuda", mesh=mesh1)
    rng = np.random.default_rng(5)
    seen = 0
    for a, b in zip(plain._aapply, sharded._aapply):
        if a is None:
            continue
        seen += 1
        assert isinstance(b, ShardedActiveSmoother)
        u = torch.as_tensor(rng.standard_normal((a.level.P, 8, 8)),
                            dtype=DTYPES[dt], device="cuda")
        before = sum(gs.launches.values())
        got = b.apply_scattered(u)
        assert sum(gs.launches.values()) == before + 1
        assert _rel(a.apply_scattered(u), got) <= RTOL[dt]
    assert seen == 2


def test_sharded_solver_keeps_the_global_levels_on_the_host(mesh1):
    """With a mesh the solver's global levels stay on the host and every
    engine level (GMG and the f32 finest) works on the card."""
    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    s = PoissonSolver(h, SolveOptions(precond_dtype=torch.float32, gmg=CycleOpts(
        fac_smoothing="active", coarse_direct_max_dof=64)), mesh=mesh1, device="cuda")
    f, _ = init_problem(h.finest, get_problem("trig", 2))
    s.solve_refined(f, tol=1e-8)
    engines = [s._op, s._fine_low] + list(s.gmg.levels)
    assert s.fine_level.device.type == "cpu"
    assert all(e.base.device.type == "cpu" for e in engines)
    assert all(e.device.type == "cuda" and e.h2inv.is_cuda and e._cellvol.is_cuda
               for e in engines)
    assert s.gmg._coarse_inv.is_cuda


def test_sharded_world1_solve_on_card_matches_plain(mesh1):
    """``solve_refined`` on a one-rank NCCL mesh takes the plain solver's
    counts to the same solution."""
    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    opts = dict(tol=1e-10, precond_dtype=torch.float32,
                gmg=CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                              coarse_direct_max_dof=64))
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    out = []
    for mesh in (None, mesh1):
        counters.reset()
        s = PoissonSolver(h, SolveOptions(**opts), mesh=mesh, device="cuda")
        u, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
        out.append((u, info, s.report(u, f, exact), dict(gs.launches)))
    (u1, i1, r1, l1), (u2, i2, r2, l2) = out
    assert i2["outer_iterations"] == i1["outer_iterations"] == 3
    assert abs(i2["inner_iterations"] - i1["inner_iterations"]) <= 1
    assert r2["residual"] <= 1e-10 and l2["float32"] > 0 and l2["float64"] > 0
    assert _rel(u1, u2) <= 1e-9


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_gathered_world1_apply_on_card_matches_level(mesh1, dt):
    """The gathered engine's (``comm="pjit"``) apply, smooth and
    interpolate on a one-rank NCCL mesh equal the level's, the apply
    through the 2D kernel with the faces."""
    from pressurepoissonsolver_torch.parallel.gathered import GatheredLevel

    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    rng = np.random.default_rng(6)
    for pl in h.levels[:2]:
        lvl = Level(pl, DTYPES[dt], device="cuda")
        gl = GatheredLevel(Level(pl, DTYPES[dt], device="cpu"), mesh1, "cuda")
        u, f = (torch.as_tensor(rng.standard_normal((pl.num_patches, 8, 8)),
                                dtype=DTYPES[dt], device="cuda") for _ in range(2))
        nogf = dict(gs.launches_nogf[2])
        got = _launch_takes(2, _width(8, dt), lambda: gl.apply(u))
        assert gs.launches_nogf[2] == nogf
        assert _rel(lvl.apply(u), got) <= RTOL[dt]
        assert _rel(lvl.smooth(f, u), gl.smooth(f, u)) <= RTOL[dt]
        assert _rel(lvl.interpolate(u), gl.interpolate(u)[: lvl.num_ifaces]) <= RTOL[dt]


def test_pjit_world1_solve_on_card_matches_plain(mesh1):
    """``solve_refined`` and ``solve_schur(gmg)`` through the gathered
    engine (``comm="pjit"``, masked FAC sweeps) on a one-rank NCCL mesh
    take the plain solver's counts to the same solution."""
    h = DomainHierarchy(refined_tree(2, 4, 2), n=8, num_shards=1)
    opts = dict(tol=1e-10, precond_dtype=torch.float32,
                gmg=CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                              coarse_direct_max_dof=64))
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    out = []
    for mesh, comm in ((None, "auto"), (mesh1, "pjit")):
        counters.reset()
        s = PoissonSolver(h, SolveOptions(comm=comm, **opts), mesh=mesh, device="cuda")
        u, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
        us, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")
        out.append((u, info, us, res.iterations, dict(gs.launches)))
    (u1, i1, us1, n1, _), (u2, i2, us2, n2, l2) = out
    assert type(s._op).__name__ == "GatheredLevel"
    assert i2["outer_iterations"] == i1["outer_iterations"] == 3
    assert abs(i2["inner_iterations"] - i1["inner_iterations"]) <= 1
    assert abs(n2 - n1) <= 1 and l2["float32"] > 0 and l2["float64"] > 0
    assert _rel(u1, u2) <= 1e-9 and _rel(us1, us2) <= 1e-9


# -- the f32 Kronecker forms (PPS_KRON_MAX_N) at the CLI's default n=16 -------

KRON_MESHES = {2: (4, 2), 3: (2, 1)}


def _kron_and_axis(monkeypatch, build):
    """``build()`` with the Kronecker forms (the default knob), then
    without them (``PPS_KRON_MAX_N=0``)."""
    monkeypatch.delenv("PPS_KRON_MAX_N", raising=False)
    kron = build()
    monkeypatch.setenv("PPS_KRON_MAX_N", "0")
    return kron, build()


@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("D", [2, 3])
def test_kron_spectral_solve_on_card_matches_per_axis(cuda, monkeypatch, D, neumann):
    """The Kronecker patch solves of a level and of an active-set subset on
    CUDA tensors at n=16, f32, against the per-axis form (the plain
    chain's solves, ``_spectral_apply``: a 2D sweep on the card takes the
    sweep kernel, which has neither)."""
    h = DomainHierarchy(refined_tree(D, *KRON_MESHES[D]), n=16, neumann=neumann)

    def build():
        lvl = Level(h.finest, dtype=torch.float32, device=cuda)
        return lvl, ActiveSmoother(lvl, np.arange(lvl.P) % 3 == 0)

    (lk, ak), (la, aa) = _kron_and_axis(monkeypatch, build)
    assert lk._st.kron is not None and ak._st.kron is not None and la._st.kron is None
    f = torch.as_tensor(np.random.default_rng(D).standard_normal((lk.P,) + (16,) * D),
                        dtype=torch.float32, device=cuda)
    assert _rel(_spectral_apply(la._st, f, D, 16), _spectral_apply(lk._st, f, D, 16)) <= RTOL["f32"]
    fa = f.index_select(0, ak._act)
    assert (_rel(_spectral_apply(aa._st, fa, D, 16), _spectral_apply(ak._st, fa, D, 16))
            <= RTOL["f32"])


@pytest.mark.parametrize("mode", ["constant", "linear"])
@pytest.mark.parametrize("D", [2, 3])
def test_kron_transfers_on_card_match_per_axis(cuda, monkeypatch, D, mode):
    """``restrict`` and ``prolong_add`` between the two finest levels on
    CUDA tensors at n=16, f32 (full FP32, TF32 off), Kronecker against
    per-axis."""
    from pressurepoissonsolver_torch.gmg import Transfer

    h = DomainHierarchy(refined_tree(D, *KRON_MESHES[D]), n=16)
    fine, coarse = (Level(h[i], dtype=torch.float32, device=cuda) for i in (0, 1))
    tk, ta = _kron_and_axis(monkeypatch, lambda: Transfer(fine, coarse, prolong_mode=mode))
    assert tk._Wp is not None and ta._Wp is None
    rng = np.random.default_rng(10 + D)
    uf, uc = (torch.as_tensor(rng.standard_normal((lvl.P,) + (16,) * D),
                              dtype=torch.float32, device=cuda) for lvl in (fine, coarse))
    assert _rel(ta.restrict(uf), tk.restrict(uf)) <= RTOL["f32"]
    assert _rel(ta.prolong_add(uc, uf), tk.prolong_add(uc, uf)) <= RTOL["f32"]


# --- the solve loops from captured CUDA graphs --------------------------------

# (solver options, entry point) of the captured solves, on the small 2D mesh
GRAPH_SOLVES = {
    "solve-bicgstab": ({}, "solve"),
    "solve-cg": ({"krylov": "cg"}, "solve"),
    "refined-bicgstab": ({"precond_dtype": torch.float32}, "refined"),
    "refined-cg": ({"precond_dtype": torch.float32, "inner_krylov": "cg"}, "refined"),
    "refined-richardson": ({"precond_dtype": torch.float32,
                            "inner_krylov": "richardson"}, "refined"),
    "schur-gmg": ({"precond_dtype": torch.float32}, "schur"),
}
GRAPH_GMG = CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
                      coarse_direct_max_dof=64)


def _graph_solver(cuda, D=2, **opts):
    h = _hierarchy() if D == 2 else _hierarchy_3d(8)
    s = PoissonSolver(h, SolveOptions(tol=1e-10, gmg=GRAPH_GMG, **opts), device=cuda)
    f, exact = init_problem(h.finest, get_problem("trig", D))
    return s, torch.as_tensor(f, device=cuda), torch.as_tensor(exact, device=cuda)


def _graph_run(s, f, how, **kw):
    """``(u, counts)`` of one solve."""
    if how == "solve":
        res = s.solve(f, **kw)
        return res.x, (res.iterations,)
    if how == "refined":
        u, info = s.solve_refined(f, tol=kw.get("tol", 1e-10), inner_tol=1e-4)
        return u, (info["outer_iterations"], info["inner_iterations"])
    u, res = s.solve_schur(f, tol=kw.get("tol", 1e-10), max_iter=60, preconditioner="gmg")
    return u, (res.iterations,)


@pytest.mark.parametrize("D, case", [(2, c) for c in GRAPH_SOLVES]
                         + [(3, "refined-bicgstab"), (3, "schur-gmg")])
def test_captured_solve_on_card_matches_eager(cuda, D, case):
    """On one card the loops run from captured graphs by default; in turns
    with the eager loop (captured (the capture), eager, eager, captured
    (replays only)) they give the same counts, the same iterate bit for
    bit and the same stencil launch counts (the replays counted per
    step)."""
    opts, how = GRAPH_SOLVES[case]
    s, f, exact = _graph_solver(cuda, D, **opts)
    assert s._graphs
    out = {}
    for mode in (True, False, False, True):
        s._graphs = mode
        counters.reset()
        u, counts = _graph_run(s, f, how)
        torch.cuda.synchronize()
        out.setdefault(mode, []).append((u, counts, gs.counters()))
    assert len(s._captured) == 1
    (ug, cg, lg), (ue, ce, le) = out[True][1], out[False][0]
    assert cg == ce and torch.equal(ug, ue) and lg == le
    assert torch.equal(out[True][0][0], ug) and out[True][0][2] == lg
    assert torch.equal(out[False][1][0], ue)
    assert sum(lg[0 if D == 2 else 1].values()) > 0
    assert s.report(ug, f, exact)["residual"] <= 1e-9


@pytest.mark.parametrize("D, case", [(2, c) for c in GRAPH_SOLVES]
                         + [(3, "refined-bicgstab"), (3, "schur-gmg")])
def test_captured_graph_holds_the_accounted_stencil_launches(cuda, D, case):
    """The launches the replay accounting adds per replay are the stencil
    kernel nodes of the graph the card replays, read back from the graph
    through the driver API (``chip_smoke.graph_stencils``)."""
    from chip_smoke import delta_stencils, graph_kernel_names, graph_stencils

    opts, how = GRAPH_SOLVES[case]
    s, f, _ = _graph_solver(cuda, D, **opts)
    _graph_run(s, f, how)
    (entry,) = s._captured.values()
    nodes = graph_stencils(entry.graph, D)
    assert nodes == delta_stencils(entry.launches, D) and sum(nodes.values()) > 0
    assert len(graph_kernel_names(entry.graph)) > sum(nodes.values())


def test_captured_loop_skips_steps_once_the_guard_is_false(cuda):
    """A false guard runs no step: the state stays as it was, bit for bit,
    and the step count with it (a zero right-hand side stops at once, with
    the static state untouched)."""
    from pressurepoissonsolver_torch import krylov
    from pressurepoissonsolver_torch.utils.graphs import CapturedLoop

    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    low = s.gmg.levels[0]
    f32 = f.to(torch.float32)
    cap = CapturedLoop(krylov.bicgstab_loop(low.apply, s.gmg.apply), f32, 1e-4, 60)
    res = cap.run(f32, 1e-4, 60)
    assert 0 < res.iterations < 60
    before = [t.clone() for t in cap.state]
    assert not bool(cap.state.go)
    state, steps = krylov.run_loop(cap.state, cap._replay)
    assert steps == 0 and all(torch.equal(a, b) for a, b in zip(before, cap.state))
    zero = cap.run(torch.zeros_like(f32), 1e-4, 60)
    assert zero.iterations == 0 and int(cap.state.k) == 0
    assert not bool(zero.x.abs().max())


def test_captured_solves_give_unaliased_answers(cuda):
    """Two solves with different right-hand sides from one captured loop:
    two correct answers, the first not overwritten by the second."""
    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    u1, i1 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    keep = u1.clone()
    u2, i2 = s.solve_refined(3 * f + 1, tol=1e-10, inner_tol=1e-4)
    assert len(s._captured) == 1
    assert torch.equal(u1, keep) and u1.data_ptr() != u2.data_ptr()
    s._graphs = False
    e1, _ = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    e2, _ = s.solve_refined(3 * f + 1, tol=1e-10, inner_tol=1e-4)
    assert torch.equal(u1, e1) and torch.equal(u2, e2)


@pytest.mark.parametrize("how", ["solve", "refined", "schur"])
def test_captured_loop_with_a_new_tol_stops_where_eager_does(cuda, how):
    """``tol`` is a buffer of the graph, not part of its key: a loosened
    and a tightened ``tol`` after the capture stop where the eager loop
    does, with the same iterate, and capture nothing new."""
    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    seen = []
    for tol in (1e-10, 1e-4, 1e-12):
        s._graphs = True
        ug, cg = _graph_run(s, f, how, tol=tol)
        s._graphs = False
        ue, ce = _graph_run(s, f, how, tol=tol)
        assert cg == ce and torch.equal(ug, ue)
        seen.append(cg)
    assert len(s._captured) == 1 and seen[1] != seen[0]


def test_captured_loop_with_a_new_step_limit_stops_where_eager_does(cuda):
    """The step limit is a buffer of the graph too: after the capture a
    lower ``max_iter`` stops the captured loop where it stops the eager
    one, and a new limit captures nothing new."""
    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    seen = []
    for max_iter in (1000, 2, 1000):
        s._graphs = True
        rg = s.solve(f, max_iter=max_iter)
        s._graphs = False
        re_ = s.solve(f, max_iter=max_iter)
        assert rg.iterations == re_.iterations and torch.equal(rg.x, re_.x)
        seen.append(rg.iterations)
    assert len(s._captured) == 1 and seen[1] == 2 and seen[0] == seen[2] > 2


def test_capture_that_cannot_be_made_raises(cuda):
    """An operator that reads a flag to the host on every call cannot be
    captured: its eager solve runs, and its one-launch solve raises instead
    of falling back to the eager loop.  (The batched patch BiCGStab, which
    read a flag per pass, is a loop of the solve's graph now, see
    ``test_one_launch_solve_matches_steps_and_eager``.)"""
    s, f, _ = _graph_solver(cuda)

    def A(u):
        if bool(torch.isnan(u).any()):  # a host read on every call
            raise ValueError("a non-finite iterate")
        return s.apply(u)

    M = s._preconditioner()
    s._graphs = False
    s.solve_matrix("host-read", A, f, M=M, max_iter=3)
    s._graphs = True
    with pytest.raises(RuntimeError):
        s.solve_matrix("host-read", A, f, M=M, max_iter=3)
    s._graphs = False
    assert s.solve_matrix("host-read", A, f, M=M, max_iter=3).iterations == 3


# --- the solves as one graph launch (WHILE nodes) -----------------------------

# the one-launch solves: the captured solves above and GMRES (composite and
# Schur), on the small 2D mesh
LOOP_SOLVES = {
    **GRAPH_SOLVES,
    "solve-gmres": ({"krylov": "gmres"}, "solve"),
    "schur-gmres": ({"precond_dtype": torch.float32, "krylov": "gmres"}, "schur"),
    # the batched patch BiCGStab smooths the finest level (f64 cycle) and
    # solves the Schur operator's patch systems: loops inside pieces
    "solve-bcgs": ({"patch_solver": "bcgs"}, "solve"),
    "refined-bcgs": ({"patch_solver": "bcgs"}, "refined"),
    "schur-bcgs": ({"precond_dtype": torch.float32, "patch_solver": "bcgs"}, "schur"),
}
LOOP_CASES = [(2, c) for c in LOOP_SOLVES] + [(3, "refined-bicgstab"), (3, "solve-gmres")]


def _counted(s, f, how, **kw):
    """One solve with every launch counter set to 0 just before it:
    ``(u, counts, kernel counters by table name (``utils.counters``: the
    stencils', the sweep's, the transfers' and the patch solves'),
    graph_loop counters, host reads made inside the solve)``."""
    from pressurepoissonsolver_torch import krylov
    from pressurepoissonsolver_torch.utils import graphs

    counters.reset()
    graphs.reset_launches()
    reads = krylov.reads["host"]
    u, counts = _graph_run(s, f, how, **kw)
    reads = krylov.reads["host"] - reads
    torch.cuda.synchronize()
    return u, counts, counters.snapshot(), dict(graphs.launches), reads


@pytest.mark.parametrize("D, case", LOOP_CASES)
def test_one_launch_solve_matches_steps_and_eager(cuda, D, case):
    """The default on one card is one graph launch per solve; in turns with
    the per-step replay and the eager loop (one launch (the capture),
    steps, eager, eager, steps, one launch) every solve gives the same
    counts, the same iterate bit for bit and the same stencil launch
    counts; a one-launch solve makes one graph launch and one host read,
    the per-step replay none and a read per guard."""
    opts, how = LOOP_SOLVES[case]
    s, f, exact = _graph_solver(cuda, D, **opts)
    assert s._graphs is True
    out = {}
    for mode in (True, "steps", False, False, "steps", True):
        s._graphs = mode
        out.setdefault(mode, []).append(_counted(s, f, how))
    assert len(s._captured) == 1
    ref_u, ref_c, ref_l = out[False][0][:3]
    for runs in out.values():
        for u, counts, launched, _, _ in runs:
            assert counts == ref_c and torch.equal(u, ref_u) and launched == ref_l
    _, _, _, one, one_reads = out[True][1]
    _, _, _, steps, steps_reads = out["steps"][1]
    assert one["graph"] == 1 and one_reads == 1
    assert one["guard"] > one["passes"] > 0
    assert steps["graph"] == steps["guard"] == 0 and steps_reads > one["passes"]
    assert sum(ref_l[f"ghost_stencil.{D}d"].values()) > 0
    assert s.report(ref_u, f, exact)["residual"] <= 1e-9


@pytest.mark.parametrize("D, case", LOOP_CASES)
def test_while_bodies_hold_the_accounted_stencils(cuda, D, case):
    """The stencil kernel nodes of each level of the composed graph (the
    root and each WHILE body, child graphs included, nested bodies not),
    read back through the driver API, are the launches the accounting adds
    per pass of that level; every node is of a kind a WHILE body may hold;
    each loop has a guard ahead of it and one closing its body."""
    from chip_smoke import graph_levels, graph_stencils, level_launches

    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, D, **opts)
    _graph_run(s, f, how)
    (entry,) = s._captured.values()
    gl = entry.graphs
    levels = graph_levels(gl)
    want = level_launches(gl)
    assert set(levels) == set(want) and len(levels) == len(gl.whiles) + 1
    allowed = {"kernel", "memcpy", "memset", "graph", "empty", "conditional"}
    for level, got in levels.items():
        assert got["stencils"] == want[level], level
        assert set(got["kinds"]) <= allowed, got["kinds"]
        nested = sum(1 for w in gl.whiles if _parent(gl, w) == level)
        assert got["guards"] == nested + (level != "root"), (level, got)
    total = graph_stencils(gl.root, D, gl.loop_nodes)
    assert total == {dt: sum(v[D][dt] for v in want.values()) for dt in total}
    assert sum(want[len(gl.whiles) - 1][D].values()) > 0


def _parent(gl, w):
    """The level (``"root"`` or a loop slot) whose graph holds the WHILE
    node of ``w``."""
    def find(tree, level):
        for item in tree:
            if hasattr(item, "body") and hasattr(item, "index"):
                if gl.whiles[item.index] is w:
                    return level
                got = find(item.body, item.index)
                if got is not None:
                    return got
        return None

    return find(gl.tree, "root")


@pytest.mark.parametrize("case", ["solve-bicgstab", "solve-gmres", "refined-bicgstab",
                                  "schur-gmres"])
def test_one_launch_solve_of_a_zero_rhs_runs_zero_steps(cuda, case):
    """A zero right-hand side after the capture: the guards are false after
    the init, so no loop runs a pass (the refinement runs its one round,
    whose inner loop runs none), as the eager loop."""
    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, **opts)
    _graph_run(s, f, how)
    zero = torch.zeros_like(f)
    u, counts, launched, g, _ = _counted(s, zero, how)
    s._graphs = False
    ue, ce, le, _, _ = _counted(s, zero, how)
    assert counts == ce and torch.equal(u, ue) and launched == le
    assert counts == ((1, 0) if how == "refined" else (0,))
    assert g["passes"] == (1 if how == "refined" else 0)
    if how != "schur":
        assert not bool(u.abs().max())


@pytest.mark.parametrize("case", ["solve-bicgstab", "solve-cg", "solve-gmres"])
def test_one_launch_solve_stops_at_max_iter(cuda, case):
    """A step limit below the count after the capture stops the one-launch
    solve where it stops the eager one (GMRES: at the first cycle boundary
    at or past it)."""
    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, **opts)
    full = _graph_run(s, f, how)[1][0]
    u, counts, launched, _, _ = _counted(s, f, how, max_iter=2)
    s._graphs = False
    ue, ce, le, _, _ = _counted(s, f, how, max_iter=2)
    assert counts == ce and torch.equal(u, ue) and launched == le
    assert len(s._captured) == 1
    assert counts[0] == 2 if case != "solve-gmres" else 2 <= counts[0] <= full


def test_one_launch_refinement_stops_at_its_limits(cuda):
    """``inner_max_iter=2`` stops every inner loop at 2 steps and
    ``max_outer=2`` the rounds at 2, after the capture, as eagerly."""
    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    for kw in (dict(inner_max_iter=2), dict(max_outer=2)):
        out = {}
        for mode in (True, False):
            s._graphs = mode
            u, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4, **kw)
            out[mode] = (u, info["outer_iterations"], info["inner_iterations"],
                         list(info["outer_history"]))
        assert out[True][1:] == out[False][1:] and torch.equal(out[True][0], out[False][0])
        k, inner = out[True][1:3]
        assert inner == 2 * k if "inner_max_iter" in kw else k == 2
    assert len(s._captured) == 1


@pytest.mark.parametrize("case", ["solve-gmres", "refined-cg", "schur-gmres"])
def test_one_launch_solve_takes_new_inputs_without_a_new_capture(cuda, case):
    """A new right-hand side, ``tol`` and step limit after the capture: the
    same graph, the eager loop's counts and iterate."""
    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, **opts)
    _graph_run(s, f, how)
    (entry,) = s._captured.values()
    for rhs, tol in ((3 * f + 1, 1e-10), (f, 1e-4), (f, 1e-12)):
        s._graphs = True
        ug, cg = _graph_run(s, rhs, how, tol=tol)
        s._graphs = False
        ue, ce = _graph_run(s, rhs, how, tol=tol)
        assert cg == ce and torch.equal(ug, ue)
    assert list(s._captured.values()) == [entry]


def test_refinement_sync_false_leaves_the_counts_on_the_card(cuda):
    """``solve_refined(sync=False)``: no host read inside the solve; its
    counts, residual and history are tensors on the card equal to the
    ``sync=True`` solve's (the history has ``max_outer + 1`` slots, 1 past
    the rounds), and its stencil launches are read at the next
    ``counters()``."""
    from pressurepoissonsolver_torch import krylov

    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float32)
    u1, info1 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    counters.reset()
    s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    synced = gs.counters()
    counters.reset()
    reads = krylov.reads["host"]
    u2, info2 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4, sync=False)
    assert krylov.reads["host"] == reads
    assert all(torch.is_tensor(v) and v.is_cuda for v in info2.values())
    k = int(info2["outer_iterations"])
    assert k == info1["outer_iterations"]
    assert int(info2["inner_iterations"]) == info1["inner_iterations"]
    assert float(info2["residual"]) == info1["residual"]
    hist = info2["outer_history"].cpu().numpy()
    assert hist.shape == (13,) and np.array_equal(hist[:k + 1], info1["outer_history"])
    assert np.all(hist[k + 1:] == 1.0)
    assert torch.equal(u1, u2)
    assert gs.counters() == synced


class _Counter(NamedTuple):
    k: torch.Tensor
    j: torch.Tensor
    total: torch.Tensor
    go: torch.Tensor
    go_in: torch.Tensor


@pytest.mark.parametrize("n, m", [(3, 4), (0, 5), (2, 0), (1, 1)])
def test_nested_while_nodes_count_as_the_plain_loop(cuda, n, m):
    """Two nested loops of counter pieces (``n`` rounds of ``m`` steps,
    both read from input buffers) as one graph launch against the plain
    version (each guard read on the host): the same state and passes,
    zero passes where a guard is false after its init, the guard kernel
    run once ahead of each loop's entry and once per pass, and the device
    nodes that ran (``launches["nodes"]``)."""
    from pressurepoissonsolver_torch.krylov import While
    from pressurepoissonsolver_torch.utils import graphs

    nb = torch.full((), n, dtype=torch.int64, device=cuda)
    mb = torch.full((), m, dtype=torch.int64, device=cuda)
    zero = torch.zeros((), dtype=torch.int64, device=cuda)

    def init(n_, m_):
        return _Counter(zero.clone(), zero.clone(), zero.clone(), zero < n_, zero > 0)

    def begin(st):
        return st._replace(j=torch.zeros_like(st.j), go_in=zero < mb)

    def step(st):
        j = st.j + 1
        return st._replace(j=j, total=st.total + 1, go_in=j < mb)

    def end(st):
        k = st.k + 1
        return st._replace(k=k, go=k < nb)

    body = (While(lambda st: st.go, (begin, While(lambda st: st.go_in, (step,)), end)),)
    gl = graphs.GraphLoop((nb, mb), init, body, lambda: init(nb, mb), step, cuda)
    runs_plain = gl.replay()
    plain = [int(t) for t in gl.state]
    graphs.reset_launches()
    gl.launch()
    torch.cuda.synchronize()
    runs = gl.runs.tolist()
    gl.account(runs)
    assert runs == runs_plain == [n, n * m]
    assert [int(t) for t in gl.state] == plain
    assert int(gl.state.k) == n and int(gl.state.total) == n * m
    # the device nodes: each piece's per run, the guard kernels and the
    # memset of the pass counters
    init_p, outer = gl.tree
    begin_p, inner, end_p = outer.body
    (step_p,) = inner.body
    nodes = (init_p.nodes + n * (begin_p.nodes + end_p.nodes) + n * m * step_p.nodes
             + (1 + n + n + n * m) + 1)
    assert graphs.launches == {"guard": 1 + n + n + n * m, "passes": n + n * m, "graph": 1,
                               "nodes": nodes}
    assert min(p.nodes for p in (init_p, begin_p, step_p, end_p)) > 0


# --- loops inside captured pieces; the monitored and assembled-matrix solves --

def test_while_node_added_in_a_capture_cannot_be_a_child_graph(cuda):
    """The probe of a WHILE node added to a graph while torch captures it
    (``pps_capture_add_while``): torch's replay of the captured graph runs
    the loop, but the CUDA driver refuses to clone that graph into a
    child-graph node (``cudaErrorNotSupported``), which is how
    ``GraphLoop`` composes pieces; so a loop inside a piece cuts the piece
    instead (``graphs.PieceLoop``)."""
    import ctypes

    from pressurepoissonsolver_torch.utils import graphs

    x = torch.zeros((), dtype=torch.int64, device=cuda)
    go = torch.ones((), dtype=torch.bool, device=cuda)
    runs = torch.zeros(1, dtype=torch.int64, device=cuda)
    y = torch.zeros((), dtype=torch.int64, device=cuda)

    def body():
        x.add_(1)
        go.copy_(x < 5)

    body_graph, _ = graphs.capture(body, cuda)

    def piece():
        x.zero_()
        go.copy_(x < 5)
        if torch.cuda.is_current_stream_capturing():
            node, inner = ctypes.c_void_p(), ctypes.c_void_p()
            graphs._call("pps_capture_add_while", torch.cuda.current_stream().cuda_stream,
                         ctypes.c_void_p(body_graph.raw_cuda_graph()), go.data_ptr(),
                         runs.data_ptr(), ctypes.byref(node), ctypes.byref(inner))
        else:
            while bool(go):
                body()
        y.copy_(10 * x)

    graph, _ = graphs.capture(piece, cuda)
    y.zero_()
    runs.zero_()
    graph.replay()
    assert int(y) == 50 and int(runs[0]) == 5
    root, node = ctypes.c_void_p(), ctypes.c_void_p()
    graphs._call("pps_graph_create", ctypes.byref(root))
    with pytest.raises(RuntimeError, match="CUDA error 801"):
        graphs._call("pps_graph_add_child", root, None,
                     ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(node))
    graphs._call("pps_graph_destroy", root, None)


class _Inner(NamedTuple):
    k: torch.Tensor
    x: torch.Tensor
    go: torch.Tensor


class _Outer(NamedTuple):
    y: torch.Tensor
    j: torch.Tensor
    go: torch.Tensor


@pytest.mark.parametrize("m", [0, 1, 7])
def test_loop_inside_a_piece_cuts_it(cuda, m):
    """A loop inside a piece (``graphs.PieceLoop``, ``m`` passes of ``x +=
    k + 1``) run in each of two rounds of an outer loop: the piece is cut
    into its part before the loop, the loop and its part after it; one
    graph launch gives the per-step replay's state and passes, the loop's
    slot counting its passes over both rounds and its largest run ``m``."""
    from pressurepoissonsolver_torch.krylov import While
    from pressurepoissonsolver_torch.utils import graphs

    mb = torch.full((), m, dtype=torch.int64, device=cuda)
    zero = torch.zeros((), dtype=torch.int64, device=cuda)
    holder = {}

    def step(st):
        k = st.k + 1
        return _Inner(k, st.x + k, k < mb)

    def inner(start):
        st = _Inner(zero.clone(), start, zero < mb)
        if graphs.capturing(start):
            return holder["loop"].captured(st).x.clone()
        loop = holder.get("loop")
        if loop is None:
            loop = holder["loop"] = graphs.PieceLoop(st, step, cuda)
        return loop.replay(st).x.clone()

    def round_(st):
        j = st.j + 1
        return _Outer(2 * inner(st.y) + 1, j, j < 2)

    def init(_):
        return _Outer(zero.clone(), zero.clone(), zero < 1)

    body = (While(lambda st: st.go, (round_,)),)
    gl = graphs.GraphLoop((mb,), init, body, lambda: init(mb), round_, cuda)
    assert [type(t).__name__ for t in gl.tree[1].body] == ["_Piece", "_Loop", "_Piece"]
    assert gl.inner == [(1, holder["loop"])]
    graphs.reset_launches()
    runs_plain, _ = gl.run(False)
    plain = [int(t) for t in gl.state]
    steps_inner = dict(graphs.inner)
    graphs.reset_launches()
    runs, _ = gl.run(True)
    assert runs == runs_plain == [2, 2 * m]
    assert [int(t) for t in gl.state] == plain
    total = m * (m + 1) // 2
    assert plain[0] == 2 * (2 * total + 1) + 1 + 2 * total  # y after two rounds
    assert dict(graphs.inner) == steps_inner == {"passes": 2 * m, "runs": 2, "largest": m}
    assert graphs.launches["graph"] == 1


MATRIX_SOLVES = ("monitored-bicgstab", "monitored-cg", "monitored-schur", "crs", "schur-pbm",
                 "monitored-bcgs")


def _matrix_run(s, f, case, ops):
    """One solve of ``case``: ``(u, counts)``."""
    from pressurepoissonsolver_torch.matrix import assemble_composite, bcoo_matvec, pbm_matvec

    if case.startswith("monitored"):
        u, res, hist = s.solve_monitored(f, max_iter=100, schur=case == "monitored-schur",
                                         schur_preconditioner="gmg")
        return u, (res.iterations, len(hist), float(hist[-1]))
    if case == "crs":
        A = ops.setdefault("A", bcoo_matvec(assemble_composite(s.hierarchy.finest),
                                            device=f.device))
        res = s.solve_matrix("crs", A, f, M=s._preconditioner(), tol=1e-10, max_iter=100)
        return res.x, (res.iterations,)
    S = ops.setdefault("S", pbm_matvec(s.fine_level))
    prepare, finish = s._schur_ends()
    res, u = s.solve_matrix("schur-pbm", S, f, M=s._schur_preconditioner("gmg"), tol=1e-10,
                            max_iter=100, prepare=prepare, finish=finish)
    return u, (res.iterations,)


@pytest.mark.parametrize("case", MATRIX_SOLVES)
def test_one_launch_monitored_and_matrix_solves_match_eager(cuda, case):
    """``solve_monitored`` (BiCGStab, CG, the Schur form, BiCGStab over bcgs
    smoothing) and ``solve_matrix`` (the assembled CRS operator and the
    probed pointer-block Schur operator) in turns one launch, per step and
    eager: the same counts, history and iterate bit for bit, the same
    stencil launches; one graph launch and one host read per one-launch
    solve, under one key."""
    from pressurepoissonsolver_torch import krylov
    from pressurepoissonsolver_torch.utils import graphs

    opts = {"krylov": "cg"} if case == "monitored-cg" else {}
    if case == "monitored-bcgs":
        opts["patch_solver"] = "bcgs"
    if case in ("monitored-schur", "schur-pbm"):
        opts["precond_dtype"] = torch.float32
    s, f, exact = _graph_solver(cuda, **opts)
    ops, out = {}, {}
    for mode in (True, "steps", False, True):
        s._graphs = mode
        counters.reset()
        graphs.reset_launches()
        reads = krylov.reads["host"]
        u, counts = _matrix_run(s, f, case, ops)
        reads = krylov.reads["host"] - reads
        out.setdefault(mode, []).append((u, counts, gs.counters(), dict(graphs.launches),
                                         reads))
    assert len(s._captured) == 1
    ref_u, ref_c, ref_l = out[False][0][:3]
    for runs in out.values():
        for u, counts, launched, _, _ in runs:
            assert counts == ref_c and torch.equal(u, ref_u) and launched == ref_l
    _, _, _, one, one_reads = out[True][1]
    assert one["graph"] == 1 and one_reads == 1 and one["guard"] > one["passes"] > 0
    assert s.report(ref_u, f, exact)["residual"] <= 1e-9


def test_refinement_sync_false_with_bcgs_smoothing(cuda):
    """``solve_refined(sync=False)`` on a solver whose cycle smooths with
    the bcgs patch solves (loops inside the inner loop's pieces): no host
    read inside the solve, the ``sync=True`` solve's iterate and counts,
    and its stencil launches and patch passes read at the next
    ``counters()``."""
    from pressurepoissonsolver_torch import krylov
    from pressurepoissonsolver_torch.utils import graphs

    s, f, _ = _graph_solver(cuda, precond_dtype=torch.float64, patch_solver="bcgs")
    u1, info1 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    counters.reset()
    graphs.reset_launches()
    s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    synced, inner = gs.counters(), dict(graphs.inner)
    assert inner["passes"] > inner["runs"] > 0
    counters.reset()
    graphs.reset_launches()
    reads = krylov.reads["host"]
    u2, info2 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4, sync=False)
    assert krylov.reads["host"] == reads
    assert int(info2["outer_iterations"]) == info1["outer_iterations"]
    assert int(info2["inner_iterations"]) == info1["inner_iterations"]
    assert torch.equal(u1, u2)
    assert gs.counters() == synced and dict(graphs.inner) == inner


# --- spans: device stamps, graph nodes, the clock offset ----------------------

def _stamped_refined(cuda):
    """A small 2D ``solve_refined``: its one-launch answer, then the same
    solve stamped (after the solve that captures the stamped graph) with its
    device record and info."""
    from pressurepoissonsolver_torch.utils import profiling

    s, f, _ = _graph_solver(cuda, 2, precond_dtype=torch.float32)
    u0, _ = _graph_run(s, f, "refined")
    with profiling.device_spans(cuda):
        _graph_run(s, f, "refined")
    with profiling.device_spans(cuda) as rec:
        u1, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    return s, f, u0, u1, info, rec


def test_stamps_inside_while_bodies_count_passes_times_stamps_per_pass(cuda):
    """A stamped one-launch solve is bit for bit the unstamped one; its
    stamps inside the WHILE bodies number the passes times the stamps of a
    pass: a V-cycle and an operator apply per preconditioned product, two
    per inner iteration, a round's pieces per round."""
    s, _, u0, u1, info, rec = _stamped_refined(cuda)
    assert torch.equal(u0, u1) and rec.overflow == 0
    assert sorted(s._captured) == [("refined", "bicgstab"), ("refined", "bicgstab", "stamped")]
    sp = rec.spans()
    names = [x.name for x in sp]
    outer, inner = info["outer_iterations"], info["inner_iterations"]
    assert names.count("pps.solver.solve_refined") == 1
    assert names.count("pps.graphs.piece.step") == inner
    assert names.count("pps.gmg.vcycle") == names.count("pps.krylov.operator") == 2 * inner
    for piece in ("begin", "end"):
        assert names.count(f"pps.graphs.piece.{piece}") == outer
    assert names.count("pps.solver.round_end") == outer
    levels = sum(x.name.startswith("pps.gmg.L") or x.name == "pps.gmg.coarse" for x in sp)
    assert levels > 0 and levels % (2 * inner) == 0
    assert len(rec.entries) == 2 * len(sp)  # no clock stamp without a profiler
    for x in sp:
        assert x.t0_ns <= x.t1_ns and x.self_ns >= 0


def test_a_graph_captured_with_tracing_off_holds_no_stamp_node(cuda):
    """Every piece of the graph ``solve_refined`` captures with tracing off
    is free of stamp kernels; each piece of the stamped graph holds at least
    its own two."""
    from chip_smoke import graph_kernel_names

    s, *_ = _stamped_refined(cuda)

    def names(entry):
        return [graph_kernel_names(p.graph) for p in entry.graphs.pieces.values()]

    for kernels in names(s._captured[("refined", "bicgstab")]):
        assert kernels and not any("pps_stamp" in k for k in kernels)
    for kernels in names(s._captured[("refined", "bicgstab", "stamped")]):
        assert kernels.count("pps_stamp") >= 2


def test_a_one_launch_schur_solve_at_n16_nests_its_spans_and_counts_its_patch_solves(cuda):
    """``solve_schur`` at n=16 on a small graded mesh, one graph launch a
    solve: stamped, it is bit for bit the unstamped solve, and its device
    spans nest as ``pps.solver.solve_schur`` > ``pps.krylov.operator`` >
    ``pps.level.schur_S`` > ``pps.level.patch_solve`` and
    ``pps.level.interpolate``; the patch-solve counter of a one-launch solve
    is the ``2k + 2`` passes its ``k`` iterations imply, each over every
    patch; the graph captured with tracing off holds no stamp node, each
    piece of the stamped one its own two at least."""
    from chip_smoke import graph_kernel_names
    from pressurepoissonsolver_torch.utils import graphs, profiling

    h = DomainHierarchy(refined_tree(2, 3, 1), n=16)
    s = PoissonSolver(h, SolveOptions(tol=1e-10, gmg=GRAPH_GMG, precond_dtype=torch.float32),
                      device=cuda)
    f = torch.as_tensor(init_problem(h.finest, get_problem("trig", 2))[0], device=cuda)
    u0, (k,) = _graph_run(s, f, "schur")
    assert s._graphs is True and k > 0
    counters.reset()
    graphs.reset_launches()
    u1, (k1,) = _graph_run(s, f, "schur")
    assert graphs.launches["graph"] == 1 and k1 == k and torch.equal(u0, u1)
    passes = 2 * k + 2
    assert level_ops.patch_solves() == {"passes": passes,
                                        "patches": passes * h.finest.num_patches}
    with profiling.device_spans(cuda):
        _graph_run(s, f, "schur")
    with profiling.device_spans(cuda) as rec:
        u2, _ = _graph_run(s, f, "schur")
    assert torch.equal(u0, u2) and rec.overflow == 0
    sp = rec.spans()
    names = [x.name for x in sp]
    assert names.count("pps.solver.solve_schur") == 1 and sp[0].name == "pps.solver.solve_schur"
    assert names.count("pps.level.schur_S") == names.count("pps.krylov.operator") == 2 * k
    assert names.count("pps.level.patch_solve") == 2 * k + 2
    for i, x in enumerate(sp):
        if x.name != "pps.level.schur_S":
            continue
        up, j = [], i
        while sp[j].parent >= 0:
            j = sp[j].parent
            up.append(sp[j].name)
        assert up[0] == "pps.krylov.operator" and up[-1] == "pps.solver.solve_schur"
        assert [y.name for y in sp if y.parent == i] == ["pps.level.patch_solve",
                                                           "pps.level.interpolate"]
        assert sp[i].t0_ns <= sp[i].t1_ns and sp[i].self_ns >= 0

    def kernels(key):
        return [graph_kernel_names(p.graph) for p in s._captured[key].graphs.pieces.values()]

    for names_ in kernels(("schur", "gmg")):
        assert names_ and not any("pps_stamp" in n for n in names_)
    for names_ in kernels(("schur", "gmg", "stamped")):
        assert names_.count("pps_stamp") >= 2


# A profiler session in a process that has run many (the card tests before
# these) may record no kernel at all, or lose some records; the two tests
# that read a trace record by record take theirs in a fresh process.
_CLOCK_TRACE = """
import json, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from pressurepoissonsolver_torch.utils import profiling

with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    with profiling.device_spans("cuda") as rec:
        for _ in range(4):
            time.sleep(0.01)
            rec.clock_ordinals.append(profiling.device_clock_offset())
prof.export_chrome_trace(sys.argv[1])
with open(sys.argv[1]) as fh:
    events = json.load(fh)["traceEvents"]
offsets = rec.clock_offsets(events)
print(json.dumps({
    "starts": sorted(e["ts"] for e in events if e.get("name") == profiling.CLOCK_KERNEL
                     and str(e.get("cat", "")).lower() == "kernel"),
    "mapped": [rec.trace_us(t, offsets) for t in rec.clocks()] if offsets else None,
    "offsets": offsets}))
"""

_REPLAY_TRACE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from pressurepoissonsolver_torch import krylov
from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.gmg import CycleOpts
from pressurepoissonsolver_torch.problems import get_problem, init_problem
from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
from pressurepoissonsolver_torch.utils import counters
from pressurepoissonsolver_torch.utils import graphs, profiling

h = DomainHierarchy(refined_tree(2, 4, 2), n=8)
gmg = CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active", coarse_direct_max_dof=64)
s = PoissonSolver(h, SolveOptions(tol=1e-10, gmg=gmg, precond_dtype=torch.float32),
                  device="cuda")
f = torch.as_tensor(init_problem(h.finest, get_problem("trig", 2))[0], device="cuda")

def counted():
    graphs.reset_launches()
    reads = krylov.reads["host"]
    s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    return dict(graphs.launches), krylov.reads["host"] - reads

s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
one, _ = counted()
s._graphs = "steps"
steps, reads = counted()
profiling.enable()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[1])
with open(sys.argv[1]) as fh:
    events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
(a, b), = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "user_annotation" and e["name"] == "pps.graphs.replay"]
launched = {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
inside = [e["cat"] for e in events
          if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")
          and a <= launched.get(e.get("args", {}).get("correlation"), -1) <= b]
print(json.dumps({"one": one, "steps": steps, "reads": reads, "inside": len(inside),
                  "memcpy": inside.count("gpu_memcpy")}))
"""


def _fresh(code: str, tmp_path) -> dict:
    """``code`` run in a fresh process on the card; the JSON it prints."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "trace.json")],
                         cwd=root, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    print(got)
    return got


def test_clock_offset_agrees_with_the_profiler_record(cuda, tmp_path):
    """The offsets of the first and the last clock stamp (interpolated
    between them: the two clocks drift by a few µs over tens of ms) map
    each clock stamp's ``%globaltimer`` onto the exported trace's clock
    within 5 µs of its own kernel record."""
    got = _fresh(_CLOCK_TRACE, tmp_path)
    assert len(got["starts"]) == 6 and got["mapped"] is not None
    for mapped, ts in zip(got["mapped"], got["starts"]):
        assert abs(mapped - ts) < 5.0


def test_node_counter_matches_the_replay_trace(cuda, tmp_path):
    """``launches["nodes"]`` of a one-launch solve is the device records of
    the same solve replayed piece by piece inside ``GraphLoop.replay`` (each
    piece's nodes, and a host read, one device-to-host copy, for each guard
    kernel) and one more, the memset that zeroes the pass counters."""
    got = _fresh(_REPLAY_TRACE, tmp_path)
    one, steps = got["one"], got["steps"]
    assert one["nodes"] == steps["nodes"] + one["guard"] + 1 and got["reads"] == one["guard"] + 1
    assert got["inside"] == one["nodes"] - 1 and got["memcpy"] >= one["guard"]


def test_stamp_clock_resolution(cuda):
    """The stamps' clock ticks, with and without a profiler session; its
    step is printed for the record."""
    from torch.profiler import ProfilerActivity, profile

    from pressurepoissonsolver_torch.utils import profiling

    bare = profiling.stamp_resolution_ns(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = profiling.stamp_resolution_ns(cuda)
    print("stamp resolution", bare, traced)
    for r in (bare, traced):
        assert 0 < r["min_step_ns"] <= 1100 and r["distinct"] > 1


# -- the block-Jacobi sweep kernel: csrc/patch_sweep.cu --------------------------

# wall sets whose patches take every transform kind: Dirichlet (DST-II /
# DST-III), Neumann (DCT-II / DCT-III, the coarsest patch pinned), and two
# mixed sets (DCT-IV / DST-IV axes; an x axis Neumann at both ends)
SWEEP_WALLS = {"dirichlet": False, "neumann": True, "mixed": ["x_lo", "y_hi"],
               "mixed-x": ["x_lo", "x_hi", "y_hi"]}


def _sweep_kernel_takes(launch):
    """``launch()``, which must be one launch of the sweep kernel."""
    before = patch_sweep.sweeps()
    out = launch()
    torch.cuda.synchronize()
    after = patch_sweep.sweeps()
    assert after["plain"] == before["plain"]
    assert sum(after["kernel"].values()) == sum(before["kernel"].values()) + 1
    return out


@pytest.mark.parametrize("walls", list(SWEEP_WALLS))
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_patch_sweep_kernel_matches_plain(cuda, dt, n, walls):
    """On every level of a small mesh: ``Level.smooth`` / ``smooth_zero``
    and ``ActiveSmoother.smooth`` / ``smooth_zero`` (an empty active set,
    a random one, every slot) launch the sweep kernel once and agree with
    the plain version on the same CUDA tensors to 1e-5 (f32) / 1e-12 (f64)
    of max|u|; the slots outside an active set keep ``u`` (or 0) bit for
    bit."""
    h = DomainHierarchy(refined_tree(2, 3, 1), n=n, neumann=SWEEP_WALLS[walls])
    rng = np.random.default_rng(n)
    pinned = False
    for pl in h.levels:
        lvl = Level(pl, dtype=DTYPES[dt], device=cuda)
        assert lvl._st.sweep is not None
        pinned |= any(g.pin_dc for g in lvl._st.groups)
        f, u = (torch.as_tensor(rng.standard_normal((lvl.P, n, n)), dtype=DTYPES[dt],
                                device=cuda) for _ in range(2))
        gf = lvl._gf_faces(u)
        got = _sweep_kernel_takes(lambda: lvl.smooth(f, u))
        assert _rel(patch_sweep.sweep_plain(lvl._st, f, gf, lvl.h2inv), got) <= RTOL[dt]
        got = _sweep_kernel_takes(lambda: lvl.smooth_zero(f))
        assert _rel(patch_sweep.sweep_plain(lvl._st, f, None, lvl.h2inv), got) <= RTOL[dt]
        for mask in (np.zeros(lvl.P, bool), rng.random(lvl.P) < 0.4, np.ones(lvl.P, bool)):
            sm = ActiveSmoother(lvl, mask)
            assert sm._st.sweep is not None
            gfa = sm._gamma_faces(u) if sm.num_sub_ifaces else None
            for base in (u, None):
                got = _sweep_kernel_takes(
                    lambda: sm.smooth(f, u) if base is not None else sm.smooth_zero(f))
                ref = patch_sweep.sweep_plain(sm._st, f, gfa if base is not None else None,
                                              sm._h2inv_act, sm._route, base)
                keep = torch.as_tensor(~mask, device=cuda)
                want = torch.zeros_like(u) if base is None else u
                assert torch.equal(got[keep], want[keep])
                if mask.any():
                    assert _rel(ref, got) <= RTOL[dt]
    assert pinned == (walls == "neumann")


def test_patch_sweep_kernel_on_a_misaligned_or_strided_field(cuda):
    """A field at an element offset (not 16-byte aligned), or a strided
    one, is copied and swept by the kernel: one launch, the result of the
    aligned field's sweep bit for bit."""
    lvl = Level(_hierarchy()[0], dtype=torch.float32, device=cuda)
    buf = torch.randn(lvl.P * 64 + 1, device=cuda)
    f = buf[1:].view(lvl.P, 8, 8)
    u = torch.randn(lvl.P, 8, 16, device=cuda)[:, :, ::2]
    assert f.data_ptr() % 16 and not u.is_contiguous()
    want = lvl.smooth(f.clone(), u.contiguous())
    got = _sweep_kernel_takes(lambda: lvl.smooth_zero(f))
    assert torch.equal(got, lvl.smooth_zero(f.clone()))
    sm = ActiveSmoother(lvl, np.arange(lvl.P) % 3 == 0)
    assert torch.equal(_sweep_kernel_takes(lambda: sm.smooth(f, u)),
                       sm.smooth(f.clone(), u.contiguous()))
    assert torch.equal(lvl.smooth(f, u), want)


def test_patch_sweep_kernel_refuses_another_dtype_or_device(cuda):
    """A sweep of a level whose tables carry the kernel's, on a field of
    another dtype than the tables' or on another device, raises: no
    version is chosen for it."""
    lvl = Level(_hierarchy()[0], dtype=torch.float32, device=cuda)
    f = torch.randn(lvl.P, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        lvl.smooth_zero(f.double())
    with pytest.raises(TypeError):
        patch_sweep.sweep(lvl._st, f, None, lvl.h2inv.double())
    with pytest.raises(TypeError):
        patch_sweep.sweep(lvl._st, f, lvl._gf_faces(f).cpu(), lvl.h2inv)


# the sweep kernel's counter table (``utils.counters``)
SWEEP_TABLE = "patch_sweep.kernel"


def _level_sweeps(gl) -> dict:
    """Per level of a composed ``GraphLoop`` (``"root"`` or a loop slot):
    the sweep kernel launches the accounting adds per pass, from the
    pieces directly in it."""
    out = {}

    def walk(tree, level):
        out.setdefault(level, 0)
        for item in tree:
            if hasattr(item, "body"):
                walk(item.body, item.index)
            else:
                out[level] += sum(item.launches.get(SWEEP_TABLE, {}).values())

    walk(gl.tree, "root")
    return out


def test_patch_sweep_kernel_counts_once_per_pass_of_a_while_body(cuda):
    """A one-launch IR solve (f32 V-cycle at n=8: level 0's full sweeps and
    the active sets' sweeps inside the inner Krylov loop's WHILE body)
    counts the sweep kernel's launches as the eager solve does, and the
    per-step replay too; the sweep kernel nodes of each level of the
    composed graph are the launches the accounting adds per pass of it."""
    from chip_smoke import graph_nodes

    opts, how = LOOP_SOLVES["refined-bicgstab"]
    s, f, _ = _graph_solver(cuda, 2, **opts)
    counted = {}
    for mode in (True, False, "steps", True):
        s._graphs = mode
        u, counts, launched, _, _ = _counted(s, f, how)
        counted.setdefault(mode, []).append((u, counts, launched[SWEEP_TABLE]))
    ref = counted[False][0]
    assert ref[2]["float32"] > 0
    for runs in counted.values():
        for u, counts, sweeps in runs:
            assert counts == ref[1] and torch.equal(u, ref[0]) and sweeps == ref[2]
    gl = s._captured[next(iter(s._captured))].graphs
    want = _level_sweeps(gl)
    levels = {"root": gl.root, **gl.bodies}
    got = {level: sum("patch_sweep_kernelI" in name for name in graph_nodes(raw)[0])
           for level, raw in levels.items()}
    assert got == want and sum(want.values()) > 0


# -- the grid transfers' kernel: csrc/transfer.cu ---------------------------------

def _cell_transfers(cuda, divide, dtype, mode):
    """Every transfer of the V-cycle on the benchmark cells' 2D hierarchy
    at ``divide`` (n=16), on stand-in levels (``chip_smoke.level_stub``)."""
    from chip_smoke import cell_tree, level_stub

    from pressurepoissonsolver_torch.gmg import Transfer

    h = DomainHierarchy(cell_tree(divide), n=16)
    levels = [pl for pl in h.levels if pl.num_patches * 256 > 4096] + [
        next(pl for pl in h.levels if pl.num_patches * 256 <= 4096)]
    stubs = [level_stub(torch, pl, dtype, cuda) for pl in levels]
    return [Transfer(stubs[k], stubs[k + 1], prolong_mode=mode) for k in range(len(stubs) - 1)]


def _transfer_kernel_takes(launch):
    """``launch()``, which must be one launch of the transfer kernel and no
    plain transfer."""
    before = transfer.transfers()
    out = launch()
    torch.cuda.synchronize()
    after = transfer.transfers()
    assert after["plain"] == before["plain"]
    assert sum(after["kernel"].values()) == sum(before["kernel"].values()) + 1
    return out


@pytest.mark.parametrize("divide", [0, 1])
@pytest.mark.parametrize("mode", ["constant", "linear"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_transfer_kernel_matches_plain(cuda, dt, mode, divide):
    """On every transfer of the cells' V-cycle (pass-through, parent-compact
    and all-parent transfers): ``restrict`` and ``prolong_add`` launch the
    kernel once each and agree with the plain chain on the same CUDA
    tensors, within 1e-6 (f32) / 1e-14 (f64) of max|out|, the constant
    prolong-add bit for bit."""
    rng = np.random.default_rng(divide)
    tol = {"f32": 1e-6, "f64": 1e-14}[dt]
    ts = _cell_transfers(cuda, divide, DTYPES[dt], mode)
    assert len(ts) == 5 + divide and any(t._r_inv is not None for t in ts)
    for t in ts:
        assert t._kt is not None
        x, u = (torch.as_tensor(rng.standard_normal((t.fine.P, 16, 16)), dtype=DTYPES[dt],
                                device=cuda) for _ in range(2))
        c = torch.as_tensor(rng.standard_normal((t.coarse.P, 16, 16)), dtype=DTYPES[dt],
                            device=cuda)
        got = _transfer_kernel_takes(lambda: t.restrict(x))
        assert _rel(t.restrict_plain(x), got) <= tol
        got = _transfer_kernel_takes(lambda: t.prolong_add(c, u))
        ref = t.prolong_add_plain(c, u)
        if mode == "constant":
            assert torch.equal(got, ref)
        else:
            assert _rel(ref, got) <= tol


def test_transfer_kernel_copies_strided_inputs_and_refuses_others(cuda):
    """A field at an element offset (not 16-byte aligned) or a strided one is
    copied and transferred by the kernel, bit for bit as its contiguous
    copy; a field of another dtype than f32 / f64, fields of two dtypes, a
    field on the CPU beside one on the card, or another shape raise."""
    t = _cell_transfers(cuda, 0, torch.float32, "constant")[0]
    P, Pc = t.fine.P, t.coarse.P
    x = torch.randn(P * 256 + 1, device=cuda)[1:].view(P, 16, 16)
    u = torch.randn(P, 16, 32, device=cuda)[:, :, ::2]
    c = torch.randn(Pc, 32, 16, device=cuda)[:, ::2]
    assert x.data_ptr() % 16 and not u.is_contiguous() and not c.is_contiguous()
    got = _transfer_kernel_takes(lambda: t.restrict(x))
    assert torch.equal(got, t.restrict(x.clone()))
    got = _transfer_kernel_takes(lambda: t.prolong_add(c, u))
    assert torch.equal(got, t.prolong_add(c.contiguous(), u.contiguous()))
    x = x.clone()
    with pytest.raises(TypeError):
        t.restrict(x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        t.prolong_add(c.double(), x)
    with pytest.raises(TypeError):
        t.prolong_add(c.cpu(), x)
    with pytest.raises(ValueError):
        t.restrict(x[1:])
    with pytest.raises(ValueError):
        t.prolong_add(c[:, :8], x)


@pytest.mark.parametrize("case", ["refined-bicgstab", "schur-gmg"])
def test_one_launch_solve_runs_every_transfer_on_the_kernel(cuda, case):
    """A one-launch ``solve_refined`` (the f32 V-cycle of the IR cells) and
    ``solve_schur`` (the Woodbury V-cycle) count every transfer as a kernel
    launch and none as plain, as many as the eager solve launches."""
    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, 2, **opts)
    counted = {}
    for mode in (True, False, True):
        s._graphs = mode
        u, counts, _, _, _ = _counted(s, f, how)
        counted.setdefault(mode, []).append((u, counts, transfer.transfers()))
    ref = counted[False][0][2]
    assert ref["kernel"]["float32"] > 0 and not any(ref["plain"].values())
    for runs in counted.values():
        for u, counts, got in runs:
            assert got == ref and torch.equal(u, counted[False][0][0])


# -- the per-side trace kernel: csrc/traces.cu -------------------------------------

def _trace_cycle(cuda, dtype, n=8, scheme="bilinear"):
    """A FAC cycle on the small 2D hierarchy (levels with refinement sides,
    pass-through levels, the active smoothers of the smoothing and the
    residual)."""
    h = DomainHierarchy(refined_tree(2, 4, 2), n=n)
    if scheme != "bilinear":
        return [Level(pl, dtype=dtype, device=cuda, iface_scheme=scheme) for pl in h.levels]
    return build_gmg(h, CycleOpts(fac_smoothing="active", coarse_direct_max_dof=64),
                     dtype=dtype, device=cuda)


def _trace_kernel_takes(build):
    """``build()``, which must be one build of the trace kernel and no plain
    chain's."""
    from pressurepoissonsolver_torch.ops import traces

    before = traces.builds()
    out = build()
    torch.cuda.synchronize()
    after = traces.builds()
    assert after["plain"] == before["plain"]
    assert sum(after["kernel"].values()) == sum(before["kernel"].values()) + 1
    return out


@pytest.mark.parametrize("scheme, n", [("bilinear", 8), ("bilinear", 16), ("bilinear", 6),
                                       ("quadratic", 8)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_trace_kernel_matches_plain(cuda, dt, scheme, n):
    """On every level of a small 2D hierarchy: the apply's and the sweep's
    traces (``Level._gf_parts``' ``w_mix * mix``, ``Level._gf_faces``) and,
    in the FAC cycle, the active smoothers' (``ActiveSmoother._gamma_faces``,
    the smoothing's and the residual's sets) are one kernel build each and
    agree with the plain chain on the same CUDA tensors, within 1e-6 (f32) /
    1e-14 (f64) of max|gf|."""
    tol = {"f32": 1e-6, "f64": 1e-14}[dt]
    cyc = _trace_cycle(cuda, DTYPES[dt], n, scheme)
    levels = cyc if scheme != "bilinear" else cyc.levels
    rng = np.random.default_rng(n)
    for lvl in levels:
        assert lvl._trace_apply is not None and lvl._trace_sweep is not None
        u = torch.as_tensor(rng.standard_normal((lvl.P, n, n)), dtype=DTYPES[dt], device=cuda)
        for got, ref in ((lambda: lvl._apply_traces(u), lambda: lvl._gf_parts(u)[0]),
                         (lambda: lvl._sweep_traces(u), lambda: lvl._gf_faces(u))):
            g, r = _trace_kernel_takes(got), ref()
            assert g.shape == r.shape
            assert _rel(r, g) <= tol if r.any() else not g.any()
    if scheme != "bilinear":
        return
    active = [s for s in cyc._asmooth + cyc._aapply if s is not None and s._trace is not None]
    assert active and any(s.Pa < s.level.P for s in active)
    for sm in active:
        u = torch.as_tensor(rng.standard_normal((sm.level.P, n, n)), dtype=DTYPES[dt],
                            device=cuda)
        g = _trace_kernel_takes(lambda: sm._traces(u))
        assert _rel(sm._gamma_faces(u), g) <= tol


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_trace_build_is_one_kernel_node(cuda, dt):
    """A captured build is one kernel node (the trace kernel's) and nothing
    else; a captured apply is that node and the stencil's, a captured sweep
    that node and the sweep kernel's."""
    from chip_smoke import graph_nodes

    cyc = _trace_cycle(cuda, DTYPES[dt])
    lvl = cyc.levels[0]
    sm = next(s for s in cyc._asmooth if s is not None and s._trace is not None)
    u = torch.randn(lvl.P, 8, 8, dtype=DTYPES[dt], device=cuda)
    f = torch.randn_like(u)
    ua = torch.randn(sm.level.P, 8, 8, dtype=DTYPES[dt], device=cuda)
    for fn, want in ((lambda: lvl._apply_traces(u), ["traces_kernel"]),
                     (lambda: lvl._sweep_traces(u), ["traces_kernel"]),
                     (lambda: sm._traces(ua), ["traces_kernel"]),
                     (lambda: lvl.apply(u), ["traces_kernel", "ghost_stencil_2d_kernel"]),
                     (lambda: lvl.smooth(f, u), ["traces_kernel", "patch_sweep_kernel"])):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn()
        names, kinds = graph_nodes(g)
        assert kinds == {"kernel": len(want)}, (kinds, names)
        assert all(sum(w in name for name in names) == 1 for w in want), names


def test_trace_kernel_copies_strided_inputs_and_refuses_others(cuda):
    """A field at an element offset or a strided one is copied and built by
    the kernel, bit for bit as its contiguous copy; a field of another dtype
    than f32 / f64, on the CPU beside tables on the card, or of another
    shape raises."""
    from pressurepoissonsolver_torch.ops import traces

    lvl = _trace_cycle(cuda, torch.float32).levels[0]
    P = lvl.P
    x = torch.randn(P * 64 + 1, device=cuda)[1:].view(P, 8, 8)
    y = torch.randn(P, 8, 16, device=cuda)[:, :, ::2]
    assert x.data_ptr() % 16 and not y.is_contiguous()
    for u in (x, y):
        got = _trace_kernel_takes(lambda: lvl._apply_traces(u))
        assert torch.equal(got, lvl._apply_traces(u.contiguous().clone()))
    tab = lvl._trace_apply
    with pytest.raises(TypeError):
        traces.build(tab, x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        traces.build(tab, x.cpu())
    with pytest.raises(ValueError):
        traces.build(tab, x[1:])


def test_plain_traces_never_run_on_the_card(cuda, monkeypatch):
    """On a CUDA tensor of a taken shape no build reaches the plain chain:
    with ``_gf_parts``, ``_gf_faces`` and ``_gamma_faces`` made to raise, a
    one-launch ``solve_refined`` and ``solve_schur`` with the V-cycle run, as
    eager solves do."""
    def refuse(*a, **kw):
        raise AssertionError("a plain trace build on the card")

    for cls, name in ((Level, "_gf_parts"), (Level, "_gf_faces"),
                      (ActiveSmoother, "_gamma_faces")):
        monkeypatch.setattr(cls, name, refuse)
    for case in ("refined-bicgstab", "schur-gmg"):
        opts, how = LOOP_SOLVES[case]
        s, f, _ = _graph_solver(cuda, 2, **opts)
        for mode in (True, False):
            s._graphs = mode
            _graph_run(s, f, how)


@pytest.mark.parametrize("case", ["refined-bicgstab", "schur-gmg"])
def test_one_launch_solve_builds_every_trace_on_the_kernel(cuda, case):
    """A one-launch ``solve_refined`` (the f32 V-cycle and the f64 round
    ends of the IR cells) and ``solve_schur`` (the Woodbury V-cycle) count
    every trace build as a kernel launch and none as plain: 100% of the
    builds, as many as the eager solve makes."""
    from pressurepoissonsolver_torch.ops import traces

    opts, how = LOOP_SOLVES[case]
    s, f, _ = _graph_solver(cuda, 2, **opts)
    counted = {}
    for mode in (True, False, True):
        s._graphs = mode
        u, counts, _, _, _ = _counted(s, f, how)
        counted.setdefault(mode, []).append((u, counts, traces.builds()))
    ref = counted[False][0][2]
    assert ref["kernel"]["float32"] > 0 and not any(ref["plain"].values())
    if case == "refined-bicgstab":
        assert ref["kernel"]["float64"] > 0
    for runs in counted.values():
        for u, counts, got in runs:
            assert got == ref and torch.equal(u, counted[False][0][0])

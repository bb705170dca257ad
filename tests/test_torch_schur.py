"""The Schur path's per-level ops of the port against the JAX reference, on
the CPU: the full contribution pipeline and gamma routing tables,
``interpolate``, ``gamma_faces``, ``fold_gamma``, the patch solves,
``schur_S`` and ``apply_with_interface``; the batched per-patch BiCGStab;
the probed Schur matrix and its block-Jacobi preconditioner.

Meshes: ``refined_tree(2, 3, 1)`` at n=8 (19 patches) and
``refined_tree(3, 3, 2)`` at n=4 (78 patches), each with Dirichlet,
all-Neumann and mixed walls.  Tolerances relative to max|ref|: f64 1e-12,
f32 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.matrix as jmatrix
import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_tpu.ops.patch_bcgs as jbcgs
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.matrix as tmatrix
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.ops.patch_bcgs as tbcgs

from _torch_parity import DTYPES, RTOL, rel_err

# per dimension: (base levels, corner levels, n)
MESH = {2: (3, 1, 8), 3: (3, 2, 4)}
WALLS = {"dirichlet": {2: False, 3: False},
         "neumann": {2: True, 3: True},
         "mixed": {2: ("x_lo", "y_hi"), 3: ("x_lo", "y_hi", "z_lo")}}
CASES = [(D, w) for D in (2, 3) for w in WALLS]
IDS = [f"{D}d-{w}" for D, w in CASES]
DT_CASES = [(D, w, dt) for D, w in CASES for dt in ("f32", "f64")]
DT_IDS = [f"{D}d-{w}-{dt}" for D, w, dt in DT_CASES]


@functools.lru_cache(maxsize=None)
def hierarchies(D, walls):
    base, corner, n = MESH[D]
    nm = WALLS[walls][D]
    nm = nm if isinstance(nm, bool) else list(nm)
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=n,
                                 neumann=nm, use_native=False)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=n, neumann=nm)
    return jh, th


@functools.lru_cache(maxsize=None)
def levels(D, walls, dt):
    jh, th = hierarchies(D, walls)
    npdt, tdt = DTYPES[dt]
    return (jlo.Level(jh.finest, dtype=jnp.dtype(npdt)),
            tlo.Level(th.finest, dtype=tdt, device="cpu"))


def _inputs(D, walls, dt, seed=0):
    """A seeded field f (zero mean on every all-Neumann patch, where the
    patch solve pins the constant) and interface vector g."""
    jl, _ = levels(D, walls, dt)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((jl.P,) + (jl.n,) * D)
    allneu = np.asarray(jl.pl.neumann).all(axis=1)
    f[allneu] -= f[allneu].mean(axis=tuple(range(1, D + 1)), keepdims=True)
    g = rng.standard_normal((jl.num_ifaces, jl.m))
    npdt = DTYPES[dt][0]
    return f.astype(npdt), g.astype(npdt)


def _check(dt, ref, got):
    assert got.dtype == DTYPES[dt][1]
    assert rel_err(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("D,walls,dt", DT_CASES, ids=DT_IDS)
def test_schur_tables(D, walls, dt):
    jl, tl = levels(D, walls, dt)
    assert np.array_equal(np.asarray(jl._iface_flat), tl._iface_flat.numpy())
    jp, tp = jl._pipe, tl._pipe
    assert (jp.num_ifaces, jp.Ks, jp.Km, jp.mm_ncase) == (tp.num_ifaces, tp.Ks, tp.Km,
                                                          tp.mm_ncase)
    for name in ("idx_s", "w_s", "idx_m", "mm_W", "mm_gather", "mm_inv"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), name
    assert tl._pipe.mm_W is not None  # the mesh has refinement boundaries


@pytest.mark.parametrize("D,walls,dt", DT_CASES, ids=DT_IDS)
def test_interpolate_gamma_faces_and_fold(D, walls, dt):
    jl, tl = levels(D, walls, dt)
    f, g = _inputs(D, walls, dt)
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    _check(dt, jax.jit(jl.interpolate)(jnp.asarray(f)), tl.interpolate(tf))
    jgf = jax.jit(jl.gamma_faces)(jnp.asarray(g))
    assert np.array_equal(np.asarray(jgf), tl.gamma_faces(tg).numpy())
    _check(dt, jax.jit(jl.fold_gamma)(jnp.asarray(f), jnp.asarray(g)),
           tl.fold_gamma(tf, tg))
    z = tl.gamma_zeros()
    assert z.dtype == DTYPES[dt][1] and tuple(z.shape) == (tl.num_ifaces, tl.m)
    assert not z.any()


@pytest.mark.parametrize("D,walls,dt", DT_CASES, ids=DT_IDS)
def test_patch_solves_schur_S_and_apply_with_interface(D, walls, dt):
    jl, tl = levels(D, walls, dt)
    f, g = _inputs(D, walls, dt, seed=1)
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    jf, jg = jnp.asarray(f), jnp.asarray(g)
    _check(dt, jax.jit(jl.patch_solve)(jf, jg), tl.patch_solve(tf, tg))
    _check(dt, jax.jit(jl.solve_with_interface)(jf, jg), tl.solve_with_interface(tf, tg))
    gf = tl.gamma_faces(tg)
    _check(dt, jax.jit(jl.patch_solve_faces)(jf, jnp.asarray(gf.numpy())),
           tl.patch_solve_faces(tf, gf))
    _check(dt, jax.jit(jl.schur_S)(jg), tl.schur_S(tg))
    _check(dt, jax.jit(jl.apply_with_interface)(jf, jg), tl.apply_with_interface(tf, tg))


@pytest.mark.parametrize("D,walls", CASES, ids=IDS)
def test_patch_solve_inverts_apply_with_interface(D, walls):
    """``apply_with_interface(patch_solve(f, g), g) == f`` in f64 for any
    g (``tests/test_operator.py``), on each side."""
    jl, tl = levels(D, walls, "f64")
    f, g = _inputs(D, walls, "f64", seed=2)
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    got = tl.apply_with_interface(tl.patch_solve(tf, tg), tg)
    ref = jl.apply_with_interface(jl.patch_solve(jnp.asarray(f), jnp.asarray(g)),
                                  jnp.asarray(g))
    assert rel_err(f, got) <= 1e-11
    assert rel_err(f, ref) <= 1e-11


@pytest.mark.parametrize("D,walls", CASES, ids=IDS)
def test_batched_patch_bicgstab_matches_spectral(D, walls):
    """The ``"bcgs"`` patch solve, ``BcgsPatchSolver`` and the bare batched
    BiCGStab give the spectral solve, as the reference's do."""
    jh, th = hierarchies(D, walls)
    _, tl = levels(D, walls, "f64")
    f, g = _inputs(D, walls, "f64", seed=3)
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    spec = tl.patch_solve(tf, tg)
    tb = tlo.Level(th.finest, device="cpu", patch_solver="bcgs")
    jb = jlo.Level(jh.finest, patch_solver="bcgs")
    ref = np.asarray(jb.patch_solve(jnp.asarray(f), jnp.asarray(g)))
    solver = tbcgs.BcgsPatchSolver(tl, tol=1e-12, max_iter=500)
    zero = tl.gamma_zeros()
    bare = tbcgs.batched_patch_bicgstab(lambda u: tl.apply_with_interface(u, zero),
                                        tl.fold_gamma(tf, tg), tol=1e-12, max_iter=500)
    jsolver = jbcgs.BcgsPatchSolver(jlo.Level(jh.finest), tol=1e-12, max_iter=500)
    jref = np.asarray(jsolver.patch_solve(jnp.asarray(f), jnp.asarray(g)))
    for got in (tb.patch_solve(tf, tg), solver.patch_solve(tf, tg), bare):
        assert rel_err(spec, got) <= 1e-8
        assert rel_err(ref, got) <= 1e-8
    assert rel_err(jref, bare) <= 1e-8
    # smooth / smooth_zero take the iterative patch solve too
    u = torch.from_numpy(_inputs(D, walls, "f64", seed=4)[0])
    assert rel_err(tl.patch_solve(tf, tl.interpolate(u)), tb.smooth(tf, u)) <= 1e-8
    assert rel_err(tl.smooth_zero(tf), tb.smooth_zero(tf)) <= 1e-8
    assert rel_err(np.asarray(jb.smooth(jnp.asarray(f), jnp.asarray(u.numpy()))),
                   tb.smooth(tf, u)) <= 1e-8


def test_batched_patch_bicgstab_freezes_converged_patches():
    """A patch whose right-hand side is zero is converged from the start
    (its mask is off) and stays exactly zero; the others converge."""
    _, tl = levels(2, "dirichlet", "f64")
    f, _ = _inputs(2, "dirichlet", "f64", seed=5)
    f[3] = 0.0
    zero = tl.gamma_zeros()
    x = tbcgs.batched_patch_bicgstab(lambda u: tl.apply_with_interface(u, zero),
                                     torch.from_numpy(f), tol=1e-12, max_iter=500)
    assert not x[3].any()
    assert rel_err(tl.patch_solve(torch.from_numpy(f), zero), x) <= 1e-8


@functools.lru_cache(maxsize=None)
def schur_matrices(D, walls):
    jl, tl = levels(D, walls, "f64")
    return jmatrix.assemble_schur(jl), tmatrix.assemble_schur(tl)


@pytest.mark.parametrize("D,walls", CASES, ids=IDS)
def test_assemble_schur_matches_reference(D, walls):
    ja, ta = schur_matrices(D, walls)
    assert ja.shape == ta.shape
    d = (ja - ta).tocoo()
    assert np.abs(d.data).max(initial=0.0) <= 1e-12 * np.abs(ja.data).max()
    # the matrix is the matrix-free I - S
    _, tl = levels(D, walls, "f64")
    _, g = _inputs(D, walls, "f64", seed=6)
    tg = torch.from_numpy(g)
    mv = (ta @ g.reshape(-1)).reshape(g.shape)
    assert rel_err(mv, tg - tl.schur_S(tg)) <= 1e-11


@pytest.mark.parametrize("D,walls", CASES, ids=IDS)
def test_schur_block_jacobi_matches_reference(D, walls):
    ja, ta = schur_matrices(D, walls)
    jl, tl = levels(D, walls, "f64")
    _, g = _inputs(D, walls, "f64", seed=7)
    ref = jmatrix.schur_block_jacobi(jl, ja)(jnp.asarray(g))
    got = tmatrix.schur_block_jacobi(tl, ta)(torch.from_numpy(g))
    assert got.dtype == torch.float64
    assert rel_err(ref, got) <= 1e-12


def test_assemble_schur_probes_in_chunks(monkeypatch):
    """Chunks of a few probes give the same matrix as one batch of all."""
    _, tl = levels(2, "mixed", "f64")
    _, whole = schur_matrices(2, "mixed")
    monkeypatch.setattr(tmatrix, "_PROBE_CHUNK_BYTES", 7 * 8 * 64 * 4)
    chunked = tmatrix.assemble_schur(tl)
    assert abs(chunked - whole).max() <= 1e-15 * abs(whole).max()

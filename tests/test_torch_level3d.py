"""Per-level ops of the port against the JAX reference at D=3, on every
level of the 3D test hierarchy (``refined_tree(3, 3, 2)`` at n=4), in f32
and f64: the level tables and denominators, face extraction, the direct
gf pipeline, the composite apply, the face fold, the smoother sweeps, the
spectral solve with its DC pin, and the FAC active-set smoother.

Tolerances relative to max|ref|: f64 <= 1e-12; f32 <= 1e-5 — both f32
sides take the Kronecker spectral form at n <= 16, but the f32 sums may
run in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.ops.patch_sweep as tps

from _torch_parity import DTYPES, MESH, RTOL, hierarchies, rel_err

D = 3
N = MESH[D][2]
LEVELS = range(5)
CASES = [(dt, k) for dt in ("f32", "f64") for k in LEVELS]
IDS = [f"{dt}-L{k}" for dt, k in CASES]


@functools.lru_cache(maxsize=None)
def levels(dt, k, neumann=False):
    jh, th = hierarchies(neumann, D=D)
    npdt, tdt = DTYPES[dt]
    return (jlo.Level(jh[k], dtype=jnp.dtype(npdt)),
            tlo.Level(th[k], dtype=tdt, device="cpu"))


@functools.lru_cache(maxsize=None)
def active(dt, k):
    """The same seeded random active set on both sides."""
    jl, tl = levels(dt, k)
    rng = np.random.default_rng(200 + k)
    mask = rng.random(jl.P) < 0.4
    mask[rng.integers(jl.P)] = True
    return (jlo.ActiveSmoother(jl, mask), tlo.ActiveSmoother(tl, mask),
            jlo.ActiveSmoother(jl, mask, build_solver=False),
            tlo.ActiveSmoother(tl, mask, build_solver=False))


def _inputs(dt, P, seed, count=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((P, N, N, N)).astype(DTYPES[dt][0])
            for _ in range(count)]


def _check(dt, ref, got):
    assert got.dtype == DTYPES[dt][1]
    assert rel_err(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_tables_3d(dt, k):
    jl, tl = levels(dt, k)
    assert (jl.P, jl.num_ifaces, jl._nref, jl.m) == (tl.P, tl.num_ifaces, tl._nref, tl.m)
    for name in ("h2inv", "ghost_coef", "ghost_coef_eff", "_gf_w_own", "_gf_w_mix"):
        a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(np.asarray(jl._gf_mix_idx), tl._gf_mix_idx.numpy())
    assert jl._case_scalar == tl._case_scalar
    # the reference keeps the case templates in the level dtype, the port
    # on the host in f64
    jT = np.asarray(jl._case_T)
    assert jT.shape == (11, N * N, N * N)
    assert np.array_equal(jT, tl._case_T.astype(jT.dtype))
    js, ts = jl._st, tl._st
    assert np.array_equal(np.asarray(js.perm), ts.perm.numpy())
    assert np.array_equal(np.asarray(js.lam_idx), ts.lam_idx)
    dn = np.asarray(jlo._denom_of(js, D, N))
    assert dn.shape == (jl.P, N, N, N)
    assert dn.dtype == ts.denom.numpy().dtype and np.array_equal(dn, ts.denom.numpy())


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_extract_faces_and_gf_parts_3d(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, jl.P, k, 1)
    ref = jax.jit(jlo.extract_faces, static_argnums=(1, 2))(jnp.asarray(u), D, N)
    got = tlo.extract_faces(torch.from_numpy(u), D, N)
    assert tuple(got.shape) == (jl.P, 6, N * N)
    assert np.array_equal(np.asarray(ref), got.numpy())
    jmix, jown = jax.jit(jl._gf_parts)(jnp.asarray(u))
    tmix, town = tl._gf_parts(torch.from_numpy(u))
    if jl.num_ifaces:
        _check(dt, jmix, tmix)
    else:  # the one-patch level has no interfaces: all zero on both sides
        assert not np.asarray(jmix).any() and not tmix.any()
    assert np.array_equal(np.asarray(jown), town.numpy())
    if jl.num_ifaces:
        _check(dt, jax.jit(jl._gf_faces)(jnp.asarray(u)),
               tl._gf_faces(torch.from_numpy(u)))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_apply_3d(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, jl.P, 10 + k, 1)
    _check(dt, jax.jit(jl.apply)(jnp.asarray(u)), tl.apply(torch.from_numpy(u)))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_smooth_fold_and_spectral_solve_3d(dt, k):
    jl, tl = levels(dt, k)
    f, u = _inputs(dt, jl.P, 20 + k)
    tf, tu = torch.from_numpy(f), torch.from_numpy(u)
    _check(dt, jax.jit(jl.smooth)(jnp.asarray(f), jnp.asarray(u)), tl.smooth(tf, tu))
    _check(dt, jax.jit(jl.smooth_zero)(jnp.asarray(f)), tl.smooth_zero(tf))
    _check(dt, jax.jit(jl._spectral_solve)(jnp.asarray(f)),
           tps._spectral_apply(tl._st, tf, D, N))
    # the fold against the reference's pad-spread sum, with random faces
    gf = np.random.default_rng(30 + k).standard_normal((jl.P, 6, N * N)).astype(f.dtype)
    fold = jax.jit(lambda f, g: jlo._fold_faces_flat(f, g, jl.h2inv, D, N))(
        jnp.asarray(f), jnp.asarray(gf))
    _check(dt, fold, tps._fold_faces_flat(tf, torch.from_numpy(gf), tl.h2inv, D, N))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_all_neumann_dc_pin_3d(dt):
    """All-Neumann walls: the one-patch level's spectral solve pins the
    DC mode at ``[:, 0, 0, 0]`` on both sides."""
    jl, tl = levels(dt, 4, neumann=True)
    assert [g.pin_dc for g in tl._st.groups] == [True]
    (f,) = _inputs(dt, 1, 40, 1)
    ref = jax.jit(jl.smooth_zero)(jnp.asarray(f))
    _check(dt, ref, tl.smooth_zero(torch.from_numpy(f)))
    (u,) = _inputs(dt, 1, 41, 1)
    _check(dt, jax.jit(jl.apply)(jnp.asarray(u)), tl.apply(torch.from_numpy(u)))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_integrate_and_zeros_3d(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, jl.P, 50 + k, 1)
    a = float(jax.jit(jl.integrate)(jnp.asarray(u)))
    b = float(tl.integrate(torch.from_numpy(u)))
    assert abs(a - b) <= RTOL[dt] * max(abs(a), 1.0)
    assert tl.volume == jl.volume
    z = tl.zeros()
    assert z.dtype == DTYPES[dt][1] and tuple(z.shape) == jl.zeros().shape == (jl.P, N, N, N)
    assert not z.any()


@pytest.mark.parametrize("dt,k", [c for c in CASES if c[1] < 4],
                         ids=[i for i, c in zip(IDS, CASES) if c[1] < 4])
def test_active_smoother_3d(dt, k):
    ja, ta, jap, tap = active(dt, k)
    assert np.array_equal(ja.act, ta.act) and ja.num_sub_ifaces == ta.num_sub_ifaces
    f, u = _inputs(dt, ja.level.P, 60 + k)
    tf, tu = torch.from_numpy(f), torch.from_numpy(u)
    _check(dt, jax.jit(ja.smooth)(jnp.asarray(f), jnp.asarray(u)), ta.smooth(tf, tu))
    _check(dt, jax.jit(ja.smooth_zero)(jnp.asarray(f)), ta.smooth_zero(tf))
    _check(dt, jax.jit(jap.apply_scattered)(jnp.asarray(u)), tap.apply_scattered(tu))

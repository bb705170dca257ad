"""Per-level ops of the port against the JAX reference, on every level of
the n=8 test hierarchy, in f32 and f64: face extraction, the direct gf
pipeline, the composite apply, the smoother sweeps, the spectral solve and
the FAC active-set smoother.

Tolerances relative to max|ref|: f64 <= 1e-12; f32 <= 1e-5 — both f32
sides take the Kronecker spectral form at n <= 16, but the f32 sums may
run in another order.  The reference ops run under
``jax.jit`` (one compile per op, not one per eager primitive)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.ops.patch_sweep as tps

from _torch_parity import DTYPES, RTOL, field, hierarchies, rel_err

LEVELS = range(6)
CASES = [(dt, k) for dt in ("f32", "f64") for k in LEVELS]
IDS = [f"{dt}-L{k}" for dt, k in CASES]


@functools.lru_cache(maxsize=None)
def levels(dt, k):
    jh, th = hierarchies()
    npdt, tdt = DTYPES[dt]
    return (jlo.Level(jh[k], dtype=jnp.dtype(npdt)),
            tlo.Level(th[k], dtype=tdt, device="cpu"))


@functools.lru_cache(maxsize=None)
def active(dt, k):
    """The same seeded random active set on both sides (at least one
    patch, and not all of them where the level has more than one)."""
    jl, tl = levels(dt, k)
    rng = np.random.default_rng(100 + k)
    mask = rng.random(jl.P) < 0.4
    mask[rng.integers(jl.P)] = True
    return (jlo.ActiveSmoother(jl, mask), tlo.ActiveSmoother(tl, mask),
            jlo.ActiveSmoother(jl, mask, build_solver=False),
            tlo.ActiveSmoother(tl, mask, build_solver=False))


def _inputs(dt, k, count=2):
    jl, _ = levels(dt, k)
    rng = np.random.default_rng(k)
    return [field(rng, jl.P, dtype=DTYPES[dt][0]) for _ in range(count)]


def _check(dt, ref, got):
    assert got.dtype == DTYPES[dt][1]
    assert rel_err(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_tables(dt, k):
    jl, tl = levels(dt, k)
    assert (jl.P, jl.num_ifaces, jl._nref) == (tl.P, tl.num_ifaces, tl._nref)
    for name in ("h2inv", "ghost_coef", "ghost_coef_eff", "_gf_w_own", "_gf_w_mix"):
        a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(np.asarray(jl._gf_mix_idx), tl._gf_mix_idx.numpy())
    assert jl._case_scalar == tl._case_scalar
    # spectral tables: BC sort, groups, factored and dense denominators
    js, ts = jl._st, tl._st
    assert np.array_equal(np.asarray(js.perm), ts.perm.numpy())
    fields = ("start", "stop", "fwd_kinds", "inv_kinds", "pin_dc")
    assert ([tuple(getattr(g, f) for f in fields) for g in js.groups]
            == [tuple(getattr(g, f) for f in fields) for g in ts.groups])
    assert np.array_equal(np.asarray(js.lam_tab), ts.lam_tab)
    assert np.array_equal(np.asarray(js.lam_idx), ts.lam_idx)
    dn = np.asarray(jlo._denom_of(js, 2, 8))
    assert dn.dtype == ts.denom.numpy().dtype and np.array_equal(dn, ts.denom.numpy())


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_extract_faces_and_gf_parts(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, k, 1)
    ref = jax.jit(jlo.extract_faces, static_argnums=(1, 2))(jnp.asarray(u), 2, 8)
    got = tlo.extract_faces(torch.from_numpy(u), 2, 8)
    assert np.array_equal(np.asarray(ref), got.numpy())
    jmix, jown = jax.jit(jl._gf_parts)(jnp.asarray(u))
    tmix, town = tl._gf_parts(torch.from_numpy(u))
    _check(dt, jmix, tmix)
    assert np.array_equal(np.asarray(jown), town.numpy())
    _check(dt, jax.jit(jl._gf_faces)(jnp.asarray(u)), tl._gf_faces(torch.from_numpy(u)))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_apply(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, k, 1)
    _check(dt, jax.jit(jl.apply)(jnp.asarray(u)), tl.apply(torch.from_numpy(u)))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_smooth_and_spectral_solve(dt, k):
    jl, tl = levels(dt, k)
    f, u = _inputs(dt, k)
    tf, tu = torch.from_numpy(f), torch.from_numpy(u)
    _check(dt, jax.jit(jl.smooth)(jnp.asarray(f), jnp.asarray(u)), tl.smooth(tf, tu))
    _check(dt, jax.jit(jl.smooth_zero)(jnp.asarray(f)), tl.smooth_zero(tf))
    _check(dt, jax.jit(jl._spectral_solve)(jnp.asarray(f)),
           tps._spectral_apply(tl._st, tf, 2, 8))
    fold = jax.jit(lambda f, u: jlo._fold_faces_flat(
        f, jl._gf_faces(u), jl.h2inv, 2, 8, mm=False))(jnp.asarray(f), jnp.asarray(u))
    _check(dt, fold, tps._fold_faces_flat(tf, tl._gf_faces(tu), tl.h2inv, 2, 8))


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_integrate_and_zeros(dt, k):
    jl, tl = levels(dt, k)
    (u,) = _inputs(dt, k, 1)
    a = float(jax.jit(jl.integrate)(jnp.asarray(u)))
    b = float(tl.integrate(torch.from_numpy(u)))
    assert abs(a - b) <= RTOL[dt] * max(abs(a), 1.0)
    assert tl.volume == jl.volume
    z = tl.zeros()
    assert z.dtype == DTYPES[dt][1] and tuple(z.shape) == jl.zeros().shape
    assert not z.any()


@pytest.mark.parametrize("dt,k", CASES, ids=IDS)
def test_active_smoother(dt, k):
    ja, ta, jap, tap = active(dt, k)
    assert np.array_equal(ja.act, ta.act) and ja.num_sub_ifaces == ta.num_sub_ifaces
    f, u = _inputs(dt, k)
    tf, tu = torch.from_numpy(f), torch.from_numpy(u)
    _check(dt, jax.jit(ja.smooth)(jnp.asarray(f), jnp.asarray(u)), ta.smooth(tf, tu))
    _check(dt, jax.jit(ja.smooth_zero)(jnp.asarray(f)), ta.smooth_zero(tf))
    _check(dt, jax.jit(jap.apply_scattered)(jnp.asarray(u)), tap.apply_scattered(tu))

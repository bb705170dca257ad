"""The port's multigrid against the JAX reference at D=3, on the 3D test
hierarchy (``refined_tree(3, 3, 2)`` at n=4, five levels): the per-axis
transfer matmul on all three array axes, the level stack and FAC active
sets, restriction and prolongation on every level pair (eight orthants),
the dense 3D coarse inverse, and whole V(1,1) applications with full and
with active-set smoothing.  ``coarse_direct_max_dof=64`` makes every level
a visited level and the one-patch bottom a dense solve.

Tolerances relative to max|ref|: f64 <= 1e-12; f32 <= 1e-5 (both packages'
f32 transfers and spectral solves take Kronecker forms at n <= 16, their
sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_torch.gmg as tgmg
from pressurepoissonsolver_torch.ops.patch_sweep import axis_matmul

from _torch_parity import DTYPES, MESH, RTOL, field, hierarchies, rel_err

D = 3
N = MESH[D][2]
OPTS = dict(pre_sweeps=1, post_sweeps=1, coarse_direct_max_dof=64)


@functools.lru_cache(maxsize=None)
def cycles(dt, fac="full"):
    jh, th = hierarchies(D=D)
    npdt, tdt = DTYPES[dt]
    return (jgmg.build_gmg(jh, jgmg.CycleOpts(fac_smoothing=fac, **OPTS),
                           dtype=jnp.dtype(npdt)),
            tgmg.build_gmg(th, tgmg.CycleOpts(fac_smoothing=fac, **OPTS),
                           dtype=tdt, device="cpu"))


@pytest.mark.parametrize("ax", [1, 2, 3])
def test_axis_matmul_contracts_the_named_axis(ax):
    """``axis_matmul`` on a ``[P, nz, ny, nx]`` field contracts exactly
    array axis ``ax`` (z = 1, y = 2, x = 3) with ``M``."""
    rng = np.random.default_rng(ax)
    M = rng.standard_normal((5, 5))
    x = rng.standard_normal((3, 5, 5, 5))
    sub = "pzyx"
    out = sub.replace(sub[ax], "k")
    ref = np.einsum(f"k{sub[ax]},{sub}->{out}", M, x)
    got = axis_matmul(torch.from_numpy(M), torch.from_numpy(x), ax)
    assert np.allclose(ref, got.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("fac", ["full", "active"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_level_stack_and_active_sets_3d(dt, fac):
    jc, tc = cycles(dt, fac)
    assert [l.P for l in jc.levels] == [l.P for l in tc.levels] == [78, 71, 64, 8, 1]
    for k in range(len(jc.levels)):
        if fac == "active":
            assert (jc._active[k] == "skip") == tc._skip[k]
        for ja, ta in ((jc._asmooth[k], tc._asmooth[k]), (jc._aapply[k], tc._aapply[k])):
            assert (ja is None) == (ta is None)
            if ja is not None:
                assert np.array_equal(ja.act, ta.act)
    if fac == "full":
        assert not any(a is not None for a in tc._asmooth)
    else:
        assert any(a is not None for a in tc._asmooth)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_coarse_inverse_3d(dt):
    jc, tc = cycles(dt)
    a, b = np.asarray(jc._coarse_inv), tc._coarse_inv.numpy()
    assert a.shape == b.shape == (64, 64)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_restrict_and_prolong_3d(dt, k):
    jc, tc = cycles(dt)
    jt, tt = jc.transfers[k], tc.transfers[k]
    rng = np.random.default_rng(10 + k)
    npdt = DTYPES[dt][0]
    fine = field(rng, jt.fine.P, n=N, dtype=npdt, D=D)
    coarse = field(rng, jt.coarse.P, n=N, dtype=npdt, D=D)
    ref = jax.jit(jt.restrict)(jnp.asarray(fine))
    got = tt.restrict(torch.from_numpy(fine))
    assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]
    ref = jax.jit(jt.prolong_add)(jnp.asarray(coarse), jnp.asarray(fine))
    got = tt.prolong_add(torch.from_numpy(coarse), torch.from_numpy(fine))
    assert rel_err(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("fac", ["full", "active"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_vcycle_apply_3d(dt, fac):
    jc, tc = cycles(dt, fac)
    f = field(np.random.default_rng(7), 78, n=N, dtype=DTYPES[dt][0], D=D)
    ref = jax.jit(jc.apply)(jnp.asarray(f))
    got = tc.apply(torch.from_numpy(f))
    assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]

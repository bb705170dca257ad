"""The port's multigrid against the JAX reference on the n=8 test
hierarchy: level stack and FAC active sets, restriction and prolongation
on every level pair, the dense coarse inverse, and whole V(2,1)
applications with active-set and with full smoothing.

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

from _torch_parity import DTYPES, RTOL, field, hierarchies, rel_err

OPTS = dict(pre_sweeps=2, post_sweeps=1, coarse_direct_max_dof=64)


@functools.lru_cache(maxsize=None)
def cycles(dt, fac="active"):
    jh, th = hierarchies()
    npdt, tdt = DTYPES[dt]
    return (jgmg.build_gmg(jh, jgmg.CycleOpts(fac_smoothing=fac, **OPTS),
                           dtype=jnp.dtype(npdt)),
            tgmg.build_gmg(th, tgmg.CycleOpts(fac_smoothing=fac, **OPTS),
                           dtype=tdt, device="cpu"))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_level_stack_and_active_sets(dt):
    jc, tc = cycles(dt)
    assert [l.P for l in jc.levels] == [l.P for l in tc.levels] == [70, 67, 64, 16, 4, 1]
    for k in range(len(jc.levels)):
        assert (jc._active[k] == "skip") == tc._skip[k]
        for ja, ta in ((jc._asmooth[k], tc._asmooth[k]), (jc._aapply[k], tc._aapply[k])):
            assert (ja is None) == (ta is None)
            if ja is not None:
                assert np.array_equal(ja.act, ta.act)
    # active-set smoothing on levels 1 and 2, as in the bench configuration
    assert [a is not None for a in tc._asmooth] == [False, True, True, False, False, False]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_coarse_inverse(dt):
    jc, tc = cycles(dt)
    a, b = np.asarray(jc._coarse_inv), tc._coarse_inv.numpy()
    assert a.shape == b.shape == (64, 64)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_restrict_and_prolong(dt, k):
    jc, tc = cycles(dt)
    jt, tt = jc.transfers[k], tc.transfers[k]
    rng = np.random.default_rng(10 + k)
    npdt = DTYPES[dt][0]
    fine = field(rng, jt.fine.P, dtype=npdt)
    coarse = field(rng, jt.coarse.P, dtype=npdt)
    ref = jax.jit(jt.restrict)(jnp.asarray(fine))
    got = tt.restrict(torch.from_numpy(fine))
    assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]
    ref = jax.jit(jt.prolong_add)(jnp.asarray(coarse), jnp.asarray(fine))
    got = tt.prolong_add(torch.from_numpy(coarse), torch.from_numpy(fine))
    assert rel_err(ref, got) <= RTOL[dt]


@pytest.mark.parametrize("fac", ["active", "full"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_vcycle_apply(dt, fac):
    jc, tc = cycles(dt, fac)
    f = field(np.random.default_rng(7), 70, dtype=DTYPES[dt][0])
    ref = jax.jit(jc.apply)(jnp.asarray(f))
    got = tc.apply(torch.from_numpy(f))
    assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]


def test_unported_cycle_options_raise():
    """The W-cycle and linear prolongation are ported (held to the
    reference in test_torch_variants.py); values the reference does not
    know raise."""
    _, th = hierarchies()
    w = tgmg.build_gmg(th, tgmg.CycleOpts(cycle_type="W", **OPTS), device="cpu")
    lin = tgmg.build_gmg(th, tgmg.CycleOpts(interpolator="linear", **OPTS), device="cpu")
    assert w.opts.cycle_type == "W"
    assert all(t.prolong_mode == "linear" for t in lin.transfers)
    with pytest.raises(ValueError):
        tgmg.build_gmg(th, tgmg.CycleOpts(cycle_type="F", **OPTS), device="cpu")
    with pytest.raises(ValueError):
        tgmg.build_gmg(th, tgmg.CycleOpts(interpolator="cubic", **OPTS), device="cpu")

"""The ghost-closure stencil of the port against the JAX reference: the
plain PyTorch version against ``level_ops._star_stencil`` and against the
Pallas TPU kernel ``pallas_stencil._kernel_2d`` run in interpret mode; the
wrapper's dispatch.  The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_tpu.ops.pallas_stencil as jps
from pressurepoissonsolver_torch.ops import ghost_stencil as gs

from _torch_parity import DTYPES, rel_err


def _inputs(P, n, npdt, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((P, n, n)).astype(npdt)
    gf = rng.standard_normal((P, 4, n)).astype(npdt)
    coef = rng.choice([-1.0, 0.0, 1.0], size=(P, 4)).astype(npdt)
    h = 1.0 / (n * 2.0 ** rng.integers(1, 5, size=(P, 1)))
    h2 = np.repeat(1.0 / h**2, 2, axis=1).astype(npdt)
    return u, gf, coef, h2


# same algebra, evaluated in the same order: f64 agrees to round-off; f32
# to a few ulps of the largest term (tolerances relative to max|ref|)
@pytest.mark.parametrize("n", [8, 12, 16])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_matches_star_stencil(dt, n):
    npdt, tdt = DTYPES[dt]
    u, gf, coef, h2 = _inputs(5, n, npdt)
    ref = jlo._star_stencil(jnp.asarray(u), jnp.asarray(gf).reshape(5, 4, n),
                            jnp.asarray(coef), jnp.asarray(h2), 2, n)
    assert ref.dtype == npdt
    got = gs.ghost_stencil_plain(*(torch.from_numpy(a) for a in (u, gf, coef, h2)))
    assert got.dtype == tdt
    assert rel_err(ref, got) <= {"f32": 1e-6, "f64": 1e-13}[dt]


@pytest.mark.parametrize("n", [8, 16])
def test_plain_matches_pallas_kernel(n):
    """The Pallas kernel itself (interpret mode, whole arrays as one
    block): f32, with a one-hot placement matmul for the face terms.  It
    agrees with ``_star_stencil`` to ~1e-7 of max|out|; allow 1e-6."""
    P = 8
    u, gf, coef, h2 = _inputs(P, n, np.float32, seed=1)
    s = 2.0 * np.stack([h2[:, 0], h2[:, 0], h2[:, 1], h2[:, 1]], axis=1)[..., None]
    gfs = (gf * s).reshape(P, 4 * n).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(jps._kernel_2d, n),
        out_shape=jax.ShapeDtypeStruct((P, n * n), jnp.float32),
        interpret=True,
    )
    ref = np.asarray(call(jnp.asarray(u.reshape(P, n * n)), jnp.asarray(gfs),
                          jnp.asarray(h2), jnp.asarray(coef),
                          jnp.asarray(jps._placement_matrix(n))))
    got = gs.ghost_stencil_plain(*(torch.from_numpy(a) for a in (u, gf, coef, h2)))
    assert rel_err(ref.reshape(P, n, n), got) <= 1e-6


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_cpu_wrapper_takes_plain_version(dt):
    npdt, _ = DTYPES[dt]
    args = [torch.from_numpy(a) for a in _inputs(6, 12, npdt)]
    before = dict(gs.launches)
    out = gs.ghost_stencil(*args)
    assert gs.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, gs.ghost_stencil_plain(*args))


def test_wrapper_rejects_bad_inputs():
    u, gf, coef, h2 = (torch.from_numpy(a) for a in _inputs(3, 8, np.float64))
    with pytest.raises(ValueError):
        gs.ghost_stencil(u, gf[:, :3], coef, h2)
    with pytest.raises(ValueError):
        gs.ghost_stencil(u[:, :, :4], gf, coef, h2)
    with pytest.raises(TypeError):
        gs.ghost_stencil(u, gf.float(), coef, h2)
    with pytest.raises(TypeError):
        gs.ghost_stencil(u.int(), gf.int(), coef.int(), h2.int())

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


@pytest.mark.parametrize("side", range(4))
def test_2d_face_order_is_extract_faces_order(side):
    """A face entry lands on the boundary cell that ``extract_faces`` of
    the reference reads it from: x faces indexed by row y, y faces by
    column x."""
    P, n = 2, 5
    zeros = np.zeros((P, n, n))
    for k in (0, 2, n - 1):
        gf = np.zeros((P, 4, n))
        gf[1, side, k] = 1.0
        out = gs.ghost_stencil_plain(
            torch.from_numpy(zeros), torch.from_numpy(gf),
            torch.zeros(P, 4, dtype=torch.float64),
            torch.ones(P, 2, dtype=torch.float64)).numpy()
        hit = np.argwhere(out != 0.0)
        assert len(hit) == 1 and out[tuple(hit[0])] == 2.0
        onehot = zeros.copy()
        onehot[tuple(hit[0])] = 1.0
        faces = np.asarray(jlo.extract_faces(jnp.asarray(onehot), 2, n))
        assert faces[1, side, k] == 1.0


# the kernels take 16-byte vectors (4 f32, 2 f64 elements) when n is a
# multiple of the vector and u, gf and out are 16-byte aligned, else one
# element per thread; ``shift`` moves one pointer by that many elements
@pytest.mark.parametrize("n, dt, shift, want", [
    (64, "f32", 0, 4), (32, "f32", 0, 4), (12, "f32", 0, 4), (4, "f32", 0, 4),
    (6, "f32", 0, 1), (2, "f32", 0, 1), (1, "f32", 0, 1),
    (32, "f32", 1, 1), (32, "f32", 2, 1), (32, "f32", 4, 4),
    (64, "f64", 0, 2), (32, "f64", 0, 2), (6, "f64", 0, 2), (2, "f64", 0, 2),
    (37, "f64", 0, 1), (1, "f64", 0, 1), (32, "f64", 1, 1), (32, "f64", 2, 2),
])
@pytest.mark.parametrize("which", ["u", "gf", "out"])
def test_vector_width_choice(n, dt, shift, want, which):
    dtype = DTYPES[dt][1]
    base = 1 << 20
    ptrs = {k: base + (shift * dtype.itemsize if k == which else 0)
            for k in ("u", "gf", "out")}
    assert gs.vector_width(n, dtype, ptrs["u"], ptrs["gf"], ptrs["out"]) == want


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_vector_width_of_a_shifted_view(dt):
    """A contiguous tensor one element into its storage is not 16-byte
    aligned, so it takes the one-element path."""
    dtype = DTYPES[dt][1]
    buf = torch.zeros(33 * 32 * 32, dtype=dtype)
    whole, shifted = buf[:32 * 32 * 32], buf[1:1 + 32 * 32 * 32]
    assert shifted.is_contiguous()
    ptr = whole.data_ptr()
    assert gs.vector_width(32, dtype, whole.data_ptr(), ptr, ptr) == 16 // dtype.itemsize
    assert gs.vector_width(32, dtype, shifted.data_ptr(), ptr, ptr) == 1


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


# --- 3D -------------------------------------------------------------------


def _inputs_3d(P, n, npdt, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((P, n, n, n)).astype(npdt)
    gf = rng.standard_normal((P, 6, n * n)).astype(npdt)
    coef = rng.choice([-1.0, 0.0, 1.0], size=(P, 6)).astype(npdt)
    h = 1.0 / (n * 2.0 ** rng.integers(1, 5, size=(P, 1)))
    h2 = np.repeat(1.0 / h**2, 3, axis=1).astype(npdt)
    return u, gf, coef, h2


# the same algebra in the same order (tolerances relative to max|ref|)
@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_3d_matches_star_stencil(dt, n):
    npdt, tdt = DTYPES[dt]
    u, gf, coef, h2 = _inputs_3d(5, n, npdt)
    ref = jlo._star_stencil(jnp.asarray(u), jnp.asarray(gf), jnp.asarray(coef),
                            jnp.asarray(h2), 3, n)
    assert ref.dtype == npdt
    got = gs.ghost_stencil_3d_plain(*(torch.from_numpy(a) for a in (u, gf, coef, h2)))
    assert got.dtype == tdt
    assert rel_err(ref, got) <= {"f32": 1e-6, "f64": 1e-13}[dt]


@pytest.mark.parametrize("n", [4, 8])
def test_plain_3d_matches_pallas_kernel(n):
    """The Pallas ``_kernel_3d`` itself (interpret mode, whole arrays as
    one block, the one-hot x-face spread ``Sx``), f32.  It sums the ghost
    terms in another order than ``_star_stencil``; allow 1e-6 of
    max|out|."""
    P = 6
    u, gf, coef, h2 = _inputs_3d(P, n, np.float32, seed=1)
    call = pl.pallas_call(
        functools.partial(jps._kernel_3d, n, P),
        out_shape=jax.ShapeDtypeStruct((P, n, n * n), jnp.float32),
        interpret=True,
    )
    ref = np.asarray(call(
        jnp.asarray(u.reshape(P, n, n * n)), jnp.asarray(gf[:, 4:6]),
        jnp.asarray(gf[:, 2:4].reshape(P, 2, n, n)),
        jnp.asarray(gf[:, 0:2].reshape(P, 2, n, n)), jnp.asarray(h2),
        jnp.asarray(coef), jnp.asarray(jps._xspread_matrix(n))))
    got = gs.ghost_stencil_3d_plain(*(torch.from_numpy(a) for a in (u, gf, coef, h2)))
    assert rel_err(ref.reshape(P, n, n, n), got) <= 1e-6


@pytest.mark.parametrize("side", range(6))
def test_3d_face_order_is_extract_faces_order(side):
    """A face entry lands on the boundary cell that ``extract_faces`` of
    the reference reads it from: x faces flat (z, y), y faces (z, x), z
    faces (y, x)."""
    P, n = 2, 5
    zeros = np.zeros((P, n, n, n))
    for k in (0, 3, 7, n * n - 1):
        gf = np.zeros((P, 6, n * n))
        gf[1, side, k] = 1.0
        out = gs.ghost_stencil_3d_plain(
            torch.from_numpy(zeros), torch.from_numpy(gf),
            torch.zeros(P, 6, dtype=torch.float64),
            torch.ones(P, 3, dtype=torch.float64)).numpy()
        hit = np.argwhere(out != 0.0)
        assert len(hit) == 1 and out[tuple(hit[0])] == 2.0
        onehot = zeros.copy()
        onehot[tuple(hit[0])] = 1.0
        faces = np.asarray(jlo.extract_faces(jnp.asarray(onehot), 3, n))
        assert faces[1, side, k] == 1.0


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_cpu_3d_wrapper_takes_plain_version(dt):
    npdt, _ = DTYPES[dt]
    args = [torch.from_numpy(a) for a in _inputs_3d(4, 6, npdt)]
    before = (dict(gs.launches), dict(gs.launches_3d))
    out = gs.ghost_stencil_3d(*args)
    assert (gs.launches, gs.launches_3d) == before  # no kernel launch on the CPU
    assert torch.equal(out, gs.ghost_stencil_3d_plain(*args))


def test_3d_wrapper_rejects_bad_inputs():
    u, gf, coef, h2 = (torch.from_numpy(a) for a in _inputs_3d(3, 4, np.float64))
    with pytest.raises(ValueError):
        gs.ghost_stencil_3d(u, gf[:, :4], coef, h2)
    with pytest.raises(ValueError):
        gs.ghost_stencil_3d(u, gf.reshape(3, 6, 4, 4), coef, h2)
    with pytest.raises(ValueError):
        gs.ghost_stencil_3d(u[:, :, :, :3], gf, coef, h2)
    with pytest.raises(ValueError):
        gs.ghost_stencil_3d(u, gf, coef, h2[:, :2])
    with pytest.raises(ValueError):  # a 2D field to the 3D kernel
        gs.ghost_stencil_3d(u[:, 0], gf, coef, h2)
    with pytest.raises(TypeError):
        gs.ghost_stencil_3d(u, gf, coef.float(), h2)

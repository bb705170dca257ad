"""The assembled operators of the CLI's ``--matrix-type`` in the port
against the JAX reference, on the CPU: ``matrix.bcoo_matvec`` (a device
SpMV over a host CSR: the composite operator, bilinear and quadratic, and
the probed Schur matrix) and ``matrix.pbm_matvec`` (the deduplicated
pointer-block Schur operator), each against the reference's, against the
host CSR product and against the matrix-free operator.

Meshes and walls as in ``test_torch_schur.py``; f64, to 1e-12 of the
largest entry (summation orders differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.matrix as jmatrix
import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_torch.matrix as tmatrix
import pressurepoissonsolver_torch.ops.level_ops as tlo

from _torch_parity import rel_err
from test_torch_schur import CASES, IDS, hierarchies, levels


@pytest.mark.parametrize("D,walls,scheme",
                         [(2, "mixed", "bilinear"), (2, "dirichlet", "quadratic"),
                          (3, "neumann", "bilinear")],
                         ids=["2d-mixed", "2d-quadratic", "3d-neumann"])
def test_bcoo_matvec_composite(D, walls, scheme):
    jh, th = hierarchies(D, walls)
    A = tmatrix.assemble_composite(th.finest, scheme=scheme)
    assert (A != jmatrix.assemble_composite(jh.finest, scheme=scheme)).nnz == 0
    u = np.random.default_rng(3).standard_normal((th.finest.num_patches,)
                                                 + th.finest.ns_shape)
    got = tmatrix.bcoo_matvec(A, device="cpu")(torch.from_numpy(u))
    assert got.shape == u.shape and got.dtype == torch.float64
    ref = jax.jit(jmatrix.bcoo_matvec(A))(jnp.asarray(u))
    assert rel_err(ref, got) <= 1e-12
    assert rel_err((A @ u.reshape(-1)).reshape(u.shape), got) <= 1e-12
    lvl = tlo.Level(th.finest, device="cpu", iface_scheme=scheme)
    assert rel_err(lvl.apply(torch.from_numpy(u)), got) <= 1e-12


@pytest.mark.parametrize("D,walls", CASES, ids=IDS)
def test_schur_operators(D, walls):
    """``bcoo_matvec(assemble_schur(.))`` and ``pbm_matvec`` both compute
    ``(I - S) gamma``: against the reference's pointer-block operator, the
    host CSR product and the matrix-free ``gamma - schur_S(gamma)``."""
    jl, tl = levels(D, walls, "f64")
    g = np.random.default_rng(4).standard_normal((tl.num_ifaces, tl.m))
    tg = torch.from_numpy(g)
    A_S = tmatrix.assemble_schur(tl)
    csr = tmatrix.bcoo_matvec(A_S, device="cpu")(tg)
    pbm = tmatrix.pbm_matvec(tl)(tg)
    assert pbm.shape == tg.shape and pbm.dtype == torch.float64
    ref = jax.jit(jmatrix.pbm_matvec(jl))(jnp.asarray(g))
    host = (A_S @ g.reshape(-1)).reshape(g.shape)
    free = tl.schur_S(tg)
    for got in (csr, pbm):
        assert rel_err(ref, got) <= 1e-12
        assert rel_err(host, got) <= 1e-12
        assert rel_err(tg - free, got) <= 1e-12


def test_pbm_matvec_quadratic():
    """The pointer-block operator at face depth 2 (the quadratic closures
    source the first-interior faces too)."""
    jh, th = hierarchies(2, "dirichlet")
    jl = jlo.Level(jh.finest, dtype=jnp.float64, iface_scheme="quadratic")
    tl = tlo.Level(th.finest, device="cpu", iface_scheme="quadratic")
    g = np.random.default_rng(5).standard_normal((tl.num_ifaces, tl.m))
    got = tmatrix.pbm_matvec(tl)(torch.from_numpy(g))
    assert rel_err(jax.jit(jmatrix.pbm_matvec(jl))(jnp.asarray(g)), got) <= 1e-12
    assert rel_err(g - tl.schur_S(torch.from_numpy(g)).numpy(), got) <= 1e-12


def test_bcoo_matvec_keeps_the_dtype():
    """The matrix is held in the dtype asked for; an f32 vector needs an
    f32 matrix."""
    _, th = hierarchies(2, "dirichlet")
    A = tmatrix.assemble_composite(th.finest)
    u = torch.ones((th.finest.num_patches,) + th.finest.ns_shape, dtype=torch.float32)
    got = tmatrix.bcoo_matvec(A, dtype=torch.float32, device="cpu")(u)
    assert got.dtype == torch.float32
    ref = (A @ np.ones(A.shape[1])).reshape(u.shape)
    assert rel_err(ref, got) <= 1e-5

"""Shared set-up of the parity tests between the JAX reference
(``pressurepoissonsolver_tpu``) and the PyTorch port
(``pressurepoissonsolver_torch``): one small adaptive hierarchy per
dimension built by both packages from the same tree, on the CPU."""

import functools

import numpy as np
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo

# refined_tree(2, 4, 2) at n=8: 70 finest patches, 6 levels
D, N, BASE, CORNER = 2, 8, 4, 2
# per dimension: (base levels, corner levels, n); the 3D mesh is
# refined_tree(3, 3, 2) at n=4: 78 finest patches, 5 levels
MESH = {2: (BASE, CORNER, N), 3: (3, 2, 4)}
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
# tolerances relative to max|ref|: f64 ops agree to round-off; f32 ops
# may take another summation order (both packages take the Kronecker
# spectral and transfer forms at n <= 16, PPS_KRON_MAX_N)
RTOL = {"f32": 1e-5, "f64": 1e-12}


@functools.lru_cache(maxsize=None)
def hierarchies(neumann=False, D=D):
    """(JAX hierarchy, port hierarchy) of the ``D``-dimensional test mesh;
    the reference uses its pure-Python table builder, the one the port
    carries."""
    base, corner, n = MESH[D]
    nm = neumann if isinstance(neumann, bool) else list(neumann)
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=n,
                                 neumann=nm, use_native=False)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=n,
                                 neumann=nm)
    return jh, th


def rel_err(ref, got) -> float:
    """max|ref - got| / max|ref| (numpy or torch inputs)."""
    ref = np.asarray(ref, dtype=np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, dtype=np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max()) or 1.0
    return float(np.abs(ref - got).max()) / scale


def field(rng, P, n=N, dtype=np.float64, D=D):
    return rng.standard_normal((P,) + (n,) * D).astype(dtype)

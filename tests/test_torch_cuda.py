"""The port on a CUDA card: the ghost-stencil kernel against its plain
version, the composite apply and the active-set residual apply through the
kernel against the CPU, and a small solve.

Every test here needs a card and skips without one (the CUDA kernel has no
CPU mode).  This file imports no JAX, so it runs on a machine without it;
there, skip the JAX-based ``tests/conftest.py``::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.gmg import CycleOpts, build_gmg
from pressurepoissonsolver_torch.ops import ghost_stencil as gs
from pressurepoissonsolver_torch.ops.level_ops import ActiveSmoother, Level
from pressurepoissonsolver_torch.problems import get_problem, init_problem
from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions

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


@pytest.mark.parametrize("shape", [(1048, 64), (37, 12), (3, 1)])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_kernel_matches_plain(cuda, dt, shape):
    P, n = shape
    rng = np.random.default_rng(0)
    arrs = (rng.standard_normal((P, n, n)), rng.standard_normal((P, 4, n)),
            rng.choice([-1.0, 0.0, 1.0], size=(P, 4)),
            rng.uniform(1e2, 1e6, size=(P, 2)))
    args = [torch.as_tensor(a, dtype=DTYPES[dt], device=cuda) for a in arrs]
    name = str(DTYPES[dt]).replace("torch.", "")
    before = gs.launches[name]
    out = gs.ghost_stencil(*args)
    torch.cuda.synchronize()
    assert gs.launches[name] == before + 1
    assert _rel(gs.ghost_stencil_plain(*args), out) <= RTOL[dt]


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
    gs.reset_launches()
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

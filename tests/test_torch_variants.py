"""The cycle and closure variants of the port against the JAX reference, on
the CPU: linear prolongation (its matrices and ``Transfer`` in 2D and 3D),
the W-cycle, and the quadratic 2D refinement closures (their tables and the
``Level`` at face depth 2: ``apply``, ``interpolate``, ``smooth``); then
the iteration counts of the IR solves that select each.

Meshes: the n=8 2D test mesh (``refined_tree(2, 4, 2)``, 6 levels) with
Dirichlet, all-Neumann and mixed walls, and the n=4 3D one.  Tolerances
relative to max|ref|: f64 1e-12, f32 1e-5 (both packages' f32 transfers
take Kronecker forms at n <= 16, their sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.iface as jiface
import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.iface as tiface
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.solver as tsolver

from _torch_parity import DTYPES, RTOL, field, hierarchies, rel_err

OPTS = dict(pre_sweeps=2, post_sweeps=1, coarse_direct_max_dof=64)
WALLS = {"dirichlet": False, "neumann": True, "mixed": ("x_lo", "y_hi")}
IFACE_FIELDS = ("num_ifaces", "m", "iface_side_idx", "iface_side_mask",
                "contrib_patch", "contrib_side", "contrib_iface",
                "contrib_case", "case_w", "case_src", "face_depth")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4, 8, 32, 64])
def test_linear_prolong_matrix_equal(n):
    for half in (0, 1):
        assert _same(jgmg._linear_prolong_matrix(n, half),
                     tgmg._linear_prolong_matrix(n, half))


@pytest.mark.parametrize("n", [4, 8, 12, 64])
def test_quadratic_templates_equal(n):
    ja, tb = jiface.quadratic2d_templates(n), tiface.quadratic2d_templates(n)
    assert ja[0] == tb[0]
    assert _same(ja[1], tb[1]) and _same(ja[2], tb[2])


@pytest.mark.parametrize("walls", list(WALLS))
def test_quadratic_tables_equal(walls):
    jh, th = hierarchies(WALLS[walls])
    for jl, tl in zip(jh.levels, th.levels):
        jt = jiface.build_iface_tables(jl, scheme="quadratic")
        tt = tiface.build_iface_tables(tl, scheme="quadratic")
        for name in IFACE_FIELDS:
            assert _same(getattr(jt, name), getattr(tt, name)), name


@functools.lru_cache(maxsize=None)
def cycles(dt, D=2, fac="active", **kw):
    jh, th = hierarchies(D=D)
    npdt, tdt = DTYPES[dt]
    opts = dict(OPTS, fac_smoothing=fac, **kw)
    return (jgmg.build_gmg(jh, jgmg.CycleOpts(**opts), dtype=jnp.dtype(npdt)),
            tgmg.build_gmg(th, tgmg.CycleOpts(**opts), dtype=tdt, device="cpu"))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_linear_transfers(dt, D):
    jc, tc = cycles(dt, D, interpolator="linear")
    n = jc.levels[0].n
    npdt = DTYPES[dt][0]
    for k, (jt, tt) in enumerate(zip(jc.transfers, tc.transfers)):
        assert tt.prolong_mode == jt.prolong_mode == "linear"
        rng = np.random.default_rng(20 + k)
        fine = field(rng, jt.fine.P, n=n, dtype=npdt, D=D)
        coarse = field(rng, jt.coarse.P, n=n, dtype=npdt, D=D)
        ref = jax.jit(jt.prolong_add)(jnp.asarray(coarse), jnp.asarray(fine))
        got = tt.prolong_add(torch.from_numpy(coarse), torch.from_numpy(fine))
        assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]
        ref = jax.jit(jt.restrict)(jnp.asarray(fine))
        assert rel_err(ref, tt.restrict(torch.from_numpy(fine))) <= RTOL[dt]


CYCLE_CASES = [("f64", 2, "active", "constant"), ("f64", 2, "full", "linear"),
               ("f32", 2, "active", "constant"), ("f64", 3, "full", "constant")]


@pytest.mark.parametrize("dt,D,fac,interp", CYCLE_CASES,
                         ids=[f"{d}-{D}d-{f}-{i}" for d, D, f, i in CYCLE_CASES])
def test_w_cycle_apply(dt, D, fac, interp):
    """One W-cycle ``apply`` (two coarse visits per level, mid sweeps
    between them) against the reference's scanned form."""
    jc, tc = cycles(dt, D, fac, cycle_type="W", interpolator=interp, mid_sweeps=2)
    f = field(np.random.default_rng(9), jc.levels[0].P, n=jc.levels[0].n,
              dtype=DTYPES[dt][0], D=D)
    ref = jax.jit(jc.apply)(jnp.asarray(f))
    got = tc.apply(torch.from_numpy(f))
    assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]
    # the W-cycle differs from the V-cycle
    _, tv = cycles(dt, D, fac, interpolator=interp, mid_sweeps=2)
    assert rel_err(got, tv.apply(torch.from_numpy(f))) > 100 * RTOL[dt]


@functools.lru_cache(maxsize=None)
def quadratic_levels(dt, walls):
    jh, th = hierarchies(WALLS[walls])
    npdt, tdt = DTYPES[dt]
    return (jlo.Level(jh.finest, dtype=jnp.dtype(npdt), iface_scheme="quadratic"),
            tlo.Level(th.finest, dtype=tdt, device="cpu", iface_scheme="quadratic"))


QCASES = [(dt, w) for dt in ("f32", "f64") for w in WALLS]


@pytest.mark.parametrize("dt,walls", QCASES, ids=[f"{d}-{w}" for d, w in QCASES])
def test_quadratic_level(dt, walls):
    """The finest level at face depth 2: its gf tables, and ``apply`` (the
    2D stencil's plain version here), ``interpolate``, ``smooth`` and
    ``smooth_zero``."""
    jl, tl = quadratic_levels(dt, walls)
    assert tl.face_depth == jl.face_depth == 2
    assert (jl.num_ifaces, jl._nref) == (tl.num_ifaces, tl._nref)
    for name in ("ghost_coef", "ghost_coef_eff", "_gf_w_own", "_gf_w_mix"):
        assert _same(getattr(jl, name), getattr(tl, name).numpy()), name
    assert np.array_equal(np.asarray(jl._gf_mix_idx), tl._gf_mix_idx.numpy())
    assert jl._case_scalar == tl._case_scalar
    rng = np.random.default_rng(11)
    npdt = DTYPES[dt][0]
    f, u = field(rng, jl.P, dtype=npdt), field(rng, jl.P, dtype=npdt)
    tf, tu = torch.from_numpy(f), torch.from_numpy(u)
    for ref, got in (
        (jax.jit(jl.apply)(jnp.asarray(u)), tl.apply(tu)),
        (jax.jit(jl.interpolate)(jnp.asarray(u)), tl.interpolate(tu)),
        (jax.jit(jl.smooth)(jnp.asarray(f), jnp.asarray(u)), tl.smooth(tf, tu)),
        (jax.jit(jl.smooth_zero)(jnp.asarray(f)), tl.smooth_zero(tf)),
    ):
        assert got.dtype == DTYPES[dt][1] and rel_err(ref, got) <= RTOL[dt]
    # the closures differ from the bilinear ones
    bil = tlo.Level(tl.pl, dtype=tl.dtype, device="cpu")
    assert rel_err(tl.apply(tu), bil.apply(tu)) > 100 * RTOL[dt]


# IR solves (f32 V(2,1) FAC cycle with active-set smoothing, inner
# BiCGStab, tol 1e-10, inner_tol 1e-4) with one variant each
SOLVES = {"quadratic": ({"iface_scheme": "quadratic"}, {}),
          "w-cycle": ({}, {"cycle_type": "W"}),
          "linear": ({}, {"interpolator": "linear"}),
          "quadratic-f64-cycle": ({"iface_scheme": "quadratic", "precond": "f64"}, {})}


@pytest.mark.parametrize("name", list(SOLVES))
def test_variant_solve_counts(name):
    """Outer rounds exactly, inner iterations within one (f32 cycle) or
    exactly (f64 cycle); the solution to 1e-9 of its largest.  With the
    quadratic closures an f32 cycle and the inner operator stay bilinear
    (the reference's structure), so the IR takes more outer rounds."""
    kw, gkw = SOLVES[name]
    kw = dict(kw)
    f64 = kw.pop("precond", "f32") == "f64"
    jh, th = hierarchies()
    gmg = dict(OPTS, fac_smoothing="active", **gkw)
    js = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, precond_dtype=jnp.float64 if f64 else jnp.float32,
        gmg=jgmg.CycleOpts(**gmg), **kw))
    ts = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        tol=1e-10, precond_dtype=torch.float64 if f64 else torch.float32,
        gmg=tgmg.CycleOpts(**gmg), **kw), device="cpu")
    f, _ = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    ju, jinfo = js.solve_refined(jnp.asarray(f), tol=1e-10, inner_tol=1e-4)
    tu, tinfo = ts.solve_refined(torch.from_numpy(f), tol=1e-10, inner_tol=1e-4)
    assert tinfo["outer_iterations"] == jinfo["outer_iterations"]
    assert abs(tinfo["inner_iterations"] - jinfo["inner_iterations"]) <= (0 if f64 else 1)
    assert tinfo["residual"] <= 1e-10
    assert rel_err(ju, tu) <= 1e-9
    if kw.get("iface_scheme") == "quadratic":
        # an f64 cycle reuses the (quadratic) fine level as its finest
        assert ts.fine_level.face_depth == 2
        assert ts._fine_low.face_depth == (2 if f64 else 1)

"""The port's gathered engine (``comm="pjit"``, ``parallel.gathered``) and
the halo engine's overlapped apply against the reference on the CPU, at a
world of 4 gloo ranks spawned once for the module
(``_torch_dist.gathered_battery``) on ``refined_tree(2, 3, 1)`` at n=8
(19 patches, padded to 20):

* every level, Schur and transfer op of the gathered engine, gathered,
  against the reference's ``comm="pjit"`` engine (``Level.set_mesh`` on a
  4-device mesh of the same padded hierarchy) and against its
  single-device ``Level``/``Transfer``, in f64 at 1e-12 and in f32 at 1e-5
  of the largest magnitude;
* the halo engine's apply at world 4, which runs the stencil in its no-gf
  mode while the exchange is in flight and adds the face term after,
  against the single-device apply and the reference's halo engine (which
  has the same split), in 2D and 3D;
* the padded patch of every op exactly 0;

and, with no world, the plain no-gf stencil plus the face term against the
stencil with the faces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.parallel.halo as jhalo
import pressurepoissonsolver_tpu.parallel.sharding as jshard
from pressurepoissonsolver_tpu.gmg import Transfer as JTransfer
from pressurepoissonsolver_tpu.ops.level_ops import Level as JLevel
from pressurepoissonsolver_tpu.ops.level_ops import _face_pad_sum

from pressurepoissonsolver_torch.ops import ghost_stencil as gs

from _torch_dist import World, field

WORLD = 4
N = 8
# relative to the largest magnitude of the reference's result
RTOL = {"float64": 1e-12, "float32": 1e-5}
JDTYPE = {"float64": jnp.float64, "float32": jnp.float32}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The world of the battery, started before the reference's side runs
    in this process."""
    w = World(WORLD, tmp_path_factory.mktemp("world"), "gathered")
    yield w
    w.close()


@pytest.fixture(scope="module")
def world(started, reference):
    res = started.wait()
    return res[0], res


def _ops(lvl, coarse, u, f, g, uf, uc):
    out = {"apply": lvl.apply(u), "smooth": lvl.smooth(f, u),
           "smooth_zero": lvl.smooth_zero(f), "interpolate": lvl.interpolate(u),
           "patch_solve": lvl.patch_solve(f, g), "fold_gamma": lvl.fold_gamma(f, g),
           "schur_S": lvl.schur_S(g), "integrate": float(lvl.integrate(u))}
    for mode in ("constant", "linear"):
        t = JTransfer(lvl, coarse, prolong_mode=mode)
        out[f"restrict_{mode}"] = t.restrict(uf)
        out[f"prolong_{mode}"] = t.prolong_add(uc, uf)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def reference(started):
    """The reference's pjit engine, its single-device level and its halo
    engine on the battery's inputs."""
    mesh = jshard.make_mesh(WORLD)
    h = jdomain.DomainHierarchy(jgeo.refined_tree(2, 3, 1), n=N, use_native=False,
                                num_shards=WORLD)
    out = {}
    for name, jdt in JDTYPE.items():
        P = h.finest.num_patches
        res = {}
        for engine in ("pjit", "single"):
            lvl, coarse = JLevel(h[0], dtype=jdt), JLevel(h[1], dtype=jdt)
            if engine == "pjit":
                lvl.set_mesh(mesh)
                coarse.set_mesh(mesh)
            u, f = (jnp.asarray(field(s, (P, N, N)), dtype=jdt) for s in (11, 1))
            g = jnp.asarray(field(7, (lvl.num_ifaces, lvl.m)), dtype=jdt)
            uf = jnp.asarray(field(3, (P, N, N)), dtype=jdt)
            uc = jnp.asarray(field(4, (coarse.P, N, N)), dtype=jdt)
            res[engine] = _ops(lvl, coarse, u, f, g, uf, uc)
            if engine == "single":
                res["halo"] = np.asarray(jhalo.ShardedLevel(lvl, mesh).apply(u))
        out[name] = res
    h3 = jdomain.DomainHierarchy(jgeo.refined_tree(3, 2, 1), n=4, use_native=False,
                                 num_shards=WORLD)
    l3 = JLevel(h3.finest)
    u3 = jnp.asarray(field(6, (l3.P, 4, 4, 4)))
    out["3d"] = {"single": np.asarray(l3.apply(u3)),
                 "halo": np.asarray(jhalo.ShardedLevel(l3, mesh).apply(u3))}
    out["P"], out["real"] = h.finest.num_patches, h.finest.real_patches
    return out


OPS = ("apply", "smooth", "smooth_zero", "interpolate", "patch_solve", "fold_gamma",
       "schur_S", "restrict_constant", "prolong_constant", "restrict_linear",
       "prolong_linear")
CASES = [(dt, op, engine) for dt in RTOL for op in OPS for engine in ("pjit", "single")]


def _close(got, want, rtol):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("dtype, op, engine", CASES,
                         ids=[f"{d}-{o}-{e}" for d, o, e in CASES])
def test_gathered_op_matches_reference(world, reference, dtype, op, engine):
    """The gathered engine's op equals the reference's pjit engine and its
    single-device level."""
    _close(world[0][dtype][op], reference[dtype][engine][op], RTOL[dtype])


@pytest.mark.parametrize("dtype", sorted(RTOL))
def test_gathered_integrate_sums_over_the_ranks(world, reference, dtype):
    got, want = world[0][dtype]["integrate"], reference[dtype]["pjit"]["integrate"]
    assert abs(got - want) <= RTOL[dtype] * abs(want)


HALO = [(dt, ref) for dt in RTOL for ref in ("single", "halo")]


@pytest.mark.parametrize("dtype, ref", HALO, ids=[f"{d}-{r}" for d, r in HALO])
def test_overlapped_halo_apply_matches_reference(world, reference, dtype, ref):
    """At world 4 the halo apply launches the no-gf stencil once (the
    exchange in flight) and equals the single-device apply and the
    reference's halo engine, whose apply has the same split."""
    assert world[0][dtype]["halo_nogf"] == [True]
    want = reference[dtype]["single" if ref == "single" else "halo"]
    want = want["apply"] if ref == "single" else want
    _close(world[0][dtype]["halo_apply"], want, RTOL[dtype])


@pytest.mark.parametrize("engine", ["gathered", "halo"])
@pytest.mark.parametrize("ref", ["single", "halo"])
def test_sharded_3d_apply_matches_reference(world, reference, engine, ref):
    got = world[0]["3d"]["apply" if engine == "gathered" else "halo_apply"]
    _close(got, reference["3d"][ref], RTOL["float64"])


def test_every_rank_gathers_the_same_field(world):
    r0, ranks = world
    for r in ranks[1:]:
        for dt in RTOL:
            for op in OPS + ("halo_apply",):
                assert np.array_equal(r[dt][op], r0[dt][op]), (dt, op)


@pytest.mark.parametrize("dtype", sorted(RTOL))
def test_gathered_dummy_patches_stay_zero(world, reference, dtype):
    """With zero data on the padded patches, the gathered apply, both
    sweeps, the patch solves and the overlapped halo apply leave them
    exactly zero."""
    dummy = world[0][dtype]["dummy"]
    assert dummy.shape[:2] == (reference["P"] - reference["real"], 5)
    assert not np.any(dummy)


@pytest.mark.parametrize("dtype", sorted(RTOL))
def test_each_rank_holds_its_rows_of_the_level(world, dtype):
    """A rank's gathered engine holds its rows and the table rows its
    outputs read, less than the global level; the gathered operands are
    whole only while an op runs."""
    shares = [r[dtype]["bytes"] for r in world[1]]
    assert all(own < level for own, level in shares), shares


# -- the no-gf stencil, no world ----------------------------------------------


SPLIT = [(D, n, dt) for D in (2, 3) for n in (1, 4, 7) for dt in ("float32", "float64")]


@pytest.mark.parametrize("D, n, dtype", SPLIT, ids=[f"{D}d-n{n}-{d}" for D, n, d in SPLIT])
def test_no_gf_stencil_plus_face_term_is_the_stencil(D, n, dtype):
    """``add_ghost_faces(stencil(u, None), gf, h2) == stencil(u, gf)`` for
    the plain version, which the wrapper runs for CPU tensors (the card
    tests hold the kernels to it)."""
    dt = getattr(torch, dtype)
    P = 5
    u = torch.as_tensor(field(1, (P,) + (n,) * D), dtype=dt)
    gf = torch.as_tensor(field(2, (P, 2 * D, n ** (D - 1))), dtype=dt)
    coef = torch.as_tensor(np.random.default_rng(3).choice([-1.0, 0.0, 1.0], (P, 2 * D)),
                           dtype=dt)
    h2 = torch.as_tensor(1.0 + np.random.default_rng(4).random((P, D)), dtype=dt)
    stencil = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
    want = stencil(u, gf, coef, h2)
    base = stencil(u, None, coef, h2)
    plain = (gs.ghost_stencil_plain if D == 2 else gs.ghost_stencil_3d_plain)(
        u, None, coef, h2)
    assert torch.equal(base, plain)
    got = gs.add_ghost_faces(base.clone(), gf, h2)
    _close(got.numpy(), want.numpy(), RTOL[dtype])
    # the base term is the stencil with gf = 0
    assert torch.equal(base, stencil(u, torch.zeros_like(gf), coef, h2))


FACES = [(D, n, dt) for D in (2, 3) for n in (1, 2, 5) for dt in ("float32", "float64")]


@pytest.mark.parametrize("D, n, dtype", FACES, ids=[f"{D}d-n{n}-{d}" for D, n, d in FACES])
def test_face_term_matches_reference_face_pad_sum(D, n, dtype):
    """``add_ghost_faces`` (its plain version here) is the reference halo
    engine's face correction, ``out + 2 * _face_pad_sum(gf, h2)``."""
    dt = getattr(torch, dtype)
    P = 4
    out, gf, h2 = (field(5, (P,) + (n,) * D), field(6, (P, 2 * D, n ** (D - 1))),
                   1.0 + np.random.default_rng(7).random((P, D)))
    jd = JDTYPE[dtype]
    want = np.asarray(jnp.asarray(out, dtype=jd) + 2.0 * _face_pad_sum(
        jnp.asarray(gf, dtype=jd), jnp.asarray(h2, dtype=jd), D, n, jd))
    t = [torch.as_tensor(a, dtype=dt) for a in (out, gf, h2)]
    got = gs.add_ghost_faces(*t)
    assert got.data_ptr() == t[0].data_ptr()  # in place
    _close(got.numpy(), want, RTOL[dtype])

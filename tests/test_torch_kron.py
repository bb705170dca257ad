"""The f32 Kronecker forms of the spectral patch solve and of the grid
transfers (``PPS_KRON_MAX_N``) in the port against the JAX reference, on
the CPU.

Meshes: the parity meshes of ``_torch_parity`` (2D ``refined_tree(2, 4,
2)`` at n=8, 3D ``refined_tree(3, 3, 2)`` at n=4) with Dirichlet walls (one
boundary-condition group per level) or all-Neumann walls (several groups
on the finest level, one pinned group on the coarsest).  Held:

* the tables are built exactly where the reference builds them (f32 and
  ``n <= PPS_KRON_MAX_N``, never f64; the knob set with
  ``monkeypatch.setenv`` before both packages build), and equal to the
  reference's bit for bit;
* the ops on that form against the reference's on the same form, and
  against the port's own per-axis form (``PPS_KRON_MAX_N=0``), to
  ``RTOL["f32"]`` of max|ref|;
* the halo engine's rank solves and transfers at a world of four gloo
  ranks (``_torch_dist.kron_battery``) against the single-device port;
* one CLI run on both packages with the knob at its default and at 0."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.cli as jcli
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.ops.level_ops as jlo
import pressurepoissonsolver_torch.cli as tcli
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.ops.level_ops as tlo
import pressurepoissonsolver_torch.ops.patch_sweep as tps

from _torch_dist import World, kron_hierarchy, kron_inputs, reads_kron
from _torch_parity import DTYPES, MESH, RTOL, field, hierarchies, rel_err

DIMS = (2, 3)
WALLS = {"dirichlet": False, "neumann": True}
# the knob's settings: None = unset (the default, 16)
KNOBS = (None, "4", "0")
WORLD = 4


def _levels(D, walls, k, dt="f32"):
    """(JAX level, port level) ``k`` of the ``D``-dimensional mesh, built
    with the knob as the environment holds it now."""
    jh, th = hierarchies(WALLS[walls], D=D)
    npdt, tdt = DTYPES[dt]
    return (jlo.Level(jh[k], dtype=jnp.dtype(npdt)),
            tlo.Level(th[k], dtype=tdt, device="cpu"))


def _mask(P):
    """An active set: every third patch (at least one, not all of them
    where the level has more than one)."""
    return np.arange(P) % 3 == 0


def _same(ref, got) -> bool:
    """Every matrix of ``ref`` (a list of arrays or of tuples) equal to
    ``got``'s bit for bit, in the same dtype."""
    flat = [(r, g) for rs, gs in zip(ref, got)
            for r, g in (zip(rs, gs) if isinstance(rs, tuple) else [(rs, gs)])]
    return len(ref) == len(got) and all(
        np.asarray(r).dtype == g.numpy().dtype and np.array_equal(np.asarray(r), g.numpy())
        for r, g in flat)


@pytest.mark.parametrize("knob", KNOBS, ids=["default", "4", "0"])
@pytest.mark.parametrize("D", DIMS)
def test_tables_built_where_the_reference_builds_them(monkeypatch, D, knob):
    if knob is None:
        monkeypatch.delenv("PPS_KRON_MAX_N", raising=False)
    else:
        monkeypatch.setenv("PPS_KRON_MAX_N", knob)
    n = MESH[D][2]
    for dt in ("f32", "f64"):
        want = dt == "f32" and n <= int(knob or 16)
        jl, tl = _levels(D, "neumann", 0, dt)
        mask = _mask(jl.P)
        ja, ta = jlo.ActiveSmoother(jl, mask), tlo.ActiveSmoother(tl, mask)
        assert len(tl._st.groups) > 1
        for js, ts in ((jl._st, tl._st), (ja._st, ta._st)):
            assert (js.kron is not None) == (ts.kron is not None) == want
            if want:
                assert len(ts.kron) == len(ts.groups) and _same(js.kron, ts.kron)
        jc, tc = _levels(D, "neumann", 1, dt)
        for mode in ("constant", "linear"):
            jt = jgmg.Transfer(jl, jc, prolong_mode=mode)
            tt = tgmg.Transfer(tl, tc, prolong_mode=mode)
            assert jt._use_kron == tt._use_kron == want
            assert (tt._Wr is not None) == (tt._Wp is not None) == want
            if want:
                assert _same(jt._Wr, tt._Wr) and _same(jt._Wp, tt._Wp)


SPECTRAL = [(D, walls, which) for D in DIMS for walls in WALLS
            for which in ("finest", "coarsest", "active")]


@pytest.mark.parametrize("D, walls, which", SPECTRAL,
                         ids=[f"{D}d-{w}-{c}" for D, w, c in SPECTRAL])
def test_spectral_apply_matches_reference(D, walls, which):
    """The Kronecker patch solves of a level (the coarsest: one patch, the
    pinned group with Neumann walls) and of an active-set subset."""
    k = -1 if which == "coarsest" else 0
    jl, tl = _levels(D, walls, k)
    f = field(np.random.default_rng(30 + D), jl.P, n=jl.n, dtype=np.float32, D=D)
    if which == "active":
        mask = _mask(jl.P)
        ja, ta = jlo.ActiveSmoother(jl, mask), tlo.ActiveSmoother(tl, mask)
        assert ta._st.kron is not None and 0 < ta.Pa < tl.P
        ref, got = jax.jit(ja.smooth_zero)(jnp.asarray(f)), ta.smooth_zero(torch.from_numpy(f))
    else:
        assert tl._st.kron is not None
        if walls == "neumann":
            assert ([g.pin_dc for g in tl._st.groups] == [True] if which == "coarsest"
                    else len(tl._st.groups) > 1)
        ref = jax.jit(lambda x: jlo._spectral_apply(jl._st, x, D, jl.n))(jnp.asarray(f))
        got = tps._spectral_apply(tl._st, torch.from_numpy(f), D, tl.n)
    assert got.dtype == torch.float32 and rel_err(ref, got) <= RTOL["f32"]


TRANSFERS = [(D, mode) for D in DIMS for mode in ("constant", "linear")]


def _transfer_inputs(D, fine, coarse):
    rng = np.random.default_rng(40 + D)
    return (field(rng, fine.P, n=fine.n, dtype=np.float32, D=D),
            field(rng, coarse.P, n=fine.n, dtype=np.float32, D=D))


@pytest.mark.parametrize("D, mode", TRANSFERS, ids=[f"{D}d-{m}" for D, m in TRANSFERS])
def test_transfers_match_reference(D, mode):
    """``restrict`` and ``prolong_add`` between the two finest levels and
    the two coarsest, both packages on the Kronecker form."""
    jh, th = hierarchies(D=D)
    for k in (0, len(th) - 2):
        jf, tf = _levels(D, "dirichlet", k)
        jc, tc = _levels(D, "dirichlet", k + 1)
        jt = jgmg.Transfer(jf, jc, prolong_mode=mode)
        tt = tgmg.Transfer(tf, tc, prolong_mode=mode)
        assert tt._use_kron
        uf, uc = _transfer_inputs(D, tf, tc)
        assert rel_err(jax.jit(jt.restrict)(jnp.asarray(uf)),
                       tt.restrict(torch.from_numpy(uf))) <= RTOL["f32"]
        assert rel_err(jax.jit(jt.prolong_add)(jnp.asarray(uc), jnp.asarray(uf)),
                       tt.prolong_add(torch.from_numpy(uc), torch.from_numpy(uf))) <= RTOL["f32"]


OWN = [(D, op) for D in DIMS for op in ("spectral", "active", "restrict", "prolong-constant",
                                        "prolong-linear")]


@pytest.mark.parametrize("D, op", OWN, ids=[f"{D}d-{o}" for D, o in OWN])
def test_kron_form_matches_per_axis_form(monkeypatch, D, op):
    """The port's Kronecker form (default knob) against its per-axis form
    (``PPS_KRON_MAX_N=0``) on the all-Neumann mesh."""
    th = hierarchies(True, D=D)[1]

    def build():
        """(form is Kronecker, the op, its Kronecker matrices)."""
        fine = tlo.Level(th[0], dtype=torch.float32, device="cpu")
        if op in ("spectral", "active"):
            sm = fine if op == "spectral" else tlo.ActiveSmoother(fine, _mask(fine.P))
            return sm._st.kron is not None, sm.smooth_zero, sm._st.kron or []
        coarse = tlo.Level(th[1], dtype=torch.float32, device="cpu")
        mode = op.split("-")[-1] if op != "restrict" else "constant"
        t = tgmg.Transfer(fine, coarse, prolong_mode=mode)
        uc = torch.from_numpy(_transfer_inputs(D, fine, coarse)[1])
        if op == "restrict":
            return t._use_kron, t.restrict, t._Wr
        return t._use_kron, lambda x: t.prolong_add(uc, x), t._Wp

    monkeypatch.delenv("PPS_KRON_MAX_N", raising=False)
    kron, fk, mats = build()
    monkeypatch.setenv("PPS_KRON_MAX_N", "0")
    axis, fa, _ = build()
    assert kron and not axis
    x = torch.from_numpy(field(np.random.default_rng(50 + D), th[0].num_patches,
                               n=th[0].n, dtype=np.float32, D=D))
    ref = fa(x)
    assert rel_err(ref.numpy(), fk(x)) <= RTOL["f32"]
    assert reads_kron(lambda: fk(x), mats)


# -- the halo engine at a world of 4 -----------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the Kronecker battery."""
    w = World(WORLD, tmp_path_factory.mktemp("world"), "kron")
    try:
        yield w.wait()
    finally:
        w.close()


@pytest.fixture(scope="module")
def single(world):
    """The single-device port's results on the battery's inputs and
    hierarchies."""
    out = {}
    for key in ("2d", "3d"):
        h = kron_hierarchy(key, WORLD)
        fine, coarse = (tlo.Level(h[i], dtype=torch.float32, device="cpu") for i in (0, 1))
        f, uf, uc = (torch.from_numpy(x) for x in kron_inputs(fine, coarse))
        mask = tgmg._fac_active_mask(tgmg.Transfer(fine, coarse), 1)
        res = {"solve": fine.smooth_zero(f),
               "active_solve": tlo.ActiveSmoother(coarse, mask).smooth_zero(uc)}
        for mode in ("constant", "linear"):
            t = tgmg.Transfer(fine, coarse, prolong_mode=mode)
            res[f"prolong_{mode}"] = t.prolong_add(uc, uf)
            res[f"restrict_{mode}"] = t.restrict(uf)
        out[key] = res
    return out


SHARDED = [(key, op) for key in ("2d", "3d") for op in (
    "solve", "active_solve", "prolong_constant", "prolong_linear", "restrict_constant")]


@pytest.mark.parametrize("key, op", SHARDED, ids=[f"{k}-{o}" for k, o in SHARDED])
def test_halo_engine_matches_single_device(world, single, key, op):
    """Each rank's op on the Kronecker form (it reads the matrices) and its
    gathered result against the single-device port."""
    for part in ("level", "active", "constant", "linear"):
        flags = [r[key]["kron"][part] for r in world if r[key]["kron"][part] is not None]
        assert flags and all(flags), (part, [r[key]["kron"] for r in world])
    for r in world:  # every rank gathers the same field
        assert np.array_equal(r[key][op], world[0][key][op])
    assert rel_err(single[key][op].numpy(), world[0][key][op]) <= RTOL["f32"]


# -- the command-line apps ---------------------------------------------------

CLI_ARGV = ["--uniform", "4", "-n", "8", "--solver", "ir", "-t", "1e-10"]


@pytest.mark.parametrize("knob", [None, "0"], ids=["default", "0"])
def test_cli_matches_reference(monkeypatch, tmp_path, knob):
    """The same argv through both packages' ``cli.main`` with the knob at
    its default and at 0: outer rounds equal, inner iterations within one,
    the error to 1e-6 of itself."""
    if knob is None:
        monkeypatch.delenv("PPS_KRON_MAX_N", raising=False)
    else:
        monkeypatch.setenv("PPS_KRON_MAX_N", knob)
    outs = []
    for name, main in (("jax", lambda a: jcli.main(2, a)),
                       ("port", lambda a: tcli.main(2, a, device="cpu"))):
        js = str(tmp_path / f"{name}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(CLI_ARGV + ["--out-json", js]) == 0
        with open(js) as fh:
            outs.append(json.load(fh))
    ref, got = outs
    assert got["outer_iterations"] == ref["outer_iterations"]
    assert abs(got["inner_iterations"] - ref["inner_iterations"]) <= 1
    assert got["residual"] <= 1e-10
    assert abs(got["error"] - ref["error"]) <= 1e-6 * ref["error"]

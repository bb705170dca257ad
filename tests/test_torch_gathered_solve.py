"""The port's public solves through the gathered engine
(``PoissonSolver(comm="pjit")``) against the reference's ``comm="pjit"``
solves on the CPU, at a world of 4 gloo ranks spawned once for the module
(``_torch_dist.gathered_solve_battery``) on ``refined_tree(2, 3, 1)`` at
n=8, padded to 20 patches, both on the same padded hierarchy and a
4-device mesh on the reference's side:

* ``solve`` (f64 GMG BiCGStab), ``solve_refined`` (f32 V(2,1) FAC cycle
  with the masked active-set sweeps) and ``solve_schur`` (Woodbury GMG
  and block-Jacobi): iterations within one (two for block-Jacobi, as the
  halo engine's test), solutions within 1e-8 (the reference's own test's
  tolerance), the padded patch exactly 0;
* one FAC cycle with active-set smoothing on ``refined_tree(2, 4, 2)``,
  whose coarse levels have proper active sets, three ways: the gathered
  engine's masked sweeps, the halo engine's per-rank subset smoothers and
  the single-device ``ActiveSmoother`` (and the reference's masked pjit
  cycle), equal at 1e-12: the port of the reference's
  ``test_sharded_active_set_smoothing_matches_masked`` on a mesh built in
  code;
* ``--shards 4 --comm pjit`` through the port's CLI against the reference
  CLI's single-device run."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pressurepoissonsolver_tpu.cli as jcli
import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.parallel.sharding as jshard
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver

import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.gmg as tgmg

from _torch_dist import CLI_ARGV, SMALL_GMG, World, field

WORLD = 4
N = 8
IR_GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
              coarse_direct_max_dof=64)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    w = World(WORLD, tmp_path_factory.mktemp("world"), "gathered_solve")
    yield w
    w.close()


@pytest.fixture(scope="module")
def world(started, reference):
    res = started.wait()
    return res[0], res


@pytest.fixture(scope="module")
def reference(started, tmp_path_factory):
    """The reference's pjit solves on the same padded hierarchy, its masked
    pjit cycle and its single-device CLI run."""
    mesh = jshard.make_mesh(WORLD)
    h = jdomain.DomainHierarchy(jgeo.refined_tree(2, 3, 1), n=N, use_native=False,
                                num_shards=WORLD)
    f, exact = jprob.init_problem(h.finest, jprob.get_problem("trig", 2))
    f = jnp.asarray(f)
    out = {"real": h.finest.real_patches}
    r = jsolver.PoissonSolver(h, jsolver.SolveOptions(
        tol=1e-11, comm="pjit", gmg=jgmg.CycleOpts(**SMALL_GMG)), mesh=mesh).solve(f)
    out["solve"] = {"x": np.asarray(r.x), "iterations": int(r.iterations)}
    s = jsolver.PoissonSolver(h, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32, comm="pjit",
        gmg=jgmg.CycleOpts(**IR_GMG)), mesh=mesh)
    u, info = s.solve_refined(f, tol=1e-10)
    out["refined"] = {"x": np.asarray(u), "info": info,
                      "report": s.report(u, f, jnp.asarray(exact))}
    for prec in ("gmg", "blockjacobi"):
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
        out[f"schur_{prec}"] = {"x": np.asarray(u), "iterations": int(res.iterations),
                                "report": s.report(u, f, jnp.asarray(exact))}
    hd = jdomain.DomainHierarchy(jgeo.refined_tree(2, 4, 2), n=N, use_native=False,
                                 num_shards=WORLD)
    g = jgmg.build_gmg(hd, jgmg.CycleOpts(pre_sweeps=2, fac_smoothing="active",
                                          coarse_direct_max_dof=64), mesh=mesh)
    fd = field(5, (hd.finest.num_patches, N, N))
    fd[hd.finest.real_patches:] = 0.0
    # jitted: the same cycle as the eager one, traced once (eager dispatch of
    # each sharded op takes six times as long here)
    out["cycle_pjit"] = np.asarray(jax.jit(g.apply)(jnp.asarray(fd)))
    js = tmp_path_factory.mktemp("jcli") / "cli.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(2, CLI_ARGV + ["--out-json", str(js)]) == 0
    out["cli"] = json.loads(js.read_text())
    return out


@pytest.mark.parametrize("key, band", [("solve", 1), ("refined", 1),
                                       ("schur_gmg", 1), ("schur_blockjacobi", 2)])
def test_pjit_solve_matches_reference(world, reference, key, band):
    w, r = world[0][key], reference[key]
    nr = reference["real"]
    if key == "refined":
        assert w["info"]["outer_iterations"] == r["info"]["outer_iterations"]
        assert (abs(w["info"]["inner_iterations"] - r["info"]["inner_iterations"])
                <= w["info"]["outer_iterations"])
        assert w["info"]["residual"] <= 1e-10
    else:
        assert abs(w["iterations"] - r["iterations"]) <= band
    if "report" in w:
        assert w["report"]["residual"] <= 1e-9
        assert (abs(w["report"]["error"] - r["report"]["error"])
                <= 1e-6 * r["report"]["error"])
    np.testing.assert_allclose(w["x"][:nr], r["x"][:nr], atol=1e-8, rtol=0)
    assert w["x"][nr:].size and not np.any(w["x"][nr:])


def test_pjit_cycle_has_masked_levels(world):
    """The solve_refined cycle smooths its coarse levels with the masked
    sweeps (at least one level)."""
    assert world[0]["masked_levels"] >= 1


def test_every_rank_gathers_the_same_solution(world):
    r0, ranks = world
    for r in ranks[1:]:
        for key in ("solve", "refined", "schur_gmg", "schur_blockjacobi"):
            assert np.array_equal(r[key]["x"], r0[key]["x"]), key


@pytest.fixture(scope="module")
def single_cycle():
    """The single-device cycle with subset-compute ``ActiveSmoother``s on
    the plain hierarchy (in the sharded slot order), the real patch count
    and the number of its levels with an active set."""
    import torch

    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 4, 2), n=N)
    ts = tdomain.DomainHierarchy(tgeo.refined_tree(2, 4, 2), n=N, num_shards=WORLD)
    opts = tgmg.CycleOpts(pre_sweeps=2, fac_smoothing="active", coarse_direct_max_dof=64)
    g = tgmg.build_gmg(th, opts, dtype=torch.float64, device="cpu")
    nr = ts.finest.real_patches
    pos = np.searchsorted(th.finest.ids, ts.finest.ids[:nr])
    f = np.zeros((th.finest.num_patches, N, N))
    f[pos] = field(5, (ts.finest.num_patches, N, N))[:nr]
    active = sum(a is not None for a in g._asmooth)
    return g.apply(torch.as_tensor(f)).numpy()[pos], nr, active


@pytest.mark.parametrize("engine", ["pjit", "halo"])
def test_sharded_active_set_smoothing_matches_masked(world, reference, single_cycle,
                                                     engine):
    """One FAC cycle with active-set smoothing: the gathered engine's masked
    full sweeps and the halo engine's per-rank subset smoothers give the
    single-device subset cycle and the reference's masked pjit cycle, and
    at least one level is masked."""
    cycles = world[0]["cycles"]
    got = cycles[engine]
    want, nr, active = single_cycle
    # the padded hierarchy may mask one more level than the plain one (a
    # level whose real patches are all active keeps its dummy patches out)
    assert active >= 1 and got["of_kind"] >= active, got["kinds"]
    assert cycles["pjit"]["of_kind"] == cycles["halo"]["of_kind"]
    np.testing.assert_allclose(got["x"][:nr], want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["x"], reference["cycle_pjit"], rtol=1e-12, atol=1e-12)
    assert not np.any(got["x"][nr:])


def test_pjit_cli_matches_reference(world, reference):
    """``--shards 4 --comm pjit``: every rank returns 0, rank 0 alone
    prints and writes the out-json, and the run matches the reference
    CLI's."""
    r0, ranks = world
    assert all(r["cli"]["rc"] == 0 for r in ranks)
    assert "Iterations:" in r0["cli"]["stdout"]
    assert all(r["cli"]["stdout"] == "" for r in ranks[1:])
    got, want = r0["cli"]["json"], reference["cli"]
    assert abs(got["iterations"] - want["iterations"]) <= 1
    assert abs(got["error"] - want["error"]) <= 0.01 * want["error"]
    assert got["residual"] <= 1e-9 and got["dof"] == want["dof"]

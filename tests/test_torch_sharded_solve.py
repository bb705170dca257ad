"""The port's public sharded solves against the reference's single-device
solves on the CPU: ``PoissonSolver(mesh=...)`` at a world of 4 gloo ranks
spawned once for the module (``_torch_dist.solve_battery``) on
``refined_tree(2, 3, 1)`` at n=8 (19 patches, padded to 20), its
solutions gathered and aligned by patch id with the reference's
(``tests/test_sharding.py``'s ``_id_align``):

* ``solve`` (GMG BiCGStab) and the mixed-BC ``solve`` at atol 1e-9;
  ``solve_monitored``, GMRES and volume-weighted CG to the same solution
  at atol 1e-8;
* ``solve_refined`` (f32 V(2,1) FAC cycle) to a residual <= 1e-10;
* ``solve_schur`` with the Woodbury GMG and the block-Jacobi
  preconditioners (``schur_block_jacobi(engine=)``) at atol 1e-8;
* the padded patch of every solution exactly 0;
* ``--shards 4`` through the port's CLI against the reference CLI's
  single-device run: iterations within one, error within 1%;

then, in this process, a one-rank group (``--shards 1``, a one-rank mesh
against the plain solver), the shard-only CLI checks and
``scripts.scaling`` on a spawned world of two.

Counts are held within one where an f32 cycle or the sharded sums may move
them (the ranks add their partial dots in another order than one device)."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import pressurepoissonsolver_tpu.cli as jcli
import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.gmg as jgmg
import pressurepoissonsolver_tpu.problems as jprob
import pressurepoissonsolver_tpu.solver as jsolver

import pressurepoissonsolver_torch.cli as tcli
import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.gmg as tgmg
import pressurepoissonsolver_torch.parallel.sharding as tsharding
import pressurepoissonsolver_torch.problems as tprob
import pressurepoissonsolver_torch.solver as tsolver
from pressurepoissonsolver_torch.scripts import one_card_backends, scaling

from _torch_dist import CLI_ARGV, SMALL_GMG, World

WORLD = 4
IR_GMG = dict(pre_sweeps=2, post_sweeps=1, fac_smoothing="active",
              coarse_direct_max_dof=64)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The world of the solve battery, started before the reference's side
    runs in this process."""
    w = World(WORLD, tmp_path_factory.mktemp("world"), "solve")
    yield w
    w.close()


@pytest.fixture(scope="module")
def world(started, reference):
    """Rank 0's results of the solve battery, and every rank's."""
    res = started.wait()
    return res[0], res


@pytest.fixture(scope="module")
def reference(started, tmp_path_factory):
    """The reference's single-device solves (and CLI run) on the same
    problems."""
    tree = jgeo.refined_tree(2, 3, 1)
    jh = jdomain.DomainHierarchy(tree, n=8, use_native=False)
    f, exact = jprob.init_problem(jh.finest, jprob.get_problem("trig", 2))
    f = jnp.asarray(f)
    out = {"ids": jh.finest.ids}
    r = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-11, gmg=jgmg.CycleOpts(**SMALL_GMG))).solve(f)
    out["solve"] = {"x": np.asarray(r.x), "iterations": int(r.iterations)}
    jm = jdomain.DomainHierarchy(tree, n=8, neumann=["x_lo", "y_hi"], use_native=False)
    fm, _ = jprob.init_problem(jm.finest, jprob.get_problem("trig", 2))
    r = jsolver.PoissonSolver(jm, jsolver.SolveOptions(
        tol=1e-11, gmg=jgmg.CycleOpts(**SMALL_GMG))).solve(jnp.asarray(fm))
    out["solve_mixed"] = {"x": np.asarray(r.x), "iterations": int(r.iterations)}
    s = jsolver.PoissonSolver(jh, jsolver.SolveOptions(
        tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32,
        gmg=jgmg.CycleOpts(**IR_GMG)))
    u, info = s.solve_refined(f, tol=1e-10)
    out["refined"] = {"x": np.asarray(u), "info": info,
                      "report": s.report(u, f, jnp.asarray(exact))}
    for prec in ("gmg", "blockjacobi"):
        u, res = s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner=prec)
        out[f"schur_{prec}"] = {"x": np.asarray(u), "iterations": int(res.iterations),
                                "report": s.report(u, f, jnp.asarray(exact))}
    js = tmp_path_factory.mktemp("jcli") / "cli.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(2, CLI_ARGV + ["--out-json", str(js)]) == 0
    out["cli"] = json.loads(js.read_text())
    return out


def _aligned(world, reference, key, ref_key=None):
    """(sharded solution on the real patches in the reference's slot order,
    its padded rows, the reference's solution ``ref_key``, by default
    ``key``'s)."""
    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=8, num_shards=WORLD)
    nr = th.finest.real_patches
    x = world[0][key]["x"]
    pos = np.searchsorted(reference["ids"], th.finest.ids[:nr])
    ref = reference[ref_key or key]["x"]
    out = np.empty_like(ref)
    out[pos] = x[:nr]
    return out, x[nr:], ref


@pytest.mark.parametrize("key", ["solve", "solve_mixed"])
def test_sharded_solve_matches_reference(world, reference, key):
    got, pads, want = _aligned(world, reference, key)
    assert world[0][key]["rel"] < 1e-10
    assert abs(world[0][key]["iterations"] - reference[key]["iterations"]) <= 1
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert pads.size and not np.any(pads)


@pytest.mark.parametrize("key", ["monitored", "solve_gmres", "solve_cg"])
def test_sharded_krylov_variants_reach_the_reference_solution(world, reference, key):
    """The monitored BiCGStab (the sharded solve's count, its history down
    to the tolerance), GMRES (the Arnoldi dots summed over the ranks) and
    CG (the volume-weighted dots) reach the reference's solution."""
    got, pads, want = _aligned(world, reference, key, ref_key="solve")
    w = world[0][key]
    if key == "monitored":
        assert w["iterations"] == world[0]["solve"]["iterations"]
        assert len(w["hist"]) == w["iterations"] + 1 and w["hist"][-1] <= 1e-11
    else:
        assert w["rel"] <= 1e-11 and w["iterations"] > 0
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
    assert not np.any(pads)


def test_sharded_solve_refined_matches_reference(world, reference):
    got, pads, want = _aligned(world, reference, "refined")
    w, r = world[0]["refined"], reference["refined"]
    assert w["report"]["residual"] <= 1e-10 and w["info"]["residual"] <= 1e-10
    assert w["info"]["outer_iterations"] == r["info"]["outer_iterations"]
    assert (abs(w["info"]["inner_iterations"] - r["info"]["inner_iterations"])
            <= w["info"]["outer_iterations"])
    assert abs(w["report"]["error"] - r["report"]["error"]) <= 1e-6 * r["report"]["error"]
    assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)
    assert not np.any(pads)


@pytest.mark.parametrize("prec, band", [("gmg", 1), ("blockjacobi", 2)])
def test_sharded_schur_solve_matches_reference(world, reference, prec, band):
    key = f"schur_{prec}"
    got, pads, want = _aligned(world, reference, key)
    w, r = world[0][key], reference[key]
    assert abs(w["iterations"] - r["iterations"]) <= band
    assert w["report"]["residual"] <= 1e-9
    assert abs(w["report"]["error"] - r["report"]["error"]) <= 1e-6 * r["report"]["error"]
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
    assert not np.any(pads)


def test_every_rank_gathers_the_same_solution(world):
    r0, ranks = world
    for r in ranks[1:]:
        for key in ("solve", "monitored", "solve_gmres", "solve_cg", "solve_mixed",
                    "refined", "schur_gmg", "schur_blockjacobi"):
            assert np.array_equal(r[key]["x"], r0[key]["x"]), key


def test_sharded_cli_matches_reference(world, reference):
    """``--shards 4``: every rank returns 0, rank 0 alone prints and writes
    the out-json, and the run matches the reference CLI's."""
    r0, ranks = world
    assert all(r["cli"]["rc"] == 0 for r in ranks)
    assert "Iterations:" in r0["cli"]["stdout"] and "TIMING RESULTS" in r0["cli"]["stdout"]
    assert all(r["cli"]["stdout"] == "" for r in ranks[1:])
    got, want = r0["cli"]["json"], reference["cli"]
    assert abs(got["iterations"] - want["iterations"]) <= 1
    assert abs(got["error"] - want["error"]) <= 0.01 * want["error"]
    assert got["residual"] <= 1e-9 and got["dof"] == want["dof"]


# -- one process, no world ----------------------------------------------------


def test_comm_pjit_is_not_ported():
    """``comm="pjit"`` is ported now (``parallel.gathered``): on a one-rank
    mesh it gives the plain solver's iterates; an unknown engine raises."""
    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=8)
    f, _ = tprob.init_problem(th.finest, tprob.get_problem("trig", 2))
    opts = dict(tol=1e-11, gmg=tgmg.CycleOpts(**SMALL_GMG))
    plain = tsolver.PoissonSolver(th, tsolver.SolveOptions(**opts), device="cpu")
    mesh = tsharding.make_mesh(1, backend="gloo")
    try:
        s = tsolver.PoissonSolver(th, tsolver.SolveOptions(comm="pjit", **opts),
                                  mesh=mesh, device="cpu")
        assert type(s._op).__name__ == "GatheredLevel"
        r1, r2 = plain.solve(f), s.solve(f)
        assert r1.iterations == r2.iterations
        assert float((r1.x - r2.x).abs().max()) <= 1e-12 * float(r1.x.abs().max())
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        tsolver.PoissonSolver(th, tsolver.SolveOptions(comm="mpi"), device="cpu")


def test_cli_shards_one_starts_and_ends_its_group(tmp_path):
    """``--shards 1`` without ``torchrun``: a one-rank gloo group of its
    own, ended with the run, and the single-device run's numbers."""
    reps = []
    for extra in ([], ["--shards", "1"]):
        js = tmp_path / "out.json"
        with contextlib.redirect_stdout(io.StringIO()):
            assert tcli.main(2, CLI_ARGV + extra + ["--out-json", str(js)],
                             device="cpu") == 0
        assert not dist.is_initialized()
        reps.append(json.loads(js.read_text()))
    assert reps[0]["iterations"] == reps[1]["iterations"]
    assert abs(reps[0]["error"] - reps[1]["error"]) <= 1e-12 * reps[0]["error"]


@pytest.mark.parametrize("argv, msg", [
    (["--shards", "2"], "world has 1 rank"),
    (["--shards", "2", "--comm", "pjit"], "world has 1 rank"),
    (["--shards", "1", "--schur", "--matrix-type", "pbm"], "pbm is single-device"),
    (["--shards", "1", "--schur", "--matrix-type", "crs"], "single-device only"),
], ids=["world", "pjit", "pbm", "crs-schur"])
def test_cli_rejects_shard_combos(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(2, ["--uniform", "2", "-n", "8"] + argv, device="cpu")
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err
    assert not dist.is_initialized()


def test_sharded_solver_on_one_rank_matches_the_plain_solver():
    """A mesh of one rank (its own gloo group) gives the plain solver's
    iterates: the exchange has no offsets and every sum is local."""
    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=8)
    f, _ = tprob.init_problem(th.finest, tprob.get_problem("trig", 2))
    opts = dict(tol=1e-10, dtype=torch.float64, precond_dtype=torch.float32)
    plain = tsolver.PoissonSolver(th, tsolver.SolveOptions(
        gmg=tgmg.CycleOpts(**IR_GMG), **opts), device="cpu")
    mesh = tsharding.make_mesh(1, backend="gloo")
    try:
        sharded = tsolver.PoissonSolver(th, tsolver.SolveOptions(
            gmg=tgmg.CycleOpts(**IR_GMG), **opts), mesh=mesh, device="cpu")
        u1, i1 = plain.solve_refined(f, tol=1e-10)
        u2, i2 = sharded.solve_refined(f, tol=1e-10)
        assert (i1["outer_iterations"], i1["inner_iterations"]) == (
            i2["outer_iterations"], i2["inner_iterations"])
        assert float((u1 - u2).abs().max()) <= 1e-12 * float(u1.abs().max())
    finally:
        dist.destroy_process_group()


NO_CARD = [
    ("local_device", lambda: tsharding.local_device()),
    ("cli", lambda: tcli.main(2, ["--uniform", "2", "-n", "8", "--shards", "1"])),
    ("scaling", lambda: scaling.main(["--devices", "2", "-n", "2"])),
    ("backend_probes", lambda: one_card_backends.main([])),
]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal without a card")
@pytest.mark.parametrize("name, call", NO_CARD, ids=[n for n, _ in NO_CARD])
def test_sharded_entry_points_refuse_without_a_card(name, call):
    """The sharded entry points default to the card and raise without one;
    they never go on on the CPU unless the caller names it."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert not dist.is_initialized()


def test_scaling_script_runs_a_spawned_world(capsys):
    """``scripts.scaling`` spawns its world of two gloo ranks and prints
    the reference's keys for each engine, both by default (pjit, then
    halo); an unknown engine exits."""
    recs = scaling.main(["--devices", "2", "--divide", "0", "-n", "2", "--solve",
                         "--device", "cpu"])
    assert [r["comm"] for r in recs] == ["pjit", "halo"]
    for rec in recs:
        assert (rec["devices"], rec["backend"], rec["platform"]) == (2, "gloo", "cpu")
        assert rec["iterations"] >= 1 and rec["apply_ms"] > 0
    assert recs[0]["iterations"] == recs[1]["iterations"]
    assert recs[1]["cut_face_rows"] > 0 and "cut_face_rows" not in recs[0]
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines[-2:]] == recs
    with pytest.raises(SystemExit):
        scaling.main(["--comm", "mpi"])

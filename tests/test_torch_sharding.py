"""The port's patch sharding against the reference on the CPU: the Morton
partition, ``pad_level``, the permuted and padded interface tables and the
sharded hierarchy (``np.array_equal``), then the halo engine
(``parallel.halo``) at a world of 4 gloo ranks spawned once for the module
(``_torch_dist.level_battery``): its exchange and owned-gamma tables
against a reference ``ShardedLevel`` constructed on a 4-device mesh, and
every level, Schur, transfer and active-set op, gathered, against the
reference's single-device ``Level``/``Transfer``/``ActiveSmoother`` on the
same padded hierarchy at rtol = atol = 1e-12 (f64; the sharded ops take
the same arithmetic on each patch, only sums of cut-face contributions may
be taken in another order), as ``tests/test_sharding.py`` holds the
reference's own engine."""

import jax.numpy as jnp
import numpy as np
import pytest

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.iface as jiface
import pressurepoissonsolver_tpu.parallel.halo as jhalo
import pressurepoissonsolver_tpu.parallel.partition as jpart
import pressurepoissonsolver_tpu.parallel.sharding as jshard
from pressurepoissonsolver_tpu.gmg import Transfer as JTransfer
from pressurepoissonsolver_tpu.gmg import _expand_ring as j_expand_ring
from pressurepoissonsolver_tpu.gmg import _fac_active_mask as j_fac_active_mask
from pressurepoissonsolver_tpu.ops.level_ops import ActiveSmoother as JActive
from pressurepoissonsolver_tpu.ops.level_ops import Level as JLevel

import pressurepoissonsolver_torch.domain as tdomain
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.iface as tiface
import pressurepoissonsolver_torch.parallel.partition as tpart
import pressurepoissonsolver_torch.parallel.sharding as tshard
from pressurepoissonsolver_torch import native as tnative

from _torch_dist import World, field

WORLD = 4
TOL = dict(rtol=1e-12, atol=1e-12)
PL_FIELDS = ("ids", "starts", "spacings", "refine_level", "parent_id", "orth_on_parent",
             "neumann", "nbr_type", "nbr_slot", "coarse_orth", "fine_nbr_slots")
TABLE_FIELDS = ("iface_side_idx", "iface_side_mask", "contrib_patch", "contrib_side",
                "contrib_iface", "contrib_case", "case_w", "case_src")
# (D, base levels, corner levels) of the host-table trees
TREES = {"2d": (2, 4, 2), "3d": (3, 2, 1)}


def _assert_pl_equal(jpl, tpl):
    for name in PL_FIELDS:
        assert np.array_equal(getattr(jpl, name), getattr(tpl, name)), name
    assert jpl.real_patches == tpl.real_patches
    assert (jpl.D, jpl.n, jpl.tree_level) == (tpl.D, tpl.n, tpl.tree_level)


def _assert_tables_equal(jt, tt):
    for name in TABLE_FIELDS:
        assert np.array_equal(getattr(jt, name), getattr(tt, name)), name
    assert (jt.num_ifaces, jt.m, jt.face_depth) == (tt.num_ifaces, tt.m, tt.face_depth)


# -- host tables, no world ----------------------------------------------------


@pytest.mark.parametrize("key", sorted(TREES))
def test_partition_matches_reference(key):
    D, base, corner = TREES[key]
    jpl = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=4,
                                  use_native=False).finest
    tpl = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=4,
                                  use_native=False).finest
    assert np.array_equal(jpart.morton_keys(jpl), tpart.morton_keys(tpl))
    perm = tpart.morton_order(tpl)
    assert np.array_equal(jpart.morton_order(jpl), perm)
    _assert_pl_equal(jpart.reorder_level(jpl, perm), tpart.reorder_level(tpl, perm))
    for k in (2, 4, 8):
        shard = tpart.block_partition(tpl.num_patches, k)
        assert np.array_equal(jpart.block_partition(jpl.num_patches, k), shard)
        assert jpart.cut_faces(jpl, shard) == tpart.cut_faces(tpl, shard)
    # the Morton order cuts no more faces than the id order (the Zoltan
    # objective), as the reference's test holds its own
    k = 8
    morton = tpart.reorder_level(tpl, perm)
    assert (tpart.cut_faces(morton, tpart.block_partition(tpl.num_patches, k))
            <= tpart.cut_faces(tpl, tpart.block_partition(tpl.num_patches, k)))


@pytest.mark.parametrize("multiple", [3, 7, 16])
def test_pad_level_matches_reference(multiple):
    jpl = jdomain.DomainHierarchy(jgeo.refined_tree(2, 3, 1), n=4, use_native=False).finest
    tpl = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=4, use_native=False).finest
    jp, tp = jshard.pad_level(jpl, multiple), tshard.pad_level(tpl, multiple)
    assert tp.num_patches % multiple == 0 and tp.real_patches == tpl.num_patches
    _assert_pl_equal(jp, tp)


def test_permute_and_pad_tables_match_reference():
    D, base, corner = TREES["2d"]
    jpl = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=4,
                                  use_native=False).finest
    tpl = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=4,
                                  use_native=False).finest
    jt, tt = jiface.build_iface_tables(jpl), tiface.build_iface_tables(tpl)
    perm = tpart.morton_order(tpl)
    jt2 = jiface.pad_tables(jiface.permute_tables(jt, perm), tpl.num_patches + 5)
    tt2 = tiface.pad_tables(tiface.permute_tables(tt, perm), tpl.num_patches + 5)
    _assert_tables_equal(jt2, tt2)
    assert tiface.pad_tables(tt, tpl.num_patches) is tt


@pytest.mark.parametrize("builder", ["python", "native"])
@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_sharded_hierarchy_matches_reference(num_shards, builder):
    """Every level Morton-ordered and padded as the reference's; the
    native generator's tables, permuted and padded, equal the reference's
    tables permuted and padded by its own functions."""
    if builder == "native" and not tnative.available():
        pytest.skip("no g++ for the port's native table generator")
    D, base, corner = TREES["2d"]
    nm = ["x_lo", "y_hi"]
    jh = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=4, neumann=nm,
                                 use_native=False, num_shards=num_shards)
    th = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=4, neumann=nm,
                                 use_native=builder == "native", num_shards=num_shards)
    plain = tdomain.DomainHierarchy(tgeo.refined_tree(D, base, corner), n=4,
                                    neumann=nm, use_native=False)
    jplain = jdomain.DomainHierarchy(jgeo.refined_tree(D, base, corner), n=4,
                                     neumann=nm, use_native=False)
    assert th.builder == builder and th.num_shards == num_shards
    assert len(jh) == len(th)
    for k in range(len(jh)):
        _assert_pl_equal(jh[k], th[k])
        assert th[k].num_patches % num_shards == 0
        if builder == "native":
            perm = tpart.morton_order(plain[k])
            want = jiface.pad_tables(
                jiface.permute_tables(jiface.build_iface_tables(jplain[k]), perm),
                th[k].num_patches)
            _assert_tables_equal(want, th[k].prebuilt_iface_tables)
        else:
            assert th[k].prebuilt_iface_tables is None


def test_one_shard_hierarchy_is_the_plain_one():
    th = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=4, num_shards=1)
    plain = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=4)
    for a, b in zip(th.levels, plain.levels):
        _assert_pl_equal(a, b)
    with pytest.raises(ValueError):
        tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=4, partition="zoltan")


# -- the halo engine at a world of 4 -----------------------------------------


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The world of the level battery, started before the reference's side
    runs in this process."""
    w = World(WORLD, tmp_path_factory.mktemp("world"), "level")
    yield w
    w.close()


@pytest.fixture(scope="module")
def world(started, reference):
    """Rank 0's results of the level battery (each rank gathers them), and
    every rank's."""
    res = started.wait()
    return res[0], res


def _jh(key, neumann=False):
    tree = {"2d": jgeo.refined_tree(2, 3, 1), "3d": jgeo.refined_tree(3, 2, 1),
            "2d-deep": jgeo.refined_tree(2, 4, 2)}[key]
    return jdomain.DomainHierarchy(tree, n=4 if key == "3d" else 8, neumann=neumann,
                                   use_native=False, num_shards=WORLD)


@pytest.fixture(scope="module")
def reference(started):
    """The reference's single-device results on the batteries' inputs, and
    its sharded engine constructed (not run) on a 4-device mesh."""
    n = 8
    out = {}
    mesh = jshard.make_mesh(WORLD)
    for neumann in (False, True):
        key = "2d-neumann" if neumann else "2d"
        h = _jh("2d", neumann)
        lvl = JLevel(h.finest)
        P = lvl.P
        u, f = jnp.asarray(field(11, (P, n, n))), jnp.asarray(field(1, (P, n, n)))
        res = {"sl": jhalo.ShardedLevel(lvl, mesh),
               "apply": lvl.apply(u), "smooth": lvl.smooth(f, u),
               "smooth_zero": lvl.smooth_zero(f)}
        if not neumann:
            g = jnp.asarray(field(7, (lvl.num_ifaces, lvl.m)))
            res.update(interpolate=lvl.interpolate(u), patch_solve=lvl.patch_solve(f, g),
                       fold_gamma=lvl.fold_gamma(f, g), schur_S=lvl.schur_S(g),
                       halo_apply=lvl.apply(u), integrate=float(lvl.integrate(u)))
            coarse = JLevel(h[1])
            uf, uc = jnp.asarray(field(3, (P, n, n))), jnp.asarray(field(4, (coarse.P, n, n)))
            for mode in ("constant", "linear"):
                t = JTransfer(lvl, coarse, prolong_mode=mode)
                res[f"restrict_{mode}"] = t.restrict(uf)
                res[f"prolong_{mode}"] = t.prolong_add(uc, uf)
            res["st"] = jhalo.ShardedTransfer(t, res["sl"], jhalo.ShardedLevel(coarse, mesh))
        out[key] = res
    h3 = _jh("3d")
    l3 = JLevel(h3.finest)
    out["3d"] = {"apply": l3.apply(jnp.asarray(field(6, (l3.P, 4, 4, 4))))}
    h = _jh("2d-deep")
    fine, coarse = JLevel(h[0]), JLevel(h[1])
    mask = j_fac_active_mask(JTransfer(fine, coarse), 1)
    ring = j_expand_ring(h[1], mask, 1)
    f, u = field(8, (coarse.P, n, n)), field(9, (coarse.P, n, n))
    u0 = np.where(mask.reshape(-1, 1, 1), u, 0.0)
    out["active"] = {
        "mask": mask, "ring": ring,
        "smooth": JActive(coarse, mask).smooth(jnp.asarray(f), jnp.asarray(u)),
        "smooth_zero": JActive(coarse, mask).smooth_zero(jnp.asarray(f)),
        "apply_scattered": JActive(coarse, ring, build_solver=False).apply_scattered(
            jnp.asarray(u0))}
    return out


OPS = [("2d", op) for op in (
    "apply", "smooth", "smooth_zero", "interpolate", "patch_solve", "fold_gamma",
    "schur_S", "halo_apply", "restrict_constant", "prolong_constant",
    "restrict_linear", "prolong_linear")]
OPS += [("2d-neumann", op) for op in ("apply", "smooth", "smooth_zero")]
OPS += [("3d", "apply")] + [("active", op) for op in
                            ("smooth", "smooth_zero", "apply_scattered")]


@pytest.mark.parametrize("key, op", OPS, ids=[f"{k}-{o}" for k, o in OPS])
def test_sharded_op_matches_reference(world, reference, key, op):
    got = world[0][key][op]
    want = np.asarray(reference[key][op])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_every_rank_gathers_the_same_field(world):
    r0, ranks = world
    for r in ranks[1:]:
        for key, op in OPS:
            assert np.array_equal(r[key][op], r0[key][op]), (key, op)


def test_integrate_sums_over_the_ranks(world, reference):
    got, want = world[0]["2d"]["integrate"], reference["2d"]["integrate"]
    assert abs(got - want) <= 1e-12 * abs(want)


def test_dummy_patches_stay_zero(world):
    """With zero data on the padded patches, apply, both sweeps and the
    patch solves leave them exactly zero."""
    h = _jh("2d")
    assert h.finest.real_patches < h.finest.num_patches
    dummy = world[0]["2d"]["dummy"]
    assert dummy.shape[:2] == (h.finest.num_patches - h.finest.real_patches, 4)
    assert not np.any(dummy)


@pytest.mark.parametrize("key", ["2d", "2d-neumann"])
def test_each_rank_holds_a_share_of_the_level(world, key):
    """A rank's engine holds its rows and tables, not the global level's:
    each rank less than the level, the four ranks together less than 1.5
    times it (the exchange tables are the overhead)."""
    shares = [r[key]["bytes"] for r in world[1]]
    level = shares[0][1]
    assert all(own < level for own, _ in shares), shares
    assert sum(own for own, _ in shares) < 1.5 * level, shares


@pytest.mark.parametrize("key", ["2d", "2d-neumann"])
def test_exchange_tables_match_reference(world, reference, key):
    got = world[0][key]["tables"]
    sl = reference[key]["sl"]
    for name, ex in (("faces", sl.exchange), ("gamma", sl.ex_gamma)):
        g = got["exchange"][name]
        assert g["offsets"] == list(ex.offsets), name
        assert g["widths"] == list(ex.widths), name
        assert g["comm_rows"] == ex.comm_rows and g["buf_rows"] == ex.buf_rows, name
        assert len(g["send_tbl"]) == len(ex.send_tbl)
        for a, b in zip(g["send_tbl"], ex.send_tbl):
            assert np.array_equal(a, b), name
    assert got["owned_ids"] == sl._owned_ids
    assert (got["NOg"], got["NIg"], got["NRg"]) == (sl.NOg, sl.NIg, sl.NRg)
    for name in ("_own_pos", "_gifidx", "_ifidx", "_imask", "_gfsrc", "_gfw_own",
                 "_gfw_mix"):
        assert np.array_equal(got[name], np.asarray(getattr(sl, name))), name
    # one face row at most per directed cut face, as the reference asserts
    assert 0 < got["comm_rows"] <= world[0][key]["cuts"]


def test_transfer_tables_match_reference(world, reference):
    got = world[0]["2d"]["transfer_tables"]
    st = reference["2d"]["st"]
    assert got["comm_rows"] == st.comm_rows
    assert np.array_equal(got["child_src"], np.asarray(st._child_src))
    assert np.array_equal(got["pt_src"], np.asarray(st._pt_src))
    for name, ex in (("pool", st.ex_pool), ("full", st.ex_full), ("par", st.ex_par)):
        offsets, tbls = got[name]
        assert offsets == list(ex.offsets), name
        assert all(np.array_equal(a, b) for a, b in zip(tbls, ex.send_tbl)), name


def test_active_sets_match_reference(world, reference):
    got, want = world[0]["active"], reference["active"]
    assert np.array_equal(got["mask"], want["mask"])
    assert np.array_equal(got["ring"], want["ring"])
    assert 0 < got["mask"].sum() < len(got["mask"])

"""The port's native table generator (``pressurepoissonsolver_torch.native``,
its own copy of ``tablegen.cpp`` built with g++) against the reference's
pure-Python builders (``extract_level`` + ``build_iface_tables``): every
table equal, dtypes included, on the generated trees of
``tests/test_native.py``; and the hierarchy's choice of builder."""

import concurrent.futures
import filecmp
import os

import numpy as np
import pytest
import torch

import pressurepoissonsolver_tpu.domain as jdomain
import pressurepoissonsolver_tpu.geometry as jgeo
import pressurepoissonsolver_tpu.iface as jiface
from pressurepoissonsolver_torch import domain as tdomain
from pressurepoissonsolver_torch import geometry as tgeo
from pressurepoissonsolver_torch import native
from pressurepoissonsolver_torch.ops.level_ops import Level

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PL_FIELDS = ("D", "n", "tree_level", "ids", "starts", "spacings", "refine_level",
             "parent_id", "orth_on_parent", "neumann", "nbr_type", "nbr_slot",
             "coarse_orth", "fine_nbr_slots", "num_real")
IFACE_FIELDS = ("num_ifaces", "m", "iface_side_idx", "iface_side_mask",
                "contrib_patch", "contrib_side", "contrib_iface", "contrib_case",
                "case_w", "case_src", "face_depth")
# tests/test_native.py:22-24
TREES = {"uniform_2_3": (2, "uniform_tree", (2, 3)),
         "refined_2_3_2": (2, "refined_tree", (2, 3, 2)),
         "refined_3_2_1": (3, "refined_tree", (3, 2, 1))}
NEUMANN = [False, True, "per-side"]


@pytest.fixture
def need_gxx():
    """Decided inside the test: without g++ the port takes the Python
    builder (tested by the parity tests of the host tables)."""
    if not native.available():
        pytest.skip("g++ is not available: no native table generator")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _spec(neumann, D):
    return ("x_lo", "y_hi", "z_lo")[:D] if neumann == "per-side" else neumann


@pytest.mark.parametrize("neumann", NEUMANN, ids=str)
@pytest.mark.parametrize("tree", list(TREES))
def test_native_tables_match_reference_python_builder(need_gxx, tree, neumann):
    D, maker, args = TREES[tree]
    spec = _spec(neumann, D)
    th = tdomain.DomainHierarchy(getattr(tgeo, maker)(*args), n=4, neumann=spec)
    assert th.builder == "native"
    jtree = getattr(jgeo, maker)(*args)
    nm = jdomain.normalize_neumann(spec, D)
    for k, lvl_no in enumerate(range(jtree.num_levels - 1, -1, -1)):
        ref_pl = jdomain.extract_level(jtree, lvl_no, 4, nm)
        ref_t = jiface.build_iface_tables(ref_pl)
        pl, t = th.levels[k], th.iface_tables[k]
        assert pl.prebuilt_iface_tables is t
        for name in PL_FIELDS:
            assert _same(getattr(ref_pl, name), getattr(pl, name)), (k, name)
        for name in IFACE_FIELDS:
            assert _same(getattr(ref_t, name), getattr(t, name)), (k, name)


@pytest.mark.parametrize("D", [2, 3])
def test_native_and_python_hierarchies_give_the_same_apply(need_gxx, D):
    tree = tgeo.refined_tree(D, 3, 2 if D == 2 else 1)
    hn = tdomain.DomainHierarchy(tree, n=4, neumann=("x_lo",))
    hp = tdomain.DomainHierarchy(tree, n=4, neumann=("x_lo",), use_native=False)
    assert (hn.builder, hp.builder) == ("native", "python")
    assert hp.iface_tables == [None] * len(hp.levels)
    ln = Level(hn.finest, torch.float64, device="cpu")
    lp = Level(hp.finest, torch.float64, device="cpu")
    assert ln.tables is hn.iface_tables[0]
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (hn.finest.num_patches,) + (4,) * D))
    a, b = ln.apply(u), lp.apply(u)
    assert torch.allclose(a, b, rtol=1e-13, atol=0)
    assert torch.equal(ln.interpolate(u), lp.interpolate(u))


def test_callable_neumann_takes_the_python_builder():
    tree = tgeo.refined_tree(2, 3, 1)
    h = tdomain.DomainHierarchy(tree, n=4, neumann=lambda s, starts, lengths: s == 0)
    assert h.builder == "python" and h.finest.neumann[:, 0].any()


def test_quadratic_level_rebuilds_its_tables(need_gxx):
    """The native tables are bilinear; a quadratic level builds its own."""
    h = tdomain.DomainHierarchy(tgeo.refined_tree(2, 3, 1), n=4)
    lvl = Level(h.finest, torch.float64, device="cpu", iface_scheme="quadratic")
    assert lvl.tables is not h.iface_tables[0] and lvl.face_depth == 2


def test_tablegen_source_is_the_reference_copy():
    assert filecmp.cmp(os.path.join(REPO, "pressurepoissonsolver_tpu/native/tablegen.cpp"),
                       str(native.SOURCE), shallow=False)


def test_concurrent_builds_leave_one_loadable_library(need_gxx, monkeypatch, tmp_path):
    """Builds racing into an empty build directory (xdist workers, several
    processes) each write a temporary file and rename it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        paths = [f.result(timeout=300) for f in [pool.submit(native._build) for _ in range(4)]]
    assert len(set(paths)) == 1 and paths[0].exists()
    assert os.listdir(tmp_path / "native") == [paths[0].name]
    import ctypes

    assert ctypes.CDLL(str(paths[0])).pps_num_patches is not None

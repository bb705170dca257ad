"""The per-side trace kernel's tables (``ops.traces``) on the CPU.

The kernel (``csrc/traces.cu``) runs only on a card
(``tests/test_torch_cuda.py``).  Here a numpy evaluator of its loop, local
to this file and driven by the int32 tables and the palette that ``Level``
and ``ActiveSmoother`` hand the kernel, is held to the three plain chains it
replaces: ``Level._gf_parts``' ``w_mix * mix`` (the apply),
``Level._gf_faces`` (the sweep) and ``ActiveSmoother._gamma_faces`` on the
smoother's and the residual's active sets of a FAC cycle, on graded 2D
meshes with refinement sides, Dirichlet, Neumann and mixed walls, the
bilinear and the quadratic closures (face depth 1 and 2), f32 and f64: f64
bit for bit on every row without a case template (the direct sides and the
scalar-only interfaces) and within two units of the last place where the
plain chain sums a template's taps in a BLAS matmul, f32 within rounding of
max|gf|.  A second build gives equal
tables; the palette holds every template's nonzeros; the CPU, 3D levels and
the shapes the kernel does not take keep the plain chain and count nothing;
the wrapper refuses a dtype, device or shape other than its tables'."""

import functools

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.gmg import CycleOpts, build_gmg
from pressurepoissonsolver_torch.ops import level_ops, traces
from pressurepoissonsolver_torch.ops.level_ops import Level

DTYPES = {"f32": torch.float32, "f64": torch.float64}
WALLS = {"dirichlet": False, "neumann": True, "mixed": ["x_lo", "y_hi"]}
# (tree, n): a 4-level graded mesh whose two finest levels have refinement
# sides, and a 3-level one at n = 4 (the smallest vector of an f32 row)
MESHES = {"graded": ((2, 4, 2), 8), "small": ((2, 3, 1), 4)}
LEVELS = 6  # refined_tree(2, 4, 2)'s hierarchy at n = 8


@functools.lru_cache(maxsize=None)
def _hierarchy(mesh, walls):
    tree, n = MESHES[mesh]
    return DomainHierarchy(refined_tree(*tree), n=n, neumann=WALLS[walls])


def _with_tables(fn):
    """``fn()`` with ``traces.kernel_fits`` true on the CPU, so that the
    levels build the kernel's tables as they do on a card."""
    mp = pytest.MonkeyPatch()
    mp.setattr(traces, "kernel_fits", lambda *a: True)
    try:
        return fn()
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _level(mesh, walls, k, dt, scheme):
    return _with_tables(lambda: Level(_hierarchy(mesh, walls)[k], dtype=DTYPES[dt],
                                      device="cpu", iface_scheme=scheme))


@functools.lru_cache(maxsize=None)
def _cycle(walls, dt):
    return _with_tables(lambda: build_gmg(
        _hierarchy("graded", walls), CycleOpts(fac_smoothing="active"), dtype=DTYPES[dt],
        device="cpu"))


def _field(P, n, dt, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((P, n, n)), dtype=DTYPES[dt])


# -- a numpy evaluator of the kernel's loop ----------------------------------------

def faces_np(x, depth):
    """The face rows of every patch of ``x`` ``[P, n, n]``, ``[P, 4 *
    depth, n]`` in the order ``side * depth + d``: the x-low and x-high
    columns, the y-low and y-high rows, ``d`` cells inward."""
    n = x.shape[-1]
    rows = []
    for side in range(4):
        for d in range(depth):
            line = n - 1 - d if side & 1 else d
            rows.append(x[:, :, line] if side < 2 else x[:, line, :])
    return np.stack(rows, axis=1)


def evaluate(tables, u):
    """What ``pps_traces`` computes from ``tables``: per output row, its
    scalar entries' products summed in table order plus its template
    entries' values (each the sum of its taps' products, ascending), summed
    in table order, every product and sum rounded in the field's dtype."""
    pal = tables.pal
    x = u.numpy()
    dt, n = x.dtype, pal.n
    cw, tw, ti = pal.cw.numpy().astype(dt), pal.tw.numpy().astype(dt), pal.ti.numpy()
    rowptr = tables.rowptr.numpy().astype(np.int64)
    ent = tables.ent.numpy().astype(np.int64)
    src, case, tmpl = ent >> 5, (ent >> 1) & 15, (ent & 1).astype(bool)
    F = faces_np(x, pal.depth).reshape(-1, n)[src]  # [E, n]
    scalar = cw[case][:, None] * F
    template = np.zeros_like(F)
    for t in range(tw.shape[2]):
        template = template + tw[case, :, t] * np.take_along_axis(F, ti[case, :, t], axis=1)
    R = tables.patches * 4
    count = np.diff(rowptr)
    row_of = np.repeat(np.arange(R), count)
    pos = np.arange(len(ent)) - rowptr[row_of]
    sc, tm = np.zeros((R, n), dt), np.zeros((R, n), dt)
    for k in range(int(count.max(initial=0))):
        at = pos == k
        sc[row_of[at & ~tmpl]] += scalar[at & ~tmpl]
        tm[row_of[at & tmpl]] += template[at & tmpl]
    return torch.as_tensor((sc + tm).reshape(tables.patches, 4, n))


def _template_rows(tables):
    """The output rows ``[patches, 4]`` with a template entry."""
    rowptr, ent = tables.rowptr.numpy(), tables.ent.numpy()
    R = tables.patches * 4
    hit = np.bincount(np.repeat(np.arange(R), np.diff(rowptr))[(ent & 1) == 1], minlength=R)
    return torch.as_tensor(hit.reshape(tables.patches, 4) > 0)


def _check(dt, ref, got, tables):
    """f64: bit for bit on the rows without a template entry, and within two
    units of the last place of max|gf| on the others, whose plain chain
    sums each template's taps in a BLAS matmul (with fused multiply-adds
    where the kernel rounds every product); f32: within rounding."""
    scale = float(ref.abs().max()) or 1.0
    err = float((ref - got).abs().max())
    if dt == "f64":
        plain = ~_template_rows(tables)
        assert torch.equal(ref[plain], got[plain])
        assert err <= 2 * 2.0 ** -52 * scale
    else:
        assert err <= 4e-7 * scale


# -- the tables against the plain chains --------------------------------------------

@pytest.mark.parametrize("k", range(LEVELS))
@pytest.mark.parametrize("scheme", ["bilinear", "quadratic"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("walls", list(WALLS))
def test_level_tables_give_the_plain_traces(walls, dt, scheme, k):
    """On every level: the apply's tables give ``Level._gf_parts``' ``w_mix *
    mix`` and the sweep's ``Level._gf_faces``."""
    lvl = _level("graded", walls, k, dt, scheme)
    assert lvl._trace_apply is not None and lvl._trace_sweep is not None
    assert lvl._trace_pal.depth == lvl.face_depth == (2 if scheme == "quadratic" else 1)
    u = _field(lvl.P, lvl.n, dt, k)
    _check(dt, lvl._gf_parts(u)[0], evaluate(lvl._trace_apply, u), lvl._trace_apply)
    _check(dt, lvl._gf_faces(u), evaluate(lvl._trace_sweep, u), lvl._trace_sweep)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("walls", list(WALLS))
def test_small_patch_tables_give_the_plain_traces(walls, dt):
    """At n = 4, one f32 vector a row, on every level."""
    for k in range(len(_hierarchy("small", walls))):
        lvl = _level("small", walls, k, dt, "bilinear")
        u = _field(lvl.P, lvl.n, dt, k)
        _check(dt, lvl._gf_parts(u)[0], evaluate(lvl._trace_apply, u), lvl._trace_apply)
        _check(dt, lvl._gf_faces(u), evaluate(lvl._trace_sweep, u), lvl._trace_sweep)


@pytest.mark.parametrize("which", ["_asmooth", "_aapply"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("walls", list(WALLS))
def test_active_tables_give_the_plain_traces(walls, dt, which):
    """On the FAC cycle's active sets, the smoother's and the residual's:
    ``ActiveSmoother._gamma_faces`` from the whole field."""
    cyc = _cycle(walls, dt)
    smoothers = [s for s in getattr(cyc, which) if s is not None]
    assert smoothers and any(s.Pa < s.level.P for s in smoothers)
    for i, sm in enumerate(smoothers):
        assert (sm._trace is not None) == (sm.num_sub_ifaces > 0)
        if sm._trace is None:
            continue
        u = _field(sm.level.P, sm.n, dt, 10 + i)
        _check(dt, sm._gamma_faces(u), evaluate(sm._trace, u), sm._trace)


def test_direct_sides_are_one_entry_in_the_apply_and_two_in_the_sweep():
    """A direct side reads its neighbour's boundary row (apply) or its own
    and its neighbour's (sweep), each a scalar entry of weight 1/2; the
    tables' other rows are the same in both."""
    lvl = _level("graded", "dirichlet", 0, "f64", "bilinear")
    direct = (lvl._gf_w_own_np[:, :, 0] == 0.5).reshape(-1)
    assert direct.any() and not direct.all()
    ca = np.diff(lvl._trace_apply.rowptr.numpy())
    cs = np.diff(lvl._trace_sweep.rowptr.numpy())
    assert np.all(ca[direct] == 1) and np.all(cs[direct] == 2)
    assert np.array_equal(ca[~direct], cs[~direct])
    ent = lvl._trace_apply.ent.numpy()[lvl._trace_apply.rowptr.numpy()[:-1][direct]]
    assert not np.any(ent & 1)
    assert np.all(lvl._trace_pal.cw.numpy()[(ent >> 1) & 15] == 0.5)


@pytest.mark.parametrize("scheme", ["bilinear", "quadratic"])
def test_tables_are_the_same_in_a_second_build(scheme):
    for k in range(LEVELS):
        a = _level("graded", "mixed", k, "f64", scheme)
        b = _with_tables(lambda: Level(a.pl, dtype=torch.float64, device="cpu",
                                       iface_scheme=scheme))
        for x, y in ((a._trace_apply, b._trace_apply), (a._trace_sweep, b._trace_sweep)):
            for name in ("rowptr", "ent"):
                assert np.array_equal(getattr(x, name).numpy(), getattr(y, name).numpy())
        for name in ("cw", "tw", "ti"):
            assert np.array_equal(getattr(a._trace_pal, name).numpy(),
                                  getattr(b._trace_pal, name).numpy())
    cyc = _cycle("mixed", "f64")
    again = _with_tables(lambda: build_gmg(_hierarchy("graded", "mixed"),
                                           CycleOpts(fac_smoothing="active"),
                                           dtype=torch.float64, device="cpu"))
    for sa, sb in zip(cyc._asmooth + cyc._aapply, again._asmooth + again._aapply):
        if sa is not None and sa._trace is not None:
            for name in ("rowptr", "ent"):
                assert np.array_equal(getattr(sa._trace, name).numpy(),
                                      getattr(sb._trace, name).numpy())


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("scheme", ["bilinear", "quadratic"])
def test_palette_holds_every_template(scheme, dt):
    """The taps give back each template case's dense matrix (in the level's
    dtype), the scalar cases their weight, and ``kt`` is the most nonzeros
    of a row."""
    lvl = _level("graded", "dirichlet", 0, dt, scheme)
    pal = lvl._trace_pal
    npdt = level_ops.np_dtype(DTYPES[dt])
    tw, ti = pal.tw.numpy(), pal.ti.numpy()
    ncase, n, kt = tw.shape
    for c in range(ncase):
        T = lvl._case_T[c].astype(npdt).astype(np.float64)
        if pal.template[c]:
            dense = np.zeros((n, n))
            np.add.at(dense, (np.repeat(np.arange(n), kt), ti[c].reshape(-1)),
                      tw[c].reshape(-1))
            assert np.array_equal(dense, T)
        else:
            assert pal.cw.numpy()[c] == T[0, 0] and not tw[c].any()
    assert kt == int(((lvl._case_T != 0) & pal.template[:, None, None]).sum(axis=2).max())


def test_cpu_and_3d_keep_the_plain_chain_and_count_nothing():
    """Without a card no level builds the tables, and the builds it runs are
    the plain chain's, not counted (the counters count on a card only)."""
    lvl = Level(_hierarchy("graded", "dirichlet")[0], dtype=torch.float32, device="cpu")
    assert lvl._trace_apply is None and lvl._trace_sweep is None
    before = traces.builds()
    u = _field(lvl.P, lvl.n, "f32", 0)
    assert torch.equal(lvl._apply_traces(u), lvl._gf_parts(u)[0])
    assert torch.equal(lvl._sweep_traces(u), lvl._gf_faces(u))
    assert traces.builds() == before
    assert not traces.kernel_fits(3, 8, 1, 7, 100, "cuda")
    assert not traces.kernel_fits(2, 8, 1, 7, 100, "cpu")
    assert traces.kernel_fits(2, 16, 1, 7, 133_120, "cuda")
    assert not traces.kernel_fits(2, 16, 3, 7, 100, "cuda")
    assert not traces.kernel_fits(2, 16, 1, 17, 100, "cuda")
    assert not traces.kernel_fits(2, 16, 2, 7, 1 << 23, "cuda")


@pytest.mark.parametrize("n, taps, fits", [(1024, 2, False), (32, 4, True), (32, 5, False)])
def test_palette_over_the_kernel_is_refused(n, taps, fits):
    """A palette over the kernel's shared memory, or a template with more
    than 4 nonzeros in a row, has no palette (the level keeps the plain
    chain)."""
    T = np.zeros((16, n, n))
    for t in range(taps):
        T[:, np.arange(n - t), np.arange(t, n)] = 1.0 + t
    assert (traces.palette(T, [None] * 16, torch.float64, 1, "cpu") is not None) == fits


def test_build_refuses_another_dtype_device_or_shape():
    lvl = _level("graded", "dirichlet", 0, "f32", "bilinear")
    tab, n = lvl._trace_apply, lvl.n
    with pytest.raises(TypeError):
        traces.build(tab, torch.zeros(lvl.P, n, n, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        traces.build(tab, torch.zeros(lvl.P, n, n, device="meta"))
    with pytest.raises(ValueError):
        traces.build(tab, torch.zeros(lvl.P - 1, n, n))
    with pytest.raises(ValueError):
        traces.build(tab, torch.zeros(lvl.P, n, n + 1))

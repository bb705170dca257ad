"""The grid transfers' kernel entry (``ops.transfer``) on the CPU.

The kernel (``csrc/transfer.cu``) runs only on a card
(``tests/test_torch_cuda.py``).  Here a torch model of its per-slot loop,
driven by the int32 tables ``gmg.Transfer`` hands the kernel, is held to
the plain chain (``Transfer.restrict_plain`` / ``prolong_add_plain``) on 2D
hierarchies whose transfers have parent rows on the parent-compact path and
off it, pass-through rows and padded rows, at n = 8, 16, 32, both
prolongation modes and both dtypes: f64 within 1e-14 and f32 within 1e-6 of
max|out|, the constant prolong-add bit for bit.  The tables hold the
invariant the kernel relies on (each coarse slot is a parent, a pass-through
slot or padding, and the two tables name the same pairs); the CPU, 3D and
other n take the plain chain and count nothing; the wrapper refuses a
dtype, device or shape other than its tables'."""

import functools

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch import gmg
from pressurepoissonsolver_torch.domain import DomainHierarchy, parent_slots
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.ops import transfer
from pressurepoissonsolver_torch.ops.level_ops import Level
from pressurepoissonsolver_torch.parallel.sharding import pad_level
from pressurepoissonsolver_torch.utils import counters

DTYPES = {"f32": torch.float32, "f64": torch.float64}
RTOL = {"f32": 1e-6, "f64": 1e-14}
# (tree, pad multiple): refined_tree(2, 5, 2) has transfers on the
# parent-compact path (T0, T1: 259 and 256 coarse slots, one parent each),
# refined_tree(2, 4, 2) pass-through rows off it, and the padded levels of
# the latter padded dummy slots on both sides (each level padded to a
# multiple of 8)
MESHES = {"compact": ((2, 5, 2), 0), "passthrough": ((2, 4, 2), 0),
          "padded": ((2, 4, 2), 8)}


@functools.lru_cache(maxsize=None)
def _levels(mesh, n, dt):
    tree, pad = MESHES[mesh]
    h = DomainHierarchy(refined_tree(*tree), n=n)
    pls = [pad_level(pl, pad) if pad else pl for pl in h.levels]
    return [Level(pl, dtype=DTYPES[dt], device="cpu") for pl in pls]


def _transfers(monkeypatch, mesh, n, dt, mode):
    """Every transfer of the mesh, each with the kernel's tables built on
    the CPU (as ``Transfer.__init__`` builds them on a card)."""
    monkeypatch.setattr(transfer, "kernel_fits", lambda *a: True)
    lv = _levels(mesh, n, dt)
    out = [gmg.Transfer(lv[k], lv[k + 1], prolong_mode=mode) for k in range(len(lv) - 1)]
    assert all(t._kt is not None for t in out)
    return out


def _fields(t, seed):
    rng = np.random.default_rng(seed)
    dt, n = t.fine.dtype, t.n
    return [torch.as_tensor(rng.standard_normal((P, n, n)), dtype=dt)
            for P in (t.fine.P, t.coarse.P, t.fine.P)]


# -- a torch model of the kernel's per-slot loop ----------------------------------

def restrict_model(tables, fine):
    """What ``pps_transfer_restrict`` computes from ``tables``: per coarse
    slot and orthant, the 2 x 2 average of the orthant's child, ((a + b) +
    (c + d)) / 4, or, without a child, the slot's pass-through patch, or
    0."""
    rtab = tables.rtab.long()
    n, h = tables.n, tables.n // 2
    out = fine.new_zeros((rtab.shape[0], n, n))
    pt = rtab[:, 4]
    for o in range(4):
        ys, xs = slice((o >> 1) * h, ((o >> 1) + 1) * h), slice((o & 1) * h, ((o & 1) + 1) * h)
        child = rtab[:, o]
        sel = child >= 0
        f = fine[child[sel]]
        a, b, c, d = f[:, 0::2, 0::2], f[:, 0::2, 1::2], f[:, 1::2, 0::2], f[:, 1::2, 1::2]
        blk = out[:, ys, xs]
        blk[sel] = 0.25 * ((a + b) + (c + d))
        copy = ~sel & (pt >= 0)
        blk[copy] = fine[pt[copy]][:, ys, xs]
    return out


def _taps(n, half):
    """Per fine cell of an axis in the half ``half``: the parent cells c
    and o and their weights (``_linear_prolong_matrix``'s)."""
    i = np.arange(n)
    c = half * (n // 2) + i // 2
    d = np.where(i % 2 == 1, 1, -1)
    inside = (c + d >= 0) & (c + d < n)
    o = np.where(inside, c + d, c - d)
    wc, wo = np.where(inside, 0.75, 1.25), np.where(inside, 0.25, -0.25)
    return c, o, wc, wo


def prolong_model(tables, coarse, u):
    """What ``pps_transfer_prolong_add`` computes from ``tables``: ``u``
    plus, per fine slot, the parent's orthant block injected or
    interpolated (x first, then y), the whole parent patch (a pass-through
    slot) or nothing (a padded slot)."""
    ptab = tables.ptab.long()
    n = tables.n
    parent, orth = ptab[:, 0], ptab[:, 1]
    add = torch.zeros_like(u)
    pt = (parent >= 0) & (orth < 0)
    add[pt] = coarse[parent[pt]]
    for o in range(4):
        hy, hx = o >> 1, o & 1
        sel = (parent >= 0) & (orth == o)
        p = coarse[parent[sel]]
        if not tables.linear:
            iy = torch.as_tensor((np.arange(n) + hy * n) // 2)
            ix = torch.as_tensor((np.arange(n) + hx * n) // 2)
            add[sel] = p[:, iy][:, :, ix]
            continue
        cx, ox, wcx, wox = _taps(n, hx)
        cy, oy, wcy, woy = _taps(n, hy)
        w = functools.partial(torch.as_tensor, dtype=u.dtype)
        t = w(wcx) * p[:, :, cx] + w(wox) * p[:, :, ox]
        add[sel] = w(wcy)[:, None] * t[:, cy, :] + w(woy)[:, None] * t[:, oy, :]
    return u + add


def _rel(ref, got):
    return float((ref.double() - got.double()).abs().max() / ref.double().abs().max())


@pytest.mark.parametrize("mode", ["constant", "linear"])
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernel_model_equals_the_plain_chain(monkeypatch, dt, mesh, n, mode):
    """On every transfer of the mesh the model of the kernel's loop, on the
    tables the kernel is given, equals the plain restriction and
    prolong-add: within 1e-14 (f64) / 1e-6 (f32) of max|out|, the constant
    prolong-add bit for bit."""
    kinds = set()
    for k, t in enumerate(_transfers(monkeypatch, mesh, n, dt, mode)):
        fine, coarse, u = _fields(t, 100 * n + k)
        kinds.add(t._r_inv is not None)
        ref = t.restrict(fine)
        got = restrict_model(t._kt, fine)
        assert got.dtype == ref.dtype and _rel(ref, got) <= RTOL[dt], k
        ref = t.prolong_add(coarse, u)
        got = prolong_model(t._kt, coarse, u)
        if mode == "constant":
            assert torch.equal(got, ref), k
        else:
            assert _rel(ref, got) <= RTOL[dt], k
    assert kinds == ({True, False} if mesh == "compact" else {False})


def _slot_loop(t):
    """The restriction's slot arrays as the per-slot loop built them."""
    Pf, Pc = t.fine.P, t.coarse.P
    pslots = parent_slots(t.fine.pl, t.coarse.pl)
    orth = t.fine.pl.orth_on_parent
    child_slot = np.full((Pc, 4), Pf, dtype=np.int64)
    pt_slot = np.full(Pc, Pf, dtype=np.int64)
    for i in range(Pf):
        ps = pslots[i]
        if ps < 0:
            continue
        if orth[i] < 0:
            pt_slot[ps] = i
        else:
            child_slot[ps, orth[i]] = i
    return child_slot, pt_slot, pslots


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tables_hold_the_kernels_invariant(monkeypatch, mesh):
    """Each coarse slot of ``rtab`` is exactly one of a parent, a
    pass-through slot or padding; ``rtab`` and ``ptab`` name the same
    (coarse slot, orthant or pass-through, fine slot) triples, each fine
    slot at most once; both are int32 and equal the per-slot loop that
    built the plain chain's tables."""
    seen = set()
    for t in _transfers(monkeypatch, mesh, 8, "f64", "constant"):
        rtab, ptab = t._kt.rtab.numpy(), t._kt.ptab.numpy()
        assert rtab.dtype == ptab.dtype == np.int32
        Pf, Pc = t.fine.P, t.coarse.P
        assert rtab.shape == (Pc, 5) and ptab.shape == (Pf, 2)
        parent = (rtab[:, :4] >= 0).any(axis=1)
        passes = rtab[:, 4] >= 0
        assert not (parent & passes).any()
        seen |= {("parent", bool(parent.any())), ("pass", bool(passes.any())),
                 ("pad", bool((~parent & ~passes).any()))}
        named = rtab[rtab >= 0]
        assert len(np.unique(named)) == len(named)
        from_rtab = {(int(c), int(o), int(rtab[c, o])) for c, o in zip(*np.nonzero(rtab >= 0))}
        from_ptab = {(int(p), int(o) if o >= 0 else 4, i)
                     for i, (p, o) in enumerate(ptab) if p >= 0}
        assert from_rtab == from_ptab
        child_slot, pt_slot, pslots = _slot_loop(t)
        want = np.concatenate([child_slot, pt_slot[:, None]], axis=1)
        assert np.array_equal(rtab, np.where(want < Pf, want, -1))
        assert np.array_equal(ptab[:, 0], pslots)
        assert np.array_equal(t._pt_slot.numpy(), pt_slot)
    assert ("pass", True) in seen and ("parent", True) in seen
    assert (("pad", True) in seen) == (mesh == "padded")


def test_cpu_and_3d_take_the_plain_chain_and_count_nothing():
    """Off the card no transfer has the kernel's tables and none is
    counted; the kernel fits 2D transfers on a card at n a multiple of 4 in
    f32 or f64 only."""
    counters.reset()
    for D, tree in ((2, (2, 4, 2)), (3, (3, 2, 1))):
        h = DomainHierarchy(refined_tree(*tree), n=8)
        lv = [Level(pl, dtype=torch.float64, device="cpu") for pl in h.levels[:2]]
        t = gmg.Transfer(lv[0], lv[1])
        assert t._kt is None
        fine = torch.randn((lv[0].P,) + (8,) * D, dtype=torch.float64)
        coarse = torch.randn((lv[1].P,) + (8,) * D, dtype=torch.float64)
        assert torch.equal(t.restrict(fine), t.restrict_plain(fine))
        assert torch.equal(t.prolong_add(coarse, fine), t.prolong_add_plain(coarse, fine))
    assert transfer.transfers() == {"kernel": {"float32": 0, "float64": 0},
                                    "plain": {"float32": 0, "float64": 0}}
    assert transfer.kernel_fits(2, 16, torch.float32, "cuda")
    assert transfer.kernel_fits(2, 12, torch.float64, "cuda:0")
    for args in ((3, 16, torch.float32, "cuda"), (2, 6, torch.float32, "cuda"),
                 (2, 16, torch.bfloat16, "cuda"), (2, 16, torch.float32, "cpu")):
        assert not transfer.kernel_fits(*args)


def test_the_counters_are_accounted_with_the_graphs():
    """A captured transfer is counted once per replay: the counters are
    tables of ``utils.counters``, which ``utils.graphs`` accounts for by
    name."""
    assert counters.table("transfer.kernel", ("float32", "float64")) is transfer.launches
    assert counters.table("transfer.plain", ("float32", "float64")) is transfer.plain
    counters.reset()
    counters.add({"transfer.kernel": {"float64": 2}, "transfer.plain": {"float32": 1}}, 3)
    assert transfer.transfers() == {"kernel": {"float32": 0, "float64": 6},
                                    "plain": {"float32": 3, "float64": 0}}
    counters.reset()


def test_the_wrapper_refuses_another_dtype_or_shape(monkeypatch):
    """Before any launch, a field of another dtype than f32 / f64, two
    fields of different dtypes, or a shape other than the tables' raise."""
    t = _transfers(monkeypatch, "passthrough", 8, "f32", "constant")[0]
    fine, coarse, u = _fields(t, 3)
    with pytest.raises(TypeError):
        transfer.restrict(t._kt, fine.to(torch.bfloat16))
    with pytest.raises(TypeError):
        transfer.prolong_add(t._kt, coarse.double(), u)
    with pytest.raises(ValueError):
        transfer.restrict(t._kt, fine[1:])
    with pytest.raises(ValueError):
        transfer.prolong_add(t._kt, coarse, u.reshape(u.shape[0], -1))
    with pytest.raises(ValueError):
        transfer.prolong_add(t._kt, coarse[:, :4], u)

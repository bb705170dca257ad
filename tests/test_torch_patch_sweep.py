"""The block-Jacobi sweep's entry (``ops.patch_sweep``) on the CPU.

Its plain version is the chain the sweep was before the CUDA kernel
(``_fold_faces_flat`` → ``_spectral_apply`` → the active set's routing),
bit for bit, on every level in f32 and f64, full and active sweeps; the
CPU, 3D levels and n = 64 take it and count nothing; the kernel's tables
rebuild the solver's BC groups from the per-slot codes and its
denominators (an f64 sum, cast afterwards) equal ``_denom_of`` bit for bit.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``)."""

import functools

import numpy as np
import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.ops import patch_sweep
from pressurepoissonsolver_torch.ops import transforms as tr
from pressurepoissonsolver_torch.ops.level_ops import (ActiveSmoother, Level,
                                                       _build_solver_tables, _denom_of)
from pressurepoissonsolver_torch.ops.patch_sweep import _fold_faces_flat, _spectral_apply

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# wall sets: Dirichlet, all Neumann (the coarsest patch pinned), and two
# mixed sets (DCT-IV / DST-IV axes, and an x axis Neumann at both ends)
WALLS = {"dirichlet": False, "neumann": True, "mixed": ["x_lo", "y_hi"],
         "mixed-x": ["x_lo", "x_hi", "y_hi"]}


@functools.lru_cache(maxsize=None)
def _hierarchy(walls, D=2, n=8):
    tree = refined_tree(D, 3, 1) if D == 2 else refined_tree(D, 2, 1)
    return DomainHierarchy(tree, n=n, neumann=WALLS[walls])


@functools.lru_cache(maxsize=None)
def _level(walls, k, dt):
    return Level(_hierarchy(walls)[k], dtype=DTYPES[dt], device="cpu")


def _fields(lvl, seed, count=2):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((lvl.P,) + (lvl.n,) * lvl.D),
                            dtype=lvl.dtype) for _ in range(count)]


def _mask(P, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(P) < 0.4
    mask[rng.integers(P)] = True
    return mask


def _chain_full(lvl, f, u):
    """The sweep of a level as the chain it was."""
    fc = f if u is None else _fold_faces_flat(f, lvl._gf_faces(u), lvl.h2inv, lvl.D, lvl.n)
    return _spectral_apply(lvl._st, fc, lvl.D, lvl.n)


def _chain_active(sm, f, u):
    """The sweep of an active set as the chain it was: the active rows of
    f, the fold, the solves, then routed back over ``u`` (or zero)."""
    fa = f.index_select(0, sm._act)
    if u is not None and sm.num_sub_ifaces:
        fa = _fold_faces_flat(fa, sm._gamma_faces(u), sm._h2inv_act, sm.D, sm.n)
    sol = _spectral_apply(sm._st, fa, sm.D, sm.n)
    inv, mask = sm._route.inv, sm._route.mask
    routed = torch.cat([sol, sol.new_zeros((1,) + sol.shape[1:])]).index_select(0, inv)
    return routed if u is None else torch.where(mask, routed, u)


@pytest.mark.parametrize("walls", list(WALLS))
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_plain_sweep_is_the_old_chain_bit_for_bit(dt, k, walls):
    """``Level.smooth`` / ``smooth_zero`` and ``ActiveSmoother.smooth`` /
    ``smooth_zero`` on the CPU give what the fold, the spectral solves and
    the routing gave, bit for bit, and count no sweep."""
    lvl = _level(walls, k, dt)
    f, u = _fields(lvl, 10 * k + len(walls))
    before = patch_sweep.sweeps()
    assert torch.equal(lvl.smooth(f, u), _chain_full(lvl, f, u))
    assert torch.equal(lvl.smooth_zero(f), _chain_full(lvl, f, None))
    sm = ActiveSmoother(lvl, _mask(lvl.P, k))
    assert torch.equal(sm.smooth(f, u), _chain_active(sm, f, u))
    assert torch.equal(sm.smooth_zero(f), _chain_active(sm, f, None))
    assert patch_sweep.sweeps() == before


@pytest.mark.parametrize("dt", list(DTYPES))
def test_active_sweeps_of_no_slot_and_of_every_slot(dt):
    """An empty active set keeps ``u`` (zero from a zero iterate); one
    that holds every slot is the level's own sweep."""
    lvl = _level("mixed", 0, dt)
    f, u = _fields(lvl, 3)
    none = ActiveSmoother(lvl, np.zeros(lvl.P, dtype=bool))
    assert none.Pa == 0 and not none._st.groups
    assert torch.equal(none.smooth(f, u), u)
    assert torch.equal(none.smooth_zero(f), torch.zeros_like(f))
    every = ActiveSmoother(lvl, np.ones(lvl.P, dtype=bool))
    assert torch.equal(every.smooth(f, u), lvl.smooth(f, u))
    assert torch.equal(every.smooth_zero(f), lvl.smooth_zero(f))


def test_kernel_fits_only_2d_levels_at_its_sizes_on_a_card():
    """The kernel's tables are built for 2D levels at n = 8, 16, 32 on a
    CUDA device, never on the CPU, for a 3D level or at n = 64."""
    assert patch_sweep.kernel_fits(2, 16, "cuda")
    assert all(patch_sweep.kernel_fits(2, n, torch.device("cuda")) for n in (8, 16, 32))
    assert not patch_sweep.kernel_fits(2, 16, "cpu")
    assert not patch_sweep.kernel_fits(3, 16, "cuda")
    assert not patch_sweep.kernel_fits(2, 64, "cuda")
    assert not patch_sweep.kernel_fits(2, 4, "cuda")


@pytest.mark.parametrize("D, n", [(2, 16), (3, 8), (2, 64)])
def test_cpu_levels_take_the_plain_sweep(D, n):
    """On the CPU no table of the kernel is built (2D at n=16, 3D, n=64),
    and a sweep whose tables do carry the kernel's still takes the plain
    version for a CPU tensor, counting nothing."""
    pl = _hierarchy("dirichlet", D, n)[0]
    lvl = Level(pl, dtype=torch.float32, device="cpu")
    assert lvl._st.sweep is None
    f, u = _fields(lvl, n)
    ref = lvl.smooth(f, u)
    st = _build_solver_tables(pl, torch.float32, np.arange(lvl.P), "cpu")
    assert st.sweep is None
    st.sweep = patch_sweep.sweep_tables(np.asarray(pl.neumann), st.lam_tab, st.lam_idx,
                                        st.inv_perm.numpy(), n, torch.float32, "cpu")
    before = patch_sweep.sweeps()
    assert torch.equal(patch_sweep.sweep(st, f, lvl._gf_faces(u), lvl.h2inv), ref)
    assert patch_sweep.sweeps() == before


def _sweep_tables(lvl, slots):
    st = _build_solver_tables(lvl.pl, lvl.dtype, slots, "cpu")
    return st, patch_sweep.sweep_tables(np.asarray(lvl.pl.neumann)[slots], st.lam_tab,
                                        st.lam_idx, st.inv_perm.numpy(), lvl.n, lvl.dtype,
                                        "cpu")


def _decode(code, D=2):
    fwd = tuple((code >> (3 * a)) & 7 for a in range(D))
    inv = tuple((code >> (3 * (D + a))) & 7 for a in range(D))
    return fwd, inv, bool((code >> (6 * D)) & 1)


@pytest.mark.parametrize("walls", list(WALLS))
def test_slot_codes_rebuild_the_bc_groups(walls):
    """Each slot's code names the forward and inverse kinds and the DC
    pin of the BC group ``_build_solver_tables`` sorted it into, on every
    level and on an active subset, for every wall set."""
    seen = set()
    for k in range(len(_hierarchy(walls).levels)):
        lvl = _level(walls, k, "f64")
        for slots in (np.arange(lvl.P), np.where(_mask(lvl.P, k))[0]):
            st, sw = _sweep_tables(lvl, slots)
            codes = sw.codes.numpy()
            assert codes.dtype == np.int32 and codes.shape == (len(slots),)
            perm = st.perm.numpy()
            for g in st.groups:
                want = (g.fwd_kinds, g.inv_kinds, g.pin_dc)
                assert {_decode(int(c)) for c in codes[perm[g.start:g.stop]]} == {want}
                seen.add(want)
            # one group per distinct code
            assert len(st.groups) == len(set(codes.tolist()))
    if walls == "mixed":
        kinds = {k for fwd, inv, _ in seen for k in fwd + inv}
        assert {tr.DCT_IV, tr.DST_IV, tr.DST_II, tr.DST_III} <= kinds
    if walls == "neumann":
        assert any(pin for _, _, pin in seen)


@pytest.mark.parametrize("walls", list(WALLS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernel_denominator_rule_is_denom_of(dt, walls):
    """The kernel's divisor of slot c, ``T(lam[y row][i] + lam[x row][k])``
    summed in f64 and cast afterwards, from its rows of ``lam``, is the
    solver tables' ``_denom_of`` of that slot, bit for bit."""
    for k in (0, 1, 2):
        lvl = _level(walls, k, dt)
        slots = np.where(_mask(lvl.P, 7 + k))[0]
        st, sw = _sweep_tables(lvl, slots)
        lam, rows = sw.lam.numpy(), sw.lam_rows.numpy()
        assert lam.dtype == np.float64 and rows.dtype == np.int32
        npdt = np.float32 if dt == "f32" else np.float64
        got = (lam[rows[:, 1]][:, :, None] + lam[rows[:, 0]][:, None, :]).astype(npdt)
        want = _denom_of(st.lam_tab, st.lam_idx, 2, lvl.n, DTYPES[dt])[st.inv_perm.numpy()]
        assert got.tobytes() == want.tobytes()
        assert np.array_equal(st.denom.numpy()[st.inv_perm.numpy()], got)


def test_transform_stack_is_every_kind_in_the_tables_dtype():
    """The kernel's ``[6, n, n]`` stack holds ``transform_matrix(kind)``
    at index ``kind``, cast from f64 once, in the tables' dtype."""
    lvl = _level("dirichlet", 0, "f32")
    _, sw = _sweep_tables(lvl, np.arange(lvl.P))
    assert sw.tmats.dtype == torch.float32 and sw.tmats.shape == (6, lvl.n, lvl.n)
    for kind in range(6):
        want = tr.transform_matrix(kind, lvl.n).astype(np.float32)
        assert sw.tmats[kind].numpy().tobytes() == want.tobytes()


def test_fresh_copies_only_a_strided_or_misaligned_input():
    """The kernel's inputs: a contiguous 16-byte aligned tensor is passed as
    it is; a strided one, or one at an element offset, is copied into a
    contiguous aligned tensor of the same values."""
    base = torch.arange(4 * 8 * 8 + 1, dtype=torch.float32)
    whole = base[:-1].view(4, 8, 8)
    assert patch_sweep._fresh(whole) is whole and patch_sweep._fresh(None) is None
    for t in (base[1:].view(4, 8, 8), whole.transpose(1, 2)):
        got = patch_sweep._fresh(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, t)


@pytest.mark.parametrize("bad", ["f_dtype", "h2inv_dtype", "gf_shape", "base_shape",
                                 "route", "slots"])
def test_kernel_refuses_inputs_unlike_its_tables(bad):
    """The kernel's entry checks its inputs against its tables before any
    launch: another dtype raises ``TypeError``, another shape, a slot map
    of another level or a level of other slots without one ``ValueError``."""
    lvl = _level("mixed", 0, "f32")
    _, sw = _sweep_tables(lvl, np.arange(lvl.P))
    f, u = _fields(lvl, 4)
    args = dict(f=f, gf=lvl._gf_faces(u), h2inv=lvl.h2inv, route=None, base=None)
    every = np.ones(lvl.P, dtype=bool)
    if bad == "f_dtype":
        args["f"] = f.double()
    elif bad == "h2inv_dtype":
        args["h2inv"] = lvl.h2inv.double()
    elif bad == "gf_shape":
        args["gf"] = args["gf"][:, :3]
    elif bad == "base_shape":
        args.update(route=ActiveSmoother(lvl, every)._route, base=u[1:])
    elif bad == "route":
        args["route"] = ActiveSmoother(_level("mixed", 1, "f32"),
                                       np.ones(_level("mixed", 1, "f32").P, bool))._route
    else:
        args.update(f=f[1:], gf=args["gf"], h2inv=lvl.h2inv)
    with pytest.raises(TypeError if bad.endswith("dtype") else ValueError):
        patch_sweep._kernel(sw, **args)

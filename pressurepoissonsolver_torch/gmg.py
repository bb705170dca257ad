"""FAC geometric multigrid: inter-level transfers and V/W cycles.

Port of ``pressurepoissonsolver_tpu.gmg`` (the reference's ``GMG::*``
layer, SURVEY.md §2.7).  Transfers between a fine and a coarse
:class:`~pressurepoissonsolver_torch.ops.level_ops.Level` are driven by
host-precomputed parent-slot tables.  Between 2D levels on a card (n a
multiple of 4, f32 or f64) each transfer is one launch of the kernel of
:mod:`.ops.transfer`; the plain chain, which the CPU, 3D and other n run,
is row gathers followed by small per-axis matmuls (in f32 at ``n <=
kron_max_n()``, the reference's Kronecker form: one ``[n^2, n^2]`` matmul
per orthant in 2D, a z matmul and one in 3D):

* Restriction (``GMG::AvgRstr``, ``GMG/AvgRstr.h:53-113``): each fine patch
  average-pools 2^D cells into one and adds the result into its orthant
  block of the parent patch; pass-through patches copy through unchanged.
* Prolongation: piecewise-constant injection of the parent's orthant block
  (``GMG::DrctIntp``, ``GMG/DrctIntp.h:77-113``) or cell-centered
  bi/trilinear interpolation (``GMG::TriLinIntp``), added into the fine
  patch; pass-through copies.

The cycles mirror ``GMG::VCycle``/``GMG::WCycle`` (``GMG/VCycle.h:44-60``,
``GMG/WCycle.h:42-67``) with FAC active-set smoothing on the coarse levels
and a dense direct solve at the bottom.

With a mesh (``build_gmg(..., mesh=, comm=)``) every level, transfer and
active-set smoother is a sharded engine's and works on this rank's block
of rows: the cut-face halo engine's (:mod:`.parallel.halo`, ``comm="halo"``,
with per-rank subset smoothers) or the gathered engine's
(:mod:`.parallel.gathered`, ``comm="pjit"``, with the reference's masked
full sweeps).  The cycle asks each level for its active-set smoother
(``Level.active_smoother``) and never branches on the engine.  The coarse
direct solve all-gathers the coarsest right-hand side, multiplies it by
the replicated inverse and keeps this rank's rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .domain import DomainHierarchy, parent_slots
from .ops import transfer
from .ops.level_ops import ActiveSmoother, Level, kron_max_n, np_dtype
from .ops.patch_sweep import axis_matmul
from .utils import profiling
from .utils.profiling import span


@dataclass
class CycleOpts:
    """Reference ``GMG::CycleOpts`` (``GMG/CycleOpts.h:51-80``); the same
    fields as ``pressurepoissonsolver_tpu.gmg.CycleOpts``."""

    max_levels: int = 0  # 0 = no limit
    patches_per_shard: float = 0  # stop when patches/shard drops below this
    pre_sweeps: int = 1
    post_sweeps: int = 1
    mid_sweeps: int = 1
    coarse_sweeps: int = 1
    cycle_type: str = "V"  # "V" | "W"
    interpolator: str = "constant"  # "constant" (DrctIntp) | "linear" (TriLinIntp)
    # exact coarse solve: stop the hierarchy once a level has at most this
    # many DOF and invert its assembled operator once
    coarse_direct_max_dof: int = 4096
    coarse_direct: bool = True
    # FAC active-set relaxation: each coarse level relaxes only the region
    # it is the finest representation of (the newly merged parents plus
    # ``fac_active_ring`` rings of neighbours); "full" relaxes everywhere,
    # as the reference does
    fac_smoothing: str = "full"  # "full" | "active"
    fac_active_ring: int = 1
    # pre-sweeps below the finest level; 0 = use pre_sweeps everywhere
    coarse_pre_sweeps: int = 0


def _constant_prolong_matrix(n: int, half: int) -> np.ndarray:
    """n×n 0/1 matrix: fine cell i of the (half)-child reads parent cell
    ``(i + half*n)//2`` — piecewise-constant injection (``GMG::DrctIntp``)."""
    W = np.zeros((n, n))
    for i in range(n):
        W[i, (i + half * n) // 2] = 1.0
    return W


def _restrict_matrix(n: int, half: int) -> np.ndarray:
    """n×n matrix accumulating a full fine-child patch line into the
    (half)-orthant of the parent line by cell averaging
    (``GMG::AvgRstr``): parent cell ``j + half*n/2`` gets
    ``(fine[2j] + fine[2j+1]) / 2`` per axis."""
    R = np.zeros((n, n))
    for j in range(n // 2):
        J = j + half * (n // 2)
        R[J, 2 * j] = 0.5
        R[J, 2 * j + 1] = 0.5
    return R


def _linear_prolong_matrix(n: int, half: int) -> np.ndarray:
    """n×n matrix mapping a parent patch's 1D cell line to the fine cells of
    its lower (half=0) or upper (half=1) child, by cell-centered linear
    interpolation with one-sided extrapolation at patch edges.

    Reproduces the reference's trilinear-prolongation coefficient tables
    (``GMG/TriLinIntp.cpp:105-673``): interior weights (3/4, 1/4) per axis
    — e.g. the 3D center stencil 27/64 = (3/4)^3 — and edge weights
    (5/4, -1/4) — e.g. the exterior-face value 45/64 = (5/4)(3/4)(3/4).
    """
    W = np.zeros((n, n))
    start = half * (n // 2)
    for i in range(n):
        c = start + i // 2
        d = 1 if (i % 2 == 1) else -1
        j = c + d
        if 0 <= j < n:
            W[i, c] += 0.75
            W[i, j] += 0.25
        else:
            W[i, c] += 1.25
            W[i, c - d] += -0.25
    return W


def _orthant_kron(mats, o: int, D: int, device):
    """Orthant ``o``'s transfer in Kronecker form from the per-axis
    matrices ``mats[half]``: ``kron(M_y, M_x)^T`` as f32 (3D: with the z
    matrix ``M_z``), the reference's ``gmg.Transfer._Wr``/``_Wp``."""
    def up(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    kr = up(np.kron(mats[(o >> 1) & 1], mats[o & 1]).T)
    return kr if D == 2 else (kr, up(mats[(o >> 2) & 1]))


def kron_to(mats, device):
    """A transfer's Kronecker matrices (``None``, or per orthant a matrix
    or a pair) on ``device``."""
    if mats is None:
        return None
    return [m.to(device) if torch.is_tensor(m) else tuple(w.to(device) for w in m)
            for m in mats]


class Transfer:
    """Fine<->coarse transfer tables between two levels.

    ``prolong_mode``: ``"constant"`` — piecewise-constant injection
    (reference ``GMG::DrctIntp``, the factory default); ``"linear"`` —
    cell-centered bi/trilinear prolongation (reference ``GMG::TriLinIntp``).

    On a CUDA tensor, a transfer between 2D levels on a card at n a
    multiple of 4 in f32 or f64 (``ops.transfer.kernel_fits``) is one
    kernel launch (:mod:`.ops.transfer`); every other transfer runs the
    plain chain (``restrict_plain`` / ``prolong_add_plain``) in the span
    ``pps.transfer.plain``, counted in ``ops.transfer.plain`` on a card.
    """

    @profiling.spanned("pps.gmg.transfer", device=False)
    def __init__(self, fine: Level, coarse: Level, prolong_mode: str = "constant"):
        if prolong_mode not in ("constant", "linear"):
            raise ValueError(f"prolong_mode={prolong_mode!r}: 'constant' or 'linear'")
        self.fine = fine
        self.coarse = coarse
        self.prolong_mode = prolong_mode
        D, n = fine.D, fine.n
        self.D, self.n = D, n
        self._cells = n**D
        dev = fine.device
        npdt = np_dtype(fine.dtype)

        def up(x):
            return torch.as_tensor(x, device=dev)

        prolong = (_linear_prolong_matrix if prolong_mode == "linear"
                   else _constant_prolong_matrix)
        self._wprol = [up(prolong(n, h).astype(npdt)) for h in range(2)]
        self._wrstr = [up(_restrict_matrix(n, h).astype(npdt)) for h in range(2)]
        # f32 at n <= kron_max_n(): per orthant o, the (y, x) pair as one
        # Kronecker matrix (3D: with the z matrix beside it), f64 products
        # cast last, in full FP32 like the per-axis form
        self._use_kron = fine.dtype == torch.float32 and n <= kron_max_n()
        self._Wr = self._Wp = None
        if self._use_kron:
            rmats = [_restrict_matrix(n, h) for h in range(2)]
            pmats = [prolong(n, h) for h in range(2)]
            self._Wr = [_orthant_kron(rmats, o, D, dev) for o in range(1 << D)]
            self._Wp = [_orthant_kron(pmats, o, D, dev) for o in range(1 << D)]
        pslots = parent_slots(fine.pl, coarse.pl)
        passthrough = fine.pl.orth_on_parent < 0
        orth = fine.pl.orth_on_parent

        # prolongation sources: per orthant, the parents of the fine
        # patches in that orthant, then the pass-through patches (padded
        # dummy patches, parent slot -1, stay zero in both directions)
        order = []  # fine slots in the concat order of the sources
        self._groups = []  # (orthant, parent slots)
        for o in range(1 << D):
            sel = np.where((~passthrough) & (orth == o))[0]
            if len(sel):
                order.append(sel)
                self._groups.append((o, up(pslots[sel])))
        sel = np.where(passthrough & (pslots >= 0))[0]
        self._pt_parent = None
        if len(sel):
            order.append(sel)
            self._pt_parent = up(pslots[sel])

        # restriction: per coarse patch, the fine slot of each orthant child
        # (Pf = zero-pad row) and the pass-through fine slot
        Pf, Pc = fine.P, coarse.P
        child_slot = np.full((Pc, 1 << D), Pf, dtype=np.int64)
        pt_slot = np.full(Pc, Pf, dtype=np.int64)
        real = pslots >= 0  # not a padded dummy patch
        sel = np.where(real & passthrough)[0]
        pt_slot[pslots[sel]] = sel
        sel = np.where(real & ~passthrough)[0]
        child_slot[pslots[sel], orth[sel]] = sel
        self._pt_slot = up(pt_slot)
        # the kernel's tables (ops.transfer), where it fits
        self._kt = None
        if transfer.kernel_fits(D, n, fine.dtype, dev):
            self._kt = transfer.transfer_tables(child_slot, pt_slot, pslots, orth, n,
                                                prolong_mode == "linear", dev)
        # parent-compact restriction: on pass-through-heavy coarse levels
        # most child_slot rows are padding — pool over just the parent rows
        # and route back with one row gather
        parents = np.where((child_slot < Pf).any(axis=1))[0]
        self._r_inv = None
        rows = child_slot
        if Pc >= 256 and len(parents) < Pc // 2:
            rows = child_slot[parents]
            inv = np.full(Pc, len(parents), dtype=np.int64)  # pad row = zeros
            inv[parents] = np.arange(len(parents))
            self._r_inv = up(inv)
        self._r_cols = [up(np.ascontiguousarray(rows[:, o])) for o in range(1 << D)]
        # the source order inverted, so one row gather routes the
        # prolonged blocks to their fine slots
        order = np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
        inv = np.full(Pf, len(order), dtype=np.int64)  # pad row = zeros
        inv[order] = np.arange(len(order))
        self._prolong_inv = up(inv)

    def _orthant_apply(self, blk_flat: torch.Tensor, o: int, axis_mats,
                       kron_mats=None) -> torch.Tensor:
        """Apply the orthant-``o`` transfer matrices to flat ``[R, n^D]``
        rows: the Kronecker ones (``self._Wr``/``_Wp`` or a sharded
        engine's copies on its device) when given, else the per-axis ones."""
        D, n = self.D, self.n
        if kron_mats is not None:
            if D == 2:
                return torch.matmul(blk_flat, kron_mats[o].to(blk_flat.dtype))
            Wyx, Mz = (w.to(blk_flat.dtype) for w in kron_mats[o])
            y = torch.matmul(Mz, blk_flat.reshape(-1, n, n * n))
            return torch.matmul(y, Wyx).reshape(blk_flat.shape[0], -1)
        blk = blk_flat.reshape((-1,) + (n,) * D)
        for a in range(D):
            M = axis_mats[(o >> a) & 1].to(blk.dtype)
            blk = axis_matmul(M, blk, 1 + (D - 1 - a))
        return blk.reshape(blk_flat.shape[0], -1)

    def restrict(self, fine_u: torch.Tensor) -> torch.Tensor:
        """Cell-averaging restriction into a new coarse-level vector: one
        kernel launch where the transfer has the kernel's tables and the
        field is on the card, else :meth:`restrict_plain`."""
        if self._kt is not None and fine_u.is_cuda:
            return transfer.restrict(self._kt, fine_u)
        transfer.count_plain(fine_u)
        with span("pps.transfer.plain"):
            return self.restrict_plain(fine_u)

    def prolong_add(self, coarse_u: torch.Tensor, fine_u: torch.Tensor) -> torch.Tensor:
        """Prolongation (constant or linear) added into ``fine_u``, as a new
        tensor: one kernel launch where the transfer has the kernel's tables
        and the fields are on the card, else :meth:`prolong_add_plain`."""
        if self._kt is not None and fine_u.is_cuda:
            return transfer.prolong_add(self._kt, coarse_u, fine_u)
        transfer.count_plain(fine_u)
        with span("pps.transfer.plain"):
            return self.prolong_add_plain(coarse_u, fine_u)

    def restrict_plain(self, fine_u: torch.Tensor) -> torch.Tensor:
        """The plain version of :meth:`restrict`: per orthant, gather the
        full child patches by the coarse-side child table and accumulate
        them through the averaging matrices."""
        Pf = fine_u.shape[0]
        cells = self._cells
        fine_flat = torch.cat(
            [fine_u.reshape(Pf, cells), fine_u.new_zeros(1, cells)], dim=0)
        assembled = None
        for o, cols in enumerate(self._r_cols):
            block = self._orthant_apply(fine_flat.index_select(0, cols), o,
                                        self._wrstr, self._Wr)
            assembled = block if assembled is None else assembled + block
        if self._r_inv is not None:
            assembled = torch.cat(
                [assembled, assembled.new_zeros(1, cells)], dim=0
            ).index_select(0, self._r_inv)
        out = assembled + fine_flat.index_select(0, self._pt_slot)
        return out.reshape((-1,) + tuple(fine_u.shape[1:]))

    def prolong_add_plain(self, coarse_u: torch.Tensor, fine_u: torch.Tensor) -> torch.Tensor:
        """The plain version of :meth:`prolong_add`: compute each orthant
        group's blocks, stack them with the pass-through rows, and route
        rows to fine slots with one precomputed row gather."""
        cells = self._cells
        cflat = coarse_u.reshape(coarse_u.shape[0], cells)
        parts = [
            self._orthant_apply(cflat.index_select(0, psel), o, self._wprol, self._Wp)
            for o, psel in self._groups
        ]
        if self._pt_parent is not None:
            parts.append(cflat.index_select(0, self._pt_parent))
        if not parts:
            return fine_u
        parts.append(cflat.new_zeros(1, cells))
        routed = torch.cat(parts, dim=0).index_select(0, self._prolong_inv)
        return fine_u + routed.reshape(fine_u.shape)


def _expand_ring(pl, active: np.ndarray, rings: int) -> np.ndarray:
    """Expand a patch set by ``rings`` rings of face neighbours."""
    active = active.copy()
    for _ in range(rings):
        cur = np.where(active)[0]
        nbrs = pl.nbr_slot[cur].ravel()
        fnbrs = pl.fine_nbr_slots[cur].ravel()
        active[nbrs[nbrs >= 0]] = True
        active[fnbrs[fnbrs >= 0]] = True
    return active


def _fac_active_mask(transfer: Transfer, ring: int):
    """Coarse-level patches to relax under FAC active-set smoothing: the
    parents newly merged from the finer level, expanded by ``ring`` rings
    of face neighbours.  ``None`` when every patch is active."""
    fine_pl, coarse_pl = transfer.fine.pl, transfer.coarse.pl
    pslots = parent_slots(fine_pl, coarse_pl)
    passthrough = fine_pl.orth_on_parent < 0
    active = np.zeros(coarse_pl.num_patches, dtype=bool)
    sel = pslots[(~passthrough) & (pslots >= 0)]
    active[sel] = True
    active = _expand_ring(coarse_pl, active, ring)
    if active.all():
        return None
    return active


class GMGCycle:
    """A V- or W-cycle over a level hierarchy, applied as ``u = M f``
    (``GMG/Cycle.h:34-127``): the input is a residual-style RHS; the
    initial guess is zero on every level.

    Spans (``utils.profiling``): ``pps.gmg.vcycle`` (a cycle, V or W), per
    level ``k`` ``pps.gmg.L{k}.smooth`` (the sweeps before, between or after
    the coarse visits),
    ``.residual``, ``.restrict`` and ``.prolong``, ``pps.gmg.coarse`` (the
    coarsest level's solve), and at set-up ``pps.gmg.coarse_inverse``."""

    def __init__(self, levels: List[Level], transfers: List[Transfer], opts: CycleOpts):
        assert len(transfers) == len(levels) - 1
        if opts.cycle_type not in ("V", "W"):
            raise ValueError(f"cycle_type={opts.cycle_type!r}: 'V' or 'W'")
        self.levels = levels
        self.transfers = transfers
        self.opts = opts
        self._coarse_inv = None
        if opts.coarse_direct and (
            levels[-1].P * levels[-1].pl.cells_per_patch <= opts.coarse_direct_max_dof
        ):
            self._build_coarse_direct()
        # FAC active-set state per level: an ActiveSmoother for the sweeps
        # and one over nbr(active) for the first residual; ``_skip`` marks
        # levels with nothing to relax
        self._skip = [False] * len(levels)
        self._asmooth: List[Optional[ActiveSmoother]] = [None] * len(levels)
        self._aapply: List[Optional[ActiveSmoother]] = [None] * len(levels)
        if opts.fac_smoothing == "active":
            for k in range(1, len(levels)):
                mask = _fac_active_mask(transfers[k - 1], opts.fac_active_ring)
                if mask is None:
                    continue
                if not mask.any():
                    self._skip[k] = True
                    continue
                # residual apply on nbr(active) only: after active-set
                # smoothing u vanishes off the active set, so every
                # nonzero row of A u lies within one ring of it
                self._asmooth[k] = levels[k].active_smoother(mask)
                self._aapply[k] = levels[k].active_smoother(
                    _expand_ring(levels[k].pl, mask, 1), build_solver=False)

    @profiling.spanned("pps.gmg.coarse_inverse", device=False)
    def _build_coarse_direct(self) -> None:
        from .matrix import assemble_composite

        lvl = self.levels[-1]
        A = assemble_composite(lvl.pl).toarray()
        # Neumann problems have the constant nullspace -> pseudo-inverse
        nr = lvl.pl.real_patches
        phys = lvl.pl.nbr_type[:nr] == 0
        all_neumann = bool(np.asarray(lvl.pl.neumann)[:nr][phys].all())
        Ainv = np.linalg.pinv(A) if all_neumann else np.linalg.inv(A)
        self._coarse_inv = torch.as_tensor(
            Ainv.astype(np_dtype(lvl.dtype)), device=lvl.device)

    def apply(self, f: torch.Tensor) -> torch.Tensor:
        with span("pps.gmg.vcycle"):
            return self._visit(0, f)

    def _pre(self, k: int) -> int:
        if k == 0 or self.opts.coarse_pre_sweeps <= 0:
            return self.opts.pre_sweeps
        return self.opts.coarse_pre_sweeps

    def _visit(self, k: int, f: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[k]
        opts = self.opts
        if k == len(self.levels) - 1:
            with span("pps.gmg.coarse"):
                if self._coarse_inv is not None:
                    fg = lvl.gather(f)
                    sol = torch.mv(self._coarse_inv.to(f.dtype), fg.reshape(-1))
                    return lvl.local_rows(sol.reshape(fg.shape))
                if opts.coarse_sweeps <= 0:
                    return torch.zeros_like(f)
                u = lvl.smooth_zero(f)
                for _ in range(opts.coarse_sweeps - 1):
                    u = lvl.smooth(f, u)
                return u
        u = self._sweeps(k, f, None, self._pre(k))
        u = self._correct(k, f, u, first=True)
        if opts.cycle_type == "W":
            # the second coarse visit (GMG/WCycle.h:30-83), after the mid
            # sweeps; level k is visited 2^k times per cycle
            u = self._sweeps(k, f, u, opts.mid_sweeps)
            u = self._correct(k, f, u, first=False)
        return self._sweeps(k, f, u, opts.post_sweeps)

    def _residual(self, k: int, f, u, first: bool):
        """``f - A u`` on level ``k``; on the first pass of a level visit
        ``u`` is zero off the active set, so the residual apply runs on
        nbr(active) only (or is ``f`` exactly when nothing was relaxed)."""
        if first and (self._skip[k] or self._pre(k) <= 0):
            return f  # u = 0: nothing was relaxed on this level yet
        with span(f"pps.gmg.L{k}.residual"):
            if first and self._aapply[k] is not None:
                return f - self._aapply[k].apply_scattered(u)
            return f - self.levels[k].apply(u)

    def _correct(self, k: int, f, u, first: bool):
        """One coarse-grid correction: restrict the residual, visit the
        coarser level, prolong the correction back (``GMG/Cycle.h:56-80``)."""
        r = self._residual(k, f, u, first)
        with span(f"pps.gmg.L{k}.restrict"):
            fc = self.transfers[k].restrict(r)
        uc = self._visit(k + 1, fc)
        with span(f"pps.gmg.L{k}.prolong"):
            return self.transfers[k].prolong_add(uc, u)

    def _sweeps(self, k: int, f: torch.Tensor, u: Optional[torch.Tensor],
                sweeps: int) -> torch.Tensor:
        """``sweeps`` block-Jacobi sweeps on level ``k`` from ``u`` (from zero
        with ``u`` None), in one span; under FAC active-set smoothing only
        the active patches are updated."""
        if sweeps <= 0 or self._skip[k]:
            return torch.zeros_like(f) if u is None else u
        smoother = self.levels[k] if self._asmooth[k] is None else self._asmooth[k]
        with span(f"pps.gmg.L{k}.smooth"):
            if u is None:
                u, sweeps = smoother.smooth_zero(f), sweeps - 1
            for _ in range(sweeps):
                u = smoother.smooth(f, u)
        return u


def build_gmg(
    hierarchy: DomainHierarchy,
    opts: Optional[CycleOpts] = None,
    dtype: torch.dtype = torch.float64,
    *,
    device="cuda",
    fine=None,
    mesh=None,
    comm: str = "halo",
) -> GMGCycle:
    """Build the level stack + transfers (reference
    ``GMG::CycleFactory2d::getCycle``, ``GMG/CycleFactory2d.cpp:69-134``):
    stop adding levels when ``max_levels`` is reached, the patch count per
    shard falls below ``patches_per_shard``, or the coarsest level is small
    enough for the direct solve.  ``fine`` reuses an existing finest level
    of the same dtype (the engine's level with a mesh).  With ``mesh`` every
    level and transfer runs patch-sharded on this rank's ``device``, through
    the halo engine (``comm="halo"``) or the gathered engine
    (``comm="pjit"``, the reference's ``build_gmg(mesh=)``); the global
    levels behind them are built on the host, and only this rank's rows and
    tables go to the device."""
    opts = opts or CycleOpts()
    num_shards = 1 if mesh is None else mesh.size()
    host = device if mesh is None else torch.device("cpu")
    if fine is None:
        fine = Level(hierarchy[0], dtype=dtype, device=host)
    levels: List[Level] = [fine]
    transfers: List[Transfer] = []
    for k in range(1, len(hierarchy)):
        if opts.max_levels > 0 and len(levels) >= opts.max_levels:
            break
        pl = hierarchy[k]
        if pl.num_patches / num_shards < opts.patches_per_shard:
            break
        if (
            opts.coarse_direct
            and levels[-1].P * levels[-1].pl.cells_per_patch
            <= opts.coarse_direct_max_dof
        ):
            break  # current coarsest is small enough for a direct solve
        lvl = Level(pl, dtype=dtype, device=host)
        transfers.append(Transfer(getattr(levels[-1], "base", levels[-1]), lvl,
                                  prolong_mode=opts.interpolator))
        levels.append(lvl)
    if mesh is not None:
        from .parallel.rank_block import engine_classes

        Lv, Tr = engine_classes(comm)
        levels = [lvl if isinstance(lvl, Lv) else Lv(lvl, mesh, device) for lvl in levels]
        transfers = [Tr(t, levels[k], levels[k + 1]) for k, t in enumerate(transfers)]
    return GMGCycle(levels, transfers, opts)

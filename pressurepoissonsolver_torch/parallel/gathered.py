"""The ``comm="pjit"`` engine: the level ops in their global-index form,
each over an all-gathered operand.

Counterpart of the reference's ``Level.set_mesh`` with ``_constrain_p`` and
``_constrain_g`` (``pressurepoissonsolver_tpu/ops/level_ops.py``), the
constraints of its transfers and the masked FAC sweeps of its
``GMGCycle`` (``gmg.py``).  There, the patch field and the interface
vector are sharded on their leading axis, the index tables are replicated
constants and XLA's SPMD partitioner puts an all-gather in front of each
irregular gather.  Here the same schedule is explicit, with plain local
tensors (no ``DTensor``: every collective is named in this module):

* a rank holds its block of ``P/k`` patch rows and its block of ``NIb =
  ceil(NIf/k)`` rows of the interface vector (``[k * NIb, m]`` in all, the
  rows past ``NIf`` zero);
* each op that reads across patches makes one all-gather of the operand
  of its global gather (``Comm.all_gather``: ``all_gather_into_tensor``
  under NCCL, staged through the host under gloo with CUDA tensors), runs
  the single-device gather code on it and keeps its own output rows:

  ===========================================  ==========================
  op                                           operand all-gathered
  ===========================================  ==========================
  ``apply``, ``smooth``, ``interpolate``       the faces ``[P, 2D*fd, m]``
  ``restrict``                                 the fine field
  ``prolong_add``                              the coarse field
  ``patch_solve``, ``fold_gamma``, ``schur_S``  the interface blocks
  ===========================================  ==========================

* the stencil kernel and the spectral patch solves run on this rank's
  rows only; the index tables on the device are the rows of the global
  tables that this rank's outputs read, with their global entries (into
  the gathered operand).

So the data moved per op is the whole operand, not the cut faces the halo
engine (:mod:`.halo`) sends, and every rank holds each gathered operand
whole while the op runs: a counterpart kept for comparison, not a faster
engine.  FAC active-set smoothing is the reference's masked form
(:class:`MaskedSmoother`); the coarse direct solve, the Krylov reduction
hook, ``integrate``, ``report`` and ``gather_patches`` are the halo
engine's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..domain import parent_slots
from ..gmg import kron_to
from ..ops.level_ops import _STENCIL, Level, _build_contrib_pipeline, extract_faces
from .rank_block import RankBlock


class GatheredLevel(RankBlock):
    """Level ops over a 1D mesh, each over an all-gathered operand (see the
    module doc); a drop-in for
    :class:`~pressurepoissonsolver_torch.ops.level_ops.Level` on this
    rank's ``[P/k, *ns]`` block, as :class:`.halo.ShardedLevel` is.
    ``level`` is the global level (build it on the host); only this rank's
    rows and the table rows its outputs read go to ``device``."""

    def __init__(self, level: Level, mesh, device=None):
        super().__init__(level, mesh, device)
        device, ndev, me, rows = self.device, self.ndev, self.me, self._rows
        t = level.tables
        D, P = self.D, self.P
        S2, S2f = 2 * D, 2 * D * self.face_depth
        NR = P * S2f  # rows of the gathered faces

        def up(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        def pipeline(keep, iface, num):
            return _build_contrib_pipeline(
                t.contrib_patch[keep], t.contrib_side[keep], t.contrib_case[keep],
                iface, num, level._case_T, level._case_scalar, level.dtype, S2f, P,
                device)

        # the interface vector: rank r owns rows r*NIb .. (r+1)*NIb - 1
        NIf = level.num_ifaces
        self.NIb = self._gamma_rows = NIb = max(-(-NIf // ndev), 1)
        self._owned_ids: List[List[int]] = [
            list(range(r * NIb, min((r + 1) * NIb, NIf))) for r in range(ndev)]
        self.NOg = NIb
        lo = me * NIb
        keep = (t.contrib_iface >= lo) & (t.contrib_iface < lo + NIb)
        self._pipe = pipeline(keep, t.contrib_iface[keep] - lo, NIb)
        # this rank's sides' interface rows in the gathered vector; masked
        # sides read the zero row after it
        iflat = level._iface_flat.cpu().numpy().reshape(P, S2)[rows]
        self._iflat = up(np.where(iflat == NIf, ndev * NIb, iflat).reshape(-1))

        # the direct gf pipeline (Level._gf_parts) for this rank's sides:
        # neighbour face rows of the gathered faces, and the refinement
        # interfaces they read through a contribution pipeline of their own
        mix = level._gf_mix_idx.cpu().numpy().reshape(P, S2)[rows]
        nref = level._nref
        ref = mix - NR
        need = np.unique(ref[(ref >= 0) & (ref < nref)])
        loc = np.full(nref + 1, len(need), dtype=np.int64)  # pad -> zero row
        loc[need] = np.arange(len(need))
        self._mix_idx = up(np.where(mix < NR, mix, NR + loc[np.clip(ref, 0, nref)])
                           .reshape(-1))
        self._ref_pipe = None
        if len(need):
            remap = np.full(max(NIf, 1), -1, dtype=np.int64)
            remap[level._gf_ref_ids[need]] = np.arange(len(need))
            keep = remap[t.contrib_iface] >= 0
            self._ref_pipe = pipeline(keep, remap[t.contrib_iface[keep]], len(need))
        self._w_own = level._gf_w_own[rows].to(device, copy=True)
        self._w_mix = level._gf_w_mix[rows].to(device, copy=True)

    # -- the gathered operands ------------------------------------------------

    def _faces(self, u: torch.Tensor):
        """This rank's faces ``[Pl, 2D*fd, m]`` and every rank's ``[P,
        2D*fd, m]`` (one all-gather)."""
        faces = extract_faces(u, self.D, self.n, self.face_depth)
        return faces, self.comm.all_gather(faces)

    def _mix_scaled(self, faces_g: torch.Tensor) -> torch.Tensor:
        """``w_mix * mix`` ``[Pl, 2D, m]`` of this rank's sides from the
        gathered faces."""
        m = self.m
        ff = faces_g.reshape(-1, m)
        srcs = [ff]
        if self._ref_pipe is not None:
            srcs.append(self._ref_pipe.interpolate(faces_g, m))
        srcs.append(ff.new_zeros(1, m))
        mix = torch.cat(srcs, dim=0).index_select(0, self._mix_idx)
        return self._w_mix.to(ff.dtype) * mix.reshape(self.Pl, 2 * self.D, m)

    def _gamma_faces(self, gamma: torch.Tensor) -> torch.Tensor:
        """``[Pl, 2D, m]`` traces of this rank's sides from the gathered
        interface vector (one all-gather of the blocks)."""
        g = self.comm.all_gather(gamma)
        gp = torch.cat([g, g.new_zeros(1, self.m)], dim=0)
        return gp.index_select(0, self._iflat).reshape(self.Pl, 2 * self.D, self.m)

    def _no_ifaces(self) -> bool:
        return self.base.num_ifaces == 0  # a single patch: nothing to gather

    # -- the level ops on this rank's block -------------------------------------

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Composite operator: the direct gf pipeline of ``Level.apply`` on
        the gathered faces, the stencil kernel on this rank's rows."""
        u = u.contiguous()
        if self._no_ifaces():
            mix_scaled = u.new_zeros(self.Pl, 2 * self.D, self.m)
        else:
            mix_scaled = self._mix_scaled(self._faces(u)[1])
        return _STENCIL[self.D](u, mix_scaled, self.ghost_coef_eff.to(u.dtype),
                                self.h2inv.to(u.dtype))

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One block-Jacobi sweep of spectral patch solves on this rank's
        rows, with the traces of the gathered faces."""
        if self._no_ifaces():
            return self.smooth_zero(f)
        faces, faces_g = self._faces(u)
        own = faces.reshape(self.Pl, 2 * self.D, self.face_depth, self.m)[:, :, 0]
        return self.sweep(f, self._w_own.to(u.dtype) * own + self._mix_scaled(faces_g))

    # -- the Schur path on the block-sharded interface vector ------------------

    def gamma_global(self, gamma: torch.Tensor) -> np.ndarray:
        """The single-device ``[NIf, m]`` interface vector from every rank's
        block, on the host (an all-gather; every rank must call it)."""
        return self.comm.all_gather(gamma).cpu().numpy()[: self.base.num_ifaces]

    def interpolate(self, u: torch.Tensor) -> torch.Tensor:
        """Trace interpolation into this rank's interface block: the
        contribution pipeline of its interfaces on the gathered faces."""
        if self._no_ifaces():
            return u.new_zeros(self.NIb, self.m)
        return self._pipe.interpolate(self._faces(u)[1], self.m)

    def fold_gamma(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Ghost injection ``f - G gamma``."""
        return self._fold(f, self._gamma_faces(gamma.to(f.dtype)))

    # -- the engine hook ---------------------------------------------------------

    def active_smoother(self, active: np.ndarray, build_solver: bool = True):
        """The reference pjit engine's FAC active-set form: masked full
        sweeps (:class:`MaskedSmoother`)."""
        return MaskedSmoother(self, active)


class MaskedSmoother:
    """FAC active-set smoothing as the reference's pjit engine runs it
    (``gmg.py``, ``where(mask, smooth(f, u), u)``): full sweeps of the
    level whose update is kept on the active patches only; the first
    residual after the pre-sweeps (``apply_scattered``) is the full apply,
    as there.  The values equal the subset smoothers' (``ActiveSmoother``,
    :class:`.halo.ShardedActiveSmoother`): a sweep's active rows read the
    same traces, and the residual equals the subset one whenever the
    iterate vanishes off the active set."""

    def __init__(self, level: GatheredLevel, active: np.ndarray):
        self.level = level
        mask = np.asarray(active, dtype=bool)[level._rows]
        self._mask = torch.as_tensor(mask.reshape((-1,) + (1,) * level.D),
                                     device=level.device)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.where(self._mask, self.level.smooth(f, u), u)

    def smooth_zero(self, f: torch.Tensor) -> torch.Tensor:
        s = self.level.smooth_zero(f)
        return torch.where(self._mask, s, torch.zeros((), dtype=s.dtype, device=s.device))

    def apply_scattered(self, u: torch.Tensor) -> torch.Tensor:
        return self.level.apply(u)


class GatheredTransfer:
    """GMG restriction and prolongation over gathered fields: the per-orthant
    gathers and matmuls of :class:`~pressurepoissonsolver_torch.gmg.Transfer`
    for this rank's output rows, on the all-gathered fine field
    (``restrict``) or coarse field (``prolong_add``)."""

    def __init__(self, transfer, fine: GatheredLevel, coarse: GatheredLevel):
        self.t = transfer
        self.fine, self.coarse = fine, coarse
        self.prolong_mode = transfer.prolong_mode
        D, n = fine.D, fine.n
        self.D, self.n, self._cells = D, n, n ** D
        dev = fine.device
        self._wprol = [w.to(dev) for w in transfer._wprol]
        self._wrstr = [w.to(dev) for w in transfer._wrstr]
        self._Wp, self._Wr = kron_to(transfer._Wp, dev), kron_to(transfer._Wr, dev)
        Pf, Pc = fine.P, coarse.P
        pslots = parent_slots(fine.pl, coarse.pl)
        passthrough = fine.pl.orth_on_parent < 0
        orth = fine.pl.orth_on_parent

        def up(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        # restriction: per coarse patch of this rank, the fine slot of each
        # orthant child and the pass-through slot (Pf = the zero row)
        child_slot = np.full((Pc, 1 << D), Pf, dtype=np.int64)
        pt_slot = np.full(Pc, Pf, dtype=np.int64)
        for i in range(Pf):
            ps = pslots[i]
            if ps < 0:
                continue  # padded dummy patch
            if passthrough[i]:
                pt_slot[ps] = i
            else:
                child_slot[ps, orth[i]] = i
        rc = coarse._rows
        self._r_cols = [up(child_slot[rc, o]) for o in range(1 << D)]
        self._pt_slot = up(pt_slot[rc])

        # prolongation: this rank's fine patches per orthant, then the
        # pass-through ones; their parents' slots, and the routing of the
        # stacked blocks back to this rank's fine rows (pad -> zero row)
        mine = np.zeros(Pf, dtype=bool)
        mine[fine._rows] = True
        order, self._groups = [], []
        for o in range(1 << D):
            sel = np.where(mine & ~passthrough & (orth == o))[0]
            if len(sel):
                order.append(sel)
                self._groups.append((o, up(pslots[sel])))
        sel = np.where(mine & passthrough & (pslots >= 0))[0]
        self._pt_parent = None
        if len(sel):
            order.append(sel)
            self._pt_parent = up(pslots[sel])
        order = np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
        inv = np.full(Pf, len(order), dtype=np.int64)
        inv[order] = np.arange(len(order))
        self._prolong_inv = up(inv[fine._rows])

    def restrict(self, fine_u: torch.Tensor) -> torch.Tensor:
        """Cell-averaging restriction into this rank's coarse rows."""
        cells = self._cells
        fg = self.fine.gather(fine_u.reshape(fine_u.shape[0], cells))
        fine_flat = torch.cat([fg, fg.new_zeros(1, cells)], dim=0)
        assembled = None
        for o, cols in enumerate(self._r_cols):
            block = self.t._orthant_apply(fine_flat.index_select(0, cols), o,
                                          self._wrstr, self._Wr)
            assembled = block if assembled is None else assembled + block
        out = assembled + fine_flat.index_select(0, self._pt_slot)
        return out.reshape((-1,) + tuple(fine_u.shape[1:]))

    def prolong_add(self, coarse_u: torch.Tensor, fine_u: torch.Tensor) -> torch.Tensor:
        """Prolongation (constant or linear) into this rank's fine rows,
        added into ``fine_u``."""
        cells = self._cells
        cflat = self.coarse.gather(coarse_u.reshape(coarse_u.shape[0], cells))
        parts = [self.t._orthant_apply(cflat.index_select(0, psel), o, self._wprol, self._Wp)
                 for o, psel in self._groups]
        if self._pt_parent is not None:
            parts.append(cflat.index_select(0, self._pt_parent))
        parts.append(cflat.new_zeros(1, cells))
        routed = torch.cat(parts, dim=0).index_select(0, self._prolong_inv)
        return fine_u + routed.reshape(fine_u.shape)

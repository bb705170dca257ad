"""Cut-face halo exchange: the sharded level ops over ``torch.distributed``.

Port of ``pressurepoissonsolver_tpu.parallel.halo`` (the reference's
recurring data motion: the PETSc ``VecScatter``s of the interface vector,
``SchurHelper.h:130-150``, and the GMG interlevel scatters,
``GMG/InterLevelComm.h:150-189``), SPMD: every rank builds the same host
tables for all ranks, keeps its own rows of them on its device, and runs
the ops on its block of ``P/k`` patches (:mod:`.sharding`).

* Every patch reads only *its own* side interfaces; the cross-rank
  coupling is that a remote patch's **face trace** contributes to a local
  interface.  So the only data that moves is the set of cut faces: face
  rows of patches whose interface readers live on another rank.
* At setup, the cut faces are grouped by **rank offset** ``d``: rank ``q``
  sends the same-shaped batch of face rows to rank ``(q+d) % k`` for every
  ``d`` that occurs (with a Morton block partition nearly all traffic is
  ``d = ±1``).  Each offset is one ``dist.batch_isend_irecv``: one send
  and one receive per rank, point to point, no all-gather.
* Each rank then computes the interface values it needs *locally* (both
  owners of a cut interface recompute it: one hop instead of a
  scatter-add and a scatter-back) and runs the ghost-closure stencil
  kernel (:mod:`..ops.ghost_stencil`) or the spectral patch solves on its
  own rows.

:class:`ShardedLevel` is the level (``apply``, the smoothers, the Schur
ops); :class:`ShardedActiveSmoother` the FAC active-set sweeps;
:class:`ShardedTransfer` the GMG restriction and prolongation with the
same per-offset exchange for parent/child pairs on different ranks.  The
host tables (``Exchange.send_tbl``, ``offsets``, ``widths``,
``comm_rows``, the owned-gamma layout) equal the reference's; the
communication volume is bounded by ``partition.cut_faces`` in the tests.
``ShardedLevel.apply`` overlaps the exchange with the stencil as the
reference does: with more than one rank it starts the exchange, runs the
kernel's no-gf mode on its rows while the exchange is in flight, then
finishes the exchange and adds the face term (the reference gets the same
schedule from an ``optimization_barrier`` between the exchange-independent
base and the face correction).  The spans ``pps.halo.exchange_start`` and
``pps.halo.exchange_finish`` (``utils.profiling.span``, host spans) mark the
two ends of the exchange in a ``torch.profiler`` trace taken with spans on
(``profiling.trace``, or ``profiling.enable()``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..domain import parent_slots
from ..gmg import kron_to
from ..ops import patch_sweep
from ..ops.ghost_stencil import add_ghost_faces
from ..ops.level_ops import (_STENCIL, Level, _build_contrib_pipeline,
                             _build_solver_tables, extract_faces, np_dtype)
from ..utils.profiling import span
from .rank_block import RankBlock
from .sharding import Comm


class Exchange:
    """Per-offset point-to-point exchange of entity rows over the mesh.

    ``sends[(q, r)]`` is an ordered list of *sender-local* row ids that
    rank ``q`` must deliver to rank ``r``.  Rows land on the receiver in a
    deterministic buffer layout: ``[local rows | offset d0 rows | offset
    d1 rows | ... | zero pad row]``; ``recv_index(r, q, row)`` returns the
    receiver-buffer position of a sent row.  ``offsets``, ``send_tbl``
    (per offset ``[k, Rd]``, padded with the zero row's index), ``widths``
    and ``comm_rows`` (the true, unpadded row count) are the reference's
    tables.  Each batch is one ``Comm.exchange_start`` /
    ``exchange_finish``."""

    def __init__(self, comm: Comm, n_local_rows: int,
                 sends: Dict[Tuple[int, int], List[int]]):
        self.comm = comm
        ndev = self.ndev = comm.size
        self.n_local = n_local_rows
        offsets = sorted({(r - q) % ndev for (q, r) in sends if sends[(q, r)]})
        self.offsets = offsets
        self.send_tbl: List[np.ndarray] = []  # per offset: [ndev, Rd]
        self.widths: List[int] = []
        self._pos: Dict[Tuple[int, int, int], int] = {}
        base = n_local_rows
        self.comm_rows = 0
        for d in offsets:
            Rd = max(len(sends.get((q, (q + d) % ndev), [])) for q in range(ndev))
            tbl = np.full((ndev, Rd), n_local_rows, dtype=np.int32)  # pad->zero row
            for q in range(ndev):
                rows = sends.get((q, (q + d) % ndev), [])
                self.comm_rows += len(rows)
                tbl[q, : len(rows)] = rows
                for k, row in enumerate(rows):
                    self._pos[((q + d) % ndev, q, row)] = base + k
            self.send_tbl.append(tbl)
            self.widths.append(Rd)
            base += Rd
        self.buf_rows = base  # before the final zero row
        self._send_idx = [torch.as_tensor(t[comm.rank].astype(np.int64), device=comm.device)
                          for t in self.send_tbl]

    def recv_index(self, r: int, q: int, row: int) -> int:
        """Receiver-buffer position of sender ``q``'s local ``row`` on ``r``."""
        return self._pos[(r, q, row)]

    def start(self, local: torch.Tensor):
        """Post every offset's exchange of ``local``'s send rows; what
        :meth:`finish` takes.  Every rank of the group must call both."""
        pending = []
        if self.offsets:
            zero = local.new_zeros((1,) + tuple(local.shape[1:]))
            local_pad = torch.cat([local, zero], dim=0)
            pending = [self.comm.exchange_start(local_pad.index_select(0, idx), d)
                       for d, idx in zip(self.offsets, self._send_idx)]
        return local, pending

    def finish(self, started) -> torch.Tensor:
        """The combined buffer ``[local | recv_d0 | ... | zero row]`` (shape
        ``[buf_rows + 1, ...]``) of an exchange :meth:`start` posted."""
        local, pending = started
        zero = local.new_zeros((1,) + tuple(local.shape[1:]))
        return torch.cat([local] + [self.comm.exchange_finish(p) for p in pending]
                         + [zero], dim=0)

    def run(self, local: torch.Tensor) -> torch.Tensor:
        """Exchange and return the combined buffer (:meth:`finish`)."""
        return self.finish(self.start(local))


def _shard_of(P: int, ndev: int) -> np.ndarray:
    assert P % ndev == 0, f"pad the level first: P={P} % {ndev} != 0"
    return np.arange(P) // (P // ndev)


class ShardedLevel(RankBlock):
    """Level ops over a 1D mesh with explicit cut-face halo exchange.

    Drop-in for :class:`~pressurepoissonsolver_torch.ops.level_ops.Level`
    inside GMG cycles and Krylov loops on this rank's ``[P/k, *ns]`` block
    (``apply``, ``smooth``, ``smooth_zero``, the Schur ops, ``zeros``,
    ``integrate``).  ``level`` is the global level, whose tables are read
    here; build it on the host (``device="cpu"``) and pass this rank's
    ``device``: only this rank's rows and tables go to the device, so a
    rank's device memory shrinks with the rank count.  Interface vectors
    are this rank's block ``[max(NOg, 1), m]`` of the owner layout ``[k *
    max(NOg, 1), m]`` (owner = the lowest reader rank, the reference's
    lower-side ownership, ``SchurInfo.h:141-150``)."""

    def __init__(self, level: Level, mesh, device=None):
        super().__init__(level, mesh, device)
        comm, ndev, me = self.comm, self.ndev, self.me
        lvl, t = level, level.tables
        D, n, m, S2 = self.D, self.n, self.m, 2 * self.D
        Pg, Pl = self.P, self.Pl
        shard_of = _shard_of(Pg, ndev)
        # face rows per patch (higher-order closures source inner faces too)
        fd = self.face_depth
        S2f = S2 * fd

        # ---- contribution bookkeeping (case-sorted, as the reference) -----
        order = np.argsort(t.contrib_case, kind="stable")
        c_patch = t.contrib_patch[order]
        c_side = t.contrib_side[order]
        c_iface = t.contrib_iface[order]
        c_case = t.contrib_case[order]
        C = len(c_patch)

        # readers of each interface = ranks of patches whose own-side
        # interface it is (every patch reads only its own side interfaces)
        readers: Dict[int, set] = {}
        for p in range(Pg):
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    readers.setdefault(int(t.iface_side_idx[p, s]), set()).add(
                        int(shard_of[p]))

        # cut faces: remote contributions' (patch, side) face rows, dedup per
        # (sender, receiver, face row)
        sends: Dict[Tuple[int, int], List[int]] = {}
        sent: set = set()
        for c in range(C):
            p, s = int(c_patch[c]), int(c_side[c])
            q = int(shard_of[p])
            local_row = (p - q * Pl) * S2f + s
            for r in readers.get(int(c_iface[c]), ()):
                if r == q or (q, r, local_row) in sent:
                    continue
                sent.add((q, r, local_row))
                sends.setdefault((q, r), []).append(local_row)
        for v in sends.values():
            v.sort()
        self.exchange = Exchange(comm, Pl * S2f, sends)
        self.comm_rows = self.exchange.comm_rows

        # ---- per-rank needed interfaces -------------------------------------
        need: List[List[int]] = [[] for _ in range(ndev)]
        for i, rs in sorted(readers.items()):
            for r in rs:
                need[r].append(i)
        loc_of = [{i: k for k, i in enumerate(lst)} for lst in need]
        self.NIg = NIg = max((len(lst) for lst in need), default=0)
        ni_me = len(need[me])  # the zero row of this rank's gamma_pad

        # ---- interface (gamma) ownership -----------------------------------
        owner = {i: min(rs) for i, rs in readers.items()}
        owned = [[i for i in need[r] if owner[i] == r] for r in range(ndev)]
        self._owned_ids = owned
        self.NOg = max((len(o) for o in owned), default=0)
        NOg = self._gamma_rows = max(self.NOg, 1)
        own_pos = np.full((ndev, NOg), max(NIg, 1), dtype=np.int32)  # pad row
        gslot: Dict[int, int] = {}
        for r in range(ndev):
            for k, i in enumerate(owned[r]):
                own_pos[r, k] = loc_of[r][i]
                gslot[i] = k
        self._own_pos = own_pos
        # exchange of owned gamma rows to their remote readers
        gsends: Dict[Tuple[int, int], List[int]] = {}
        for i, rs in sorted(readers.items()):
            q = owner[i]
            for r in rs:
                if r != q:
                    gsends.setdefault((q, r), []).append(gslot[i])
        for v in gsends.values():
            v.sort()
        self.ex_gamma = Exchange(comm, NOg, gsends)
        # per-patch-side position in the gamma exchange buffer
        gifidx = np.full((ndev, Pl, S2), self.ex_gamma.buf_rows, dtype=np.int32)
        # per-patch-side needed-interface slots (+ mask)
        ifidx = np.full((ndev, Pl, S2), max(NIg, 1), dtype=np.int32)
        imask = np.zeros((ndev, Pl, S2), dtype=bool)
        for p in range(Pg):
            r = int(shard_of[p])
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    i = int(t.iface_side_idx[p, s])
                    q = owner[i]
                    gifidx[r, p - r * Pl, s] = (
                        gslot[i] if q == r
                        else self.ex_gamma.recv_index(r, q, gslot[i]))
                    ifidx[r, p - r * Pl, s] = loc_of[r][i]
                    imask[r, p - r * Pl, s] = True
        self._gifidx, self._ifidx, self._imask = gifidx, ifidx, imask

        def up(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64,
                                   device=self.device)

        # this rank's rows, the masked and pad entries on the zero row
        op = own_pos[me].astype(np.int64)
        op[np.arange(NOg) >= len(owned[me])] = ni_me
        self._own_pos_me = up(op)
        self._gifidx_me = up(gifidx[me].reshape(-1))
        self._ifidx_me = np.where(imask[me], ifidx[me], ni_me)  # [Pl, S2]

        # ---- this rank's trace-interpolation pipeline over the exchange
        # buffer: contributions (buffer row, needed interface, case) ---------
        def buffer_row(p, s):
            q = int(shard_of[p])
            row = (p - q * Pl) * S2f + s
            return row if q == me else self.exchange.recv_index(me, q, row)

        def pipeline(keep, loc, num):
            if not num:
                return None
            rows, ifs, cases = [], [], []
            for c in range(C):
                i = int(c_iface[c])
                if me in readers.get(i, ()) and keep(i):
                    rows.append(buffer_row(int(c_patch[c]), int(c_side[c])))
                    ifs.append(loc[i])
                    cases.append(int(c_case[c]))
            return _build_contrib_pipeline(
                np.asarray(rows, dtype=np.int64), np.zeros(len(rows), dtype=np.int64),
                np.asarray(cases, dtype=np.int64), np.asarray(ifs, dtype=np.int64),
                num, lvl._case_T, lvl._case_scalar, self.dtype, 1,
                self.exchange.buf_rows, self.device)

        self._pipe = pipeline(lambda i: True, loc_of[me], ni_me)

        # ---- direct gf tables (apply/smooth fast path) ---------------------
        # As Level._build_gf_tables: on a same-level interface the ghost is
        # the neighbour's boundary value, gf = 0.5*own + 0.5*nbr, where the
        # nbr face row is already in the cut-face exchange buffer; only the
        # refinement-boundary interfaces run the contribution pipeline.
        by_if: Dict[int, List[int]] = {}
        for c in range(C):
            by_if.setdefault(int(c_iface[c]), []).append(c)
        g_readers: Dict[int, List[Tuple[int, int]]] = {}
        for p in range(Pg):
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    g_readers.setdefault(int(t.iface_side_idx[p, s]), []).append((p, s))
        direct: Dict[int, List[int]] = {}
        for i, lst in by_if.items():
            if len(lst) != 2 or len(g_readers.get(i, ())) != 2:
                continue
            ok = all(lvl._case_scalar[int(c_case[c])] == 0.5
                     and int(c_side[c]) % fd == 0 for c in lst)
            crows = {int(c_patch[c]) * S2f + int(c_side[c]) for c in lst}
            orows = {p * S2f + s * fd for p, s in g_readers[i]}
            if ok and crows == orows:
                direct[i] = lst
        need_ref = [[i for i in lst if i not in direct] for lst in need]
        loc_ref = [{i: k for k, i in enumerate(lst)} for lst in need_ref]
        self.NRg = max((len(lst) for lst in need_ref), default=0)
        self._ref_pipe = pipeline(lambda i: i not in direct, loc_ref[me],
                                  len(need_ref[me]))
        # per-side source into [buf | gamma_ref], masked sides on the
        # buffer's zero row
        buf_zero = self.exchange.buf_rows
        gfsrc = np.full((ndev, Pl, S2), buf_zero, dtype=np.int32)
        gfw_own = np.zeros((ndev, Pl, S2, 1))
        gfw_mix = np.zeros((ndev, Pl, S2, 1))
        for p in range(Pg):
            r = int(shard_of[p])
            pl_ = p - r * Pl
            for s in range(S2):
                if not t.iface_side_mask[p, s]:
                    continue
                i = int(t.iface_side_idx[p, s])
                if i in direct:
                    own_row = pl_ * S2f + s * fd
                    rows = []
                    for c in direct[i]:
                        cp, cs = int(c_patch[c]), int(c_side[c])
                        q = int(shard_of[cp])
                        lr = (cp - q * Pl) * S2f + cs
                        rows.append(lr if q == r else self.exchange.recv_index(r, q, lr))
                    rows.remove(own_row)
                    gfsrc[r, pl_, s] = rows[0]
                    gfw_own[r, pl_, s] = 0.5
                    gfw_mix[r, pl_, s] = 0.5
                else:
                    gfsrc[r, pl_, s] = buf_zero + 1 + loc_ref[r][i]
                    gfw_mix[r, pl_, s] = 1.0
        self._gfsrc, self._gfw_own, self._gfw_mix = gfsrc, gfw_own, gfw_mix
        npdt = np_dtype(self.dtype)
        self._gfsrc_me = up(gfsrc[me].reshape(-1))
        self._gfw_own_me = torch.as_tensor(gfw_own[me].astype(npdt), device=self.device)
        self._gfw_mix_me = torch.as_tensor(gfw_mix[me].astype(npdt), device=self.device)


    # -- this rank's pieces ----------------------------------------------------

    def _interp_local(self, u: torch.Tensor) -> torch.Tensor:
        """Exchange the cut faces and compute the interfaces this rank
        reads, with a zero row appended: ``[NI + 1, m]``."""
        faces = extract_faces(u, self.D, self.n, self.face_depth).reshape(-1, self.m)
        buf = self.exchange.run(faces)
        zero = u.new_zeros(1, self.m)
        if self._pipe is None:
            return zero
        return torch.cat([self._pipe.interpolate_rows(buf), zero], dim=0)

    def _gf_direct_parts(self, u: torch.Tensor):
        """``(w_mix * mix, own)`` of the direct pipeline, both ``[Pl, 2D,
        m]``: direct sides read the neighbour face row straight from the
        exchange buffer; refinement sides run the compact pipeline."""
        faces = extract_faces(u, self.D, self.n, self.face_depth)
        buf = self.exchange.run(faces.reshape(-1, self.m))
        own = faces.reshape(self.Pl, 2 * self.D, self.face_depth, self.m)[:, :, 0]
        return self._mix_scaled(buf), own

    def _mix_scaled(self, buf: torch.Tensor) -> torch.Tensor:
        """``w_mix * mix`` ``[Pl, 2D, m]`` from the cut-face exchange
        buffer."""
        srcs = [buf]
        if self._ref_pipe is not None:
            srcs.append(self._ref_pipe.interpolate_rows(buf))
        mix = torch.cat(srcs, dim=0).index_select(0, self._gfsrc_me)
        return self._gfw_mix_me.to(buf.dtype) * mix.reshape(self.Pl, 2 * self.D, self.m)

    def _gf_from_gamma(self, gamma: torch.Tensor) -> torch.Tensor:
        """``[Pl, 2D, m]`` traces from this rank's owned-gamma block
        (remote-owned rows exchanged point to point)."""
        buf = self.ex_gamma.run(gamma)
        return buf.index_select(0, self._gifidx_me).reshape(self.Pl, 2 * self.D, self.m)

    # -- the level ops on this rank's block -------------------------------------

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Composite operator with the cut-face exchange, through the
        ghost-stencil kernel (own-face term folded into ``ghost_coef_eff``,
        as ``Level.apply``).

        With more than one rank the exchange overlaps the stencil, as the
        reference's ``_stencil_local`` (an exchange-independent base, an
        ``optimization_barrier``, the face correction): the faces are
        extracted, every offset's exchange is started, the kernel runs in
        its no-gf mode (ghost ``coef_eff * u_b``) on this rank's rows while
        the exchange is in flight, then the exchange is finished, the
        contribution pipeline runs and ``2 h^-2 w_mix mix`` is added on the
        boundary cells.  One rank keeps the single fused launch: there is
        nothing to overlap."""
        u = u.contiguous()
        coef, h2 = self.ghost_coef_eff.to(u.dtype), self.h2inv.to(u.dtype)
        if self.ndev == 1:
            mix_scaled, _ = self._gf_direct_parts(u)
            return _STENCIL[self.D](u, mix_scaled, coef, h2)
        faces = extract_faces(u, self.D, self.n, self.face_depth)
        with span("pps.halo.exchange_start", device=False):
            started = self.exchange.start(faces.reshape(-1, self.m))
        out = _STENCIL[self.D](u, None, coef, h2)
        with span("pps.halo.exchange_finish", device=False):
            buf = self.exchange.finish(started)
        return add_ghost_faces(out, self._mix_scaled(buf), h2)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One block-Jacobi sweep of spectral patch solves."""
        mix_scaled, own = self._gf_direct_parts(u)
        return self.sweep(f, self._gfw_own_me.to(u.dtype) * own + mix_scaled)

    # -- the Schur path on the owner-sharded interface vector -----------------

    def gamma_global(self, gamma: torch.Tensor) -> np.ndarray:
        """Every rank's owned block -> the single-device ``[NIf, m]``
        layout, on the host (an all-gather; every rank must call it)."""
        NOg = max(self.NOg, 1)
        g = self.comm.all_gather(gamma).cpu().numpy()
        out = np.zeros((self.base.num_ifaces, self.m), dtype=g.dtype)
        for r, ids in enumerate(self._owned_ids):
            for k, i in enumerate(ids):
                out[i] = g[r * NOg + k]
        return out

    def interpolate(self, u: torch.Tensor) -> torch.Tensor:
        """Trace interpolation into this rank's owned-gamma block."""
        return self._interp_local(u).index_select(0, self._own_pos_me)

    def fold_gamma(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Ghost injection ``f - G gamma``."""
        return self._fold(f, self._gf_from_gamma(gamma.to(f.dtype)))

    def active_smoother(self, active: np.ndarray, build_solver: bool = True):
        """The FAC active-set smoother of this level (``build_solver`` is
        :class:`~pressurepoissonsolver_torch.ops.level_ops.Level`'s
        signature: a rank builds only its own active patches' tables)."""
        return ShardedActiveSmoother(self, active)


class ShardedActiveSmoother:
    """FAC active-set smoothing on a :class:`ShardedLevel`: each rank
    solves only its own active patches (its own count: ranks need not run
    same-shaped programs here).  The interface values come from the
    level's cut-face exchange, so cross-rank trace sources need no extra
    bookkeeping.  The sharded counterpart of
    ``ops.level_ops.ActiveSmoother``."""

    def __init__(self, sl: ShardedLevel, active: np.ndarray):
        self.sl = sl
        D, n, m, Pl = sl.D, sl.n, sl.m, sl.Pl
        self.D, self.n, self.m = D, n, m
        act = np.where(np.asarray(active, dtype=bool)[sl._rows])[0].astype(np.int64)
        self.Pa = len(act)
        dev = sl.device
        self._act = torch.as_tensor(act, device=dev)
        inv = np.full(Pl, self.Pa, dtype=np.int64)  # pad row: untouched
        inv[act] = np.arange(self.Pa)
        mask = np.zeros(Pl, dtype=bool)
        mask[act] = True
        self._route = patch_sweep.Route(
            self._act, torch.as_tensor(inv, device=dev),
            torch.as_tensor(mask.reshape((Pl,) + (1,) * D), device=dev))
        self._gfi = torch.as_tensor(sl._ifidx_me[act].reshape(-1).astype(np.int64),
                                    device=dev)
        self._h2a = sl.h2inv.index_select(0, self._act)
        self._coefa = sl.ghost_coef.index_select(0, self._act)
        self._st = _build_solver_tables(sl.pl, sl.dtype, act + sl._rows.start, dev)

    def _gf_act(self, u: torch.Tensor) -> torch.Tensor:
        """``[Pa, 2D, m]`` traces of the active patches (the exchange runs on
        every rank, active patches or not)."""
        gamma_pad = self.sl._interp_local(u)
        return gamma_pad.index_select(0, self._gfi).reshape(self.Pa, 2 * self.D, self.m)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One sweep of this rank's active patches from ``u``, which its
        other patches keep (``patch_sweep.sweep``)."""
        return patch_sweep.sweep(self._st, f, self._gf_act(u), self._h2a, self._route, u)

    def smooth_zero(self, f: torch.Tensor) -> torch.Tensor:
        return patch_sweep.sweep(self._st, f, None, self._h2a, self._route)

    def apply_scattered(self, u: torch.Tensor) -> torch.Tensor:
        """``A u`` on the active subset, through the ghost-stencil kernel,
        scattered into zeros (see ``ActiveSmoother.apply_scattered`` for
        the exactness condition)."""
        gf = self._gf_act(u)
        if not self.Pa:
            return torch.zeros_like(u)
        out = _STENCIL[self.D](u.index_select(0, self._act), gf,
                               self._coefa.to(u.dtype), self._h2a.to(u.dtype))
        return patch_sweep._scatter(out, self._route, None)


class ShardedTransfer:
    """GMG restriction/prolongation with per-offset parent/child exchange.

    Mirrors :class:`~pressurepoissonsolver_torch.gmg.Transfer`
    (cell-average restriction; constant or linear prolongation; pass-through
    copies); parent/child pairs on different ranks move pooled child blocks
    (restriction: ``(n/2)^D`` values per child) or whole parent patches
    (prolongation) point to point."""

    def __init__(self, transfer, fine: ShardedLevel, coarse: ShardedLevel):
        self.t = transfer
        self.fine, self.coarse = fine, coarse
        self.mesh = fine.mesh
        comm = fine.comm
        ndev, me = fine.ndev, fine.me
        D, n = fine.D, fine.n
        self.D, self.n = D, n
        Pf, Pc = fine.P, coarse.P
        Pfl, Pcl = fine.Pl, coarse.Pl
        self.Pcl = Pcl
        fshard = _shard_of(Pf, ndev)
        cshard = _shard_of(Pc, ndev)
        pslots = parent_slots(fine.pl, coarse.pl)
        passthrough = fine.pl.orth_on_parent < 0
        orth = fine.pl.orth_on_parent
        self.prolong_mode = transfer.prolong_mode
        dev = fine.device
        self._wprol = [w.to(dev) for w in transfer._wprol]
        self._Wp = kron_to(transfer._Wp, dev)

        def up(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        # ---- restriction: children/pass-through -> parent rank ------------
        sends_pool: Dict[Tuple[int, int], List[int]] = {}
        sends_full: Dict[Tuple[int, int], List[int]] = {}
        child_info = []  # (fine slot, parent slot, orth, passthrough)
        for i in range(Pf):
            ps = pslots[i]
            if ps < 0:
                continue
            q, r = int(fshard[i]), int(cshard[ps])
            if q != r:
                lst = (sends_full if passthrough[i] else sends_pool).setdefault((q, r), [])
                if (i - q * Pfl) not in lst:
                    lst.append(i - q * Pfl)
            child_info.append((i, int(ps), int(orth[i]), bool(passthrough[i])))
        for v in (*sends_pool.values(), *sends_full.values()):
            v.sort()
        self.ex_pool = Exchange(comm, Pfl, sends_pool)
        self.ex_full = Exchange(comm, Pfl, sends_full)
        self.comm_rows = self.ex_pool.comm_rows + self.ex_full.comm_rows

        # coarse-side assembly tables (the buffers' zero rows where none)
        child_src = np.full((ndev, Pcl, 1 << D), self.ex_pool.buf_rows, dtype=np.int32)
        pt_src = np.full((ndev, Pcl), self.ex_full.buf_rows, dtype=np.int32)
        for i, ps, o, pt in child_info:
            q, r = int(fshard[i]), int(cshard[ps])
            ex = self.ex_full if pt else self.ex_pool
            src = (i - q * Pfl) if q == r else ex.recv_index(r, q, i - q * Pfl)
            if pt:
                pt_src[r, ps - r * Pcl] = src
            else:
                child_src[r, ps - r * Pcl, o] = src
        self._child_src, self._pt_src = child_src, pt_src
        self._child_src_me = [up(child_src[me, :, o]) for o in range(1 << D)]
        self._pt_src_me = up(pt_src[me])

        # ---- prolongation: parent patches -> child ranks -------------------
        sends_par: Dict[Tuple[int, int], List[int]] = {}
        for i, ps, o, pt in child_info:
            q, r = int(cshard[ps]), int(fshard[i])
            if q != r:
                lst = sends_par.setdefault((q, r), [])
                if (ps - q * Pcl) not in lst:
                    lst.append(ps - q * Pcl)
        for v in sends_par.values():
            v.sort()
        self.ex_par = Exchange(comm, Pcl, sends_par)
        self.comm_rows += self.ex_par.comm_rows

        # this rank's fine patches per orthant (then pass-through): their
        # parents' rows in the parent buffer, and the inverse routing of
        # the stacked blocks to fine slots (pad -> the zero row)
        groups: Dict[object, List[Tuple[int, int]]] = {o: [] for o in range(1 << D)}
        groups[None] = []
        for i, ps, o, pt in child_info:
            if int(fshard[i]) != me:
                continue
            q = int(cshard[ps])
            src = (ps - q * Pcl) if q == me else self.ex_par.recv_index(me, q, ps - q * Pcl)
            groups[None if pt else o].append((src, i - me * Pfl))
        self._pseg = []
        inv = np.zeros(Pfl, dtype=np.int64)
        stacked = 0
        for o in list(range(1 << D)) + [None]:
            if not groups[o]:
                continue
            self._pseg.append((o, up([s for s, _ in groups[o]])))
            for j, (_, tgt) in enumerate(groups[o]):
                inv[tgt] = stacked + j + 1
            stacked += len(groups[o])
        # row 0 of the stacked blocks is the zero row the other slots read
        self._pinv = up(inv)

    def restrict(self, fine_u: torch.Tensor) -> torch.Tensor:
        """Pool each child locally to ``(n/2)^D`` cell averages, send the
        pooled blocks to their parents' ranks and place each into its
        orthant; pass-through patches copy through."""
        D, n = self.D, self.n
        h = n // 2
        cells = n ** D
        shape = [fine_u.shape[0]]
        for _ in range(D):
            shape += [h, 2]
        pooled = fine_u.reshape(shape).mean(dim=tuple(range(2, 2 * D + 2, 2)))
        pbuf = self.ex_pool.run(pooled.reshape(-1, h ** D))
        fbuf = self.ex_full.run(fine_u.reshape(-1, cells))
        out = fbuf.index_select(0, self._pt_src_me).reshape((self.Pcl,) + (n,) * D)
        for o, src in enumerate(self._child_src_me):
            blk = pbuf.index_select(0, src).reshape((self.Pcl,) + (h,) * D)
            region = [slice(None)] * (D + 1)
            for a in range(D):
                half = (o >> a) & 1
                region[1 + (D - 1 - a)] = slice(half * h, (half + 1) * h)
            out[tuple(region)] += blk
        return out

    def prolong_add(self, coarse_u: torch.Tensor, fine_u: torch.Tensor) -> torch.Tensor:
        """Prolongation (constant or linear, the wrapped transfer's
        matrices) from the exchanged parent patches, added into ``fine_u``."""
        cells = self.n ** self.D
        t = self.t
        buf = self.ex_par.run(coarse_u.reshape(-1, cells))
        parts = [buf.new_zeros(1, cells)]
        for o, src in self._pseg:
            rows = buf.index_select(0, src)
            parts.append(rows if o is None else t._orthant_apply(rows, o, self._wprol, self._Wp))
        if len(parts) == 1:
            return fine_u
        routed = torch.cat(parts, dim=0).index_select(0, self._pinv)
        return fine_u + routed.reshape(fine_u.shape)


class HaloApply:
    """The cut-face sharded composite-operator apply as a callable."""

    def __init__(self, level: Level, mesh, device=None):
        self.sharded = ShardedLevel(level, mesh, device)
        self.level = level
        self.mesh = mesh

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.sharded.apply(u)

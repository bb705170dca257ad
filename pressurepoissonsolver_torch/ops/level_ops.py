"""Batched per-level operations (2D and 3D) in PyTorch.

One :class:`Level` holds the index tables and spectral data of one
refinement level, built in numpy and uploaded once, and exposes the
main-path linear maps batched over the leading patch axis:

* ``apply(u) -> A u`` — the composite-grid operator
  (``SchurHelper.h:360-376``): boundary faces, the neighbour-face halo and
  the refinement-boundary interpolation feed the ghost-closure stencil
  kernel of the level's dimension (:mod:`.ghost_stencil`).
* ``smooth(f, u)`` / ``smooth_zero(f)`` — one block-Jacobi sweep of exact
  spectral patch solves (``SchurHelper::solveWithSolution``), through
  :func:`.patch_sweep.sweep` (a CUDA kernel on a 2D level on the card).
* The Schur path: ``interpolate(u) -> gamma`` (trace interpolation onto
  the interface vector ``[NIf, m]``), ``gamma_faces``,
  ``apply_with_interface(u, gamma)`` (the stencil with explicit interface
  values, through the same kernel), ``fold_gamma``, ``patch_solve(f,
  gamma)`` and the matrix-free Schur operator ``schur_S``.

:class:`ActiveSmoother` is the FAC active-set form of the sweep on a
static subset of patches.

The per-side traces that the apply and the sweeps read (``gf[P, 2D, m]``)
are built on a 2D level on the card by one launch of the trace kernel
(:mod:`.traces`), elsewhere by the plain chain ``_gf_parts`` /
``_gf_faces`` (and ``ActiveSmoother._gamma_faces``).

Port of ``pressurepoissonsolver_tpu.ops.level_ops``.  Layout: fields
``[P, ny, nx]`` or ``[P, nz, ny, nx]`` (x fastest), face vectors
``[P, 2D, m]`` with ``m = n**(D-1)``; index tables are int64.  The f32
spectral solves take the reference's flat Kronecker form at ``n <=``
:func:`kron_max_n` (``PPS_KRON_MAX_N``).  TPU-only forms of the reference
are not carried: the one-hot placement fold and the refined-f32 f64 patch
solve (the H100 has native f64).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import iface as iface_mod
from ..domain import PatchLevel
from ..matrix import _dense_case_templates
from ..utils import counters, profiling
from . import patch_sweep, traces
from . import transforms as tr
from .ghost_stencil import ghost_stencil, ghost_stencil_3d
from .patch_bcgs import PatchBicgstab
from .patch_sweep import _arr_axis, _fold_faces_flat, _spectral_apply

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}
# the ghost-closure stencil kernel of each dimension
_STENCIL = {2: ghost_stencil, 3: ghost_stencil_3d}
#: ``Level.patch_solve`` calls (``passes``, each over every patch of its
#: level) and the patches they solved, on every device; a captured piece's
#: are added per replay and per pass of a graph launch, as the kernels'
#: launch counters are (the table ``level_ops.patch_solves`` of
#: ``utils.counters``)
solved = counters.table("level_ops.patch_solves", ("passes", "patches"))


def patch_solves() -> dict:
    """A copy of :data:`solved`, after the counts of a graph launch not
    read yet (``utils.counters.flush``)."""
    counters.flush()
    return dict(solved)


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a floating torch dtype."""
    return _NP_DTYPE[dtype]


def kron_max_n() -> int:
    """Largest patch size whose f32 spectral patch solves and grid transfers
    take the flat Kronecker form: one ``[n^2, n^2]`` matmul on ``[P, n^2]``
    rows for each (y, x) pair of per-axis matmuls, 2n^2 flops per cell
    where the pair costs 4n.  ``PPS_KRON_MAX_N`` (default
    16, the reference's; 0 turns the forms off), read when the tables are
    built."""
    return int(os.environ.get("PPS_KRON_MAX_N", "16"))


def extract_faces(u: torch.Tensor, D: int, n: int, depth: int = 1) -> torch.Tensor:
    """Boundary-cell traces: ``[P, 2D*depth, m]`` with ``m = n**(D-1)``
    (row order ``side * depth + d``, ``d`` cells inward)."""
    P = u.shape[0]
    faces = []
    for a in range(D):
        ax = _arr_axis(D, a)
        for d in range(depth):
            faces.append(u.select(ax, d).reshape(P, -1))
        for d in range(depth):
            faces.append(u.select(ax, n - 1 - d).reshape(P, -1))
    return torch.stack(faces, dim=1)


@dataclass(frozen=True)
class _SolveGroup:
    """Static metadata of one BC-homogeneous patch-solver batch."""

    start: int
    stop: int
    fwd_kinds: Tuple[int, ...]  # per spatial axis
    inv_kinds: Tuple[int, ...]
    pin_dc: bool  # all-Neumann nullspace pin (FftwPatchSolver.h:197)


@dataclass
class _SolverTables:
    """Spectral patch-solve data for a (subset of a) level, BC-sorted."""

    perm: torch.Tensor  # [Ps] int64
    inv_perm: torch.Tensor
    identity_perm: bool
    # factored per-axis eigenvalue rows (host, f64) and, per sorted slot
    # and axis, the row it uses; ``denom`` is their per-cell sum, taken in
    # f64 and cast afterwards (``_denom_of``), materialized once at setup
    lam_tab: np.ndarray  # [K, n] f64
    lam_idx: np.ndarray  # [Ps, D] int64
    denom: torch.Tensor  # [Ps, *ns] in the table dtype
    groups: List[_SolveGroup]
    tmats: dict  # transform kind -> [n, n] tensor
    # f32 at n <= kron_max_n(): per group, the transforms in Kronecker
    # form, 2D (W1, W2) with W1 = kron(Tf_y, Tf_x)^T and W2 the inverse pair
    # times (2/n)^D, so a patch solve is two matmuls on [Ps, n^2] rows;
    # 3D (W1, W2, Tz1, Tz2), the (y, x) pair plus the z-axis transforms
    kron: Optional[list] = None
    # on a card, at a patch size the sweep kernel is built for: its tables
    # (``patch_sweep.SweepTables``)
    sweep: Optional[patch_sweep.SweepTables] = None


def _denom_of(lam_tab: np.ndarray, lam_idx: np.ndarray, D: int, n: int,
              dtype: torch.dtype) -> np.ndarray:
    """The ``[Ps, *ns]`` eigen-denominator from the factored per-axis
    rows: summed in f64 in the reference's order, cast after (its bit
    pattern)."""
    Ps = lam_idx.shape[0]
    rows = lam_tab[lam_idx.reshape(-1)].reshape(Ps, D, n)
    if D == 2:
        dn = rows[:, 1][:, :, None] + rows[:, 0][:, None, :]  # [Ps, y, x]
    else:
        dn = (rows[:, 2][:, :, None, None]  # [Ps, z, y, x]
              + rows[:, 1][:, None, :, None]
              + rows[:, 0][:, None, None, :])
    return dn.astype(np_dtype(dtype))


def _build_solver_tables(pl: PatchLevel, dtype: torch.dtype, slots: np.ndarray,
                         device) -> _SolverTables:
    """BC-grouped spectral solver tables for patch slots ``slots`` (the
    reference's plan cache keyed on (neumann bits, h),
    ``FftwPatchSolver.h:33-47``, generalized to an arbitrary patch subset
    for the FAC active-set smoother), and the sweep kernel's tables where
    the level has the kernel (``patch_sweep.kernel_fits``)."""
    D, n = pl.D, pl.n
    Ps = len(slots)
    keys = []
    for p in slots:
        keys.append(tuple(
            tr.axis_transforms(bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1]))[:2]
            for a in range(D)
        ))
    order = sorted(range(Ps), key=lambda i: (keys[i], i))
    perm = np.array(order, dtype=np.int64)
    inv_perm = np.empty(Ps, dtype=np.int64)
    inv_perm[perm] = np.arange(Ps)

    lam_keys: dict = {}
    lam_rows: List[np.ndarray] = []
    lam_idx = np.zeros((Ps, D), dtype=np.int64)
    for i, si in enumerate(order):
        p = slots[si]
        for a in range(D):
            delta = tr.axis_transforms(
                bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1])
            )[2]
            hkey = (delta, float(pl.spacings[p, a]))
            k = lam_keys.get(hkey)
            if k is None:
                k = lam_keys[hkey] = len(lam_rows)
                lam_rows.append(tr.axis_eigenvalues(n, hkey[1], delta))
            lam_idx[i, a] = k
    lam_tab = np.stack(lam_rows) if lam_rows else np.zeros((1, n))

    groups: List[_SolveGroup] = []
    start = 0
    while start < Ps:
        stop = start
        k = keys[order[start]]
        while stop < Ps and keys[order[stop]] == k:
            stop += 1
        all_neu = bool(np.all(pl.neumann[slots[order[start]]]))
        groups.append(_SolveGroup(
            start=start, stop=stop,
            fwd_kinds=tuple(kk[0] for kk in k),
            inv_kinds=tuple(kk[1] for kk in k),
            pin_dc=all_neu,
        ))
        start = stop
    kinds_used = sorted({kk for g in groups for kk in g.fwd_kinds + g.inv_kinds})
    npdt = np_dtype(dtype)
    tmats = {
        kk: torch.as_tensor(tr.transform_matrix(kk, n).astype(npdt), device=device)
        for kk in kinds_used
    }
    kron = None
    if dtype == torch.float32 and n <= kron_max_n():
        # built in f64 and cast last, as the reference builds them
        def up(x):
            return torch.as_tensor(np.asarray(x, dtype=npdt), device=device)

        scale = (2.0 / n) ** D
        kron = []
        for g in groups:
            Tf = [tr.transform_matrix(k, n) for k in g.fwd_kinds]
            Ti = [tr.transform_matrix(k, n) for k in g.inv_kinds]
            mats = (up(np.kron(Tf[1], Tf[0]).T), up(np.kron(Ti[1], Ti[0]).T * scale))
            kron.append(mats if D == 2 else mats + (up(Tf[2]), up(Ti[2])))
    sweep = None
    if patch_sweep.kernel_fits(D, n, device):
        sweep = patch_sweep.sweep_tables(np.asarray(pl.neumann)[slots], lam_tab, lam_idx,
                                         inv_perm, n, dtype, device)
    return _SolverTables(
        perm=torch.as_tensor(perm, device=device),
        inv_perm=torch.as_tensor(inv_perm, device=device),
        identity_perm=bool(np.all(perm == np.arange(Ps))),
        lam_tab=lam_tab,
        lam_idx=lam_idx,
        denom=torch.as_tensor(_denom_of(lam_tab, lam_idx, D, n, dtype), device=device),
        groups=groups,
        tmats=tmats,
        kron=kron,
        sweep=sweep,
    )


@dataclass
class _ContribPipeline:
    """Trace-interpolation pipeline, gather form.

    Scalar-weighted contributions (normal/c2c — the bulk) are stored
    interface-major, padded to a uniform count ``Ks``, so the interface
    reduction is a multiply + sum with no scatter; the matmul contributions
    (refinement-boundary closures, in full precision) run case-sorted on
    their own compact interface set and are added back with one padded
    row gather.  Every gather is a row gather on the flattened
    ``[P*S2f, m]`` face table."""

    num_ifaces: int
    Ks: int
    idx_s: torch.Tensor  # [NIf*Ks] flat face-row ids (pad -> zero row)
    w_s: torch.Tensor  # [NIf, Ks, 1] scalar weights (0 on pads)
    idx_m: Optional[torch.Tensor]  # [Cm+1] flat face-row ids (last -> zero row)
    mm_W: Optional[torch.Tensor]  # [m, ncase_m*m] all case templates stacked
    mm_ncase: int
    Km: int
    mm_gather: Optional[torch.Tensor]  # [NIfm*Km] -> r*ncase+case (pad -> Cm*ncase)
    mm_inv: Optional[torch.Tensor]  # [NIf] -> compact mm row (pad -> NIfm)

    def interpolate(self, faces: torch.Tensor, m: int) -> torch.Tensor:
        """gamma[NIf, m] from per-patch face traces [P, 2D*depth, m]."""
        P, S2f = faces.shape[0], faces.shape[1]
        return self.interpolate_rows(
            torch.cat([faces.reshape(P * S2f, m), faces.new_zeros(1, m)], dim=0))

    def interpolate_rows(self, ffp: torch.Tensor) -> torch.Tensor:
        """gamma[NIf, m] from the flat source rows ``ffp [R+1, m]`` whose
        last row is zero (the pad row every table pads to)."""
        m = ffp.shape[1]
        gs = ffp.index_select(0, self.idx_s).reshape(self.num_ifaces, self.Ks, m)
        gamma = (gs * self.w_s.to(ffp.dtype)).sum(dim=1)
        if self.idx_m is not None:
            # all case templates in ONE [Cm, m] @ [m, ncase*m] matmul; the
            # per-row case selection is folded into the gather (row r,
            # case k -> r*ncase + k); the last idx_m entry reads the zero
            # face row, so row Cm*ncase is a guaranteed-zero pad
            gm = ffp.index_select(0, self.idx_m)  # [Cm+1, m]
            vals = torch.matmul(gm, self.mm_W.to(ffp.dtype)).reshape(
                gm.shape[0] * self.mm_ncase, m)
            sums = vals.index_select(0, self.mm_gather).reshape(-1, self.Km, m).sum(dim=1)
            sp = torch.cat([sums, sums.new_zeros(1, m)], dim=0)
            gamma = gamma + sp.index_select(0, self.mm_inv)
        return gamma


def _build_contrib_pipeline(
    contrib_patch: np.ndarray,
    contrib_side: np.ndarray,
    contrib_case: np.ndarray,
    contrib_iface: np.ndarray,
    num_ifaces: int,
    case_T: np.ndarray,
    case_scalar: list,
    dtype: torch.dtype,
    n_face_rows: int,
    num_src_patches: int,
    device,
) -> _ContribPipeline:
    flat = contrib_patch.astype(np.int64) * n_face_rows + contrib_side
    pad_row = num_src_patches * n_face_rows  # the appended zero row
    is_mm = np.array([case_scalar[int(k)] is None for k in contrib_case], dtype=bool)
    # scalar part: interface-major, padded to uniform Ks
    by_if = [[] for _ in range(num_ifaces)]
    for c in np.where(~is_mm)[0]:
        by_if[int(contrib_iface[c])].append(c)
    Ks = max((len(v) for v in by_if), default=1) or 1
    idx_s = np.full((num_ifaces, Ks), pad_row, dtype=np.int64)
    w_s = np.zeros((num_ifaces, Ks, 1))
    for i, v in enumerate(by_if):
        for k, c in enumerate(v):
            idx_s[i, k] = flat[c]
            w_s[i, k, 0] = case_scalar[int(contrib_case[c])]
    npdt = np_dtype(dtype)

    def up(x):
        return torch.as_tensor(x, device=device)

    idx_m = mm_W = mm_gather = mm_inv = None
    Km = ncase_m = 0
    mc = np.where(is_mm)[0]
    if len(mc):
        order = mc[np.lexsort((mc, contrib_case[mc]))]
        cs = contrib_case[order]
        cases_present = sorted(set(int(k) for k in cs))
        case_col = {k: j for j, k in enumerate(cases_present)}
        ncase_m = len(cases_present)
        W = np.concatenate([case_T[k].T for k in cases_present], axis=1)
        mm_if = np.unique(contrib_iface[order])
        remap = np.full(num_ifaces, -1, dtype=np.int64)
        remap[mm_if] = np.arange(len(mm_if))
        by_mm = [[] for _ in range(len(mm_if))]
        for r, c in enumerate(order):
            # row r of the merged matmul output, case block of c
            by_mm[int(remap[contrib_iface[c]])].append(
                r * ncase_m + case_col[int(contrib_case[c])]
            )
        Km = max(len(v) for v in by_mm)
        pad_val = len(order) * ncase_m  # the appended zero-source row
        gath = np.full((len(mm_if), Km), pad_val, dtype=np.int64)
        for i, v in enumerate(by_mm):
            gath[i, : len(v)] = v
        inv = np.full(num_ifaces, len(mm_if), dtype=np.int64)
        inv[mm_if] = np.arange(len(mm_if))
        idx_m = up(np.concatenate([flat[order], [pad_row]]).astype(np.int64))
        mm_W = up(np.asarray(W, dtype=npdt))
        mm_gather = up(gath.reshape(-1))
        mm_inv = up(inv)
    return _ContribPipeline(
        num_ifaces=num_ifaces,
        Ks=Ks,
        idx_s=up(idx_s.reshape(-1)),
        w_s=up(np.asarray(w_s, dtype=npdt)),
        idx_m=idx_m,
        mm_W=mm_W,
        mm_ncase=ncase_m,
        Km=Km,
        mm_gather=mm_gather,
        mm_inv=mm_inv,
    )


class Level:
    """Device tables + core ops for one 2D or 3D refinement level."""

    @profiling.spanned("pps.level.build", device=False)
    def __init__(self, patch_level: PatchLevel, dtype: torch.dtype = torch.float64,
                 *, device="cuda", iface_scheme: str = "bilinear",
                 patch_solver: str = "dft"):
        if patch_level.D not in _STENCIL:
            raise NotImplementedError(f"no {patch_level.D}D levels in the port")
        if patch_solver not in ("dft", "bcgs"):
            raise ValueError(f"patch_solver={patch_solver!r}: 'dft' or 'bcgs'")
        # "dft": exact spectral patch solves; "bcgs": batched per-patch
        # BiCGStab through the stencil kernel (the reference's
        # BiCGStabSolver fallback) in patch_solve, smooth and smooth_zero
        self.patch_solver_kind = patch_solver
        self._bcgs: dict = {}  # dtype -> PatchBicgstab (patch_solver="bcgs")
        self.pl = patch_level
        self.D = patch_level.D
        self.n = patch_level.n
        self.P = patch_level.num_patches
        self.dtype = dtype
        self.device = torch.device(device)
        self.m = self.n ** (self.D - 1)

        # the native generator's tables when the hierarchy built them
        # (bilinear only); else the Python builder's, which are the same
        t = getattr(patch_level, "prebuilt_iface_tables", None)
        if t is None or iface_scheme != "bilinear":
            t = iface_mod.build_iface_tables(patch_level, scheme=iface_scheme)
        self.tables = t
        self.num_ifaces = t.num_ifaces
        self.face_depth = t.face_depth
        npdt = np_dtype(dtype)

        # each case's (weights, source-index) template as a dense m×m
        # matrix; cases that are a scalar multiple of the identity (normal
        # = I/2, c2c = I/3 — the bulk) are applied as elementwise scalings
        ncase = t.case_w.shape[0]
        m = t.m
        case_T = _dense_case_templates(t)
        self._case_T = case_T  # host f64 [ncase, m, m]
        self._case_scalar = []
        for k in range(ncase):
            diag = np.diag(case_T[k])
            if np.allclose(case_T[k], np.diag(diag)) and np.allclose(diag, diag[0] if m else 0):
                self._case_scalar.append(float(diag[0]) if m else 0.0)
            else:
                self._case_scalar.append(None)

        # the Schur path's tables: the contribution pipeline over every
        # interface (interpolate) and the per-(patch, side) gamma routing,
        # masked sides to the zero pad row (gamma_faces)
        self._pipe = _build_contrib_pipeline(
            t.contrib_patch, t.contrib_side, t.contrib_case, t.contrib_iface,
            t.num_ifaces, case_T, self._case_scalar, dtype,
            2 * self.D * self.face_depth, self.P, self.device,
        )
        if_flat = np.asarray(t.iface_side_idx, dtype=np.int64).copy()
        if_flat[np.asarray(t.iface_side_mask) == 0] = t.num_ifaces
        self._iface_flat = torch.as_tensor(if_flat.reshape(-1), device=self.device)

        # direct gf pipeline: for a same-level interface the ghost closure
        # collapses to the neighbour's boundary value (the classic halo),
        # so only refinement-boundary interfaces need the contribution
        # pipeline (a compact one)
        self._build_gf_tables(t)
        # on a card, the trace kernel's tables (ops.traces): each build of
        # the apply's and the sweep's traces is one launch from u
        self._trace_pal = self._trace_apply = self._trace_sweep = None
        if traces.kernel_fits(self.D, self.n, self.face_depth, ncase, self.P, self.device):
            self._trace_pal = traces.palette(case_T, self._case_scalar, dtype,
                                             self.face_depth, self.device)
        if self._trace_pal is not None:
            every = np.arange(self.P)
            self._trace_apply = traces.trace_tables(
                t, every, self._trace_pal, own_dropped=self._gf_w_own_np[:, :, 0] == 0.5)
            self._trace_sweep = traces.trace_tables(t, every, self._trace_pal)

        # stencil coefficients
        h2inv = (1.0 / patch_level.spacings**2).astype(np.float64)
        self.h2inv = torch.as_tensor(h2inv.astype(npdt), device=self.device)  # [P, D]
        # ghost closure: ghost = c*u_b + 2*gamma; c=+1 Neumann, -1 otherwise
        coef = np.where(patch_level.neumann, 1.0, -1.0)
        self.ghost_coef = torch.as_tensor(coef.astype(npdt), device=self.device)
        # apply path: own-face gf term folded into the ghost closure
        # (ghost = (c + 2*w_own)*u_b + 2*w_mix*mix; 0 on direct sides);
        # operands cast to the table dtype first, then combined
        self.ghost_coef_eff = torch.as_tensor(
            np.asarray(coef, dtype=npdt)
            + np.asarray(2.0, dtype=npdt)
            * np.asarray(self._gf_w_own_np[:, :, 0], dtype=npdt),
            device=self.device,
        )
        self._cellvol = torch.as_tensor(
            np.prod(patch_level.spacings, axis=1), device=self.device)
        self._st = _build_solver_tables(
            patch_level, dtype, np.arange(self.P, dtype=np.int64), self.device
        )

    def _build_gf_tables(self, t) -> None:
        """Tables of the direct gf pipeline (see __init__)."""
        D, P = self.D, self.P
        S2 = 2 * D
        S2f = S2 * self.face_depth
        NR = P * S2f  # face-row count; combined source = [faces | gamma_ref | 0]
        by_iface: dict = {}
        for c in range(len(t.contrib_patch)):
            by_iface.setdefault(int(t.contrib_iface[c]), []).append(c)
        isidx = np.asarray(t.iface_side_idx)
        ismask = np.asarray(t.iface_side_mask)
        readers: dict = {}
        for p in range(P):
            for s in range(S2):
                if ismask[p, s]:
                    readers.setdefault(int(isidx[p, s]), []).append((p, s))
        # direct = exactly two scalar-0.5 contributions, each being the
        # boundary face row of one of the interface's two reader sides
        direct = {}
        for i, lst in by_iface.items():
            if len(lst) != 2 or len(readers.get(i, ())) != 2:
                continue
            ok = all(
                self._case_scalar[int(t.contrib_case[c])] == 0.5
                and int(t.contrib_side[c]) % self.face_depth == 0
                for c in lst
            )
            crows = {
                int(t.contrib_patch[c]) * S2f + int(t.contrib_side[c])
                for c in lst
            }
            orows = {
                p * S2f + s * self.face_depth for p, s in readers[i]
            }
            if ok and crows == orows:
                direct[i] = lst
        ref_ids = np.array(
            sorted(i for i in by_iface if i not in direct), dtype=np.int64
        )
        ref_remap = np.full(max(t.num_ifaces, 1), -1, dtype=np.int64)
        ref_remap[ref_ids] = np.arange(len(ref_ids))
        self._nref = len(ref_ids)
        self._gf_ref_ids = ref_ids  # interface of each compact ref row
        self._gf_ref_pipe = None
        if self._nref:
            keep = ref_remap[t.contrib_iface] >= 0
            self._gf_ref_pipe = _build_contrib_pipeline(
                t.contrib_patch[keep], t.contrib_side[keep],
                t.contrib_case[keep], ref_remap[t.contrib_iface[keep]],
                self._nref, self._case_T, self._case_scalar, self.dtype, S2f, P,
                self.device,
            )
        mix_idx = np.full((P, S2), NR + self._nref, dtype=np.int64)  # pad->0 row
        w_own = np.zeros((P, S2, 1))
        w_mix = np.zeros((P, S2, 1))
        for p in range(P):
            for s in range(S2):
                if not ismask[p, s]:
                    continue
                i = int(isidx[p, s])
                if i in direct:
                    own_row = p * S2f + s * self.face_depth
                    rows = [
                        int(t.contrib_patch[c]) * S2f + int(t.contrib_side[c])
                        for c in direct[i]
                    ]
                    if own_row in rows:
                        rows.remove(own_row)
                        mix_idx[p, s] = rows[0]
                        w_own[p, s] = 0.5
                        w_mix[p, s] = 0.5
                        continue
                # refinement (or irregular) side: gf = full gamma of iface i
                mix_idx[p, s] = NR + ref_remap[i]
                w_mix[p, s] = 1.0
                if ref_remap[i] < 0:  # direct iface read by a third side
                    mix_idx[p, s] = NR + self._nref  # cannot happen; pad
        npdt = np_dtype(self.dtype)
        self._gf_mix_idx = torch.as_tensor(mix_idx.reshape(-1), device=self.device)
        self._gf_w_own_np = w_own  # host copy (ghost_coef_eff derives from it)
        self._gf_w_own = torch.as_tensor(w_own.astype(npdt), device=self.device)
        self._gf_w_mix = torch.as_tensor(w_mix.astype(npdt), device=self.device)

    def _gf_parts(self, u: torch.Tensor):
        """``(w_mix * mix, own)`` of the direct gf pipeline, both
        ``[P, 2D, m]`` (direct sides: halo of neighbour faces; refinement
        sides: compact contribution pipeline)."""
        D, m, P = self.D, self.m, self.P
        S2 = 2 * D
        if self.num_ifaces == 0:
            z = u.new_zeros(P, S2, m)
            return z, z
        faces = extract_faces(u, D, self.n, self.face_depth)  # [P, S2f, m]
        ff = faces.reshape(-1, m)
        own = faces.reshape(P, S2, self.face_depth, m)[:, :, 0]  # [P, S2, m]
        srcs = [ff]
        if self._gf_ref_pipe is not None:
            srcs.append(self._gf_ref_pipe.interpolate(faces, m))
        srcs.append(u.new_zeros(1, m))
        mix = torch.cat(srcs, dim=0).index_select(0, self._gf_mix_idx).reshape(P, S2, m)
        return self._gf_w_mix.to(u.dtype) * mix, own

    def _gf_faces(self, u: torch.Tensor) -> torch.Tensor:
        """Per-patch-side interface traces ``[P, 2D, m]``."""
        mix_scaled, own = self._gf_parts(u)
        return self._gf_w_own.to(u.dtype) * own + mix_scaled

    def _apply_traces(self, u: torch.Tensor) -> torch.Tensor:
        """The apply's traces ``w_mix * mix`` (:func:`.traces.build_or_plain`:
        the trace kernel on a card, else ``_gf_parts``)."""
        return traces.build_or_plain(self._trace_apply, u, lambda x: self._gf_parts(x)[0])

    def _sweep_traces(self, u: torch.Tensor) -> torch.Tensor:
        """The sweep's traces (the trace kernel on a card, else
        ``_gf_faces``)."""
        return traces.build_or_plain(self._trace_sweep, u, self._gf_faces)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Composite-grid operator ``A u`` (``SchurHelper.h:360-376``):
        ``ghost = c*u_b + 2*(w_own*u_b + w_mix*mix)``, with the own-face
        term folded into the effective ghost coefficient ``c + 2*w_own``
        (exactly 0 on direct sides, where the ghost is the neighbour-face
        halo), through the ghost-stencil kernel."""
        u = u.contiguous()
        mix_scaled = self._apply_traces(u)
        return _STENCIL[self.D](
            u, mix_scaled, self.ghost_coef_eff.to(u.dtype), self.h2inv.to(u.dtype)
        )

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One FFT block-Jacobi sweep (``SchurHelper::solveWithSolution``,
        :func:`.patch_sweep.sweep`); with ``patch_solver="bcgs"``, batched
        BiCGStab patch solves with the traces of ``u``."""
        if self.patch_solver_kind == "bcgs":
            return self.patch_solve(f, self.interpolate(u))
        return patch_sweep.sweep(self._st, f, self._sweep_traces(u), self.h2inv)

    def smooth_zero(self, f: torch.Tensor) -> torch.Tensor:
        """``smooth(f, 0)``: with a zero iterate the traces vanish, so the
        sweep is just the batched patch solve."""
        if self.patch_solver_kind == "bcgs":
            return self.patch_solve(f, self.gamma_zeros(f.dtype))
        return patch_sweep.sweep(self._st, f, None, self.h2inv)

    # -- the Schur path -------------------------------------------------------

    def interpolate(self, u: torch.Tensor) -> torch.Tensor:
        """Trace interpolation: ``gamma[NIf, m]`` from patch values, through
        the contribution pipeline over every interface; the span
        ``pps.level.interpolate``."""
        if self.num_ifaces == 0:  # a single isolated patch (coarsest level)
            return u.new_zeros(0, self.m)
        with profiling.span("pps.level.interpolate"):
            faces = extract_faces(u, self.D, self.n, self.face_depth)
            return self._pipe.interpolate(faces, self.m)

    def gamma_faces(self, gamma: torch.Tensor) -> torch.Tensor:
        """Per-patch-side interface traces ``[P, 2D, m]``, zero where a side
        has no interface: one padded row gather (a fresh tensor, so the
        stencil kernel's inputs stay 16-byte aligned)."""
        if self.num_ifaces == 0:
            return gamma.new_zeros(self.P, 2 * self.D, self.m)
        gp = torch.cat([gamma, gamma.new_zeros(1, self.m)], dim=0)
        return gp.index_select(0, self._iface_flat).reshape(self.P, 2 * self.D, self.m)

    def gamma_zeros(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A zero interface vector ``[NIf, m]``."""
        return torch.zeros((self.num_ifaces, self.m), dtype=dtype or self.dtype,
                           device=self.device)

    def apply_with_interface(self, u: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Stencil apply with explicit interface values
        (``StarPatchOp::applyWithInterface``, ``StarPatchOp.h:28-184``):
        ``ghost = c*u_b + 2*gamma`` through the ghost-stencil kernel."""
        return self._stencil_with_faces(u.contiguous(), self.gamma_faces(gamma))

    def _stencil_with_faces(self, u: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
        return _STENCIL[self.D](u, gf, self.ghost_coef.to(u.dtype), self.h2inv.to(u.dtype))

    def fold_gamma(self, fc: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Ghost injection ``f - G gamma``: ``f_slice -= 2/h^2 * gamma`` on
        every side with an interface (``StarPatchOp::addInterfaceToRHS``)."""
        return self._fold_faces_into_rhs(fc, self.gamma_faces(gamma))

    def _fold_faces_into_rhs(self, fc: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
        return _fold_faces_flat(fc, gf, self.h2inv, self.D, self.n)

    def patch_solve_faces(self, f: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
        """Spectral patch solves with explicit per-patch-side traces
        ``gf[P, 2D, m]`` (the Schur probing of ``matrix.assemble_schur``)."""
        return _spectral_apply(self._st, self._fold_faces_into_rhs(f, gf), self.D, self.n)

    def patch_solve(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Exact per-patch solves with interface values ``gamma``: spectral
        (``FftwPatchSolver.h:173-206``), or batched per-patch BiCGStab with
        ``patch_solver="bcgs"`` (the reference's ``BiCGStabSolver``).  The
        span ``pps.level.patch_solve``, one pass of :data:`solved`."""
        solved["passes"] += 1
        solved["patches"] += self.P
        with profiling.span("pps.level.patch_solve"):
            fc = self.fold_gamma(f, gamma)
            if self.patch_solver_kind == "bcgs":
                return self._patch_bcgs(f.dtype)(fc)
            return _spectral_apply(self._st, fc, self.D, self.n)

    def _patch_bcgs(self, dtype: torch.dtype) -> PatchBicgstab:
        """The batched patch BiCGStab of ``patch_solve`` in ``dtype``
        (``tol=1e-12, max_iter=500``, as the reference's ``Level``), over
        a zero interface vector kept for it, so that its pass can be
        captured."""
        solve = self._bcgs.get(dtype)
        if solve is None:
            zero = self.gamma_zeros(dtype)
            solve = self._bcgs[dtype] = PatchBicgstab(
                lambda u: self.apply_with_interface(u, zero), tol=1e-12, max_iter=500)
        return solve

    def solve_with_interface(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Patch solves with explicit interface values (the Schur path)."""
        return self.patch_solve(f, gamma)

    def schur_S(self, gamma: torch.Tensor) -> torch.Tensor:
        """Matrix-free Schur operator ``S gamma = interp(patch_solve(0,
        gamma))`` (``SchurWrapOp.h:47-53``); the span ``pps.level.schur_S``."""
        with profiling.span("pps.level.schur_S"):
            zf = torch.zeros((self.P,) + self.pl.ns_shape, dtype=gamma.dtype,
                             device=gamma.device)
            return self.interpolate(self.patch_solve(zf, gamma))

    def integrate(self, u: torch.Tensor) -> torch.Tensor:
        """Volume integral (``Domain.h:258-278``), in f64."""
        sums = u.reshape(self.P, -1).sum(dim=1)
        return (sums * self._cellvol).sum()

    @property
    def volume(self) -> float:
        return self.pl.volume()

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.P,) + self.pl.ns_shape, dtype=self.dtype,
                           device=self.device)

    # -- the engine hooks a sharded level (``parallel.halo``) overrides -------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global field: ``x`` itself on one device."""
        return x

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This device's rows of a global field: all of ``x``."""
        return x

    def active_smoother(self, active: np.ndarray, build_solver: bool = True):
        """The FAC active-set smoother of this level over ``active``."""
        return ActiveSmoother(self, active, build_solver=build_solver)


class ActiveSmoother:
    """FAC active-set block-Jacobi smoother, subset-compute form.

    One sweep replaces the iterate on a static subset of patches with their
    exact patch solves (traces interpolated from the full current iterate);
    every other patch is left untouched.  Only the interfaces adjacent to
    active patches are interpolated and only active patches are solved, so
    a sweep costs O(active) instead of O(level) (classical FAC relaxation;
    the reference relaxes every patch, ``GMG/FFTBlockJacobiSmoother.h:31-59``).
    """

    def __init__(self, level: Level, active: np.ndarray, build_solver: bool = True):
        self.level = level
        D, n, m = level.D, level.n, level.m
        self.D, self.n, self.m = D, n, m
        P = level.P
        dev = level.device
        act = np.where(np.asarray(active))[0].astype(np.int64)
        self.act = act
        self.Pa = len(act)
        self._act = torch.as_tensor(act, device=dev)
        inv = np.full(P, self.Pa, dtype=np.int64)  # pad row = untouched
        inv[act] = np.arange(self.Pa)
        self._route = patch_sweep.Route(
            self._act, torch.as_tensor(inv, device=dev),
            torch.as_tensor(np.asarray(active, dtype=bool).reshape((P,) + (1,) * D), device=dev))

        t = level.tables
        # interfaces the active patches read: remap to a compact range
        ii = np.asarray(t.iface_side_idx)[act]  # [Pa, 2D]
        mm = np.asarray(t.iface_side_mask)[act] > 0
        needed = np.unique(ii[mm]) if mm.any() else np.zeros(0, dtype=np.int64)
        self.num_sub_ifaces = len(needed)
        remap = np.full(max(t.num_ifaces, 1), -1, dtype=np.int64)
        remap[needed] = np.arange(len(needed))

        # reduced contribution pipeline: only contributions that land on a
        # needed interface, sourcing faces from just the contributing
        # patches (active + their face neighbours)
        keep = remap[t.contrib_iface] >= 0
        cp = t.contrib_patch[keep]
        src = np.unique(cp).astype(np.int64) if len(cp) else np.zeros(0, dtype=np.int64)
        src_remap = np.full(P, -1, dtype=np.int64)
        src_remap[src] = np.arange(len(src))
        self._src = torch.as_tensor(src, device=dev)
        self._pipe = _build_contrib_pipeline(
            src_remap[cp],
            t.contrib_side[keep],
            t.contrib_case[keep],
            remap[t.contrib_iface[keep]],
            self.num_sub_ifaces,
            level._case_T,
            level._case_scalar,
            level.dtype,
            2 * D * level.face_depth,
            len(src),
            dev,
        )
        # flattened per-(active patch, side) gamma routing (masked -> pad)
        gidx = np.asarray(remap[ii], dtype=np.int64).copy()
        gidx[~mm] = self.num_sub_ifaces
        self._g_flat = torch.as_tensor(gidx.reshape(-1), device=dev)
        # on a card, the trace kernel's tables over the active sides, read
        # from the whole field (ops.traces)
        self._trace = None
        if level._trace_pal is not None and self.num_sub_ifaces:
            self._trace = traces.trace_tables(t, act, level._trace_pal)

        self._st = (
            _build_solver_tables(level.pl, level.dtype, act, dev) if build_solver else None
        )
        self._h2inv_act = level.h2inv.index_select(0, self._act)
        self._ghost_act = level.ghost_coef.index_select(0, self._act)

    def _gamma_faces(self, u: torch.Tensor) -> torch.Tensor:
        """[Pa, 2D, m] interface traces at the active patches' faces,
        interpolated from the full iterate via the reduced pipeline."""
        faces = extract_faces(
            u.index_select(0, self._src), self.D, self.n, self.level.face_depth
        )
        gamma = self._pipe.interpolate(faces, self.m)  # [NIsub, m]
        gp = torch.cat([gamma, gamma.new_zeros(1, self.m)], dim=0)
        return gp.index_select(0, self._g_flat).reshape(self.Pa, 2 * self.D, self.m)

    def _traces(self, u: torch.Tensor) -> torch.Tensor:
        """The active sides' traces (:func:`.traces.build_or_plain`: the
        trace kernel on a card, else ``_gamma_faces``)."""
        return traces.build_or_plain(self._trace, u, self._gamma_faces)

    def smooth(self, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One sweep of the active patches from ``u``, which the other
        patches keep (:func:`.patch_sweep.sweep`)."""
        gf = self._traces(u) if self.num_sub_ifaces else None
        return patch_sweep.sweep(self._st, f, gf, self._h2inv_act, self._route, u)

    def smooth_zero(self, f: torch.Tensor) -> torch.Tensor:
        """``smooth(f, 0)`` — traces vanish, so just the subset solves."""
        return patch_sweep.sweep(self._st, f, None, self._h2inv_act, self._route)

    def apply_scattered(self, u: torch.Tensor) -> torch.Tensor:
        """``A u`` scattered into a zero field, computed on the subset only
        (through the ghost-stencil kernel).

        Exact for the full composite operator whenever ``u`` vanishes
        outside a set A with nbr(A) ⊆ this subset: every nonzero row of
        ``A u`` is then in the subset.  Used for the FAC coarse-level
        residual ``r = f − A u`` after active-set pre-smoothing."""
        if self.num_sub_ifaces:
            gf = self._traces(u)
        else:
            gf = u.new_zeros(self.Pa, 2 * self.D, self.m)
        out = _STENCIL[self.D](
            u.index_select(0, self._act),
            gf,
            self._ghost_act.to(u.dtype),
            self._h2inv_act.to(u.dtype),
        )
        return patch_sweep._scatter(out, self._route, None)

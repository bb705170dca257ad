"""Interface (gamma) system bookkeeping: host-built index tables.

The reference keeps a per-patch-side pointer graph of interface records
(``SchurInfo.h:36-558``) and moves trace values through PETSc VecScatters.
Here the whole interface system of a level is three flat tables consumed by
batched device gathers/scatter-adds:

* ``iface_side_idx[P, 2D]`` — for every patch side that has a neighbor, the
  slot of *that patch's own* interface in the gamma vector (the interface
  at the patch's own resolution; ``SchurInfo.h:141-405``).
* a *contribution list*: each entry says "patch ``p``'s face on side ``s``
  adds a weighted stencil of its trace into interface ``i`` using case
  template ``c``".  The case templates encode the reference's bilinear
  (2D, ``BilinearInterpolator.cpp:61-117``) / trilinear
  (3D, ``TriLinInterp.cpp:60-172``) trace-interpolation weights, or the
  higher-order 2D closures (:func:`quadratic2d_templates`).

Interface identity follows the reference id scheme
``iface_id = patch_id * num_sides + side`` with the owner being the
lower-side patch for same-level faces (``SchurInfo.h:141-150``):

* NORMAL side: one shared interface.
* COARSE side (this patch is fine): the patch's own fine-resolution
  interface **plus** the coarse patch's interface (``SchurInfo.h:229-237``).
* FINE side (this patch is coarse): the patch's own coarse-resolution
  interface plus one per fine neighbor (``SchurInfo.h:322-331``).

Face-vector layout: a face trace is a flat vector of ``m = n**(D-1)``
values ordered with the *lowest remaining axis fastest* — identical to the
reference's interface vector layout (``SchurHelper.h:199-204``) and to a
C-order flatten of our ``[P, (z,) y, x]`` patch arrays after dropping the
face's axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import geometry as geo
from .domain import NBR_COARSE, NBR_FINE, NBR_NONE, NBR_NORMAL, PatchLevel

# contribution case codes; F2C/C2F get one case per face orthant
CASE_NORMAL = "normal"
CASE_C2C = "c2c"
CASE_F2F = "f2f"
CASE_F2C = "f2c"  # + orthant
CASE_C2F = "c2f"  # + orthant


def _face_shape(D: int, n: int) -> Tuple[int, ...]:
    return (n,) * (D - 1)


def _face_coords(D: int, n: int) -> np.ndarray:
    """[m, D-1] integer coords of face-vector entries, coord 0 = fastest
    (lowest remaining axis)."""
    m = n ** (D - 1)
    idx = np.arange(m)
    coords = np.zeros((m, D - 1), dtype=np.int64)
    for a in range(D - 1):
        coords[:, a] = (idx // (n**a)) % n
    return coords


def case_templates(D: int, n: int) -> Tuple[Dict[str, int], np.ndarray, np.ndarray]:
    """Build the per-case (weights, source-index) templates.

    Returns ``(case_index, W, S)`` where ``W[c, m, K]`` are weights and
    ``S[c, m, K]`` indices into the *source* face vector; zero-weight slots
    use index 0.  ``K = 2**(D-1)`` covers the widest case (fine_to_fine).

    Weight tables (exact reference semantics):

    2D (``BilinearInterpolator.cpp:61-117``):
      normal       : out[i] += 1/2 · u[i]
      c2c          : out[i] += 1/3 · u[i]
      f2c (orth q) : out[(i + q·n)/2] += 1/3 · u[i]           (pairs sum)
      f2f          : out[i] += 5/6 · u[i] − 1/6 · u[pair(i)]
      c2f (orth q) : out[i] += 1/3 · u[(i + q·n)/2]

    3D (``TriLinInterp.cpp:60-172``):
      normal       : out[xy] += 1/2 · u[xy]
      c2c          : out[xy] += 1/3 · u[xy]
      f2c (orth q) : out[(x+qx·n)/2, (y+qy·n)/2] += 1/6 · u[x,y]
      f2f          : 2×2 blocks: out[e] += (11·u[e] − Σ_others u)/12
      c2f (orth q) : out[x,y] += 1/3 · u[(x+qx·n)/2, (y+qy·n)/2]
    """
    m = n ** (D - 1)
    K = max(2, 1 << (D - 1))
    half = 1 << (D - 1)
    coords = _face_coords(D, n)

    names: List[str] = [CASE_NORMAL, CASE_C2C, CASE_F2F]
    names += [f"{CASE_F2C}{q}" for q in range(half)]
    names += [f"{CASE_C2F}{q}" for q in range(half)]
    case_index = {name: i for i, name in enumerate(names)}

    W = np.zeros((len(names), m, K))
    S = np.zeros((len(names), m, K), dtype=np.int32)

    def flat(c: np.ndarray) -> np.ndarray:
        """face coords [.., D-1] -> flat index (axis 0 fastest)."""
        out = np.zeros(c.shape[:-1], dtype=np.int64)
        for a in range(D - 1):
            out += c[..., a] * (n**a)
        return out

    # normal / c2c: identity stencils
    W[case_index[CASE_NORMAL], :, 0] = 0.5
    S[case_index[CASE_NORMAL], :, 0] = np.arange(m)
    W[case_index[CASE_C2C], :, 0] = 1.0 / 3.0
    S[case_index[CASE_C2C], :, 0] = np.arange(m)

    # f2f: within each 2^(D-1) block of the fine face
    ci = case_index[CASE_F2F]
    nblk = 1 << (D - 1)
    for i in range(m):
        c = coords[i]
        base = c - (c % 2)
        # enumerate the block members, self first
        others = []
        for b in range(nblk):
            oc = base + np.array([(b >> a) & 1 for a in range(D - 1)])
            others.append(int(flat(oc[None, :])[0]))
        if D == 2:
            # out[i] += 5/6 u[i] - 1/6 u[pair]
            pair = others[0] if others[1] == i else others[1]
            W[ci, i, 0] = 5.0 / 6.0
            S[ci, i, 0] = i
            W[ci, i, 1] = -1.0 / 6.0
            S[ci, i, 1] = pair
        else:
            # out[e] += (11 u[e] - sum(others))/12
            k = 0
            W[ci, i, k] = 11.0 / 12.0
            S[ci, i, k] = i
            k += 1
            for j in others:
                if j == i:
                    continue
                W[ci, i, k] = -1.0 / 12.0
                S[ci, i, k] = j
                k += 1

    # f2c / c2f per face orthant q (bits of q map to face axes, axis0 = bit0)
    for q in range(half):
        qoff = np.array([((q >> a) & 1) * n for a in range(D - 1)])
        # f2c: out[(c + qoff)//2] += w * u[c]  -> per OUT entry j gather its
        # 2^(D-1) fine sources
        ci = case_index[f"{CASE_F2C}{q}"]
        w = (1.0 / 3.0) if D == 2 else (1.0 / 6.0)
        srcs_of: Dict[int, List[int]] = {}
        for i in range(m):
            j = int(flat(((coords[i] + qoff) // 2)[None, :])[0])
            srcs_of.setdefault(j, []).append(i)
        for j, srcs in srcs_of.items():
            for k, i in enumerate(srcs):
                W[ci, j, k] = w
                S[ci, j, k] = i
        # c2f: out[c] += w * u[(c + qoff)//2]
        ci = case_index[f"{CASE_C2F}{q}"]
        w = 1.0 / 3.0
        for i in range(m):
            j = int(flat(((coords[i] + qoff) // 2)[None, :])[0])
            W[ci, i, 0] = w
            S[ci, i, 0] = j

    return case_index, W, S


@dataclass
class IfaceTables:
    """Device-ready interface tables for one level."""

    num_ifaces: int
    m: int  # face-vector length n**(D-1)
    # per patch side: own-interface slot (0 where none) and validity mask
    iface_side_idx: np.ndarray  # [P, 2D] int32
    iface_side_mask: np.ndarray  # [P, 2D] bool
    # contribution list; ``contrib_side`` indexes a *face row*:
    # ``side * face_depth + depth`` (depth 0 = boundary face, depth 1 =
    # one cell inward — used by the higher-order 2D closures)
    contrib_patch: np.ndarray  # [C] int32
    contrib_side: np.ndarray  # [C] int32
    contrib_iface: np.ndarray  # [C] int32
    contrib_case: np.ndarray  # [C] int32
    # case templates
    case_w: np.ndarray  # [ncase, m, K] float64
    case_src: np.ndarray  # [ncase, m, K] int32
    # number of face depths referenced by contributions (1 = boundary
    # faces only; 2 = boundary + first-interior faces)
    face_depth: int = 1


def permute_tables(t: "IfaceTables", perm: np.ndarray) -> "IfaceTables":
    """Re-slot interface tables after a patch-slot permutation
    (``parallel.partition.reorder_level``): patch-indexed rows permute,
    contribution patch ids remap, interface ids are slot-independent."""
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    return IfaceTables(
        num_ifaces=t.num_ifaces,
        m=t.m,
        iface_side_idx=t.iface_side_idx[perm],
        iface_side_mask=t.iface_side_mask[perm],
        contrib_patch=inv[t.contrib_patch].astype(np.int32),
        contrib_side=t.contrib_side,
        contrib_iface=t.contrib_iface,
        contrib_case=t.contrib_case,
        case_w=t.case_w,
        case_src=t.case_src,
        face_depth=t.face_depth,
    )


def pad_tables(t: "IfaceTables", num_patches: int) -> "IfaceTables":
    """Extend the patch-indexed rows for padded dummy patches (no
    interfaces, no contributions)."""
    P_now = t.iface_side_idx.shape[0]
    pad = num_patches - P_now
    if pad <= 0:
        return t
    S = t.iface_side_idx.shape[1]
    return IfaceTables(
        num_ifaces=t.num_ifaces,
        m=t.m,
        iface_side_idx=np.concatenate(
            [t.iface_side_idx, np.zeros((pad, S), dtype=t.iface_side_idx.dtype)]
        ),
        iface_side_mask=np.concatenate(
            [t.iface_side_mask, np.zeros((pad, S), dtype=bool)]
        ),
        contrib_patch=t.contrib_patch,
        contrib_side=t.contrib_side,
        contrib_iface=t.contrib_iface,
        contrib_case=t.contrib_case,
        case_w=t.case_w,
        case_src=t.case_src,
        face_depth=t.face_depth,
    )


def quadratic2d_templates(n: int):
    """Case templates of the reference's higher-order 2D refinement
    closures (``StencilHelper2d.h:222-224,344-346``, used by the 2D
    assembled operator ``MatrixHelper2d.cpp:30-122``), re-expressed as
    interface-value templates: with the ghost closure
    ``ghost = -u_b + 2*gamma'``, the effective interface value is
    ``gamma' = (ghost_HO + u_b) / 2`` where ``ghost_HO`` is the closure's
    ghost row.  Sources per refinement side:

    fine side (coarse neighbor, orthant q):
      * own boundary face: ``5/6 * I``   (the (2/3 + 1)/2 own-cell term)
      * own inner face:    ``-1/10 * I`` (the -1/5 inner-cell term / 2)
      * coarse boundary face: quadratic tangential interpolation ``Q_q``
        with end/penultimate-row specials and even/odd parity
        (coefficients {1/12, 1/2, -1/20} mid; {1/12, -3/10, 3/4} end;
        {-1/20, 7/30, 7/20} penultimate — all halved).

    coarse side (fine neighbors):
      * own boundary face: ``T_own`` — identity/2 plus the tangential
        {-1/30, -1/30} mid / {-1/10, 1/15, -1/30} end couplings, halved.
      * fine boundary face (orthant q): ``1/6`` pair-sum into the half
      * fine inner face (orthant q):    ``1/10`` pair-sum into the half

    Returns ``(case_index, W, S)`` shaped like :func:`case_templates`.
    """
    m = n
    K = 4
    names = ["normal", "hofb", "hofi", "hocb"]
    names += [f"hofc{q}" for q in range(2)]
    names += [f"hocf{q}" for q in range(2)]
    names += [f"hocfi{q}" for q in range(2)]
    case_index = {name: i for i, name in enumerate(names)}
    W = np.zeros((len(names), m, K))
    S = np.zeros((len(names), m, K), dtype=np.int32)

    ci = case_index["normal"]
    W[ci, :, 0] = 0.5
    S[ci, :, 0] = np.arange(m)

    ci = case_index["hofb"]  # fine side, own boundary face
    W[ci, :, 0] = 5.0 / 6.0
    S[ci, :, 0] = np.arange(m)
    ci = case_index["hofi"]  # fine side, own inner face
    W[ci, :, 0] = -1.0 / 10.0
    S[ci, :, 0] = np.arange(m)

    ci = case_index["hocb"]  # coarse side, own boundary face
    for i in range(m):
        if i == 0:
            taps = [(0, 1.0 - 1.0 / 10), (1, 1.0 / 15), (2, -1.0 / 30)]
        elif i == m - 1:
            taps = [(m - 1, 1.0 - 1.0 / 10), (m - 2, 1.0 / 15), (m - 3, -1.0 / 30)]
        else:
            taps = [(i, 1.0), (i - 1, -1.0 / 30), (i + 1, -1.0 / 30)]
        for k, (j, w) in enumerate(taps):
            S[ci, i, k] = j
            W[ci, i, k] = 0.5 * w

    for q in range(2):
        # fine side: quadratic interpolation from the coarse boundary face
        ci = case_index[f"hofc{q}"]
        for i in range(m):
            if q == 0 and i == 0:
                taps = [(0, 3.0 / 4), (1, -3.0 / 10), (2, 1.0 / 12)]
            elif q == 0 and i == 1:
                taps = [(0, 7.0 / 20), (1, 7.0 / 30), (2, -1.0 / 20)]
            elif q == 1 and i == m - 1:
                taps = [(m - 1, 3.0 / 4), (m - 2, -3.0 / 10), (m - 3, 1.0 / 12)]
            elif q == 1 and i == m - 2:
                taps = [(m - 1, 7.0 / 20), (m - 2, 7.0 / 30), (m - 3, -1.0 / 20)]
            else:
                j = q * (m // 2) + i // 2
                near, far = (j - 1, j + 1) if i % 2 == 0 else (j + 1, j - 1)
                taps = [(j, 1.0 / 2), (near, 1.0 / 12), (far, -1.0 / 20)]
            for k, (jj, w) in enumerate(taps):
                S[ci, i, k] = jj
                W[ci, i, k] = 0.5 * w
        # coarse side: pair sums from fine boundary / inner faces
        for name, w in ((f"hocf{q}", 1.0 / 6.0), (f"hocfi{q}", 1.0 / 10.0)):
            ci = case_index[name]
            for i in range(q * (m // 2), (q + 1) * (m // 2)):
                j = i - q * (m // 2)
                S[ci, i, 0] = 2 * j
                W[ci, i, 0] = w
                S[ci, i, 1] = 2 * j + 1
                W[ci, i, 1] = w
    return case_index, W, S


def build_iface_tables(level: PatchLevel, scheme: str = "bilinear") -> IfaceTables:
    if scheme == "quadratic":
        return _build_iface_tables_quadratic2d(level)
    if scheme != "bilinear":
        raise ValueError(f"unknown interface scheme {scheme!r}")
    return _build_iface_tables_bilinear(level)


def _build_iface_tables_quadratic2d(level: PatchLevel) -> IfaceTables:
    """Interface tables with the higher-order 2D refinement closures.

    Same interface id scheme as the bilinear builder; only the
    contribution cases at coarse/fine sides change, and contributions may
    source the first-interior face (``face_depth = 2``)."""
    if level.D != 2:
        raise ValueError("the quadratic closures are 2D only "
                         "(reference StencilHelper2d.h)")
    D, n = level.D, level.n
    S2 = 2 * D
    m = n
    P = level.num_patches
    ids = level.ids

    iface_slot: Dict[int, int] = {}

    def slot(iface_id: int) -> int:
        if iface_id not in iface_slot:
            iface_slot[iface_id] = len(iface_slot)
        return iface_slot[iface_id]

    side_idx = np.zeros((P, S2), dtype=np.int32)
    side_mask = np.zeros((P, S2), dtype=bool)
    c_patch: List[int] = []
    c_side: List[int] = []  # side * 2 + depth
    c_iface: List[int] = []
    c_case: List[str] = []

    def add(p, s, depth, i, case):
        c_patch.append(p)
        c_side.append(2 * s + depth)
        c_iface.append(i)
        c_case.append(case)

    for p in range(P):
        pid = int(ids[p])
        for s in range(S2):
            t = level.nbr_type[p, s]
            if t == NBR_NONE:
                continue
            if t == NBR_NORMAL:
                nbr_pid = int(ids[level.nbr_slot[p, s]])
                if geo.side_is_lower(s):
                    own = pid * S2 + s
                else:
                    own = nbr_pid * S2 + geo.side_opposite(s)
                i = slot(own)
                side_idx[p, s] = i
                side_mask[p, s] = True
                add(p, s, 0, i, "normal")
            elif t == NBR_COARSE:
                # fine side: own iface from own faces + coarse boundary face
                i_own = slot(pid * S2 + s)
                side_idx[p, s] = i_own
                side_mask[p, s] = True
                q = int(level.coarse_orth[p, s])
                nbr = int(level.nbr_slot[p, s])
                add(p, s, 0, i_own, "hofb")
                add(p, s, 1, i_own, "hofi")
                add(nbr, geo.side_opposite(s), 0, i_own, f"hofc{q}")
            elif t == NBR_FINE:
                # coarse side: own iface from own face + fine faces
                i_own = slot(pid * S2 + s)
                side_idx[p, s] = i_own
                side_mask[p, s] = True
                add(p, s, 0, i_own, "hocb")
                for q in range(2):
                    fine = int(level.fine_nbr_slots[p, s, q])
                    add(fine, geo.side_opposite(s), 0, i_own, f"hocf{q}")
                    add(fine, geo.side_opposite(s), 1, i_own, f"hocfi{q}")

    case_index, W, Src = quadratic2d_templates(n)
    return IfaceTables(
        num_ifaces=len(iface_slot),
        m=m,
        iface_side_idx=side_idx,
        iface_side_mask=side_mask,
        contrib_patch=np.array(c_patch, dtype=np.int32),
        contrib_side=np.array(c_side, dtype=np.int32),
        contrib_iface=np.array(c_iface, dtype=np.int32),
        contrib_case=np.array([case_index[c] for c in c_case], dtype=np.int32),
        case_w=W,
        case_src=Src,
        face_depth=2,
    )


def _build_iface_tables_bilinear(level: PatchLevel) -> IfaceTables:
    """Enumerate interfaces and trace-interpolation contributions.

    Mirrors the id scheme of ``SchurInfo.h`` and the contribution pattern of
    the reference interpolators: per patch side,

    * NORMAL: one contribution (``normal``) to the shared interface.
    * COARSE nbr (this patch fine, orthant ``q`` on the coarse face):
      ``f2f`` into its own interface and ``f2c(q)`` into the coarse
      patch's interface (``SchurInfo.h:253-259``).
    * FINE nbrs (this patch coarse): ``c2c`` into its own interface and
      ``c2f(q)`` into fine neighbor ``q``'s interface
      (``SchurInfo.h:363-370``).
    """
    D, n = level.D, level.n
    S = 2 * D
    half = 1 << (D - 1)
    m = n ** (D - 1)
    P = level.num_patches
    ids = level.ids

    iface_slot: Dict[int, int] = {}

    def slot(iface_id: int) -> int:
        if iface_id not in iface_slot:
            iface_slot[iface_id] = len(iface_slot)
        return iface_slot[iface_id]

    side_idx = np.zeros((P, S), dtype=np.int32)
    side_mask = np.zeros((P, S), dtype=bool)

    c_patch: List[int] = []
    c_side: List[int] = []
    c_iface: List[int] = []
    c_case: List[str] = []

    for p in range(P):
        pid = int(ids[p])
        for s in range(S):
            t = level.nbr_type[p, s]
            if t == NBR_NONE:
                continue
            if t == NBR_NORMAL:
                nbr_pid = int(ids[level.nbr_slot[p, s]])
                if geo.side_is_lower(s):
                    own = pid * S + s
                else:
                    own = nbr_pid * S + geo.side_opposite(s)
                i = slot(own)
                side_idx[p, s] = i
                side_mask[p, s] = True
                c_patch.append(p), c_side.append(s), c_iface.append(i)
                c_case.append(CASE_NORMAL)
            elif t == NBR_COARSE:
                nbr_pid = int(ids[level.nbr_slot[p, s]])
                own = pid * S + s
                coarse = nbr_pid * S + geo.side_opposite(s)
                i_own, i_coarse = slot(own), slot(coarse)
                side_idx[p, s] = i_own
                side_mask[p, s] = True
                q = int(level.coarse_orth[p, s])
                c_patch.append(p), c_side.append(s), c_iface.append(i_own)
                c_case.append(CASE_F2F)
                c_patch.append(p), c_side.append(s), c_iface.append(i_coarse)
                c_case.append(f"{CASE_F2C}{q}")
            elif t == NBR_FINE:
                own = pid * S + s
                i_own = slot(own)
                side_idx[p, s] = i_own
                side_mask[p, s] = True
                c_patch.append(p), c_side.append(s), c_iface.append(i_own)
                c_case.append(CASE_C2C)
                for q in range(half):
                    fine_pid = int(ids[level.fine_nbr_slots[p, s, q]])
                    i_fine = slot(fine_pid * S + geo.side_opposite(s))
                    c_patch.append(p), c_side.append(s), c_iface.append(i_fine)
                    c_case.append(f"{CASE_C2F}{q}")

    case_index, W, Src = case_templates(D, n)
    return IfaceTables(
        num_ifaces=len(iface_slot),
        m=m,
        iface_side_idx=side_idx,
        iface_side_mask=side_mask,
        contrib_patch=np.array(c_patch, dtype=np.int32),
        contrib_side=np.array(c_side, dtype=np.int32),
        contrib_iface=np.array(c_iface, dtype=np.int32),
        contrib_case=np.array([case_index[c] for c in c_case], dtype=np.int32),
        case_w=W,
        case_src=Src,
    )

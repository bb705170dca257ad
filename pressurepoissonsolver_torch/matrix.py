"""Explicit matrix assembly for the composite operator (host, numpy/scipy).

Carried from ``pressurepoissonsolver_tpu.matrix`` (the CSR assembly only):
the global CSR matrix is composed algebraically from the same host tables
the matrix-free path uses,

    ``A = L_patch + G @ Gamma``

where ``L_patch`` is the block-diagonal patch stencil (with the per-side
boundary coefficients), ``Gamma`` the trace-interpolation matrix
(u -> interface values) and ``G`` the ghost-closure injection
(``+2 gamma / h^2`` into boundary rows).  By construction the assembled
matrix is *exactly* the matrix-free operator.  Here it serves the dense
coarse-level inverse of the multigrid cycle and the CLI's ``--matrix-type
crs`` (:func:`bcoo_matvec`, a device SpMV).

The Schur interface matrix ``I - S`` is assembled by probing
(:func:`assemble_schur`: batched patch solves on the card, placement on
the host) and serves the block-Jacobi interface preconditioner
(:func:`schur_block_jacobi`) and ``--schur --matrix-type crs``; the same
probes give the deduplicated pointer-block form (:func:`pbm_matvec`,
``--matrix-type pbm``).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from .domain import PatchLevel
from .iface import IfaceTables, build_iface_tables


def _face_cell_flat(D: int, n: int, s: int, depth: int = 0) -> np.ndarray:
    """Flat in-patch cell index of each face-vector entry of side ``s``,
    ``depth`` cells inward from the boundary.

    Face vector order: lowest remaining axis fastest; patch flat order:
    C order of [z, y, x] (x fastest)."""
    a = s // 2
    fixed = depth if s % 2 == 0 else n - 1 - depth
    m = n ** (D - 1)
    idx = np.arange(m)
    coords = np.zeros((m, D), dtype=np.int64)  # coords[:, axis]
    rem = [ax for ax in range(D) if ax != a]
    for k, ax in enumerate(rem):
        coords[:, ax] = (idx // (n**k)) % n
    coords[:, a] = fixed
    flat = np.zeros(m, dtype=np.int64)
    for ax in range(D):
        flat += coords[:, ax] * (n**ax)
    return flat


def assemble_interpolation(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``Gamma``: (num_ifaces*m) x (P*n^D) trace-interpolation matrix."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    depth = getattr(t, "face_depth", 1)
    rows, cols, vals = [], [], []
    for c in range(len(t.contrib_patch)):
        p = int(t.contrib_patch[c])
        code = int(t.contrib_side[c])
        s, d = (code // depth, code % depth) if depth > 1 else (code, 0)
        i = int(t.contrib_iface[c])
        k = int(t.contrib_case[c])
        W = t.case_w[k]  # [m, K]
        S = t.case_src[k]
        face_flat = _face_cell_flat(D, n, s, d)
        for out_i in range(m):
            for kk in range(W.shape[1]):
                w = W[out_i, kk]
                if w != 0.0:
                    rows.append(i * m + out_i)
                    cols.append(p * cells + face_flat[S[out_i, kk]])
                    vals.append(w)
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(t.num_ifaces * m, level.num_patches * cells)
    )


def assemble_patch_stencil(level: PatchLevel) -> sp.csr_matrix:
    """Block-diagonal patch Laplacian with boundary-closure coefficients
    (the homogeneous part of ``StarPatchOp::applyWithInterface``)."""
    D, n = level.D, level.n
    P = level.num_patches
    cells = n**D
    rows, cols, vals = [], [], []
    coords = np.zeros((cells, D), dtype=np.int64)
    idx = np.arange(cells)
    for ax in range(D):
        coords[:, ax] = (idx // (n**ax)) % n
    for p in range(P):
        base = p * cells
        for a in range(D):
            h2inv = 1.0 / level.spacings[p, a] ** 2
            x = coords[:, a]
            # diagonal
            neum_lo = level.neumann[p, 2 * a]
            neum_hi = level.neumann[p, 2 * a + 1]
            c_lo = -1.0 if neum_lo else -3.0
            c_hi = -1.0 if neum_hi else -3.0
            diag = np.where(x == 0, c_lo, np.where(x == n - 1, c_hi, -2.0))
            rows.extend(base + idx)
            cols.extend(base + idx)
            vals.extend(diag * h2inv)
            # off-diagonals along axis a
            sel = x < n - 1
            rows.extend(base + idx[sel])
            cols.extend(base + idx[sel] + n**a)
            vals.extend(np.full(sel.sum(), h2inv))
            rows.extend(base + idx[sel] + n**a)
            cols.extend(base + idx[sel])
            vals.extend(np.full(sel.sum(), h2inv))
    return sp.csr_matrix((vals, (rows, cols)), shape=(P * cells, P * cells))


def assemble_ghost_injection(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``G``: (P*n^D) x (num_ifaces*m) injection of ``2 gamma / h^2`` into
    boundary rows of neighbored sides."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    rows, cols, vals = [], [], []
    for p in range(level.num_patches):
        for s in range(2 * D):
            if not t.iface_side_mask[p, s]:
                continue
            i = int(t.iface_side_idx[p, s])
            a = s // 2
            h2inv = 1.0 / level.spacings[p, a] ** 2
            face_flat = _face_cell_flat(D, n, s)
            rows.extend(p * cells + face_flat)
            cols.extend(i * m + np.arange(m))
            vals.extend(np.full(m, 2.0 * h2inv))
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(level.num_patches * cells, t.num_ifaces * m)
    )


def assemble_composite(level: PatchLevel, scheme: str = "bilinear") -> sp.csr_matrix:
    """The full composite-grid operator as CSR: ``A = L + G @ Gamma``.

    ``scheme="quadratic"`` assembles the 2D higher-order refinement
    closures (reference ``MatrixHelper2d.cpp:30-122``)."""
    t = build_iface_tables(level, scheme=scheme)
    L = assemble_patch_stencil(level)
    G = assemble_ghost_injection(level, t)
    Gamma = assemble_interpolation(level, t)
    return (L + G @ Gamma).tocsr()


def _dense_case_templates(tables: IfaceTables) -> np.ndarray:
    """Each interpolation case's (weights, source) template as a dense
    ``m×m`` matrix ``T`` with ``out = T @ face``, in float64."""
    ncase, m, K = tables.case_w.shape
    T = np.zeros((ncase, m, m))
    for k in range(ncase):
        for i in range(m):
            for kk in range(K):
                w = tables.case_w[k, i, kk]
                if w != 0.0:
                    T[k, i, tables.case_src[k, i, kk]] += w
    return T


# bytes of one field of the probes' batched patch solves
_PROBE_CHUNK_BYTES = 1 << 30


def _probe_responses(level):
    """``(class_of, R)``: each patch's (Neumann bits, spacings) class and the
    classes' responses to unit interface traces,
    ``R[src side, probe j, class, out face code (side*depth + d), m]``.

    A patch's response to a unit trace depends only on its class, so the
    ``2D·m`` unit-trace probes run once per class: on a mini-level of one
    representative patch per class, repeated once per probe of a chunk, as
    batched spectral patch solves on ``level``'s device (chunks of about
    ``_PROBE_CHUNK_BYTES`` per field)."""
    from .ops.level_ops import Level, extract_faces

    D, n = level.D, level.n
    m = level.m
    S2 = 2 * D
    P = level.P
    pl = level.pl

    # -- canonical patch classes ------------------------------------------
    uniq: dict = {}
    class_of = np.zeros(P, dtype=np.int64)
    reps: list = []
    for p in range(P):
        key = (
            tuple(bool(x) for x in pl.neumann[p]),
            tuple(float(x) for x in pl.spacings[p]),
        )
        if key not in uniq:
            uniq[key] = len(reps)
            reps.append(p)
        class_of[p] = uniq[key]
    U = len(reps)

    # -- the probes, chunked: probe b of a chunk is patch block b ----------
    B = S2 * m
    fd = level.face_depth
    itemsize = torch.empty(0, dtype=level.dtype).element_size()
    chunk = max(1, min(B, _PROBE_CHUNK_BYTES // (U * n**D * itemsize)))
    lvl_u = Level(_isolated_patches(pl, np.tile(reps, chunk)), dtype=level.dtype,
                  device=level.device)
    R = np.zeros((B, U, S2 * fd, m))
    for b0 in range(0, B, chunk):
        nb = min(chunk, B - b0)
        gf = np.zeros((chunk, U, S2, m))
        for i in range(nb):
            s, j = divmod(b0 + i, m)
            gf[i, :, s, j] = 1.0
        gf_t = torch.as_tensor(gf.reshape(chunk * U, S2, m), dtype=level.dtype,
                               device=level.device)
        zeros = torch.zeros((chunk * U,) + (n,) * D, dtype=level.dtype,
                            device=level.device)
        u = lvl_u.patch_solve_faces(zeros, gf_t)
        faces = extract_faces(u, D, n, fd).reshape(chunk, U, S2 * fd, m)
        R[b0:b0 + nb] = faces[:nb].cpu().numpy()
    return class_of, R.reshape(S2, m, U, S2 * fd, m)


def assemble_schur(level) -> sp.csr_matrix:
    """The explicit Schur interface matrix ``A_S = I - S`` by probing
    (``SchurMatrixHelper.cpp:24-205``, ``SchurMatrixHelper2d.cpp:130-190``):
    the probes of :func:`_probe_responses` on ``level``'s device, the m×m
    response blocks placed under the interpolation-case templates on the
    host.  ``level`` is an ``ops.level_ops.Level``.
    """
    t = level.tables
    m = t.m
    S2 = 2 * level.D
    NIf = t.num_ifaces
    class_of, R = _probe_responses(level)

    # -- host placement under the case templates ---------------------------
    T = _dense_case_templates(t)  # [ncase, m, m]
    rows, cols, vals = [], [], []
    blk_r = np.repeat(np.arange(m), m)
    blk_c = np.tile(np.arange(m), m)
    for s in range(S2):
        src_iface = t.iface_side_idx[:, s]  # [P]
        src_mask = t.iface_side_mask[:, s]
        sel = np.where(src_mask[t.contrib_patch])[0]
        for c in sel:
            p = int(t.contrib_patch[c])
            sc = int(t.contrib_side[c])
            k = int(t.contrib_case[c])
            resp = R[s, :, class_of[p], sc, :]  # [probe j, m]
            block = T[k] @ resp.T  # [m out, m probe]
            rows.append(int(t.contrib_iface[c]) * m + blk_r)
            cols.append(int(src_iface[p]) * m + blk_c)
            vals.append(block.ravel())
    S_mat = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(NIf * m, NIf * m),
    )
    return (sp.identity(NIf * m, format="csr") - S_mat).tocsr()


def _isolated_patches(pl: PatchLevel, slots: np.ndarray) -> PatchLevel:
    """The patches ``slots`` of ``pl`` (repeats allowed) as a level of
    isolated patches: their Neumann bits and spacings, no neighbours."""
    U, S2 = len(slots), 2 * pl.D
    return PatchLevel(
        D=pl.D,
        n=pl.n,
        tree_level=pl.tree_level,
        ids=np.arange(U, dtype=np.int64),
        starts=pl.starts[slots],
        spacings=pl.spacings[slots],
        refine_level=pl.refine_level[slots],
        parent_id=np.arange(U, dtype=np.int64),
        orth_on_parent=np.full(U, -1, dtype=np.int32),
        neumann=pl.neumann[slots],
        nbr_type=np.zeros((U, S2), dtype=np.int8),
        nbr_slot=np.full((U, S2), -1, dtype=np.int64),
        coarse_orth=np.full((U, S2), -1, dtype=np.int32),
        fine_nbr_slots=np.full((U, S2, 1 << (pl.D - 1)), -1, dtype=np.int64),
    )


def schur_block_jacobi(level, A_S: sp.csr_matrix = None, engine=None):
    """Block-Jacobi preconditioner for the interface system: the inverses
    of the m×m diagonal blocks of ``I - S`` (the reference's ``PBMatrix``
    ``getDiagInv`` + ``BlockJacobiSmoother``, ``Experimental/PBMatrix.cpp``),
    applied as one batched matmul on ``level``'s device.

    ``engine`` (optional): a sharded engine of ``level`` (the halo
    ``ShardedLevel`` or the gathered ``GatheredLevel``); the inverse blocks
    are then this rank's block of its sharded gamma layout (identity blocks
    on the padding rows), on the engine's device."""
    if A_S is None:
        A_S = assemble_schur(level)
    m = level.m
    NIf = level.num_ifaces
    blocks = np.zeros((NIf, m, m))
    Acoo = A_S.tocoo()
    ri, ci, v = Acoo.row, Acoo.col, Acoo.data
    same = (ri // m) == (ci // m)
    # accumulated in entry order, as a loop over the entries would
    np.add.at(blocks, (ri[same] // m, ri[same] % m, ci[same] % m), v[same])
    binv = np.linalg.inv(blocks)
    if engine is not None:
        owned = engine._owned_ids[engine.me]
        arr = np.tile(np.eye(m), (max(engine.NOg, 1), 1, 1))
        arr[: len(owned)] = binv[owned]
        binv = arr
    binv = torch.as_tensor(binv, dtype=level.dtype, device=(engine or level).device)

    def M(gamma):
        return torch.bmm(binv, gamma.unsqueeze(-1)).squeeze(-1)

    return M


def bcoo_matvec(csr: sp.csr_matrix, *, dtype: torch.dtype = torch.float64,
                device="cuda"):
    """Wrap a host CSR as a device SpMV (the reference's BCOO wrapper): the
    matrix becomes a ``torch.sparse_csr_tensor`` of ``dtype`` on
    ``device``; ``mv(x)`` multiplies the flattened ``x`` and keeps its
    shape.  Duplicate entries are summed and column indices sorted first
    (the canonical CSR the sparse tensor requires)."""
    csr = sp.csr_matrix(csr, copy=True)
    csr.sum_duplicates()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        mat = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64),
            torch.as_tensor(csr.indices, dtype=torch.int64),
            torch.as_tensor(csr.data, dtype=dtype),
            size=csr.shape, device=device, check_invariants=True,
        )

    def mv(x):
        return torch.mv(mat, x.reshape(-1)).reshape(x.shape)

    return mv


def pbm_matvec(level):
    """Matrix-free "pointer-block" interface operator (the reference's
    experimental ``PBMatrix``, ``Experimental/PBMatrix.{h,cpp}``): the
    probed Schur matrix kept as deduplicated m×m coefficient blocks plus
    (row, col, block-id) pointers instead of CRS.

    Blocks are deduplicated by (probe side, patch class, source side, case)
    — the analog of the reference's rotation/flip canonicalization
    (``SchurMatrixHelper.cpp:24-205``) — from the probes of
    :func:`_probe_responses`.  Entries are sorted by block id, so the apply
    is one ``[E_c, m] @ [m, m]`` GEMM per distinct block over the gathered
    column traces, then an interface-major padded gather-sum (no
    scatter-adds).  Returns ``gamma [NIf, m] -> (I - S) gamma`` on
    ``level``'s device.
    """
    t = level.tables
    m = t.m
    S2 = 2 * level.D
    NIf = t.num_ifaces
    class_of, R = _probe_responses(level)
    T = _dense_case_templates(t)  # [ncase, m, m]

    # -- pointer entries with deduplicated blocks --------------------------
    blk_ids: dict = {}
    blocks: list = []
    ent_row, ent_col, ent_blk = [], [], []
    for s in range(S2):
        src_iface = t.iface_side_idx[:, s]
        src_mask = t.iface_side_mask[:, s]
        sel = np.where(src_mask[t.contrib_patch])[0]
        for c in sel:
            p = int(t.contrib_patch[c])
            key = (s, int(class_of[p]), int(t.contrib_side[c]),
                   int(t.contrib_case[c]))
            b = blk_ids.get(key)
            if b is None:
                b = blk_ids[key] = len(blocks)
                # out = block @ gamma_col; stored transposed for row @ W
                blocks.append((T[key[3]] @ R[s, :, key[1], key[2], :].T).T)
            ent_row.append(int(t.contrib_iface[c]))
            ent_col.append(int(src_iface[p]))
            ent_blk.append(b)
    E = len(ent_row)

    # sort entries by block id -> per-block contiguous segments
    order = np.argsort(np.asarray(ent_blk, dtype=np.int64), kind="stable")
    ent_row = np.asarray(ent_row, dtype=np.int64)[order]
    ent_col = np.asarray(ent_col, dtype=np.int64)[order]
    ent_blk = np.asarray(ent_blk, dtype=np.int64)[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(ent_blk)) + 1])
    stops = np.concatenate([starts[1:], [E]])
    segs = [(int(ent_blk[a]), int(a), int(b)) for a, b in zip(starts, stops)]

    # iface-major padded row reduction (gather + sum, no scatter)
    by_row: dict = {}
    for e in range(E):
        by_row.setdefault(int(ent_row[e]), []).append(e)
    Ks = max((len(v) for v in by_row.values()), default=1)
    gath = np.full((NIf, Ks), E, dtype=np.int64)  # pad -> zero row
    for i, lst in by_row.items():
        gath[i, : len(lst)] = lst

    dev = level.device
    cols = torch.as_tensor(ent_col, device=dev)
    gath_t = torch.as_tensor(gath.reshape(-1), device=dev)
    W = torch.as_tensor(np.stack(blocks), dtype=level.dtype, device=dev)

    def mv(gamma):
        g_in = gamma.index_select(0, cols)  # [E, m] row gather
        parts = [g_in[a:b] @ W[bid] for bid, a, b in segs]
        parts.append(g_in.new_zeros(1, m))
        acc = torch.cat(parts).index_select(0, gath_t).reshape(NIf, Ks, m).sum(dim=1)
        return gamma - acc

    return mv

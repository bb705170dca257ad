"""Domain layer: extraction of per-level patch tables from the tree.

Numpy only; carried from ``pressurepoissonsolver_tpu.domain`` (the tests
hold every table equal to the reference's).  Instead of a pointer graph of
per-patch records (the ``PatchInfo`` / ``Domain`` / ``ThundereggDomGen``
machinery, SURVEY.md §2.2), each multigrid level is a set of flat NumPy
arrays indexed by a dense patch slot, ready to be uploaded once and
consumed by batched device ops.

Level-``k`` patch set (reference ``ThundereggDomGen.h:127-222``): all tree
nodes at level ``k`` plus every leaf at a coarser level.  Leaves coarser
than ``k`` appear on level ``k`` (and all coarser levels down to their own)
as *pass-through* patches that are their own parent
(``ThundereggDomGen.h:152-163``).

Neighbor types per side (``PatchInfo.h:40-53``):

* ``NONE`` — physical boundary.
* ``NORMAL`` — one neighbor at the same refinement level.
* ``COARSE`` — the neighbor is one level coarser; ``coarse_orth`` records
  which of the ``2**(D-1)`` face-orthants of the coarse face this patch
  occupies (in the ``geometry.orthants_on_side`` ordering).
* ``FINE`` — ``2**(D-1)`` neighbors one level finer, stored in face-orthant
  order of the opposite side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import geometry as geo
from .geometry import Tree
from .utils import profiling
from .utils.profiling import span

NBR_NONE = 0
NBR_NORMAL = 1
NBR_COARSE = 2
NBR_FINE = 3


@dataclass
class PatchLevel:
    """Flat patch tables for one refinement level.

    All index-valued arrays refer to *patch slots* (positions in these
    arrays), not tree node ids, except ``ids`` which keeps the original
    globally-unique tree node id for provenance / inter-level matching.
    """

    D: int
    n: int  # cells per side of a patch (isotropic, as in the reference apps)
    tree_level: int

    ids: np.ndarray  # [P] int64 — tree node id
    starts: np.ndarray  # [P, D] float64 — physical lower corner
    spacings: np.ndarray  # [P, D] float64 — cell size h per axis
    refine_level: np.ndarray  # [P] int32 — tree level of the node
    parent_id: np.ndarray  # [P] int64 — tree id of parent (== own id if pass-through)
    orth_on_parent: np.ndarray  # [P] int32 — orthant within parent; -1 if pass-through
    neumann: np.ndarray  # [P, 2D] bool — physical boundary with Neumann BC
    nbr_type: np.ndarray  # [P, 2D] int8
    nbr_slot: np.ndarray  # [P, 2D] int64 — slot of NORMAL or COARSE nbr; -1 otherwise
    coarse_orth: np.ndarray  # [P, 2D] int32 — face-orthant on the coarse nbr; -1
    fine_nbr_slots: np.ndarray  # [P, 2D, 2**(D-1)] int64 — slots of FINE nbrs; -1
    # number of real (non-padding) patches; None = all.  Levels padded
    # with isolated dummy patches (the reference's sharded levels) keep
    # them identically zero.
    num_real: Optional[int] = None

    @property
    def num_patches(self) -> int:
        return len(self.ids)

    @property
    def real_patches(self) -> int:
        return self.num_real if self.num_real is not None else self.num_patches

    @property
    def ns_shape(self):
        """Per-patch array shape, axes reversed so x is last/fastest —
        matching the reference's stride-1-in-x memory layout."""
        return (self.n,) * self.D

    @property
    def cells_per_patch(self) -> int:
        return self.n**self.D

    @property
    def num_cells(self) -> int:
        return self.num_patches * self.cells_per_patch

    def has_nbr(self) -> np.ndarray:
        return self.nbr_type != NBR_NONE

    def cell_centers(self) -> np.ndarray:
        """Physical coordinates of cell centers, shape [P, *ns_rev, D].

        Cell ``i`` center on axis ``a`` is ``start + h/2 + h*i``
        (reference ``apps/shared/Init.cpp:25-52``).
        """
        P, D, n = self.num_patches, self.D, self.n
        out = np.zeros((P,) + self.ns_shape + (D,))
        idx = np.arange(n)
        for a in range(D):
            # array axis for spatial axis a (x fastest): 1 + (D-1-a)
            shape = [1] * (D + 1)
            shape[1 + (D - 1 - a)] = n
            coord = self.starts[:, a].reshape((P,) + (1,) * D) + (
                self.spacings[:, a].reshape((P,) + (1,) * D)
                * (idx.reshape(shape) + 0.5)
            )
            out[..., a] = coord
        return out

    def volume(self) -> float:
        real = self.real_patches
        return float(
            np.sum(np.prod(self.spacings[:real], axis=1)) * self.cells_per_patch
        )


def normalize_neumann(neumann, D: int):
    """Normalize a Neumann BC spec (reference ``IsNeumannFunc``,
    ``PatchInfo.h:684-697``):

    * ``bool`` — all physical boundaries Dirichlet/Neumann;
    * an iterable of side names (``"x_lo", "x_hi", "y_lo", "y_hi", "z_lo",
      "z_hi"``) or side indices — those walls Neumann, the rest Dirichlet;
    * a callable ``fn(side, starts, lengths) -> bool`` evaluated per patch
      on its physical boundary (full ``IsNeumannFunc`` parity: the
      reference passes the side and the patch's physical bounds).

    Returns ``bool`` | ``np.ndarray[2D] of bool`` | the callable.
    """
    if callable(neumann):
        return neumann
    if isinstance(neumann, (bool, np.bool_)):
        return bool(neumann)
    if isinstance(neumann, np.ndarray) and neumann.dtype == bool:
        return neumann  # already normalized (idempotent)
    names = {
        f"{'xyz'[a]}_{tag}": 2 * a + i
        for a in range(D)
        for i, tag in enumerate(("lo", "hi"))
    }
    side_mask = np.zeros(2 * D, dtype=bool)
    for tok in neumann:
        if isinstance(tok, str):
            if tok not in names:
                raise ValueError(
                    f"unknown side {tok!r}; valid: {sorted(names)}"
                )
            side_mask[names[tok]] = True
        else:
            side_mask[int(tok)] = True
    return side_mask


def _eval_neumann(nm, s: int, node) -> bool:
    if callable(nm):
        return bool(nm(s, node.starts, node.lengths))
    if isinstance(nm, np.ndarray):
        return bool(nm[s])
    return bool(nm)


def extract_level(tree: Tree, tree_level: int, n: int, neumann=False) -> PatchLevel:
    """Build the patch tables for one level of the hierarchy.

    Follows the reference's BFS over the neighbor graph starting from the
    level's representative node (``ThundereggDomGen.h:127-222``), but
    enumerates the patch set directly: nodes at ``tree_level`` plus leaves
    at coarser levels.  Patches are ordered by tree id for determinism.
    """
    D = tree.D
    S = 2 * D
    half = 1 << (D - 1)
    nm = normalize_neumann(neumann, D)

    members: List[int] = []
    for nid, node in tree.nodes.items():
        if node.level == tree_level or (node.level < tree_level and not node.has_children()):
            members.append(nid)
    members.sort()
    slot_of: Dict[int, int] = {nid: i for i, nid in enumerate(members)}
    P = len(members)

    ids = np.array(members, dtype=np.int64)
    starts = np.zeros((P, D))
    spacings = np.zeros((P, D))
    refine_level = np.zeros(P, dtype=np.int32)
    parent_id = np.full(P, -1, dtype=np.int64)
    orth_on_parent = np.full(P, -1, dtype=np.int32)
    neumann_arr = np.zeros((P, S), dtype=bool)
    nbr_type = np.zeros((P, S), dtype=np.int8)
    nbr_slot = np.full((P, S), -1, dtype=np.int64)
    coarse_orth = np.full((P, S), -1, dtype=np.int32)
    fine_nbr_slots = np.full((P, S, half), -1, dtype=np.int64)

    for i, nid in enumerate(members):
        node = tree.nodes[nid]
        starts[i] = node.starts
        spacings[i] = node.lengths / n
        refine_level[i] = node.level
        if node.level < tree_level:
            parent_id[i] = nid  # pass-through: own parent
        else:
            parent_id[i] = node.parent
            if node.parent != -1:
                pchildren = tree.nodes[node.parent].child_id
                orth_on_parent[i] = int(np.where(pchildren == nid)[0][0])

        for s in range(S):
            if not node.has_nbr(s) and node.parent != -1 and tree.nodes[node.parent].has_nbr(s):
                # coarser neighbor (ThundereggDomGen.h:167-179)
                parent = tree.nodes[node.parent]
                nbr = tree.nodes[int(parent.nbr_id[s])]
                octs = geo.orthants_on_side(s, D)
                quad = next(
                    q for q, o in enumerate(octs) if int(parent.child_id[o]) == nid
                )
                nbr_type[i, s] = NBR_COARSE
                nbr_slot[i, s] = slot_of[nbr.id]
                coarse_orth[i, s] = quad
            elif (
                node.level < tree_level
                and node.has_nbr(s)
                and tree.nodes[int(node.nbr_id[s])].has_children()
            ):
                # finer neighbors (ThundereggDomGen.h:180-193)
                nbr = tree.nodes[int(node.nbr_id[s])]
                octs = geo.orthants_on_side(geo.side_opposite(s), D)
                nbr_type[i, s] = NBR_FINE
                for q, o in enumerate(octs):
                    fine_nbr_slots[i, s, q] = slot_of[int(nbr.child_id[o])]
            elif node.has_nbr(s):
                nbr_type[i, s] = NBR_NORMAL
                nbr_slot[i, s] = slot_of[int(node.nbr_id[s])]
            else:
                # physical boundary: evaluate the BC spec per patch side
                neumann_arr[i, s] = _eval_neumann(nm, s, node)

    return PatchLevel(
        D=D,
        n=n,
        tree_level=tree_level,
        ids=ids,
        starts=starts,
        spacings=spacings,
        refine_level=refine_level,
        parent_id=parent_id,
        orth_on_parent=orth_on_parent,
        neumann=neumann_arr,
        nbr_type=nbr_type,
        nbr_slot=nbr_slot,
        coarse_orth=coarse_orth,
        fine_nbr_slots=fine_nbr_slots,
    )


class DomainHierarchy:
    """The full finest→coarsest stream of :class:`PatchLevel` objects
    (reference ``DomainGenerator`` contract, ``DomainGenerator.h:437-456``).

    With ``use_native`` (and ``g++`` at hand, :func:`.native.available`)
    every level's patch and interface tables come from the native C++
    generator, which fills ``iface_tables`` and each level's
    ``prebuilt_iface_tables`` (consumed by ``ops.level_ops.Level``);
    otherwise, and for a callable Neumann spec, from the pure-Python
    builders :func:`extract_level` and ``iface.build_iface_tables``, which
    give the same tables.  ``builder`` records which one ran.

    ``num_shards > 1`` prepares every level for patch-axis sharding over
    that many ranks: the patch slots are reordered along the Morton curve
    (``partition="morton"``, the only method; :mod:`.parallel.partition`, the
    static replacement of the reference's Zoltan balancing; a parent's
    Morton key prefixes its children's, so parents land near their
    children), and every level is padded with isolated dummy patches to a
    multiple of ``num_shards`` (``parallel.sharding.pad_level``)."""

    @profiling.spanned("pps.domain.hierarchy", device=False)
    def __init__(self, tree: Tree, n: int, neumann=False, use_native: bool = True,
                 num_shards: int = 1, partition: str = "morton"):
        if partition != "morton":
            raise ValueError(f"partition={partition!r}: only 'morton'")
        if num_shards < 1:
            raise ValueError(f"num_shards={num_shards}: at least 1")
        self.tree = tree
        self.n = n
        self.neumann = neumann
        self.num_shards = num_shards
        self.levels: List[PatchLevel] = []
        #: per-level prebuilt interface tables (None from the Python builder)
        self.iface_tables: List[Optional[object]] = []
        nm = normalize_neumann(neumann, tree.D)
        native = None
        if use_native and not callable(nm):
            from . import native as native_mod

            if native_mod.available():
                native = native_mod
        self.builder = "python" if native is None else "native"
        for lvl in range(tree.num_levels - 1, -1, -1):
            if native is None:
                pl, tables = extract_level(tree, lvl, n, nm), None
            elif isinstance(nm, bool):
                with span("pps.domain.native_tables", device=False):
                    pl, tables = native.build_level_native(tree, lvl, n, nm)
            else:
                # per-side spec: the native builder takes one flag, and the
                # interface tables do not depend on the walls: post-fix them
                with span("pps.domain.native_tables", device=False):
                    pl, tables = native.build_level_native(tree, lvl, n, False)
                pl.neumann = (pl.nbr_type == NBR_NONE) & nm[None, :]
            if num_shards > 1:
                pl, tables = _shard_level(pl, tables, num_shards)
            pl.prebuilt_iface_tables = tables
            self.levels.append(pl)
            self.iface_tables.append(tables)

    @property
    def finest(self) -> PatchLevel:
        return self.levels[0]

    def __len__(self) -> int:
        return len(self.levels)

    def __getitem__(self, i: int) -> PatchLevel:
        return self.levels[i]


def _shard_level(pl: PatchLevel, tables, num_shards: int):
    """One level's tables Morton-ordered and padded
    to a multiple of ``num_shards`` (see :class:`DomainHierarchy`)."""
    from . import iface as iface_mod
    from .parallel.partition import morton_order, reorder_level
    from .parallel.sharding import pad_level

    perm = morton_order(pl)
    pl = reorder_level(pl, perm)
    if tables is not None:
        tables = iface_mod.permute_tables(tables, perm)
    pl = pad_level(pl, num_shards)
    if tables is not None:
        tables = iface_mod.pad_tables(tables, pl.num_patches)
    return pl, tables


def parent_slots(fine: PatchLevel, coarse: PatchLevel) -> np.ndarray:
    """For each fine patch, the slot of its parent patch in the coarse level
    (reference ``GMG/InterLevelComm.h:114-160``).  Pass-through patches map
    to themselves (their id appears on the coarse level too)."""
    coarse_slot_of = {int(pid): i for i, pid in enumerate(coarse.ids)}
    return np.array(
        [coarse_slot_of.get(int(pid), -1) for pid in fine.parent_id],
        dtype=np.int64,
    )

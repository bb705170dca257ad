"""Geometry & topology primitives: sides, orthants, and the refinement tree.

Host-side (pure Python/NumPy) — this layer builds the static metadata that
the device kernels consume as int32 index tables.

Semantics follow the reference library's conventions (see SURVEY.md §2.1):

* A *side* of a D-cube is an int in ``[0, 2D)``: ``2*axis`` is the side
  lower on that axis, ``2*axis+1`` the upper one
  (reference ``Side.h:41-162``: west=0, east=1, south=2, north=3,
  bottom=4, top=5).
* An *orthant* is an int in ``[0, 2**D)`` whose bit ``a`` is set when the
  orthant is on the *upper* half of axis ``a``
  (reference ``Side.h:171-368``: bsw=0b000 … tne=0b111).
* The refinement tree is a quadtree (2D) / octree (3D) of nodes with
  per-side neighbor ids and per-orthant child ids, maintained with 2:1
  balance (reference ``OctNode.h:29-132``, ``OctTree.h:34-213``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Side / Orthant math
# ---------------------------------------------------------------------------


def num_sides(D: int) -> int:
    return 2 * D


def num_orthants(D: int) -> int:
    return 1 << D


def side_axis(s: int) -> int:
    """Axis orthogonal to side ``s``."""
    return s // 2


def side_is_lower(s: int) -> bool:
    """True when the side is lower on its axis (reference ``Side.h:97-101``)."""
    return (s & 1) == 0


def side_opposite(s: int) -> int:
    return s ^ 1


def orthant_is_on_side(o: int, s: int) -> bool:
    """Does orthant ``o`` touch side ``s`` of the cube?

    Reference ``Side.h:289-295``: bit ``s//2`` of ``o`` must equal ``s%2``.
    """
    return ((o >> (s // 2)) & 1) == (s % 2)


def orthant_interior_nbr_on_side(o: int, s: int) -> int:
    """Sibling orthant adjacent to ``o`` across side ``s`` (``Side.h:332-345``)."""
    return o ^ (1 << (s // 2))


def orthant_exterior_nbr_on_side(o: int, s: int) -> int:
    return o ^ (1 << (s // 2))


def orthant_interior_sides(o: int, D: int) -> List[int]:
    """Sides of orthant ``o`` facing the interior of the cube (``Side.h:257-266``)."""
    out = []
    for a in range(D):
        s = 2 * a
        if not ((o >> a) & 1):
            s |= 1
        out.append(s)
    return out


def orthant_exterior_sides(o: int, D: int) -> List[int]:
    out = []
    for a in range(D):
        s = 2 * a
        if (o >> a) & 1:
            s |= 1
        out.append(s)
    return out


def orthants_on_side(s: int, D: int) -> List[int]:
    """The ``2**(D-1)`` orthants touching side ``s``, ordered so that index
    ``i`` enumerates the remaining axes' bits with lower axes varying
    fastest (reference ``Side.h:346-362``, the documented

        ``2 | 3``
        ``0 | 1``

    ordering of a face).  This ordering defines the ``orth_on_coarse``
    index used by coarse/fine interface bookkeeping.
    """
    bit = s // 2
    set_bit = 0 if side_is_lower(s) else 1
    lower_mask = ~((~0) << bit)
    upper_mask = (~0) << (bit + 1)
    out = []
    for i in range(1 << (D - 1)):
        v = ((i << 1) & upper_mask) | (i & lower_mask) | (set_bit << bit)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Tree
# ---------------------------------------------------------------------------


@dataclass
class Node:
    """A node of the refinement tree (reference ``OctNode.h:29-132``)."""

    id: int = -1
    level: int = -1
    parent: int = -1
    lengths: Optional[np.ndarray] = None  # [D] float64
    starts: Optional[np.ndarray] = None  # [D] float64
    nbr_id: Optional[np.ndarray] = None  # [2D] int
    child_id: Optional[np.ndarray] = None  # [2**D] int

    def has_children(self) -> bool:
        return int(self.child_id[0]) != -1

    def has_nbr(self, s: int) -> bool:
        return int(self.nbr_id[s]) != -1


def _child_node(parent: Node, o: int, D: int) -> Node:
    """Child of ``parent`` on orthant ``o`` (reference ``OctNode.h:76-87``)."""
    lengths = parent.lengths / 2.0
    starts = parent.starts.copy()
    for a in range(D):
        if not orthant_is_on_side(o, 2 * a):  # on upper half of axis a
            starts[a] = parent.starts[a] + lengths[a]
    return Node(
        id=-1,
        level=parent.level + 1,
        parent=parent.id,
        lengths=lengths,
        starts=starts,
        nbr_id=np.full(2 * D, -1, dtype=np.int64),
        child_id=np.full(1 << D, -1, dtype=np.int64),
    )


class Tree:
    """Quadtree/octree with per-side neighbor links and 2:1 balance.

    Mirrors the reference ``Tree<D>`` (``OctTree.h:34-213``), including its
    binary file format (``OctTree.h:90-118``)::

        int32 num_nodes, int32 num_trees,
        then per node: int32 id, level, parent;
                       float64 lengths[D]; float64 starts[D];
                       int32 nbr_id[2D]; int32 child_id[2**D]
    """

    def __init__(self, D: int):
        self.D = D
        self.nodes: Dict[int, Node] = {}
        self.levels: Dict[int, int] = {}  # level -> a representative node id
        self.root = 0
        self.max_id = 0
        self.num_levels = 1
        root = Node(
            id=0,
            level=0,
            parent=-1,
            lengths=np.ones(D),
            starts=np.zeros(D),
            nbr_id=np.full(2 * D, -1, dtype=np.int64),
            child_id=np.full(1 << D, -1, dtype=np.int64),
        )
        self.nodes[0] = root
        self.levels[0] = 0

    # -- file I/O -----------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, D: int) -> "Tree":
        t = cls.__new__(cls)
        t.D = D
        t.nodes = {}
        t.levels = {}
        t.num_levels = 0
        t.max_id = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        num_nodes, _num_trees = struct.unpack_from("<ii", data, off)
        off += 8
        S, O = 2 * D, 1 << D
        for i in range(num_nodes):
            nid, level, parent = struct.unpack_from("<iii", data, off)
            off += 12
            lengths = np.frombuffer(data, dtype="<f8", count=D, offset=off).copy()
            off += 8 * D
            starts = np.frombuffer(data, dtype="<f8", count=D, offset=off).copy()
            off += 8 * D
            nbr_id = np.frombuffer(data, dtype="<i4", count=S, offset=off).astype(np.int64)
            off += 4 * S
            child_id = np.frombuffer(data, dtype="<i4", count=O, offset=off).astype(np.int64)
            off += 4 * O
            n = Node(nid, level, parent, lengths, starts, nbr_id, child_id)
            if i == 0:
                t.root = nid
            t.max_id = max(t.max_id, nid)
            t.nodes[nid] = n
            t.num_levels = max(t.num_levels, n.level + 1)
            t.levels[n.level] = nid
        if off != len(data):
            raise ValueError(
                f"tree file {path}: consumed {off} bytes of {len(data)} — wrong D?"
            )
        # normalize node levels so the root sits at level 0 (the reference
        # fixtures store 1-based levels; the in-memory convention here is
        # 0-based counts)
        min_level = min(n.level for n in t.nodes.values())
        if min_level != 0:
            for n in t.nodes.values():
                n.level -= min_level
            t.levels = {lvl - min_level: nid for lvl, nid in t.levels.items()}
            t.num_levels -= min_level
        return t

    def to_file(self, path: str) -> None:
        D = self.D
        with open(path, "wb") as f:
            f.write(struct.pack("<ii", len(self.nodes), 1))
            # root first to match the reference reader's `if (i==0) root=id`
            order = [self.root] + [i for i in sorted(self.nodes) if i != self.root]
            for nid in order:
                n = self.nodes[nid]
                f.write(struct.pack("<iii", n.id, n.level, n.parent))
                f.write(np.asarray(n.lengths, dtype="<f8").tobytes())
                f.write(np.asarray(n.starts, dtype="<f8").tobytes())
                f.write(np.asarray(n.nbr_id, dtype="<i4").tobytes())
                f.write(np.asarray(n.child_id, dtype="<i4").tobytes())

    # -- refinement ---------------------------------------------------------

    def leaves(self) -> List[int]:
        return [nid for nid, n in self.nodes.items() if not n.has_children()]

    def refine_leaves(self) -> None:
        """Add one uniformly finer level by refining every leaf.

        The reference walks the leaf adjacency graph from one deepest leaf
        (``OctTree.h:119-179``); for face-connected domains that visits
        every leaf, so refining all leaves is equivalent and keeps 2:1
        balance.
        """
        for nid in sorted(self.leaves()):
            self.refine_node(nid)
        # representative for the new finest level
        rep = self.nodes[self.levels[self.num_levels - 1]]
        self.levels[self.num_levels] = int(rep.child_id[0])
        self.num_levels += 1

    def refine_node(self, nid: int) -> None:
        """Create 2**D children of node ``nid`` and stitch neighbor links
        (reference ``OctTree.h:180-213``)."""
        D = self.D
        n = self.nodes[nid]
        children: List[Node] = []
        for o in range(1 << D):
            c = _child_node(n, o, D)
            self.max_id += 1
            c.id = self.max_id
            n.child_id[o] = c.id
            children.append(c)
        # sibling links
        for o in range(1 << D):
            for s in orthant_interior_sides(o, D):
                children[o].nbr_id[s] = children[orthant_interior_nbr_on_side(o, s)].id
        # links to already-refined neighbors' children
        for s in range(2 * D):
            if n.has_nbr(s) and self.nodes[int(n.nbr_id[s])].has_children():
                nbr = self.nodes[int(n.nbr_id[s])]
                for o in orthants_on_side(s, D):
                    child = children[o]
                    nbr_child = self.nodes[int(nbr.child_id[orthant_exterior_nbr_on_side(o, s)])]
                    child.nbr_id[s] = nbr_child.id
                    nbr_child.nbr_id[side_opposite(s)] = child.id
        for c in children:
            self.nodes[c.id] = c


def uniform_tree(D: int, levels: int) -> Tree:
    """A tree refined uniformly ``levels-1`` times (so the finest level is a
    ``2**(levels-1)``-per-side grid of leaves)."""
    t = Tree(D)
    for _ in range(levels - 1):
        t.refine_leaves()
    return t


def refined_tree(D: int, base_levels: int, corner_levels: int = 1) -> Tree:
    """An adaptively refined tree: uniform to ``base_levels``, then the
    lower-corner (orthant-0) leaf refined ``corner_levels`` more times with
    a 2:1-balance walk — similar in spirit to the ``2refine`` fixture."""
    t = uniform_tree(D, base_levels)
    for _ in range(corner_levels):
        # find the leaf containing the domain origin
        nid = t.root
        while t.nodes[nid].has_children():
            nid = int(t.nodes[nid].child_id[0])
        _refine_with_balance(t, nid)
        t.levels[t.num_levels] = int(t.nodes[nid].child_id[0])
        t.num_levels += 1
    return t


def _refine_with_balance(t: Tree, nid: int) -> None:
    """Refine node ``nid``, recursively refining coarser neighbors first to
    maintain 2:1 balance."""
    n = t.nodes[nid]
    for s in range(2 * t.D):
        if (
            not n.has_nbr(s)
            and n.parent != -1
            and t.nodes[n.parent].has_nbr(s)
        ):
            # neighbor is coarser: must refine it first
            coarse_nbr = int(t.nodes[n.parent].nbr_id[s])
            if not t.nodes[coarse_nbr].has_children():
                _refine_with_balance(t, coarse_nbr)
    t.refine_node(nid)

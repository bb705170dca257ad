"""The benchmark's own mesh generator and its frozen copy of the mesh-file writer.

A configuration's ``mesh`` entry describes a graded quadtree or octree over
the unit square or cube: ``uniform`` uniform refinements of the root, then
for each box of ``refine_inside`` every leaf lying inside it refined once
(with a 2:1 balance walk), then every leaf refined ``divide`` times (the
reference CLI's ``--divide``).  The tree structure, the balance walk and the
binary mesh file are copies of ``pressurepoissonsolver_torch.geometry``'s
``Tree.refine_node``, ``_refine_with_balance``, ``Tree.refine_leaves`` and
``Tree.to_file``, kept here so that a change to the program cannot change the
benchmark's inputs; ``benchmark/tests/test_harness_copies.py`` holds the tree
equal to one the program builds the same way.

The tree is handed to the program as a mesh file (:func:`write_mesh`, read by
``geometry.Tree.from_file``) and to the plain reference as arrays
(:func:`leaf_boxes`).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _on_side(o: int, s: int) -> bool:
    """Does orthant ``o`` touch side ``s`` (bit ``s//2`` of ``o`` equals
    ``s % 2``)?"""
    return ((o >> (s // 2)) & 1) == (s % 2)


def _interior_sides(o: int, D: int) -> List[int]:
    return [2 * a + (0 if (o >> a) & 1 else 1) for a in range(D)]


def _orthants_on_side(s: int, D: int) -> List[int]:
    """The orthants touching side ``s``, the remaining axes' bits with the
    lower axes varying fastest."""
    bit = s // 2
    set_bit = s & 1
    lower_mask = ~((~0) << bit)
    upper_mask = (~0) << (bit + 1)
    return [((i << 1) & upper_mask) | (i & lower_mask) | (set_bit << bit)
            for i in range(1 << (D - 1))]


class Node:
    __slots__ = ("id", "level", "parent", "lengths", "starts", "nbr_id", "child_id")

    def __init__(self, nid, level, parent, lengths, starts, D):
        self.id = nid
        self.level = level
        self.parent = parent
        self.lengths = lengths
        self.starts = starts
        self.nbr_id = np.full(2 * D, -1, dtype=np.int64)
        self.child_id = np.full(1 << D, -1, dtype=np.int64)

    def has_children(self) -> bool:
        return int(self.child_id[0]) != -1

    def has_nbr(self, s: int) -> bool:
        return int(self.nbr_id[s]) != -1


class Tree:
    """A quadtree (2D) or octree (3D) over the unit square or cube, with
    per-side neighbour links and 2:1 balance."""

    def __init__(self, D: int):
        self.D = D
        self.nodes: Dict[int, Node] = {0: Node(0, 0, -1, np.ones(D), np.zeros(D), D)}
        self.root = 0
        self.max_id = 0

    def leaves(self) -> List[int]:
        return [nid for nid, n in self.nodes.items() if not n.has_children()]

    def refine_leaves(self) -> None:
        """One uniformly finer level: every leaf refined."""
        for nid in sorted(self.leaves()):
            self.refine_node(nid)

    def refine_node(self, nid: int) -> None:
        D = self.D
        n = self.nodes[nid]
        children = []
        for o in range(1 << D):
            lengths = n.lengths / 2.0
            starts = n.starts.copy()
            for a in range(D):
                if not _on_side(o, 2 * a):
                    starts[a] = n.starts[a] + lengths[a]
            self.max_id += 1
            c = Node(self.max_id, n.level + 1, n.id, lengths, starts, D)
            n.child_id[o] = c.id
            children.append(c)
        for o in range(1 << D):
            for s in _interior_sides(o, D):
                children[o].nbr_id[s] = children[o ^ (1 << (s // 2))].id
        for s in range(2 * D):
            if n.has_nbr(s) and self.nodes[int(n.nbr_id[s])].has_children():
                nbr = self.nodes[int(n.nbr_id[s])]
                for o in _orthants_on_side(s, D):
                    nbr_child = self.nodes[int(nbr.child_id[o ^ (1 << (s // 2))])]
                    children[o].nbr_id[s] = nbr_child.id
                    nbr_child.nbr_id[s ^ 1] = children[o].id
        for c in children:
            self.nodes[c.id] = c

    def _refine_with_balance(self, nid: int) -> None:
        n = self.nodes[nid]
        for s in range(2 * self.D):
            if not n.has_nbr(s) and n.parent != -1 and self.nodes[n.parent].has_nbr(s):
                coarse_nbr = int(self.nodes[n.parent].nbr_id[s])
                if not self.nodes[coarse_nbr].has_children():
                    self._refine_with_balance(coarse_nbr)
        self.refine_node(nid)


def graded_tree(D: int, uniform: int, refine_inside: Sequence = (),
                divide: int = 0) -> Tree:
    """``uniform`` uniform refinements of the root; then, box by box, every
    leaf inside ``[lo, hi]`` (a pair of ``D`` coordinates) refined once,
    2:1 balanced; then every leaf refined ``divide`` times."""
    t = Tree(D)
    for _ in range(uniform):
        t.refine_leaves()
    for lo, hi in refine_inside:
        lo, hi = np.asarray(lo, dtype=float), np.asarray(hi, dtype=float)
        for nid in sorted(t.leaves()):
            n = t.nodes[nid]
            if (not n.has_children() and np.all(n.starts >= lo)
                    and np.all(n.starts + n.lengths <= hi)):
                t._refine_with_balance(nid)
    for _ in range(divide):
        t.refine_leaves()
    return t


def write_mesh(tree: Tree, path: str) -> None:
    """The reference's binary mesh file: ``int32 num_nodes, num_trees``,
    then per node (root first) ``int32 id, level, parent``, ``float64
    lengths[D], starts[D]``, ``int32 nbr_id[2D], child_id[2**D]``."""
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", len(tree.nodes), 1))
        order = [tree.root] + [i for i in sorted(tree.nodes) if i != tree.root]
        for nid in order:
            n = tree.nodes[nid]
            f.write(struct.pack("<iii", n.id, n.level, n.parent))
            f.write(np.asarray(n.lengths, dtype="<f8").tobytes())
            f.write(np.asarray(n.starts, dtype="<f8").tobytes())
            f.write(np.asarray(n.nbr_id, dtype="<i4").tobytes())
            f.write(np.asarray(n.child_id, dtype="<i4").tobytes())


def leaf_boxes(tree: Tree) -> Tuple[np.ndarray, np.ndarray]:
    """``(starts, lengths)``, each ``[P, D]`` float64, of the leaves in
    ascending node id: the patches of the finest composite level in the
    order the program's finest level holds them."""
    ids = sorted(tree.leaves())
    starts = np.stack([tree.nodes[i].starts for i in ids])
    lengths = np.stack([tree.nodes[i].lengths for i in ids])
    return starts, lengths


def build(mesh: dict, D: int) -> Tree:
    """The tree a configuration's ``mesh`` entry describes."""
    return graded_tree(D, int(mesh["uniform"]), mesh.get("refine_inside", ()),
                       int(mesh.get("divide", 0)))


def leaf_levels(tree: Tree) -> int:
    """The number of distinct levels among the leaves."""
    return len({tree.nodes[i].level for i in tree.leaves()})

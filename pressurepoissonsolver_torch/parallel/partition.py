"""Static partitioning: Morton (Z-order) space-filling-curve ordering.

Numpy only; carried from ``pressurepoissonsolver_tpu.parallel.partition``
(the tests hold every table equal to the reference's).  The
replacement for the reference's Zoltan hypergraph partitioning
with migration (``ThundereggDomGen.h:223-648``): patch slots are ordered
along a Morton curve so a static block partition over the mesh axis gives
compact, face-sharing shards — the same locality objective as the
reference's hypergraph edges-as-shared-faces model.  The coarse-level
"fixed vertex" affinity (``balanceLevelWithLower``: parents land near
children) holds automatically because a parent's Morton key is the prefix
of its children's keys.
"""

from __future__ import annotations

import numpy as np

from ..domain import PatchLevel


def _spread_bits(x: np.ndarray, D: int, nbits: int) -> np.ndarray:
    """Insert D-1 zero bits between the bits of x."""
    out = np.zeros_like(x, dtype=np.uint64)
    for b in range(nbits):
        out |= ((x >> b) & 1).astype(np.uint64) << np.uint64(D * b)
    return out


def morton_keys(level: PatchLevel, nbits: int = 16) -> np.ndarray:
    """Morton key of each patch from its physical lower corner, normalized
    to the domain bounding box."""
    starts = level.starts
    lo = starts.min(axis=0)
    extent = (starts + level.spacings * level.n).max(axis=0) - lo
    extent[extent == 0] = 1.0
    key = np.zeros(level.num_patches, dtype=np.uint64)
    for a in range(level.D):
        # power-of-two-exact quantization keeps dyadic patch corners aligned
        q = np.floor(((starts[:, a] - lo[a]) / extent[a]) * (1 << nbits))
        q = np.clip(q, 0, (1 << nbits) - 1)
        key |= _spread_bits(q.astype(np.uint64), level.D, nbits) << np.uint64(a)
    return key


def morton_order(level: PatchLevel) -> np.ndarray:
    """Permutation of patch slots along the Morton curve (stable by id)."""
    keys = morton_keys(level)
    return np.lexsort((level.ids, keys))


def reorder_level(level: PatchLevel, perm: np.ndarray) -> PatchLevel:
    """Apply a slot permutation to all patch tables, remapping neighbor
    slot references."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    def remap_slots(a):
        out = a[perm].copy()
        valid = out >= 0
        out[valid] = inv[out[valid]]
        return out

    return PatchLevel(
        D=level.D,
        n=level.n,
        tree_level=level.tree_level,
        ids=level.ids[perm],
        starts=level.starts[perm],
        spacings=level.spacings[perm],
        refine_level=level.refine_level[perm],
        parent_id=level.parent_id[perm],
        orth_on_parent=level.orth_on_parent[perm],
        neumann=level.neumann[perm],
        nbr_type=level.nbr_type[perm],
        nbr_slot=remap_slots(level.nbr_slot),
        coarse_orth=level.coarse_orth[perm],
        fine_nbr_slots=remap_slots(level.fine_nbr_slots),
    )


def block_partition(num_patches: int, num_shards: int) -> np.ndarray:
    """Shard index of each patch slot under a contiguous block partition."""
    return (np.arange(num_patches) * num_shards) // max(num_patches, 1)


def cut_faces(level: PatchLevel, shard_of: np.ndarray) -> int:
    """Number of patch faces crossing shard boundaries (the communication
    volume a partition induces — the quantity Zoltan minimizes)."""
    cut = 0
    for p in range(level.num_patches):
        for s in range(2 * level.D):
            q = level.nbr_slot[p, s]
            if q >= 0 and shard_of[p] != shard_of[q]:
                cut += 1
            for fq in level.fine_nbr_slots[p, s]:
                if fq >= 0 and shard_of[p] != shard_of[fq]:
                    cut += 1
    return cut

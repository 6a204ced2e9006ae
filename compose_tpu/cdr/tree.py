"""Reduction-tree topology for QLT and the BFB tree allreduce.

Counterpart of /root/reference/cedr/cedr_tree.{hpp,cpp}. The reference builds
a pointer-based caller tree, prunes it per MPI rank, and derives a level
schedule with per-level message consolidation. Here the whole tree lives in
flat index arrays: nodes are numbered leaves-first, every internal node lists
its two kids, and nodes are grouped into levels (level = max(kid levels)+1,
exactly the reference's deadlock-free schedule, cedr_tree.cpp:185-213). The
tree depends only on the GLOBAL cell numbering - never on the device layout -
which is what makes QLT decomposition-invariant (the BfbTreeAllReducer
contract, cedr_bfb_tree_allreduce.hpp:11-14).

Single-kid chain nodes are represented by pairing a node with itself is NOT
done; instead an odd node is promoted unchanged to the next level (kid1 = -1
sentinel handled by masking).
"""

import dataclasses
from functools import lru_cache

import numpy as np
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Tree:
    """Flat binary-ish reduction tree over nleaf leaves.

    Node ids: 0..nleaf-1 are leaves; internal nodes follow. For each level
    l >= 1, nodes[l] lists internal node ids, kids0[l]/kids1[l] their kid
    node ids; kids1 may be -1 (single-kid pass-through). The last node is the
    root.
    """
    nleaf: int
    nnodes: int
    levels: tuple          # tuple of (nodes, kids0, kids1) jnp int32 arrays

    @property
    def root(self):
        return self.nnodes - 1


@lru_cache(maxsize=None)
def build(nleaf: int, imbalanced: bool = False) -> Tree:
    """Build a reduction tree over `nleaf` leaves.

    Default: pair adjacent nodes level by level (complete binary tree, like
    the reference's balanced oned tree). `imbalanced=True` mimics the
    reference's 1/3-2/3 recursive split (cedr_tree.cpp:391-410) used to
    stress non-power-of-two level schedules.
    """
    if imbalanced:
        return _build_imbalanced(nleaf)
    levels = []
    cur = np.arange(nleaf, dtype=np.int32)
    next_id = nleaf
    while len(cur) > 1:
        n_pairs = len(cur) // 2
        odd = len(cur) % 2 == 1
        k0 = cur[0:2 * n_pairs:2]
        k1 = cur[1:2 * n_pairs:2]
        ids = np.arange(next_id, next_id + n_pairs, dtype=np.int32)
        next_id += n_pairs
        if odd:
            # Promote the odd node via a single-kid pass-through node.
            ids = np.concatenate([ids, [next_id]])
            k0 = np.concatenate([k0, [cur[-1]]])
            k1 = np.concatenate([k1, [-1]])
            next_id += 1
        levels.append((jnp.asarray(ids), jnp.asarray(k0), jnp.asarray(k1)))
        cur = np.asarray(ids)
    return Tree(nleaf=nleaf, nnodes=int(next_id), levels=tuple(levels))


def _build_imbalanced(nleaf: int) -> Tree:
    # Recursive 1/3 - 2/3 split; then assign levels bottom-up.
    kids = {}

    counter = [nleaf]

    def rec(lo, hi):
        if hi - lo == 1:
            return lo, 0
        n = hi - lo
        nl = max(1, n // 3)
        left, dl = rec(lo, lo + nl)
        right, dr = rec(lo + nl, hi)
        nid = counter[0]
        counter[0] += 1
        lvl = 1 + max(dl, dr)
        kids[nid] = (left, right, lvl)
        return nid, lvl

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * nleaf + 100))
    try:
        root, depth = rec(0, nleaf)
    finally:
        sys.setrecursionlimit(old)
    nnodes = counter[0]
    by_level = {}
    for nid, (k0, k1, lvl) in kids.items():
        by_level.setdefault(lvl, []).append((nid, k0, k1))
    levels = []
    # Pass-throughs: a node at level l whose parent is at level l' > l+1 is
    # fine in this representation - each internal node is processed exactly at
    # its own level and reads kid values that are already final.
    for lvl in range(1, depth + 1):
        rows = sorted(by_level.get(lvl, []))
        if not rows:
            continue
        ids = np.array([r[0] for r in rows], dtype=np.int32)
        k0 = np.array([r[1] for r in rows], dtype=np.int32)
        k1 = np.array([r[2] for r in rows], dtype=np.int32)
        levels.append((jnp.asarray(ids), jnp.asarray(k0), jnp.asarray(k1)))
    # The root must be the last node id for Tree.root; renumber if needed.
    if root != nnodes - 1:
        # Swap ids root <-> nnodes-1 in all arrays.
        def fix(a):
            a = np.asarray(a).copy()
            a[a == root] = -2
            a[a == nnodes - 1] = root
            a[a == -2] = nnodes - 1
            return jnp.asarray(a)
        levels = [(fix(i), fix(j), jnp.asarray(np.where(
            np.asarray(k) == -1, -1, np.asarray(fix(k))))) for i, j, k in levels]
    return Tree(nleaf=nleaf, nnodes=nnodes, levels=tuple(levels))

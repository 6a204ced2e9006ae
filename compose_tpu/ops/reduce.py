"""Deterministic, decomposition-invariant reductions.

The reference guarantees bit-for-bit (BFB) reproducibility of mass sums under
changes in thread count / rank decomposition via fixed-order accumulation
(/root/reference/methods/slmm/slmm_accum.hpp:12-34) and a fixed-topology tree
allreduce (/root/reference/cedr/cedr_bfb_tree_allreduce.hpp). XLA's own
reductions choose their order per backend and per partitioning, so the order
changes with sharding. `bfb_sum` fixes the summation order to a binary tree
over the *global* index space, so the result is bitwise identical regardless
of how (or whether) the array is sharded - the same contract as the
reference's BfbTreeAllReducer.

The tree pairs ADJACENT elements (level j sums contiguous blocks of 2^j
leaves). That makes every aligned contiguous power-of-two block a complete
subtree, which is what lets a block-sharded array reproduce the global sum
bitwise from per-block partials (cdr/bfb.py builds the distributed
completion; the old fold-in-half pairing `x[:h]+x[h:]` did NOT have this
property - blocks were strided across subtrees).
"""

import jax.numpy as jnp


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bfb_sum(x, axis: int = -1):
    """Sum along `axis` with a fixed adjacent-pairwise binary-tree order.

    The tree is defined purely by global element index (pad with zeros to the
    next power of two, then pairwise-sum adjacent elements log2(n) times), so
    the result is independent of device layout and identical run to run.
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    p = _next_pow2(n)
    if p != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, p - n)]
        x = jnp.pad(x, pad)
    while x.shape[-1] > 1:
        # Adjacent-pair fold via reshape (bitwise identical to the strided
        # x[0::2] + x[1::2] formulation, but the reshape keeps the access
        # contiguous - the strided slices defeat XLA's fusion inside the
        # full transport step).
        y = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
        x = y[..., 0] + y[..., 1]
    return x[..., 0]


def bfb_masked_sum(x, mask, axis: int = -1):
    """bfb_sum of x where mask else 0."""
    return bfb_sum(jnp.where(mask, x, jnp.zeros_like(x)), axis=axis)


def bfb_sum_cells(x):
    """bfb_sum over the two trailing axes (..., ncell, np2) flattened.

    When np2 is a power of two, every cell is an ALIGNED depth-log2(np2)
    subtree of the global adjacent-pair tree (cell c's slots start at
    c*np2), so evaluating the per-cell folds first and then the cell-level
    tree computes the EXACT same DAG as bfb_sum(x.reshape(..., -1)) -
    bitwise identical, with the within-cell folds kept local to each cell.
    Falls back to the flat evaluation otherwise."""
    np2 = x.shape[-1]
    if np2 & (np2 - 1):
        return bfb_sum(x.reshape(x.shape[:-2] + (-1,)), axis=-1)
    y = x
    while y.shape[-1] > 1:
        z = y.reshape(y.shape[:-1] + (y.shape[-1] // 2, 2))
        y = z[..., 0] + z[..., 1]
    return bfb_sum(y[..., 0], axis=-1)


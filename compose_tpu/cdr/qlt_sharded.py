"""Distributed QLT: a real sharded level schedule over the reduction tree.

Counterpart of the reference's rank-pruned trees + level schedules
(/root/reference/cedr/cedr_tree.cpp:185-213 builds the deadlock-free level
schedule; cedr_qlt.cpp:619-640 runs the l2r/r2l sweeps with one message per
rank per level). This design exploits that device shards are
CONTIGUOUS leaf blocks, so each shard's block decomposes into O(log n)
maximal aligned subtrees of the GLOBAL tree (the same decomposition as
cdr/bfb.py):

  l2r:  each shard sweeps its own subtrees with a per-shard level schedule
        (flat padded index arrays selected by `axis_index`), producing the
        values of its subtree ROOTS ("frontier" nodes). ONE small
        `all_gather` ships every shard's frontier (O(n_shards * log n)
        scalars per channel) and every shard redundantly combines the
        remaining "top" of the tree (< 2*n_shards nodes).
  r2l:  every shard redundantly solves the top node QPs down to the
        frontier, takes its own frontier masses from the (replicated)
        result, and finishes the sweep locally.

Because the tree topology and every node's arithmetic are the global ones,
the result is BITWISE equal to the single-chip QLT (cdr/qlt.py) for every
leaf->shard decomposition - the reference's decomposition invariance
contract (cedr_bfb_tree_allreduce.hpp:11-14) - while no full-length
(nt, nnodes) array ever crosses chips: communication is the frontier
gather, O(perimeter-free log n), not O(n).

Decompositions: the default is contiguous blocks, RAGGED when ncells is
not divisible by n_shards (block B = ceil(ncells/n_shards); trailing pad
slots are dead). An explicit `owner` leaf->shard array supports arbitrary
(e.g. pseudorandom) decompositions - the reference's heavy-duty multi-rank
stress ("forces the QLT tree to communicate, pack, and unpack in silly
ways", cedr_tree.hpp:128-138; cedr-test-unit-mpi runs 111 cells on 8
ranks, cedr/CMakeLists.txt:14-16). With a scattered owner map few internal
nodes are shard-local, so most of the tree lands in the replicated "top" -
correct (and what the stress tests exercise), just not the layout to pick
for performance.
"""

import numpy as np
import jax
import jax.numpy as jnp

from . import tree as tree_mod
from .qlt import (CONSERVE, NONNEGATIVE, SHAPEPRESERVE, CONSISTENT,
                  solve_node_problem)


class ShardedQLT:
    """QLT over `ncells` leaves block-sharded across `n_shards` devices.

    Supports every problem type the single-chip QLT does: the
    sum-combining types (SHAPEPRESERVE, NONNEGATIVE, each optionally
    | CONSERVE) and the dynamic-range (consistent-only) types, whose
    bound channels combine via min/max on the l2r sweep and broadcast the
    ROOT's q bounds down the r2l sweep (cedr_qlt.cpp:341-387,490-565).
    """

    def __init__(self, ncells: int, n_shards: int,
                 problem_type: int = SHAPEPRESERVE,
                 prefer_mass_con_to_bounds: bool = False,
                 owner: np.ndarray = None):
        assert n_shards >= 2, "use cdr.qlt.QLT for a single shard"
        pt = problem_type
        self.ncells = ncells
        self.n_shards = n_shards
        self.problem_type = pt
        self.prefer = prefer_mass_con_to_bounds
        t = tree_mod.build(ncells)
        self.tree = t
        if owner is None:
            # Contiguous blocks, ragged when not divisible (pad slots at
            # the tail of short shards are dead; the level schedules never
            # reference them).
            B = -(-ncells // n_shards)
            owner = np.arange(ncells) // B
        owner = np.asarray(owner, np.int64)
        assert owner.shape == (ncells,)
        counts = np.bincount(owner, minlength=n_shards)
        # The reference's QLT rejects 0-cells-per-rank (cedr_qlt.cpp:235).
        assert counts.min() >= 1, "every shard needs >= 1 leaf"
        B = int(counts.max())
        self.block = B
        # leaf_idx[s, i]: global leaf id of shard s's i-th local leaf slot
        # (sorted global order; pads repeat slot 0's leaf and are dead).
        leaf_idx = np.zeros((n_shards, B), np.int64)
        leaf_slot = np.zeros(ncells, np.int64)
        for s in range(n_shards):
            mine = np.nonzero(owner == s)[0]
            leaf_idx[s, :len(mine)] = mine
            leaf_idx[s, len(mine):] = mine[0]
            leaf_slot[mine] = np.arange(len(mine))
        self.leaf_idx = leaf_idx
        self.leaf_count = counts
        self.owner_leaf = owner

        # Internal-node ownership: a node is shard-local iff all its
        # leaves share one owner (propagated up the levels).
        own = np.full(t.nnodes, -1, np.int64)
        own[:t.nleaf] = owner
        for ids, k0, k1 in t.levels:
            ids, k0, k1 = map(np.asarray, (ids, k0, k1))
            o0 = own[k0]
            o1 = np.where(k1 < 0, o0, own[np.maximum(k1, 0)])
            own[ids] = np.where(o0 == o1, o0, -1)
        # Parent map (for the frontier).
        parent = np.full(t.nnodes, -1, np.int64)
        for ids, k0, k1 in t.levels:
            ids, k0, k1 = map(np.asarray, (ids, k0, k1))
            parent[k0] = ids
            parent[np.maximum(k1, 0)] = np.where(k1 < 0,
                                                 parent[np.maximum(k1, 0)],
                                                 ids)

        # ---- Per-shard local structure.
        # Local slots: [0, B) leaves, [B, B+nloc_int) internal, dummy last.
        loc_of = {}                       # global node id -> (shard, slot)
        nloc_int = np.zeros(n_shards, np.int64)
        for g in range(t.nleaf):
            loc_of[g] = (int(owner[g]), int(leaf_slot[g]))
        for g in range(t.nleaf, t.nnodes):
            s = own[g]
            if s >= 0:
                loc_of[g] = (int(s), B + int(nloc_int[s]))
                nloc_int[s] += 1
        max_int = int(nloc_int.max())
        self.loc_size = B + max_int + 1   # + dummy slot
        D = self.loc_size - 1

        # Local level schedule: per global level, per shard, padded arrays.
        self.local_levels = []            # (ids, k0, k1) each (n_shards, m)
        for ids, k0, k1 in t.levels:
            ids, k0, k1 = map(np.asarray, (ids, k0, k1))
            rows = [[] for _ in range(n_shards)]
            for i, g in enumerate(ids):
                s = own[g]
                if s >= 0:
                    kk0 = loc_of[int(k0[i])][1]
                    kk1 = -1 if k1[i] < 0 else loc_of[int(k1[i])][1]
                    rows[s].append((loc_of[g][1], kk0, kk1))
            m = max(len(r) for r in rows)
            if m == 0:
                continue
            lids = np.full((n_shards, m), D, np.int32)
            lk0 = np.full((n_shards, m), D, np.int32)
            lk1 = np.full((n_shards, m), -1, np.int32)
            for s in range(n_shards):
                for j, (a, b, c) in enumerate(rows[s]):
                    lids[s, j], lk0[s, j], lk1[s, j] = a, b, c
            self.local_levels.append(
                (jnp.asarray(lids), jnp.asarray(lk0), jnp.asarray(lk1)))

        # ---- Frontier: nodes owned by a shard whose parent is top (or the
        # root itself if it happens to be owned - impossible for
        # n_shards >= 2). Ordered by global id per shard; padded with D.
        frontier = [[] for _ in range(n_shards)]
        for g in range(t.nnodes):
            s = own[g]
            if s >= 0 and (parent[g] < 0 or own[parent[g]] < 0):
                # Leaves are always owned. parent < 0 only for the root.
                if g != t.root:
                    frontier[s].append(g)
        assert own[t.root] < 0
        max_nf = max(len(f) for f in frontier)
        self.max_nf = max_nf
        fr_idx = np.full((n_shards, max_nf), D, np.int32)
        fslot_of = {}                     # global node id -> gathered slot
        for s in range(n_shards):
            for i, g in enumerate(sorted(frontier[s])):
                fr_idx[s, i] = loc_of[g][1]
                fslot_of[g] = s * max_nf + i
        self.frontier_idx = jnp.asarray(fr_idx)

        # ---- Top structure: gathered frontier slots first, then top nodes.
        top_nodes = [g for g in range(t.nleaf, t.nnodes) if own[g] < 0]
        F_tot = n_shards * max_nf
        tslot_of = dict(fslot_of)
        for i, g in enumerate(top_nodes):
            tslot_of[g] = F_tot + i
        self.top_size = F_tot + len(top_nodes) + 1   # + dummy (unused)
        self.n_top = len(top_nodes)
        self.top_levels = []
        for ids, k0, k1 in t.levels:
            ids, k0, k1 = map(np.asarray, (ids, k0, k1))
            rows = [(tslot_of[int(g)], tslot_of[int(k0[i])],
                     -1 if k1[i] < 0 else tslot_of[int(k1[i])])
                    for i, g in enumerate(ids) if own[g] < 0]
            if not rows:
                continue
            tids = np.array([r[0] for r in rows], np.int32)
            tk0 = np.array([r[1] for r in rows], np.int32)
            tk1 = np.array([r[2] for r in rows], np.int32)
            self.top_levels.append(
                (jnp.asarray(tids), jnp.asarray(tk0), jnp.asarray(tk1)))
        self.root_slot = tslot_of[t.root]

    # ------------------------------------------------------------------
    def scatter_leaves(self, x, fill=0.0):
        """Global (..., ncells) -> (..., n_shards * B) in the per-shard
        leaf-slot layout `run` expects (shard-major; pad slots get `fill`).
        For the dynamic-range problem types pad rhom with fill=1.0 (its
        pad lanes are divided by; real lanes are untouched)."""
        out = x[..., self.leaf_idx.reshape(-1)]
        if fill is not None:
            mask = (np.arange(self.block)[None, :]
                    < self.leaf_count[:, None]).reshape(-1)
            out = jnp.where(jnp.asarray(mask), out,
                            jnp.asarray(fill, out.dtype))
        return out

    def gather_leaves(self, blocks):
        """Inverse of scatter_leaves: (..., n_shards * B) block layout ->
        global (..., ncells) (pad slots dropped)."""
        mask = (np.arange(self.block)[None, :]
                < self.leaf_count[:, None]).reshape(-1)
        inv = np.zeros(self.ncells, np.int64)
        inv[self.leaf_idx.reshape(-1)[mask]] = np.nonzero(mask)[0]
        return blocks[..., jnp.asarray(inv)]

    # ------------------------------------------------------------------
    def run(self, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
            root_extra=None, axis_name="cells"):
        """Inside shard_map: rhom (B,), Qm/Qm_min/Qm_max/Qm_prev (nt, B)
        are this shard's leaf blocks in leaf_idx order (for the default
        contiguous decomposition that is simply the global order; ragged /
        custom decompositions lay data out with scatter_leaves). Pad slots
        (beyond this shard's leaf_count) are dead: any finite values are
        accepted and ignored, except that dynamic-range problem types
        divide by rhom, whose pads must be nonzero. Returns (nt, B) leaf
        masses, bitwise equal to QLT.run on the assembled global arrays."""
        pt = self.problem_type
        t = self.tree
        B = self.block
        nt = Qm.shape[0]
        dtype = Qm.dtype
        s = jax.lax.axis_index(axis_name)
        D = self.loc_size - 1

        if pt & NONNEGATIVE:
            l2r_min, l2r_max = Qm, Qm
        elif pt & SHAPEPRESERVE:
            l2r_min, l2r_max = Qm_min, Qm_max
        elif pt & CONSISTENT:
            # Dynamic range: leaf bound channels carry q = Qm/rhom
            # (cedr_qlt_inl.hpp:46-58); combined via min/max below.
            l2r_min, l2r_max = Qm_min / rhom, Qm_max / rhom
        else:
            raise ValueError("invalid problem type")
        sum_bounds = bool(pt & SHAPEPRESERVE) or bool(pt & NONNEGATIVE)
        dynamic_range = bool(pt & CONSISTENT) and not (pt & SHAPEPRESERVE)

        L = self.loc_size
        W_rho = jnp.zeros((L,), dtype).at[:B].set(rhom)
        W_min = jnp.zeros((nt, L), dtype).at[:, :B].set(l2r_min)
        W_Qm = jnp.zeros((nt, L), dtype).at[:, :B].set(Qm)
        W_max = jnp.zeros((nt, L), dtype).at[:, :B].set(l2r_max)
        if pt & CONSERVE:
            W_prev = jnp.zeros((nt, L), dtype).at[:, :B].set(Qm_prev)

        def comb_sum(V, k0, k1):
            v0 = V[..., k0]
            v1 = jnp.where(k1 < 0, jnp.zeros_like(v0),
                           V[..., jnp.maximum(k1, 0)])
            return v0 + v1

        def comb_min(V, k0, k1):
            v0 = V[..., k0]
            v1 = jnp.where(k1 < 0, v0, V[..., jnp.maximum(k1, 0)])
            return jnp.minimum(v0, v1)

        def comb_max(V, k0, k1):
            v0 = V[..., k0]
            v1 = jnp.where(k1 < 0, v0, V[..., jnp.maximum(k1, 0)])
            return jnp.maximum(v0, v1)

        def comb_bounds(Vmin, Vmax, k0, k1):
            if sum_bounds:
                return comb_sum(Vmin, k0, k1), comb_sum(Vmax, k0, k1)
            return comb_min(Vmin, k0, k1), comb_max(Vmax, k0, k1)

        # ---- Local l2r over this shard's subtrees.
        for lids, lk0, lk1 in self.local_levels:
            ids, k0, k1 = lids[s], lk0[s], lk1[s]
            W_rho = W_rho.at[ids].set(comb_sum(W_rho, k0, k1))
            bmn, bmx = comb_bounds(W_min, W_max, k0, k1)
            W_min = W_min.at[:, ids].set(bmn)
            W_max = W_max.at[:, ids].set(bmx)
            W_Qm = W_Qm.at[:, ids].set(comb_sum(W_Qm, k0, k1))
            if pt & CONSERVE:
                W_prev = W_prev.at[:, ids].set(comb_sum(W_prev, k0, k1))

        # ---- Frontier gather: O(n_shards * log n) scalars per channel.
        fidx = self.frontier_idx[s]                     # (max_nf,)
        f_rho = W_rho[fidx]
        ch = [W_min[:, fidx], W_Qm[:, fidx], W_max[:, fidx]]
        if pt & CONSERVE:
            ch.append(W_prev[:, fidx])
        f_tr = jnp.stack(ch)                            # (C, nt, max_nf)
        g_rho = jax.lax.all_gather(f_rho, axis_name, axis=0).reshape(-1)
        g_tr = jax.lax.all_gather(f_tr, axis_name, axis=2)
        g_tr = g_tr.reshape(f_tr.shape[0], nt, -1)      # (C, nt, ns*max_nf)

        TS = self.top_size
        T_rho = jnp.zeros((TS,), dtype).at[:g_rho.shape[0]].set(g_rho)
        nf = g_tr.shape[-1]
        T_min = jnp.zeros((nt, TS), dtype).at[:, :nf].set(g_tr[0])
        T_Qm = jnp.zeros((nt, TS), dtype).at[:, :nf].set(g_tr[1])
        T_max = jnp.zeros((nt, TS), dtype).at[:, :nf].set(g_tr[2])
        if pt & CONSERVE:
            T_prev = jnp.zeros((nt, TS), dtype).at[:, :nf].set(g_tr[3])

        # ---- Top l2r (replicated; < 2*n_shards nodes).
        for tids, tk0, tk1 in self.top_levels:
            T_rho = T_rho.at[tids].set(comb_sum(T_rho, tk0, tk1))
            bmn, bmx = comb_bounds(T_min, T_max, tk0, tk1)
            T_min = T_min.at[:, tids].set(bmn)
            T_max = T_max.at[:, tids].set(bmx)
            T_Qm = T_Qm.at[:, tids].set(comb_sum(T_Qm, tk0, tk1))
            if pt & CONSERVE:
                T_prev = T_prev.at[:, tids].set(comb_sum(T_prev, tk0, tk1))

        # ---- Root + top r2l (replicated).
        root = self.root_slot
        M_root = (T_prev if pt & CONSERVE else T_Qm)[:, root]
        if root_extra is not None:
            M_root = M_root + root_extra
        M_top = jnp.zeros((nt, TS), dtype).at[:, root].set(M_root)
        # Dynamic range: every node QP sees the ROOT's global q bounds
        # (r2l_solve_qp_set_q, cedr_qlt.cpp:490-565), known replicated
        # after the top l2r.
        if dynamic_range:
            qmin_g = T_min[:, root][:, None]
            qmax_g = T_max[:, root][:, None]

        def r2l(levels, M, V_rho, V_min, V_Qm, V_max):
            def bounds_at(idx):
                if dynamic_range:
                    shape = (nt,) + idx.shape
                    return (jnp.broadcast_to(qmin_g, shape),
                            jnp.broadcast_to(qmax_g, shape))
                return V_min[:, idx], V_max[:, idx]

            for ids, k0, k1 in reversed(levels):
                bmin, bmax = bounds_at(ids)
                pd = jnp.stack([bmin, V_Qm[:, ids], bmax], axis=-1)
                k1s = jnp.maximum(k1, 0)
                bmin0, bmax0 = bounds_at(k0)
                bmin1, bmax1 = bounds_at(k1s)
                k0d = jnp.stack([bmin0, V_Qm[:, k0], bmax0], axis=-1)
                k1d = jnp.stack([bmin1, V_Qm[:, k1s], bmax1], axis=-1)
                Qm_node = M[:, ids]
                rhom_n = jnp.broadcast_to(V_rho[ids], Qm_node.shape)
                rhom0 = jnp.broadcast_to(V_rho[k0], Qm_node.shape)
                rhom1 = jnp.broadcast_to(
                    jnp.where(k1 < 0, 1.0, V_rho[k1s]), Qm_node.shape)
                Qm0, Qm1 = solve_node_problem(
                    pt, rhom_n, pd, Qm_node, rhom0, k0d, rhom1, k1d,
                    self.prefer)
                single = k1 < 0
                Qm0 = jnp.where(single, Qm_node, Qm0)
                M = M.at[:, k0].set(Qm0)
                M = M.at[:, k1s].set(jnp.where(single, M[:, k1s], Qm1))
            return M

        M_top = r2l(self.top_levels, M_top, T_rho, T_min, T_Qm, T_max)

        # ---- Seed local masses from this shard's frontier and finish.
        my_fr = jax.lax.dynamic_slice_in_dim(
            M_top, s * self.max_nf, self.max_nf, axis=1)  # (nt, max_nf)
        M_loc = jnp.zeros((nt, L), dtype).at[:, D].set(0.0)

        def seed(M, fidx, vals):
            return M.at[:, fidx].set(vals)

        M_loc = seed(M_loc, fidx, my_fr)
        local = [(lids[s], lk0[s], lk1[s])
                 for lids, lk0, lk1 in self.local_levels]
        M_loc = r2l(local, M_loc, W_rho, W_min, W_Qm, W_max)
        return M_loc[:, :B]

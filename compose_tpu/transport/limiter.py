"""Cell-local limiters (MonoData equivalents), batched over all cells.

Counterpart of /root/reference/methods/slmm/slmmir_mono_data.{hpp,cpp}. The
reference loops cells and calls a per-cell QP; here every cell's limiter runs
in one vectorized call (the QP solvers in ops/local_qp.py broadcast over
leading axes). Limiter types: 'mn2' (solve_1eq_bc_qp), 'caas'
(clip_and_sum), 'caags' (clip_and_weighted_sum), 'qlt' (tensor-2d local
QLT tree over the np x np nodes of a cell,
/root/reference/methods/slmm/slmm_spf_lqlt.cpp).
"""

import math
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import local_qp

# ---------------------------------------------------------------------------
# Local tensor-2d QLT (slmm_spf_lqlt.cpp). A 1-D tree over the np GLL indices
# (tree_desc, :8-24) is crossed with itself (make_tensor2d_tree,
# slmm_array_tree.cpp:92-126) to give a static tree over the np^2 cell DOFs;
# the limiter then runs the QLT pattern on it: leaf-to-root aggregation of
# (lo-mass, hi-mass, mass) and root-to-leaf mass splitting via
# solve_1eq_bc_qp at every node. Because the aggregates are plain sums over
# each node's DOF support, the l2r sweep here is one masked matmul, and the
# r2l sweep is one batched QP per (level, kid-count) group - O(depth) fused
# kernels for ALL cells and tracers at once.

_TREE_DESC = {
    4: "((0 1) (2 3))",
    7: "((0 1) (2 3 4) (5 6))",
    8: "(((0 1) (2 3)) ((4 5) (6 7)))",
    10: "(((0 1) (2 3)) (4 5) ((6 7) (8 9)))",
    11: "(((0 1) (2 3)) (4 5 6) ((7 8) (9 10)))",
    12: "(((0 1) (2 3 4)) (5 6) ((7 8 9) (10 11)))",
    13: "(((0 1) (2 3 4)) (5 6 7) ((8 9 10) (11 12)))",
    16: "((((0 1) (2 3)) ((4 5) (6 7))) "
        "(((8 9) (10 11)) ((12 13) (14 15))))",
}


def _parse_desc(desc):
    tokens = re.findall(r"[()]|\d+", desc)
    def parse(it):
        node = []
        for tok in it:
            if tok == "(":
                node.append(parse(it))
            elif tok == ")":
                return node
            else:
                node.append(int(tok))
        return node
    it = iter(tokens)
    next(it)  # leading '('
    return parse(it)


def _is_interior(nd):
    return any(isinstance(e, list) for e in nd)


def _tensor2d(n, x, y):
    """make_tensor2d_tree (slmm_array_tree.cpp:92-114)."""
    xi, yi = _is_interior(x), _is_interior(y)
    if xi:
        kids = []
        for xk in x:
            if yi:
                kids += [_tensor2d(n, xk, yk) for yk in y]
            else:
                kids.append(_tensor2d(n, xk, y))
        return kids
    if yi:
        return [_tensor2d(n, x, yk) for yk in y]
    return [n * iy + ix for iy in y for ix in x]


class _Lqlt2dTree:
    """Flattened static tensor-2d tree for one np."""

    def __init__(self, np_):
        root = _tensor2d(np_, _parse_desc(_TREE_DESC[np_]),
                         _parse_desc(_TREE_DESC[np_]))
        np2 = np_ * np_
        self.kids = []       # per node: kid node ids (interior) or None
        self.dofs = []       # per node: DOF list (leaf) or None
        self.depth = []
        def rec(nd, depth):
            idx = len(self.kids)
            self.kids.append(None)
            self.dofs.append(None)
            self.depth.append(depth)
            if _is_interior(nd):
                self.kids[idx] = [rec(k, depth + 1) for k in nd]
            else:
                self.dofs[idx] = list(nd)
            return idx
        rec(root, 0)
        nnode = len(self.kids)
        memb = np.zeros((nnode, np2))
        for i in reversed(range(nnode)):
            if self.dofs[i] is not None:
                memb[i, self.dofs[i]] = 1.0
            else:
                for k in self.kids[i]:
                    memb[i] += memb[k]
        assert np.all(memb[0] == 1.0)
        self.memb = jnp.asarray(memb)
        # Interior nodes grouped by (depth, nkids); leaves by ndofs.
        self.int_groups = []  # list of (node_ids (g,), kid_ids (g, k))
        for d in range(max(self.depth) + 1):
            byk = {}
            for i in range(nnode):
                if self.depth[i] == d and self.kids[i] is not None:
                    byk.setdefault(len(self.kids[i]), []).append(i)
            for k, ids in sorted(byk.items()):
                self.int_groups.append(
                    (np.asarray(ids), np.asarray([self.kids[i] for i in ids])))
        byd = {}
        for i in range(nnode):
            if self.dofs[i] is not None:
                byd.setdefault(len(self.dofs[i]), []).append(i)
        self.leaf_groups = [
            (np.asarray(ids), np.asarray([self.dofs[i] for i in ids]))
            for _, ids in sorted(byd.items())]


_LQLT_TREES = {}


def _get_lqlt_tree(np_):
    if np_ not in _LQLT_TREES:
        _LQLT_TREES[np_] = (_Lqlt2dTree(np_) if np_ in _TREE_DESC else None)
    return _LQLT_TREES[np_]


def _local_qlt_tensor2d(a, b, xlo, xhi, y):
    """local_qlt_tensor2d_run (slmm_spf_lqlt.cpp:162-173), batched over all
    leading dims. a: (..., np2) per-DOF masses; b: (...,) target mass;
    xlo/xhi/y: (..., np2)."""
    np2 = y.shape[-1]
    np_ = math.isqrt(np2)
    tree = _get_lqlt_tree(np_) if np_ * np_ == np2 else None
    if tree is None:
        # No tree for this np (tree_desc returns nullptr): plain n-dim QP.
        x, _ = local_qp.solve_1eq_bc_qp(a, a, b, xlo, xhi, y)
        return x
    memb = tree.memb
    lmass = jnp.einsum('...i,ni->...n', a * xlo, memb)
    hmass = jnp.einsum('...i,ni->...n', a * xhi, memb)
    ymass = jnp.einsum('...i,ni->...n', a * y, memb)
    mass = jnp.zeros(b.shape + (memb.shape[0],), y.dtype)
    mass = mass.at[..., 0].set(b)
    for node_ids, kid_ids in tree.int_groups:
        nb = mass[..., node_ids]                       # (..., g)
        kl = lmass[..., kid_ids]                       # (..., g, k)
        kh = hmass[..., kid_ids]
        ky = ymass[..., kid_ids]
        ones = jnp.ones_like(kl)
        xk, _ = local_qp.solve_1eq_bc_qp(ones, ones, nb, kl, kh, ky)
        mass = mass.at[..., kid_ids.reshape(-1)].set(
            xk.reshape(xk.shape[:-2] + (-1,)))
    out = jnp.zeros_like(y)
    for leaf_ids, dof_ids in tree.leaf_groups:
        lb = mass[..., leaf_ids]                       # (..., g)
        la = a[..., dof_ids]                           # (..., g, d)
        ll = xlo[..., dof_ids]
        lh = xhi[..., dof_ids]
        ly = y[..., dof_ids]
        xs, _ = local_qp.solve_1eq_bc_qp(la, la, lb, ll, lh, ly)
        out = out.at[..., dof_ids.reshape(-1)].set(
            xs.reshape(xs.shape[:-2] + (-1,)))
    return out


def _spf_run(limiter, w, a, b, xlo, xhi, y):
    if limiter == "mn2":
        x, _ = local_qp.solve_1eq_bc_qp(w, a, b, xlo, xhi, y)
        return x
    if limiter == "caas":
        return local_qp.clip_and_sum(a, b, xlo, xhi, y)
    if limiter == "caags":
        return local_qp.clip_and_weighted_sum(a, b, xlo, xhi, y)
    if limiter == "qlt":
        return _local_qlt_tensor2d(a, b, xlo, xhi, y)
    raise ValueError(f"unknown limiter {limiter}")


@partial(jax.jit, static_argnames=("limiter",))
def limit_density(F, rho, extra_mass, limiter: str = "mn2"):
    """Positivity limiter for density (slmmir_mono_data.cpp:66-105).

    F, rho: (ncell, np2); extra_mass: (ncell,) per-cell mass delta.
    Returns adjusted rho with rho >= 0 and
    sum(F*rho_out) == sum(F*rho_in) + extra_mass per cell.
    """
    mass_tgt = jnp.sum(rho * F, axis=-1) + extra_mass
    any_below = jnp.any(rho < 0, axis=-1)
    need = any_below | (extra_mass != 0)
    rho_clip = jnp.maximum(rho, 0.0)
    mass = jnp.sum(rho_clip * F, axis=-1)
    delta = mass_tgt - mass
    # delta >= 0: add a constant (linearly invariant).
    fac = delta / jnp.sum(F, axis=-1)
    rho_add = rho_clip + fac[..., None]

    # delta < 0: solve the nonneg QP with mn2 (reference hard-codes mn2
    # here). That's the rare branch (density staying near 0 globally); run
    # it under lax.cond so the common all-positive step skips the iterative
    # solve entirely.
    def qp_branch(_):
        zeros = jnp.zeros_like(rho)
        big = rho_clip + jnp.abs(mass_tgt)[..., None] + 1.0
        x_qp, _ = local_qp.solve_1eq_bc_qp(F, F, mass_tgt, zeros, big,
                                           rho_clip)
        return x_qp

    # The mn2 QP with w = a = F has the UNIFORM SHIFT as its unconstrained
    # optimum (x_i = y_i + lambda with lambda = delta/sum(F)), so the
    # iterative solve is needed only when the shift would drive a node
    # negative - rare (density staying near 0 globally), and `rho_add` is
    # exactly the QP optimum otherwise. The cond is ONLY a compute skip;
    # the per-cell `sel` below picks the branch value cell by cell, so the
    # result is invariant to which OTHER cells share the batch (a shard_map
    # block sees a subset of cells - a batch-global selection would break
    # the bitwise single-chip/sharded contract in the near-zero-density
    # regime).
    need_qp = jnp.any(rho_add < 0.0)
    x_qp = jax.lax.cond(need_qp, qp_branch, lambda _: rho_add, None)
    sel = (delta >= 0) | jnp.all(rho_add >= 0.0, axis=-1)
    out = jnp.where(sel[..., None], rho_add, x_qp)
    return jnp.where(need[..., None], out, rho)


@partial(jax.jit, static_argnames=("limiter", "expand_bounds_allowed",
                                   "return_q"))
def limit_tracer(F, rho, Q, q_min, q_max, Qm_extra,
                 limiter: str = "caas", expand_bounds_allowed: bool = False,
                 precomp=None, return_q: bool = False):
    """Bounds-preserving tracer-mass limiter with per-node bounds
    (slmmir_mono_data.cpp:299-361).

    F, rho, Q, q_min, q_max: (ncell, np2); Qm_extra: (ncell,).
    Solves per cell:
        min sum_i w_i (q_i - y_i)^2  s.t.  sum_i F_i rho_i q_i = Qm_tot,
        q_min_i <= q_i <= q_max_i
    with w = a = F*rho, y = Q/rho, Qm_tot = sum(F*Q) + Qm_extra,
    expanding bounds first if the cell problem is infeasible (and allowed).
    Returns adjusted Q.

    `precomp`: optional (rhom, Qm_tot, Qm_min, Qm_max) computed by the
    caller (the ISL CDR records these exact expressions already -
    commutative-identical products/sums, so passing them is bitwise
    neutral and saves ~3 full passes over the tracer state).
    """
    if precomp is not None:
        rhom, Qm_tot, Qm_min, Qm_max = precomp
        rhom_tot = jnp.sum(rhom, axis=-1)
    else:
        rhom = rho * F                       # per-node masses
        rhom_tot = jnp.sum(rhom, axis=-1)
        Qm_tot = jnp.sum(Q * F, axis=-1) + Qm_extra
        Qm_min = jnp.sum(q_min * rhom, axis=-1)
        Qm_max = jnp.sum(q_max * rhom, axis=-1)

    lo = Qm_tot < Qm_min
    hi = Qm_tot > Qm_max
    if expand_bounds_allowed:
        q_min, q_max = _expand_bounds(
            rhom, q_min, q_max, Qm_tot - jnp.where(lo, Qm_min, Qm_max),
            lo, hi, rhom_tot)

    # Zero-density nodes carry no tracer mass; give them a vanishing but
    # nonzero QP weight so the solvers' a/w, w/a ratios stay finite (the
    # reference assumes rho > 0 at every node; under extreme divergence the
    # positivity limiter can produce exact zeros).
    tiny = 1e-300
    a = jnp.maximum(rhom, tiny)
    w = a
    # One reciprocal then multiply: under vmap over tracers, rho carries
    # no batch axis, so the reciprocal is computed once while Q/rho would
    # be nt divides per node.
    y = Q * (1.0 / jnp.where(rho == 0, 1.0, rho))
    x = _spf_run(limiter, w, a, Qm_tot, q_min, q_max, y)
    if return_q:
        # The solvers work in mixing-ratio space and every branch clips or
        # corner-selects within [q_min, q_max]; returning x directly lets
        # the ISL CDR skip the Q -> q round trip (x*rho*(1/rho) + re-clip),
        # which only adds rounding (slmmir_remapper_isl.cpp:1429-1452's
        # clip exists purely to scrub that roundoff).
        return x
    return x * rho


def _expand_bounds(rhom, q_min, q_max, Qm_extra, lo, hi, rhom_tot):
    """Feasibility-restoring bound expansion (slmmir_mono_data.cpp:244-297),
    batched over cells. Only rows with lo|hi change."""
    act = lo | hi
    neg = lo  # Qm_extra < 0 corresponds to being under the min-bound sum
    q_bnd = jnp.where(neg[..., None], q_min, q_max)
    Qm = Qm_extra + jnp.sum(q_bnd * rhom, axis=-1)
    # Relaxed bound box for the bound-adjusting QP.
    all_min = jnp.min(q_min, axis=-1, keepdims=True)
    all_max = jnp.max(q_max, axis=-1, keepdims=True)
    q_bnd_min = jnp.where(neg[..., None],
                          jnp.broadcast_to(all_min, q_min.shape), q_min)
    q_bnd_max = jnp.where(neg[..., None], q_max,
                          jnp.broadcast_to(all_max, q_max.shape))
    Qm_lo = jnp.sum(q_bnd_min * rhom, axis=-1)
    Qm_hi = jnp.sum(q_bnd_max * rhom, axis=-1)
    feasible = (Qm_lo <= Qm) & (Qm <= Qm_hi)
    x_qp, _ = local_qp.solve_1eq_bc_qp(
        rhom, rhom, Qm, q_bnd_min, q_bnd_max, q_bnd)
    q_const = (Qm / rhom_tot)[..., None]
    new_bnd = jnp.where(feasible[..., None], x_qp,
                        jnp.broadcast_to(q_const, q_bnd.shape))
    q_min_out = jnp.where((act & neg)[..., None], new_bnd, q_min)
    q_max_out = jnp.where((act & ~neg)[..., None], new_bnd, q_max)
    return q_min_out, q_max_out

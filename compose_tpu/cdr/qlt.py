"""QLT: quasi-local tree constrained density reconstructor, batched.

Counterpart of /root/reference/cedr/cedr_qlt.{hpp,cpp,_inl.hpp}. The
reference runs a leaf->root MPI sweep (combine kid data per level) and a
root->leaf sweep solving a 2-unknown QP at every interior node. Here both
sweeps are level-batched array programs over a flat tree (see tree.py): each
level is one gather + vectorized node solve + scatter, so the whole solve is
O(log ncell) fused kernels regardless of tracer count (tracers are a dense
vectorized axis, as in the reference's bulk buffers, cedr_qlt.hpp:44-127).

Problem types follow cedr::ProblemType (cedr/cedr.hpp:16-39): bitmask of
  conserve=1, shapepreserve=2, consistent=4, nonnegative=16.
"""

import jax.numpy as jnp

from ..ops import local_qp
from . import tree as tree_mod

CONSERVE = 1
SHAPEPRESERVE = 2
CONSISTENT = 4
NONNEGATIVE = 16

_EPS = 2.220446049250313e-16


def solve_1eq_bc_qp_2d(w, a, b, xlo, xhi, y, clip=True, early_exit_on_tol=True):
    """Closed-form 2-unknown QP (cedr_local_inl.hpp:68-165), batched over
    leading axes. All of w, a, xlo, xhi, y have shape (..., 2); b (...,).

    Returns (x, info): info 1 solved, -1 infeasible (x then = nearest corner).
    """
    r_tol = local_qp.calc_r_tol(b, a, y)

    r_lo = jnp.sum(a * xlo, axis=-1) - b
    r_hi = jnp.sum(a * xhi, axis=-1) - b
    lo_is_sol = jnp.abs(r_lo) <= r_tol
    hi_is_sol = jnp.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    if not early_exit_on_tol:
        lo_is_sol = jnp.zeros_like(lo_is_sol)
        hi_is_sol = jnp.zeros_like(hi_is_sol)
        infeas = jnp.zeros_like(infeas)
    corner_sel = lo_is_sol | (infeas & (r_lo > 0))
    x_corner = jnp.where(corner_sel[..., None], xlo, xhi)
    corner_done = lo_is_sol | hi_is_sol | infeas

    # Unconstrained optimum along the constraint line.
    q = a / w
    qmass = jnp.sum(a * q, axis=-1)
    dm = b - jnp.sum(a * y, axis=-1)
    lam = dm / qmass
    x_free = y + lam[..., None] * q
    free_ok = jnp.all((x_free >= xlo) & (x_free <= xhi), axis=-1)

    # Constrained: intersect the line a'x=b with the box walls.
    x_base = 0.5 * b[..., None] / a
    x_dir = jnp.stack([-a[..., 1], a[..., 0]], axis=-1)
    alphas = jnp.stack([
        (xlo[..., 1] - x_base[..., 1]) / x_dir[..., 1],   # 0: bottom
        (xhi[..., 0] - x_base[..., 0]) / x_dir[..., 0],   # 1: right
        (xhi[..., 1] - x_base[..., 1]) / x_dir[..., 1],   # 2: top
        (xlo[..., 0] - x_base[..., 0]) / x_dir[..., 0],   # 3: left
    ], axis=-1)
    order = jnp.argsort(alphas, axis=-1)
    mid_ai = order[..., 1:3]                               # wall indices (2,)
    mid_alpha = jnp.take_along_axis(alphas, mid_ai, axis=-1)

    def eval_candidate(k):
        alpha = mid_alpha[..., k]
        xx = x_base + alpha[..., None] * x_dir
        obj = jnp.sum(w * (y - xx) ** 2, axis=-1)
        return obj

    obj0 = eval_candidate(0)
    obj1 = eval_candidate(1)
    pick = jnp.where(obj0 <= obj1, 0, 1)
    ai = jnp.take_along_axis(mid_ai, pick[..., None], axis=-1)[..., 0]

    # Fix one coordinate at its wall, solve the other from the constraint.
    fixed_is_x1 = (ai == 0) | (ai == 2)     # bottom/top fix x[1]
    fixed_val = jnp.select(
        [ai == 0, ai == 1, ai == 2],
        [xlo[..., 1], xhi[..., 0], xhi[..., 1]], xlo[..., 0])
    # i0 = fixed coord, i1 = free coord.
    a_fixed = jnp.where(fixed_is_x1, a[..., 1], a[..., 0])
    a_free = jnp.where(fixed_is_x1, a[..., 0], a[..., 1])
    free_val = (b - a_fixed * fixed_val) / a_free
    if clip:
        free_lo = jnp.where(fixed_is_x1, xlo[..., 0], xlo[..., 1])
        free_hi = jnp.where(fixed_is_x1, xhi[..., 0], xhi[..., 1])
        free_val = jnp.clip(free_val, free_lo, free_hi)
    x_wall = jnp.where(
        fixed_is_x1[..., None],
        jnp.stack([free_val, fixed_val], axis=-1),
        jnp.stack([fixed_val, free_val], axis=-1))

    x = jnp.where(free_ok[..., None], x_free, x_wall)
    x = jnp.where(corner_done[..., None], x_corner, x)
    info = jnp.where(infeas, -1, 1).astype(jnp.int32)
    return x, info


def r2l_nl_adjust_bounds(Qm_bnd, rhom, Qm_extra):
    """Feasibility-restoring bound relaxation (cedr_qlt_inl.hpp:69-99),
    batched. Qm_bnd, rhom: (..., 2); Qm_extra: (...,). Returns adjusted
    Qm_bnd."""
    q = Qm_bnd / rhom
    neg = Qm_extra < 0
    # i0 = the kid whose q bound is (for neg) larger / (for pos) smaller.
    i0_is_0 = jnp.where(neg, q[..., 0] >= q[..., 1], q[..., 0] <= q[..., 1])
    q_i0 = jnp.where(i0_is_0, q[..., 0], q[..., 1])
    q_i1 = jnp.where(i0_is_0, q[..., 1], q[..., 0])
    rhom_i0 = jnp.where(i0_is_0, rhom[..., 0], rhom[..., 1])
    Qm_gap = (q_i1 - q_i0) * rhom_i0
    single_ok = jnp.where(neg, Qm_gap <= Qm_extra, Qm_gap >= Qm_extra)
    # Single-kid adjustment.
    adj0 = jnp.where(i0_is_0, Qm_extra, 0.0)
    adj1 = jnp.where(i0_is_0, 0.0, Qm_extra)
    single = Qm_bnd + jnp.stack([adj0, adj1], axis=-1)
    # Both-kid adjustment: equalize q bounds.
    Qm_tot = Qm_bnd[..., 0] + Qm_bnd[..., 1] + Qm_extra
    rhom_tot = rhom[..., 0] + rhom[..., 1]
    q_tot = (Qm_tot / rhom_tot)[..., None]
    both = q_tot * rhom
    return jnp.where(single_ok[..., None], single, both)


def solve_node_problem(problem_type, rhom, pd, Qm, rhom0, k0d, rhom1, k1d,
                       prefer_mass_con_to_bounds=False):
    """Batched node QP (cedr_qlt_inl.hpp:120-203).

    pd, k0d, k1d: (..., 3) = (Qm_min, Qm, Qm_max) per node (the l2r data);
    rhom*: (...,). problem_type is a static int bitmask (one problem type per
    call; callers partition tracers by type). Returns (Qm0, Qm1).
    """
    if (problem_type & CONSISTENT) and not (problem_type & SHAPEPRESERVE):
        scale = lambda d, r: jnp.stack(
            [d[..., 0] * r, d[..., 1], d[..., 2] * r], axis=-1)
        return solve_node_problem(
            problem_type | SHAPEPRESERVE, rhom, scale(pd, rhom), Qm,
            rhom0, scale(k0d, rhom0), rhom1, scale(k1d, rhom1),
            prefer_mass_con_to_bounds)
    if problem_type & NONNEGATIVE:
        a = jnp.ones(Qm.shape + (2,), Qm.dtype)
        w = jnp.stack([1.0 / rhom0, 1.0 / rhom1], axis=-1)
        y = jnp.stack([k0d[..., 0], k1d[..., 0]], axis=-1)
        x, _ = local_qp.solve_1eq_nonneg(a, Qm, y, w, method="least_squares")
        return x[..., 0], x[..., 1]

    Qm_min_kids = jnp.stack([k0d[..., 0], k1d[..., 0]], axis=-1)
    Qm_orig_kids = jnp.stack([k0d[..., 1], k1d[..., 1]], axis=-1)
    Qm_max_kids = jnp.stack([k0d[..., 2], k1d[..., 2]], axis=-1)
    rhom_kids = jnp.stack([rhom0, rhom1], axis=-1)

    Qm_min, Qm_max = pd[..., 0], pd[..., 2]
    lo = Qm < Qm_min
    hi = Qm > Qm_max
    tol = 10 * _EPS
    discrepancy = jnp.where(lo, Qm_min - Qm, Qm - Qm_max)
    act = (lo | hi) & (discrepancy > tol * (Qm_max - Qm_min))
    target = Qm - jnp.where(lo, Qm_min, Qm_max)
    adj_min = r2l_nl_adjust_bounds(Qm_min_kids, rhom_kids, target)
    adj_max = r2l_nl_adjust_bounds(Qm_max_kids, rhom_kids, target)
    Qm_min_kids = jnp.where((act & lo)[..., None], adj_min, Qm_min_kids)
    Qm_max_kids = jnp.where((act & hi)[..., None], adj_max, Qm_max_kids)

    # Quick exit: nothing changed and kids feasible -> pass kid masses through
    # untouched (critical for the no-change test; cedr_qlt_inl.hpp:145-159).
    no_change = ((~lo) & (~hi) & (Qm == pd[..., 1])
                 & jnp.all((Qm_orig_kids >= Qm_min_kids)
                           & (Qm_orig_kids <= Qm_max_kids), axis=-1))

    ones = jnp.ones_like(Qm_min_kids)
    w = 1.0 / rhom_kids
    x, _ = solve_1eq_bc_qp_2d(
        w, ones, Qm, Qm_min_kids, Qm_max_kids, Qm_orig_kids,
        clip=not prefer_mass_con_to_bounds,
        early_exit_on_tol=not prefer_mass_con_to_bounds)
    x = jnp.where(no_change[..., None], Qm_orig_kids, x)
    return x[..., 0], x[..., 1]


class QLT:
    """Functional QLT over a fixed tree.

    Usage:
        q = QLT(ncells, problem_type=SHAPEPRESERVE|CONSERVE)
        Qm_out = q.run(rhom, Qm, Qm_min, Qm_max, Qm_prev)

    All tracer arrays have shape (nt, ncells) (tracers are the dense batch
    axis). `problem_type` is static for the call; mixed-type tracer sets are
    handled by calling run per type group (the reference similarly groups
    tracers into per-problem-type blocks, cedr_qlt.hpp:77-99).
    """

    def __init__(self, ncells: int, problem_type: int = SHAPEPRESERVE,
                 imbalanced_tree: bool = False,
                 prefer_mass_con_to_bounds: bool = False):
        self.ncells = ncells
        self.problem_type = problem_type
        self.prefer = prefer_mass_con_to_bounds
        self.tree = tree_mod.build(ncells, imbalanced_tree)
        self._run_jit = None

    def run(self, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
            root_extra=None):
        """Jitted entry point; compiles once per (shape, dtype) signature.

        root_extra: optional (nt,) mass added directly to the ROOT total -
        the reference spf contract `root_mass = Q_data(root,2) + extra_mass`
        (slmm_spf.cpp:837-843), which redistributes a global discrepancy
        without perturbing any leaf channel.
        """
        import jax
        if self._run_jit is None:
            self._run_jit = jax.jit(self._run)
        args = [rhom, Qm]
        pt = self.problem_type
        if not (pt & NONNEGATIVE):
            args += [Qm_min, Qm_max]
        else:
            args += [Qm, Qm]  # placeholders, unused
        args += [Qm_prev if (pt & CONSERVE) else Qm]
        if root_extra is None:
            root_extra = jnp.zeros(Qm.shape[:1], Qm.dtype)
        args += [root_extra]
        return self._run_jit(*args)

    def _run(self, rhom, Qm, Qm_min=None, Qm_max=None, Qm_prev=None,
             root_extra=None):
        pt = self.problem_type
        t = self.tree
        nt = Qm.shape[0]
        dtype = Qm.dtype

        # ---- Leaf l2r data: (Qm_min, Qm, Qm_max) (+ rhom channel).
        if pt & NONNEGATIVE:
            # Channel layout mirrors set_Qm for the nonnegative type
            # (cedr_qlt_inl.hpp:46-48): the value channel is Qm itself.
            l2r_min = Qm
            l2r_max = Qm
        elif pt & SHAPEPRESERVE:
            l2r_min, l2r_max = Qm_min, Qm_max
        elif pt & CONSISTENT:
            l2r_min, l2r_max = Qm_min / rhom, Qm_max / rhom
        else:
            raise ValueError("invalid problem type")

        nn = t.nnodes
        V_rho = jnp.zeros((nn,), dtype).at[:t.nleaf].set(rhom)
        V_min = jnp.zeros((nt, nn), dtype).at[:, :t.nleaf].set(l2r_min)
        V_Qm = jnp.zeros((nt, nn), dtype).at[:, :t.nleaf].set(Qm)
        V_max = jnp.zeros((nt, nn), dtype).at[:, :t.nleaf].set(l2r_max)
        if pt & CONSERVE:
            V_prev = jnp.zeros((nt, nn), dtype).at[:, :t.nleaf].set(Qm_prev)

        # ---- Leaf-to-root combine (cedr_qlt.cpp:339-430): sums for the mass
        # channels; for non-shapepreserve (dynamic-range) bound channels, kid
        # min/max instead of sums.
        sum_bounds = bool(pt & SHAPEPRESERVE) or bool(pt & NONNEGATIVE)

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

        for (ids, k0, k1) in t.levels:
            V_rho = V_rho.at[ids].set(comb_sum(V_rho, k0, k1))
            if sum_bounds:
                V_min = V_min.at[:, ids].set(comb_sum(V_min, k0, k1))
                V_max = V_max.at[:, ids].set(comb_sum(V_max, k0, k1))
            else:
                V_min = V_min.at[:, ids].set(comb_min(V_min, k0, k1))
                V_max = V_max.at[:, ids].set(comb_max(V_max, k0, k1))
            V_Qm = V_Qm.at[:, ids].set(comb_sum(V_Qm, k0, k1))
            if pt & CONSERVE:
                V_prev = V_prev.at[:, ids].set(comb_sum(V_prev, k0, k1))

        # ---- Root: total mass (cedr_qlt.cpp root_compute).
        root = t.root
        if pt & CONSERVE:
            M_root = V_prev[:, root]
        else:
            M_root = V_Qm[:, root]
        if root_extra is not None:
            M_root = M_root + root_extra
        M = jnp.zeros((nt, nn), dtype).at[:, root].set(M_root)

        # ---- Root-to-leaf: per-level batched node QPs. For the
        # consistent-only (dynamic-range) types, the reference propagates the
        # parent's q bounds down the sweep (r2l_solve_qp_set_q,
        # cedr_qlt.cpp:490-565), so every node sees the ROOT's global q
        # bounds and the node QPs stay feasible; reproduce by broadcasting
        # the root bounds.
        dynamic_range = bool(pt & CONSISTENT) and not (pt & SHAPEPRESERVE)
        if dynamic_range:
            qmin_g = V_min[:, t.root][:, None]
            qmax_g = V_max[:, t.root][:, None]

        def bounds_at(idx):
            if dynamic_range:
                shape = (nt,) + idx.shape
                return (jnp.broadcast_to(qmin_g, shape),
                        jnp.broadcast_to(qmax_g, shape))
            return V_min[:, idx], V_max[:, idx]

        for (ids, k0, k1) in reversed(t.levels):
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
                pt, rhom_n, pd, Qm_node, rhom0, k0d, rhom1, k1d, self.prefer)
            # Single-kid nodes pass mass straight through.
            single = k1 < 0
            Qm0 = jnp.where(single, Qm_node, Qm0)
            M = M.at[:, k0].set(Qm0)
            M = M.at[:, k1s].set(jnp.where(single, M[:, k1s], Qm1))

        return M[:, :t.nleaf]

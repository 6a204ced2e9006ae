"""Batched local QP / filter solvers.

Batched counterparts of the reference's device-side local solvers:
  - caas:             /root/reference/cedr/cedr_local_inl.hpp:272-306
  - solve_1eq_bc_qp:  /root/reference/cedr/cedr_local_inl.hpp:167-270 and
                      /root/reference/methods/slmm/slmm_spf.cpp:46-165
  - clip_and_sum:     /root/reference/methods/slmm/slmm_spf.cpp:245-303
  - solve_1eq_nonneg: /root/reference/cedr/cedr_local_inl.hpp:308-330

All solvers are written over the *last* axis (the n constrained unknowns) and
broadcast over arbitrary leading batch axes, so one call solves every cell's
QP at once. Data-dependent iteration (the reference's bisection-safeguarded
Newton with early exit) becomes a fixed-trip masked loop: each batch lane
carries `done`/`info` state and stops changing once converged. This keeps the
whole solve a single fused XLA computation - the accelerator way to run
millions of tiny independent QPs.

Problem solved (Bochev-Ridzal-Shashkov / Guba et al. JCP 2014):
    min_x sum_i w_i (x_i - y_i)^2   s.t.  a'x = b,  xlo <= x <= xhi
"""

import jax
import jax.numpy as jnp

_EPS = 2.220446049250313e-16


def calc_r_tol(b, a, y):
    """Residual tolerance (cedr_local_inl.hpp:13-18)."""
    ab = jnp.maximum(jnp.abs(b), jnp.max(jnp.abs(a * y), axis=-1))
    return 1e1 * _EPS * ab


def caas(a, b, xlo, xhi, y, clip: bool = True):
    """ClipAndAssuredSum (cedr_local_inl.hpp:272-306).

    Clip y into [xlo, xhi]; then distribute the mass discrepancy
    dm = b - a'x proportionally to the remaining headroom toward the bound on
    the needed side; finally re-clip for numerics.
    Shapes: a, xlo, xhi, y: (..., n); b: (...,). Returns x: (..., n).
    """
    x = jnp.clip(y, xlo, xhi)
    dm = b - jnp.sum(a * x, axis=-1)
    fac_hi = jnp.sum(a * (xhi - x), axis=-1)
    fac_lo = jnp.sum(a * (x - xlo), axis=-1)
    # dm > 0: push toward xhi; dm < 0: pull toward xlo; dm == 0: no-op.
    up = dm > 0
    fac = jnp.where(up, fac_hi, fac_lo)
    scale = jnp.where(fac > 0, dm / jnp.where(fac > 0, fac, 1.0), 0.0)
    dirn = jnp.where(up[..., None], xhi - x, x - xlo)
    x = x + scale[..., None] * dirn
    if clip:
        x = jnp.clip(x, xlo, xhi)
    return x


def caas_gsum(a, b, xlo, xhi, y, gsum, clip: bool = True):
    """`caas` with a caller-supplied global sum over the last axis.

    The single chip passes the fixed-tree bfb_sum; a shard_map caller
    passes the distributed BFB tree reducer (cdr/bfb.py), which is
    bitwise-equal on contiguous blocks - so one formulation serves the
    single-chip and sharded caas-node paths identically
    (glbl_only_lcldyn, slmmir_remapper_isl.cpp:389-445).
    """
    x = jnp.clip(y, xlo, xhi)
    dm = b - gsum(a * x)
    fac_hi = gsum(a * (xhi - x))
    fac_lo = gsum(a * (x - xlo))
    up = dm > 0
    fac = jnp.where(up, fac_hi, fac_lo)
    scale = jnp.where(fac > 0, dm / jnp.where(fac > 0, fac, 1.0), 0.0)
    dirn = jnp.where(up[..., None], xhi - x, x - xlo)
    x = x + scale[..., None] * dirn
    if clip:
        x = jnp.clip(x, xlo, xhi)
    return x


def solve_1eq_bc_qp(w, a, b, xlo, xhi, y, max_its: int = 50):
    """Single-equality bound-constrained QP via bisection-safeguarded Newton
    on the Lagrange multiplier (cedr_local_inl.hpp:167-270).

    Shapes: w, a, xlo, xhi, y: (..., n); b: (...,).
    Returns (x, info) where info (int32, (...,)) is:
       1 solved; -1 infeasible; 0 input already satisfied constraints.
    For infeasible lanes x is the nearest bound corner (like the reference,
    which leaves x at the last evaluation).
    """
    r_tol = calc_r_tol(b, a, y)

    # Endpoint feasibility checks (check_lu, cedr_local_inl.hpp:23-41).
    r_lo = jnp.sum(a * xlo, axis=-1) - b
    r_hi = jnp.sum(a * xhi, axis=-1) - b
    lo_is_sol = jnp.abs(r_lo) <= r_tol
    hi_is_sol = jnp.abs(r_hi) <= r_tol
    infeas = (~lo_is_sol) & (~hi_is_sol) & ((r_lo > 0) | (r_hi < 0))
    corner_done = lo_is_sol | hi_is_sol | infeas
    x_corner = jnp.where((lo_is_sol | (r_lo > 0))[..., None], xlo, xhi)

    # Quick exit: y already satisfies everything (spf.cpp:51-66).
    y_in = jnp.all((y >= xlo) & (y <= xhi), axis=-1)
    ry = jnp.abs(jnp.sum(a * y, axis=-1) - b)
    y_done = y_in & (ry <= r_tol) & ~corner_done

    # Lambda bracketing (cedr_local_inl.hpp:204-219).
    rq = w / a
    lam_i_lo = rq * (xlo - y)
    lam_i_hi = rq * (xhi - y)
    lamlo0 = jnp.min(lam_i_lo, axis=-1)
    lamhi0 = jnp.max(lam_i_hi, axis=-1)
    lam0 = jnp.where((lamlo0 <= 0) & (lamhi0 >= 0), 0.0, lamlo0)

    wall_dist = 1e-3
    q = a / w
    aq = a * q

    done0 = corner_done | y_done
    state0 = (jnp.asarray(0), lam0, lamlo0, lamhi0,
              y.astype(jnp.result_type(y, w)), done0,
              jnp.zeros_like(b, dtype=bool))

    # Early-exit batched Newton-bisection: iterate while ANY lane is
    # unconverged, up to max_its (the reference exits per-scalar; the batch
    # exits when the slowest lane does - typically ~10 iterations, far under
    # the safety cap).
    def cond(state):
        it, _, _, _, _, done, _ = state
        return (it < max_its) & ~jnp.all(done)

    def body(state):
        it, lam, lamlo, lamhi, x_newton, done, prev_bisect = state
        x_trial = y + lam[..., None] * q
        inside = (x_trial >= xlo) & (x_trial <= xhi)
        x_it = jnp.clip(x_trial, xlo, xhi)
        r = jnp.sum(a * x_it, axis=-1) - b
        r_lambda = jnp.sum(jnp.where(inside, aq, 0.0), axis=-1)
        converged = jnp.abs(r) <= r_tol
        newly_active = ~done
        x_newton = jnp.where(newly_active[..., None], x_it, x_newton)
        done = done | converged
        # Bracket update + Newton step with bisection safeguard.
        lamhi = jnp.where(r > 0, lam, lamhi)
        lamlo = jnp.where(r > 0, lamlo, lam)
        lam_newton = jnp.where(r_lambda != 0, lam - r / jnp.where(
            r_lambda != 0, r_lambda, 1.0), lamlo)
        D = jnp.where(prev_bisect, 0.0, wall_dist * (lamhi - lamlo))
        need_bisect = ((lam_newton - lamlo < D) | (lamhi - lam_newton < D))
        lam_next = jnp.where(need_bisect, 0.5 * (lamlo + lamhi), lam_newton)
        lam = jnp.where(done, lam, lam_next)
        return (it + 1, lam, lamlo, lamhi, x_newton, done,
                need_bisect & ~done)

    state = jax.lax.while_loop(cond, body, state0)
    _, lam, lamlo, lamhi, x_newton, done, _ = state
    info = jnp.where(y_done, 0, jnp.where(infeas, -1, 1)).astype(jnp.int32)
    x = jnp.where(y_done[..., None], y,
                  jnp.where(corner_done[..., None], x_corner, x_newton))
    return x, info


def clip_and_sum(a, b, xlo, xhi, y):
    """CAAS with the reference's slmm_spf flavor (spf.cpp:245-303): clip, then
    distribute ALL of the mass discrepancy (including what clipping removed)
    along the headroom direction. Numerically identical to `caas` above; kept
    as an alias for parity with the spf namespace."""
    return caas(a, b, xlo, xhi, y, clip=True)


def clip_and_weighted_sum(a, b, xlo, xhi, y):
    """CAAGS (spf.cpp:305-352): like clip_and_sum but blends the proportional
    direction v with a constant-per-node direction w_i = 1/a_i, with the blend
    factor alpha chosen as large as possible without violating bounds."""
    x = jnp.clip(y, xlo, xhi)
    m = b - jnp.sum(a * x, axis=-1)
    up = m > 0
    v = jnp.where(up[..., None], xhi - x, x - xlo)
    v_den = jnp.sum(v * a, axis=-1)
    # Constant-mass direction over nodes that still have headroom.
    has_room = jnp.where(up[..., None], y < xhi, y > xlo)
    wdir = jnp.where(has_room, 1.0 / a, 0.0)
    w_den = jnp.sum(wdir * a, axis=-1)

    v_den_safe = jnp.where(v_den != 0, v_den, 1.0)
    w_den_safe = jnp.where(w_den > 0, w_den, 1.0)
    vi = v / v_den_safe[..., None]
    wi = wdir / w_den_safe[..., None]
    bound = jnp.where(up[..., None], xhi, xlo)
    num = bound - x - m[..., None] * vi
    den = m[..., None] * (wi - vi)
    frac = jnp.where((wi > vi) & (jnp.abs(num) < jnp.abs(den)),
                     num / jnp.where(den != 0, den, 1.0), 1.0)
    alpha = jnp.minimum(jnp.min(frac, axis=-1), 1.0)
    alpha = jnp.where(w_den > 0, alpha, 0.0)
    blend = (1 - alpha[..., None]) * vi + alpha[..., None] * wi
    step = jnp.where((m != 0)[..., None] & (v_den != 0)[..., None],
                     m[..., None] * jnp.where(alpha[..., None] > 0, blend, vi),
                     0.0)
    return jnp.clip(x + step, xlo, xhi)


def solve_1eq_nonneg(a, b, y, w, method: str = "caas"):
    """Nonnegativity-constrained distribution (cedr_local_inl.hpp:308-330).

    Bounds are [0, b/a_i] (one slot could get all the mass). Infeasible iff
    b < 0; those lanes return y unchanged with info -1.
    """
    xhi = b[..., None] / a
    zero = jnp.zeros_like(y)
    if method == "caas":
        x = caas(a, b, zero, xhi, y)
        info = jnp.ones_like(b, dtype=jnp.int32)
    else:
        x, info = solve_1eq_bc_qp(w, a, b, zero, xhi, y)
    feasible = b >= 0
    x = jnp.where(feasible[..., None], x, y)
    info = jnp.where(feasible, info, -1)
    return x, info

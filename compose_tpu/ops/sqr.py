"""Spherical-quad <-> reference-square maps, batched.

Counterpart of /root/reference/siqk/siqk_sqr.hpp (bilinear map + Newton
inverse) and the improved solver at
/root/reference/methods/slmm/slmmir_remapper_isl.cpp:41-150, which works with
the standard p=1 isoparametric form on [-1,1]^2:

    f(a,b) = sum_i c_i N_i(a,b),  N = quarter-bilinear shape functions
    q(a,b) = f / |f|

The inverse (sphere -> ref) is a fixed-iteration masked Newton solve - all
points iterate the same number of times so the computation is a static XLA
graph; converged points simply stop updating. This is the idiomatic SIMD
replacement for the reference's early-exit scalar loop.

Conventions: `corners` has shape (..., 4, 3), CCW; (a,b) in [-1,1]^2 with
(-1,-1) -> corner 0, (1,-1) -> corner 1, (1,1) -> corner 2, (-1,1) -> corner 3.
"""

from functools import partial

import jax
import jax.numpy as jnp

from . import sphere


def _shape_fns(a, b):
    """Bilinear shape functions, shape (..., 4)."""
    qtr = 0.25
    return jnp.stack([
        qtr * (1 - a) * (1 - b),
        qtr * (1 + a) * (1 - b),
        qtr * (1 + a) * (1 + b),
        qtr * (1 - a) * (1 + b)], axis=-1)


def _shape_fns_da(a, b):
    qtr = 0.25
    return jnp.stack([
        -qtr * (1 - b), qtr * (1 - b), qtr * (1 + b), -qtr * (1 + b)],
        axis=-1)


def _shape_fns_db(a, b):
    qtr = 0.25
    return jnp.stack([
        -qtr * (1 - a), -qtr * (1 + a), qtr * (1 + a), qtr * (1 - a)],
        axis=-1)


def ref_to_bilinear(corners, a, b):
    """Bilinear point (not normalized), shape (..., 3)."""
    N = _shape_fns(a, b)
    return jnp.einsum('...i,...id->...d', N, corners)


def ref_to_sphere(corners, a, b):
    """Map ref coords to the unit sphere (siqk_sqr.hpp: calc_ref_to_sphere)."""
    return sphere.normalize(ref_to_bilinear(corners, a, b))


def _sphere_jacobian(corners, a, b):
    """Point on sphere s and Jacobian columns (s_a, s_b) of the normalized
    bilinear map (slmmir_remapper_isl.cpp:67-106, calc_Jacobian)."""
    N = _shape_fns(a, b)
    Na = _shape_fns_da(a, b)
    Nb = _shape_fns_db(a, b)
    s = jnp.einsum('...i,...id->...d', N, corners)
    sa = jnp.einsum('...i,...id->...d', Na, corners)
    sb = jnp.einsum('...i,...id->...d', Nb, corners)
    # Guard: a folded (degenerate) quad's bilinear map can pass through the
    # origin; keep the masked Newton NaN-free for such lanes.
    r2 = jnp.maximum(sphere.norm2(s)[..., None], jnp.finfo(s.dtype).tiny)
    r = jnp.sqrt(r2)
    sa = (sa - s * (sphere.dot(s, sa)[..., None] / r2)) / r
    sb = (sb - s * (sphere.dot(s, sb)[..., None] / r2)) / r
    return s / r, sa, sb


def _solve_Jxr(sa, sb, r):
    """Least-squares solve of [sa sb] dx = r via Gram-Schmidt QR on the two
    3-vector columns (slmmir_remapper_isl.cpp:47-65). Degenerate Jacobians
    (folded/collapsed quads under extreme deformation) are guarded so the
    masked Newton loop stays NaN-free - those lanes simply stop moving."""
    tiny = jnp.finfo(sa.dtype).tiny
    n1 = jnp.maximum(sphere.norm(sa), tiny)
    q1 = sa / n1[..., None]
    alpha = sphere.dot(q1, sb)
    v2 = sb - alpha[..., None] * q1
    n2 = jnp.maximum(sphere.norm(v2), tiny)
    q2 = v2 / n2[..., None]
    qtr1 = sphere.dot(q1, r)
    qtr2 = sphere.dot(q2, r)
    db = qtr2 / n2
    da = (qtr1 - alpha * db) / n1
    return da, db


@partial(jax.jit, static_argnames=("max_its", "tol"))
def sphere_to_ref(corners, q, max_its: int = 10, tol: float = None,
                  a0=None, b0=None):
    """Invert ref_to_sphere by Newton iteration; batched over leading dims.

    Returns (a, b). `q` must be on (or very near) the unit sphere; callers
    should normalize first (the reference does the same for speed,
    slmmir_remapper_isl.cpp:1107-1110). Passing a warm start (a0, b0)
    (e.g. the closed-form equiangular estimate on the quasiuniform mesh)
    lets callers cut max_its to ~4 - Newton is quadratic from an O(h^2)
    guess.
    """
    if tol is None:
        tol = 1e2 * jnp.finfo(jnp.float64).eps
    tol2 = tol * tol

    a = jnp.zeros(q.shape[:-1], q.dtype) if a0 is None else a0
    b = jnp.zeros(q.shape[:-1], q.dtype) if b0 is None else b0

    # Fixed-trip masked Newton: every lane runs max_its cheap iterations;
    # lanes that have converged stop updating via the mask. No data-dependent
    # control flow, so XLA compiles a single small loop body.
    def body(_, ab):
        a, b = ab
        s, sa, sb = _sphere_jacobian(corners, a, b)
        r = s - q
        active = sphere.norm2(r) > tol2
        da, db = _solve_Jxr(sa, sb, r)
        # Bound the iterates: every legitimate query point inverts to
        # |a|,|b| <~ 1.5 of its element, but a folded/degenerate quad (CFL
        # far beyond validity) makes the iteration diverge, and once an
        # iterate overflows the next Jacobian turns NaN - which poisons
        # masked downstream sums. The bound never binds for real solves.
        lim = 1e3
        a = jnp.clip(jnp.where(active, a - da, a), -lim, lim)
        b = jnp.clip(jnp.where(active, b - db, b), -lim, lim)
        return a, b

    return jax.lax.fori_loop(0, max_its, body, (a, b))


def isoparametric_point_and_jacobian(nodes_xyz, va, vb, dva, dvb):
    """Isoparametric (np x np)-node map: point on sphere and |J|.

    nodes_xyz: (..., np, np, 3) physical node positions, indexed [j, i] with i
    the fast (a / x) direction, matching the reference's cell layout
    (slmmir_remapper_isl.cpp:152-224, calc_isoparametric_Jacobian).
    va, vb: basis values at (a, b), shape (..., np); dva, dvb: derivatives.

    Returns (u, jac): normalized point (..., 3) and Jacobian determinant
    norm |u_a x u_b| (...,).
    """
    f = jnp.einsum('...j,...i,...jid->...d', vb, va, nodes_xyz)
    fa = jnp.einsum('...j,...i,...jid->...d', vb, dva, nodes_xyz)
    fb = jnp.einsum('...j,...i,...jid->...d', dvb, va, nodes_xyz)
    r2 = sphere.norm2(f)[..., None]
    r = jnp.sqrt(r2)
    u = f / r
    ua = (fa - f * (sphere.dot(f, fa)[..., None] / r2)) / r
    ub = (fb - f * (sphere.dot(f, fb)[..., None] / r2)) / r
    return u, sphere.norm(sphere.cross(ua, ub))


@jax.jit
def bilinear_jacobian_norm(corners, a, b):
    """|J| of the corner-bilinear sphere map at (a, b) - used for Eulerian
    node Jacobians (slmmir_util.cpp:16-41, calc_node_jacobians)."""
    _, sa, sb = _sphere_jacobian(corners, a, b)
    return sphere.norm(sphere.cross(sa, sb))

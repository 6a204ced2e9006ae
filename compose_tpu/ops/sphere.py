"""Sphere geometry primitives, batched and jit-friendly.

Batched counterpart of the reference's SphereGeometry statics
(/root/reference/siqk/siqk_geometry.hpp:118-309) and the lat-lon helpers
(/root/reference/methods/slmm/slmm_util.hpp:40-72). All functions operate on
arrays whose last axis is the 3-vector axis, so they vmap/broadcast freely.
"""

import jax.numpy as jnp


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def norm2(a):
    return dot(a, a)


def norm(a):
    return jnp.sqrt(norm2(a))


def cross(a, b):
    return jnp.cross(a, b)


def normalize(a):
    return a / norm(a)[..., None]


def ll2xyz(lat, lon, radius=1.0):
    """Latitude/longitude (radians) -> unit-sphere cartesian, stacked last."""
    coslat = jnp.cos(lat)
    return jnp.stack(
        [radius * jnp.cos(lon) * coslat,
         radius * jnp.sin(lon) * coslat,
         radius * jnp.sin(lat)], axis=-1)


def xyz2ll(p):
    """Cartesian -> (lat, lon) in radians."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    lat = jnp.arctan2(z, jnp.sqrt(x * x + y * y))
    lon = jnp.arctan2(y, x)
    return lat, lon


def great_circle_dist(lat1, lon1, lat2, lon2, radius=1.0):
    """Great-circle distance via atan2(|a x b|, a.b).

    Same formulation as the reference (slmm_util.hpp:50-66), which is accurate
    for both small and near-antipodal separations.
    """
    a = ll2xyz(lat1, lon1)
    b = ll2xyz(lat2, lon2)
    cp = cross(a, b)
    return radius * jnp.arctan2(norm(cp), dot(a, b))


def edge_normal(a, b):
    """Inward-pointing normal of the great-circle edge a->b of a CCW spherical
    polygon (siqk_geometry.hpp: SphereGeometry::edge_normal)."""
    return normalize(cross(a, b))


def inside(p, nml):
    """Half-space test: is p on the inside of the edge with normal nml?"""
    return dot(p, nml) >= 0


def tri_jacobian(v1, v2, v3, bary):
    """Jacobian of the map (barycentric coords on flat triangle) -> sphere,
    evaluated at barycentric point `bary` (shape (..., 3)); also returns the
    sphere point. Reference: SphereGeometry::calc_tri_jacobian
    (siqk_geometry.hpp, exact derivation in comments there).

    The flat point is q = b1 v1 + b2 v2 + b3 v3; the sphere point is
    q/|q|. The Jacobian of the normalized map contracted with the triangle's
    tangent vectors gives |J| = |t1 x t2| where
    ti = (vi - v3 projected through the normalization differential).
    """
    q = (bary[..., 0:1] * v1 + bary[..., 1:2] * v2 + bary[..., 2:3] * v3)
    # Guard for degenerate (near-origin) flat points so masked lanes stay
    # NaN-free; real triangles on the unit sphere have |q| = O(1).
    r2 = jnp.maximum(norm2(q)[..., None], jnp.finfo(q.dtype).tiny)
    r = jnp.sqrt(r2)
    sphere_p = q / r
    # d(q/|q|)/dq applied to edge vectors e1 = v1-v3, e2 = v2-v3:
    #   J e = e/r - q (q.e)/r^3
    e1 = v1 - v3
    e2 = v2 - v3
    t1 = e1 / r - q * (dot(q, e1)[..., None] / (r2 * r))
    t2 = e2 / r - q * (dot(q, e2)[..., None] / (r2 * r))
    jac = norm(cross(t1, t2))
    return jac, sphere_p

"""Direct stiffness summation (DSS): DGLL <-> CGLL transfers.

Counterpart of /root/reference/methods/slmm/slmmir_d2c.{hpp,cpp} (D2Cer). The
reference builds CSR transpose maps and loops per continuous node; here the
same transfers are `segment_sum`s over the dgll->cgll index map - one fused
gather/scatter per field, batched over tracers. On a GPU a scatter-add
accumulates with atomics in an order that changes between runs, so the
transport steps use the gather variants below (fixed order, bitwise
reproducible on every backend); the scatter forms serve output (io.py) and
tests.

Conventions: fields carry the DGLL axis LAST, shape (..., ndgll); the
continuous axis is also last, (..., cnn).
"""

from functools import partial

import jax
import jax.numpy as jnp


def _seg(op, x, ids, cnn):
    """Apply a jax.ops.segment_* op along the last axis of x."""
    xm = jnp.moveaxis(x, -1, 0)
    out = op(xm, ids, num_segments=cnn)
    return jnp.moveaxis(out, 0, -1)


@partial(jax.jit, static_argnames=("cnn", "clip_minmax"))
def d2c(dg, d2c_map, dgbfi, cnn: int, clip_minmax: bool = True):
    """Weighted average of coincident DGLL values onto CGLL nodes
    (slmmir_d2c.cpp:60-84). dg: (..., ndgll); d2c_map: (ndgll,) int; dgbfi:
    (ndgll,) weights. Returns (..., cnn)."""
    num = _seg(jax.ops.segment_sum, dgbfi * dg, d2c_map, cnn)
    den = _seg(jax.ops.segment_sum, jnp.broadcast_to(dgbfi, dg.shape),
               d2c_map, cnn)
    cg = num / den
    if clip_minmax:
        # A weighted average cannot create new extrema; clip numerical noise
        # (see the comment at slmmir_d2c.cpp:108-113).
        mx = _seg(jax.ops.segment_max, dg, d2c_map, cnn)
        mn = _seg(jax.ops.segment_min, dg, d2c_map, cnn)
        cg = jnp.clip(cg, mn, mx)
    return cg


@jax.jit
def c2d(cg, d2c_map):
    """Inject CGLL values back to DGLL slots (slmmir_d2c.cpp:54-58)."""
    return cg[..., d2c_map]


@partial(jax.jit, static_argnames=("cnn",))
def dss(dg, d2c_map, dgbfi, cnn: int):
    """Make a DGLL field continuous: d2c then c2d (slmmir_d2c.cpp:86-89)."""
    return c2d(d2c(dg, d2c_map, dgbfi, cnn), d2c_map)


@partial(jax.jit, static_argnames=("cnn",))
def d2c_q(rho_dg, q_dg, d2c_map, dgbfi, cnn: int):
    """Mixing-ratio DSS: average q weighted by dgbfi*rho, clipped to the
    coincident-node range (slmmir_d2c.cpp:91-115)."""
    w = dgbfi * rho_dg
    num = _seg(jax.ops.segment_sum, w * q_dg, d2c_map, cnn)
    den = _seg(jax.ops.segment_sum, jnp.broadcast_to(w, q_dg.shape),
               d2c_map, cnn)
    # Zero-mass nodes (rho == 0 at every coincident slot): fall back to the
    # dgbfi-weighted average so q stays finite (the reference assumes
    # rho > 0 here).
    num0 = _seg(jax.ops.segment_sum, dgbfi * q_dg, d2c_map, cnn)
    den0 = _seg(jax.ops.segment_sum,
                jnp.broadcast_to(dgbfi, q_dg.shape), d2c_map, cnn)
    ok = den > 0
    cg = jnp.where(ok, num / jnp.where(ok, den, 1.0), num0 / den0)
    mx = _seg(jax.ops.segment_max, q_dg, d2c_map, cnn)
    mn = _seg(jax.ops.segment_min, q_dg, d2c_map, cnn)
    return jnp.clip(cg, mn, mx)


@partial(jax.jit, static_argnames=("cnn",))
def dss_q(rho_dg, q_dg, d2c_map, dgbfi, cnn: int):
    """q-DSS round trip (slmmir_d2c.cpp:117-120)."""
    return c2d(d2c_q(rho_dg, q_dg, d2c_map, dgbfi, cnn), d2c_map)


# ----------------------------------------------------------------------------
# Gather-based variants: the inverse map has <= 4 coincident DGLL slots per
# continuous node (mesh.c2d_idx/c2d_mask), so the per-node reduction becomes
# a (cnn, 4) gather + masked sum - no scatter-add, so no atomics and a
# fixed summation order on every backend.

@jax.jit
def d2c_gather(dg, c2d_idx, c2d_mask, dgbfi, clip_minmax: bool = True):
    """Gather-based d2c. dg: (..., ndgll) -> (..., cnn)."""
    vals = dg[..., c2d_idx]                         # (..., cnn, 4)
    w = jnp.where(c2d_mask, dgbfi[c2d_idx], 0.0)
    num = jnp.sum(w * vals, axis=-1)
    den = jnp.sum(w, axis=-1)
    cg = num / den
    if clip_minmax:
        big = jnp.where(c2d_mask, vals, -jnp.inf)
        small = jnp.where(c2d_mask, vals, jnp.inf)
        cg = jnp.clip(cg, jnp.min(small, axis=-1), jnp.max(big, axis=-1))
    return cg


@jax.jit
def dss_gather(dg, d2c_map, c2d_idx, c2d_mask, dgbfi):
    return c2d(d2c_gather(dg, c2d_idx, c2d_mask, dgbfi), d2c_map)


@jax.jit
def d2c_q_gather(rho_dg, q_dg, c2d_idx, c2d_mask, dgbfi):
    """Gather-based mixing-ratio d2c (weights dgbfi*rho, clip to coincident
    range)."""
    vals = q_dg[..., c2d_idx]                       # (..., cnn, 4)
    w = jnp.where(c2d_mask, (dgbfi * rho_dg)[c2d_idx], 0.0)
    num = jnp.sum(w * vals, axis=-1)
    den = jnp.sum(w, axis=-1)
    w0 = jnp.where(c2d_mask, dgbfi[c2d_idx], 0.0)
    num0 = jnp.sum(w0 * vals, axis=-1)
    den0 = jnp.sum(w0, axis=-1)
    ok = den > 0
    cg = jnp.where(ok, num / jnp.where(ok, den, 1.0), num0 / den0)
    big = jnp.where(c2d_mask, vals, -jnp.inf)
    small = jnp.where(c2d_mask, vals, jnp.inf)
    return jnp.clip(cg, jnp.min(small, axis=-1), jnp.max(big, axis=-1))


@jax.jit
def dss_q_gather(rho_dg, q_dg, d2c_map, c2d_idx, c2d_mask, dgbfi):
    return c2d(d2c_q_gather(rho_dg, q_dg, c2d_idx, c2d_mask, dgbfi), d2c_map)


# Tracer-innermost variants: indexing the LAST axis of a (nt, dnn) field
# with the (cnn, 4) inverse map gathers SCALARS. Transposing so the tracer
# axis is innermost makes every gather row nt elements wide; the results
# are bitwise identical (the arithmetic per node is unchanged).

@jax.jit
def dss_gather_t(dg, d2c_map, c2d_idx, c2d_mask, dgbfi,
                 clip_minmax: bool = True):
    """dss_gather for (nt, dnn) fields via the tracer-innermost layout."""
    dgT = jnp.moveaxis(dg, 0, -1)                   # (dnn, nt)
    vals = dgT[c2d_idx]                             # (cnn, 4, nt)
    w = jnp.where(c2d_mask, dgbfi[c2d_idx], 0.0)[..., None]
    num = jnp.sum(w * vals, axis=-2)
    den = jnp.sum(w, axis=-2)
    cg = num / den
    if clip_minmax:
        big = jnp.where(c2d_mask[..., None], vals, -jnp.inf)
        small = jnp.where(c2d_mask[..., None], vals, jnp.inf)
        cg = jnp.clip(cg, jnp.min(small, axis=-2), jnp.max(big, axis=-2))
    return jnp.moveaxis(cg[d2c_map], -1, 0)


@jax.jit
def dss_q_gather_t(rho_dg, q_dg, d2c_map, c2d_idx, c2d_mask, dgbfi):
    """dss_q_gather for (nt, dnn) tracers via the tracer-innermost layout."""
    qT = jnp.moveaxis(q_dg, 0, -1)                  # (dnn, nt)
    vals = qT[c2d_idx]                              # (cnn, 4, nt)
    w = jnp.where(c2d_mask, (dgbfi * rho_dg)[c2d_idx], 0.0)[..., None]
    num = jnp.sum(w * vals, axis=-2)
    den = jnp.sum(w, axis=-2)
    w0 = jnp.where(c2d_mask, dgbfi[c2d_idx], 0.0)[..., None]
    num0 = jnp.sum(w0 * vals, axis=-2)
    den0 = jnp.sum(w0, axis=-2)
    ok = den > 0
    cg = jnp.where(ok, num / jnp.where(ok, den, 1.0), num0 / den0)
    big = jnp.where(c2d_mask[..., None], vals, -jnp.inf)
    small = jnp.where(c2d_mask[..., None], vals, jnp.inf)
    cg = jnp.clip(cg, jnp.min(small, axis=-2), jnp.max(big, axis=-2))
    return jnp.moveaxis(cg[d2c_map], -1, 0)

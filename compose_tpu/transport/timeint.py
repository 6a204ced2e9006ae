"""Trajectory (departure point) integration.

Counterpart of /root/reference/methods/slmm/slmm_time_int.hpp (adaptive
embedded RK ark23/ark45) and slmmir_time_int.cpp (MeshIntegrator). The
reference integrates every CGLL node with per-node adaptive stepping and a
tolerance ~1e2*eps - effectively exact trajectories. Per-node adaptivity is
hostile to SIMD (divergent trip counts); instead we integrate all nodes
in lockstep with a fixed-substep Dormand-Prince RK5(4) step (the same tableau
as the reference's ark45, slmm_time_int.hpp:273-417). With a handful of
substeps per transport step the trajectory error lands far below the spatial
discretization error, which is all the accuracy goldens require; `nsub` is
configurable for studies.

Positions are advected in cartesian xyz form (no pole singularity; the wind
fields add a radial restoring component, gallery._uv2xyz), then normalized.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import sphere

# Dormand-Prince 5(4) coefficients (the classic ode45 tableau; also the
# reference's ark45, slmm_time_int.hpp:273-310).
_C = (0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0)
_A = (
    (),
    (1.0 / 5,),
    (3.0 / 40, 9.0 / 40),
    (44.0 / 45, -56.0 / 15, 32.0 / 9),
    (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729),
    (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
     -5103.0 / 18656),
    (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
     11.0 / 84),
)
_B5 = (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
       11.0 / 84, 0.0)


def _dopri5_step(velocity, t0, dt, p):
    ks = []
    # Times are evaluated in the position dtype so an f32 geometry pipeline
    # is not promoted back to f64 through the wind-field formulas (time
    # resolution at f32 is ~0.1 s against ~1e6 s flow periods).
    dtl = jnp.asarray(dt, p.dtype)
    for i in range(7):
        pi = p
        for j, a in enumerate(_A[i]):
            pi = pi + (dtl * a) * ks[j]
        ks.append(velocity(jnp.asarray(t0 + _C[i] * dt, p.dtype), pi))
    out = p
    for b, k in zip(_B5, ks):
        if b != 0.0:
            out = out + (dtl * b) * k
    return out


@partial(jax.jit, static_argnames=("velocity", "nsub"))
def integrate(velocity, ts: float, tf: float, p, nsub: int = 8):
    """Integrate dp/dt = velocity(t, p) from ts to tf (tf < ts = backward
    integration, used for ISL departure points) with `nsub` fixed
    Dormand-Prince substeps. p: (..., 3). Returns the (normalized) endpoint.
    """
    dt = (tf - ts) / nsub

    def body(i, p):
        t = ts + i * dt
        return _dopri5_step(velocity, t, dt, p)

    p = jax.lax.fori_loop(0, nsub, body, p)
    return sphere.normalize(p)


@partial(jax.jit, static_argnames=("velocity",))
def integrate_line(velocity, ts: float, tf: float, p):
    """The reference's 'line' study integrator (StudyTimeIntegrator,
    slmmir_time_int_exp.cpp:26-60): a 2-iteration midpoint fixed point -
    two velocity evaluations per transport step, the cheapest trajectory
    scheme the reference studies (-timeint line / interpline)."""
    dt = tf - ts
    th = 0.5 * (ts + tf)
    uh = p
    for _ in range(2):
        f = velocity(th, uh)
        uh = p + (0.5 * dt) * f
    return sphere.normalize(p + dt * f)


def interp_departure(vw, cells):
    """Departure-point interpolation sum_k vw[..., k] * cells[..., k, :] as
    an explicit left-to-right chain - einsum association is batch-shape-
    dependent, and the sharded step evaluates the same rows in per-shard
    blocks (bitwise contract)."""
    acc = vw[..., 0, None] * cells[..., 0, :]
    for k in range(1, vw.shape[-1]):
        acc = acc + vw[..., k, None] * cells[..., k, :]
    return acc

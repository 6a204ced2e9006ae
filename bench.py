"""Benchmark: tracer-DOF/s on one GPU for the flagship ISL transport step.

Config: ne=30 cubed sphere (5400 cells), np=4 (16 DOF/cell), 40 tracers,
pisl method with CAAS property preservation + CAAS cell-local limiter, f32
geometry and tracer interpolation (mass and bounds arithmetic stays f64) -
the BASELINE.json headline configuration, over the 12-day deformational
flow in 120 steps.

Prints ONE JSON line that names the device, the card and its power limit.
Exits nonzero when JAX finds no GPU: a benchmark never falls back to the
CPU.

    python bench.py
"""

import json
import sys
import time

NE, NP, NT = 30, 4, 40
ICS = ("gaussianhills", "slottedcylinders", "cosinebells", "xyztrig")
T = 86400.0 * 12
NSTEPS = 120
DT = T / NSTEPS
CONFIG = dict(filter="caas", limiter="caas", rho_isl=True, nsub=8,
              geom_dtype="f32", interp_dtype="f32")


def build(ne=NE, nt=NT, **overrides):
    """(model, rho, q) for the bench configuration at `ne` with `nt`
    tracers (the four ICs repeated); `overrides` replace CONFIG fields."""
    import jax.numpy as jnp
    from compose_tpu import driver
    from compose_tpu.mesh import cubed_sphere
    from compose_tpu.transport import IslConfig, IslTransport, gallery

    mesh = cubed_sphere.build(ne, NP)
    cfg = IslConfig(ne=ne, np_=NP, **dict(CONFIG, **overrides))
    model = IslTransport(mesh, gallery.create_wind("divergent"), cfg)
    rho = jnp.ones((mesh.ncell, mesh.np2))
    q = driver.init_tracers(mesh, (ICS * -(-nt // len(ICS)))[:nt])
    return model, rho, q


def run_bench(nsteps_timed=10):
    import jax
    from compose_tpu.gpu import card_info

    model, rho, q = build()
    mesh = model.mesh
    t0 = time.perf_counter()
    r, qq = model.step(rho, q, 0.0, DT)
    qq.block_until_ready()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    r, qq = rho, q
    for i in range(nsteps_timed):
        r, qq = model.step(r, qq, i * DT, (i + 1) * DT)
    qq.block_until_ready()
    el = time.perf_counter() - t0

    dev = jax.devices()[0]
    dof_per_step = mesh.ncell * mesh.np2 * NT
    return {
        "metric": "tracer-DOF/s per chip (ne30, np4, 40 tracers, pisl+caas)",
        "value": dof_per_step * nsteps_timed / el,
        "unit": "DOF/s",
        "detail": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card_info(),
            "sec_per_step": el / nsteps_timed,
            "first_step_sec": compile_s,
            "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use"),
            "ncell": mesh.ncell, "np2": mesh.np2, "ntracer": NT,
        },
    }


def main():
    from compose_tpu.gpu import require_gpu
    require_gpu()
    print(json.dumps(run_bench()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

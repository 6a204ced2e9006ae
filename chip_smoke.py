"""Smoke test of the transport system on NVIDIA GPUs.

    python chip_smoke.py          # phases 1-6 on one card
    python chip_smoke.py --four   # only the four-card sharded path

Phases, all in this one process (the only child is nvidia-smi):

  1. device: JAX's default backend must be a GPU, else exit nonzero with
     no result line; print the card's name and power limit.
  2. flagship, bench config (ne30, np4, 40 tracers, f32 geometry and
     interpolation) through driver.run over the 12-day flow in 120 steps:
     the reference's per-step invariants (mass < 1e-12, bounds < 5e-13).
     Prints the step's compiled memory analysis, peak device memory and
     warm seconds per step - information only, nothing is claimed.
  3. flagship, f64 config: the same.
  4. one flagship f64 step on the GPU against the same step on the host's
     CPU backend, and f32 against f64 interpolation on the GPU.
  5. the reference goldens at ne10: ISL (pisl, qlt/mn2) and IR.
  6. determinism: two runs of one flagship ISL step and of one ne10 IR
     step are bitwise equal.

With --four the script runs only the four-card path: ShardedIsl over a
2-D face-tile layout at the flagship size against the single-card step in
the gather-DSS formulation (rho bitwise, q within TOL_FOUR_Q), then
sharded_ir.dryrun_ir.

Every phase asserts. A failed phase prints its traceback and the later
phases still run, but the script then exits nonzero with no result line.
On success the last line of stdout is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import sys
import time
import traceback

import numpy as np

FLAGSHIP_NE, FLAGSHIP_NT = 30, 40

# Phase 4 tolerances, as max |a - b| / max |b| over the field.
# GPU vs CPU, both f64. The two backends contract mul+add chains into FMAs
# differently, sum in other orders and use other elementwise math
# libraries; each costs ~1e-16 relative, and one step chains O(1e3)
# dependent operations. Continuous quantities (departure points, rho)
# therefore agree to 1e-12.
TOL_GPU_VS_CPU = 1e-12
# q is not continuous in those roundoff differences: a departure point
# within roundoff of a cell edge may land in either cell, and while the
# interpolant is continuous across the edge, the source-cell bounds the
# limiter enforces are not. On the CPU alone, perturbing the ne30 node
# positions by 1e-15 flips 47 of 48,602 departure cells and moves q by
# 4.8e-8. Allow 1e-6: 20x that, and still 70x below the f32-config step
# difference (TOL_F32_STEP), so f32 or TF32 arithmetic leaking into the
# f64 path fails.
TOL_GPU_VS_CPU_Q = 1e-6
# f32 vs f64 tracer interpolation (the einsum in IslTransport._interp) on
# the same departure weights: f32 values and weights carry ~6e-8 relative
# rounding, summed over 16 basis functions whose weights add up in
# magnitude to ~2 - about 2e-7. TF32 keeps 10 mantissa bits, ~5e-4. 1e-5
# is 50x from each: f32 passes, TF32 fails.
TOL_F32_INTERP = 1e-5
# The whole f32-config step against the f64 one is further apart: the
# departure Jacobian differences f32 node positions a cell width apart,
# which costs ~eps32 / h (measured 7e-5 at ne30 on the CPU backend, where
# there is no TF32). 1e-3 catches a gross f32 failure, not TF32.
TOL_F32_STEP = 1e-3


def log(msg):
    print(msg, flush=True)


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _maxulp(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.where(a == b, 0.0, np.abs(a - b) / scale)))


def _ics(nt):
    from bench import ICS
    return (ICS * -(-nt // len(ICS)))[:nt]


# -- phase 1 -----------------------------------------------------------------
def phase_device():
    """Exit nonzero unless JAX's default backend is a GPU; print what the
    card and JAX say of it."""
    import jax
    from compose_tpu.gpu import card_info, require_gpu
    dev = require_gpu()
    log(card_info())
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}")
    return dev


# -- phases 2 and 3 ----------------------------------------------------------
def phase_flagship(ne=FLAGSHIP_NE, nt=FLAGSHIP_NT, nsteps=120, dtype="f32",
                   ntimed=10):
    """driver.run over the bench schedule in the given geometry and
    interpolation precision; asserts the per-step invariants. Returns the
    bench-config model built for the step's memory analysis and timing."""
    import jax
    import bench
    from compose_tpu import driver
    from compose_tpu.gpu import card_info

    t0 = time.perf_counter()
    out = driver.run(ne=ne, np_=4, nsteps=nsteps, ics=_ics(nt),
                     filter_="caas", limiter="caas", nsub=8,
                     geom_dtype=dtype, interp_dtype=dtype, verbose=False)
    log(f"flagship {dtype}: ne{ne} nt{nt} {nsteps} steps in "
        f"{time.perf_counter() - t0:.1f} s: max step mass err "
        f"{out.max_step_mass_err:.3e}, max step bounds err "
        f"{out.max_step_bounds_err:.3e}, l2 {out.l2_err:.4e}, "
        f"cvgll {out.cv_gll:.3e}")
    assert out.max_step_mass_err < 1e-12, out.max_step_mass_err
    assert out.max_step_bounds_err < 5e-13, out.max_step_bounds_err
    assert np.isfinite(out.l2_err)

    model, rho, q = bench.build(ne, nt, geom_dtype=dtype, interp_dtype=dtype)
    dt = bench.T / nsteps
    tables = (model.F, model.mesh.jac_node)
    compiled = model._step.lower(rho, q, 0.0, dt,
                                 mesh_tables=tables).compile()
    log(f"flagship {dtype}: step memory analysis: "
        f"{compiled.memory_analysis()}")
    r, qq = model.step(rho, q, 0.0, dt)
    qq.block_until_ready()
    t0 = time.perf_counter()
    r, qq = rho, q
    for i in range(ntimed):
        r, qq = model.step(r, qq, i * dt, (i + 1) * dt)
    qq.block_until_ready()
    sec = (time.perf_counter() - t0) / ntimed
    stats = jax.devices()[0].memory_stats() or {}
    log(f"flagship {dtype}: warm {sec:.6f} s/step over {ntimed} steps, "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"[{card_info()}]")
    return model, rho, q


# -- phase 4 -----------------------------------------------------------------
def _one_step(ne, nt, device, dtype):
    """(model, q, departure points, departure cells, rho', q') of one
    bench step built and run on `device`."""
    import jax
    import bench
    with jax.default_device(device):
        model, rho, q = bench.build(ne, nt, geom_dtype=dtype,
                                    interp_dtype=dtype)
        dep, ci, _ = jax.jit(model._departure_data)(0.0, bench.DT)
        r, qq = model.step(rho, q, 0.0, bench.DT)
        return (model, q, np.asarray(dep), np.asarray(ci), np.asarray(r),
                np.asarray(qq))


def phase_gpu_vs_cpu(ne=FLAGSHIP_NE, nt=FLAGSHIP_NT):
    """One f64 step on the default device against the host CPU backend;
    then, on the default device, the f32 tracer interpolation against the
    f64 one on the same weights, and the f32-config step against f64."""
    import jax
    import jax.numpy as jnp
    import bench
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
    _, _, g_dep, g_ci, g_rho, g_q = _one_step(ne, nt, dev, "f64")
    _, _, c_dep, c_ci, c_rho, c_q = _one_step(ne, nt, cpu, "f64")
    d_dep = float(np.max(np.abs(g_dep - c_dep)))
    d_rho, d_q = _maxrel(g_rho, c_rho), _maxrel(g_q, c_q)
    log(f"{dev.platform} vs cpu, f64 step ne{ne} nt{nt}: departure points "
        f"max diff {d_dep:.3e}, departure cells differing "
        f"{int(np.sum(g_ci != c_ci))} of {g_ci.size}; max rel diff rho "
        f"{d_rho:.3e} (tol {TOL_GPU_VS_CPU:.0e}), q {d_q:.3e} (tol "
        f"{TOL_GPU_VS_CPU_Q:.0e}); max ulp rho {_maxulp(g_rho, c_rho):.3g}")
    assert d_dep <= TOL_GPU_VS_CPU and d_rho <= TOL_GPU_VS_CPU, (d_dep,
                                                                 d_rho)
    assert d_q <= TOL_GPU_VS_CPU_Q, d_q

    model, q, _, _, s_rho, s_q = _one_step(ne, nt, dev, "f32")
    _, ci, w = jax.jit(model._departure_data)(0.0, bench.DT)
    f32 = jnp.float32
    i32 = jax.jit(lambda q, ci, w: model._interp(q.astype(f32), ci,
                                                 w.astype(f32)))(q, ci, w)
    i64 = jax.jit(model._interp)(q, ci, w)
    d_i = _maxrel(i32.astype(jnp.float64), i64)
    log(f"{dev.platform} f32 vs f64 tracer interpolation ne{ne} nt{nt}: "
        f"max rel diff {d_i:.3e} (tol {TOL_F32_INTERP:.0e})")
    assert d_i <= TOL_F32_INTERP, d_i
    d_rho, d_q = _maxrel(s_rho, g_rho), _maxrel(s_q, g_q)
    log(f"{dev.platform} f32 vs f64 config, one step ne{ne} nt{nt}: max "
        f"rel diff rho {d_rho:.3e}, q {d_q:.3e} (tol {TOL_F32_STEP:.0e})")
    assert d_rho <= TOL_F32_STEP and d_q <= TOL_F32_STEP, (d_rho, d_q)


# -- phase 5 -----------------------------------------------------------------
# The reference's regression rows (slmm_runtests.py:115-116 and :188) with
# its own tolerances. The l2 and IR cv limits are those of the ne10 rows;
# at another ne only the size-independent checks apply.
GOLDENS = (
    ("isl pisl qlt/mn2",
     dict(ics=("slottedcylinders", "cosinebells", "gaussianhills"),
          filter_="qlt", limiter="mn2"),
     dict(l2=3.34e-1), dict(cv_gll=5e-14, bounds=(0.1, 1.0))),
    ("ir", dict(ics=("gaussianhills",), method="ir", filter_="none",
                limiter="none"),
     dict(l2=1.02e-2, cv=8e-15), {}),
)


def phase_goldens(ne=10):
    from compose_tpu import driver
    for name, kw, at_ne10, anywhere in GOLDENS:
        out = driver.run(ne=ne, np_=4, nsteps=12, verbose=False, **kw)
        log(f"golden {name} ne{ne}: l2 {out.l2_err:.6e} cv {out.cv:.3e} "
            f"cvgll {out.cv_gll:.3e} min {out.min_e:.6e} "
            f"max {out.max_e:.6e}")
        assert 0 < out.l2_err and np.isfinite(out.l2_err), name
        lim = dict(anywhere, **(at_ne10 if ne == 10 else {}))
        if "l2" in lim:
            assert out.l2_err <= lim["l2"], (name, out.l2_err)
        if "cv" in lim:
            assert out.cv <= lim["cv"], (name, out.cv)
        if "cv_gll" in lim:
            assert out.cv_gll <= lim["cv_gll"], (name, out.cv_gll)
            assert out.max_step_mass_err < 1e-12, name
            assert out.max_step_bounds_err < 5e-13, name
        if "bounds" in lim:
            lo, hi = lim["bounds"]
            assert lo <= out.min_e and out.max_e <= hi, name


# -- phase 6 -----------------------------------------------------------------
def phase_determinism(isl, ir_ne=10):
    """Two runs of one step must be bitwise equal: the flagship ISL step
    (`isl` = (model, rho, q)) and one IR step at `ir_ne`."""
    import jax
    import bench
    from compose_tpu import driver
    from compose_tpu.mesh import cubed_sphere
    from compose_tpu.transport import gallery
    from compose_tpu.transport.ir import IrConfig, IrTransport

    model, rho, q = isl
    a = [np.asarray(x) for x in model.step(rho, q, 0.0, bench.DT)]
    b = [np.asarray(x) for x in model.step(rho, q, 0.0, bench.DT)]
    isl_ok = all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"determinism isl ne{model.mesh.ne}: bitwise {isl_ok}")

    mesh = cubed_sphere.build(ir_ne, 4)
    ir = IrTransport(mesh, gallery.create_wind("divergent"),
                     IrConfig(ne=ir_ne, np_=4, method="ir", dmc="none",
                              filter="none", limiter="none"))
    rho = jax.numpy.ones((mesh.ncell, mesh.np2))
    q = driver.init_tracers(mesh, ("gaussianhills",))
    dt = bench.T / 12
    a = [np.asarray(x) for x in ir.step(rho, q, 0.0, dt)]
    b = [np.asarray(x) for x in ir.step(rho, q, 0.0, dt)]
    ir_ok = all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"determinism ir ne{ir_ne}: bitwise {ir_ok}"
        + ("" if ir_ok else f", max ulp {max(map(_maxulp, a, b)):.3g}"))
    assert isl_ok and ir_ok, (isl_ok, ir_ok)


# -- --four ------------------------------------------------------------------
# The sharded step must reproduce the single-card rho bitwise. For q, the
# bench configuration (f32 tracer interpolation) on the 2-D tile layout
# carries a residue of up to ~1e2 ulp (3e-15 absolute at ne8) through the
# cell-local limiter on XLA:CPU: it vanishes with strips, with f64
# interpolation, and with limiter='none'. Mass and bounds are enforced with
# the same arithmetic on both sides. Pin q at 1e-14 absolute (mixing ratios
# are O(1)) and report the ulp count.
TOL_FOUR_Q = 1e-14


def phase_four(ne=FLAGSHIP_NE, nt=FLAGSHIP_NT, n=4):
    """ShardedIsl over an n-card 2-D tile layout against the single-card
    step (gather-DSS formulation); then the sharded IR dryrun."""
    import jax
    import bench
    from compose_tpu.gpu import card_info
    from compose_tpu.parallel import cell_mesh
    from compose_tpu.parallel.halo import tile_owner
    from compose_tpu.parallel.sharded import ShardedIsl
    from compose_tpu.parallel.sharded_ir import dryrun_ir

    assert len(jax.devices()) >= n, f"needs {n} devices"
    model, rho, q = bench.build(ne, nt)
    mesh_dev = cell_mesh(n)
    sh = ShardedIsl(model, n, mesh_dev=mesh_dev,
                    owner=tile_owner(model.mesh, n))
    assert sh.coverage_ok(0.0, bench.DT), "halo does not cover the step"
    r4, q4 = sh.step(rho, q, 0.0, bench.DT)
    t0 = time.perf_counter()
    r4, q4 = sh.step(rho, q, 0.0, bench.DT)
    q4.block_until_ready()
    sec = time.perf_counter() - t0
    model.face_dss = None
    model._step = jax.jit(model._step_impl)
    r1, q1 = model.step(rho, q, 0.0, bench.DT)
    dq = float(np.max(np.abs(np.asarray(q4) - np.asarray(q1))))
    log(f"sharded isl ne{ne} nt{nt} on {n} x {jax.devices()[0].device_kind}"
        f" (tiles): vs single card max ulp rho {_maxulp(r4, r1):.3g}, q "
        f"{_maxulp(q4, q1):.3g} (q max abs {dq:.3e}, tol "
        f"{TOL_FOUR_Q:.0e}); warm {sec:.6f} s/step [{card_info()}]")
    assert np.array_equal(np.asarray(r4), np.asarray(r1)), "rho differs"
    assert dq <= TOL_FOUR_Q, dq
    dryrun_ir(n, mesh_dev)
    log(f"sharded ir dryrun on {n} devices: ok")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded path")
    a = p.parse_args(argv)
    t_start = time.perf_counter()
    dev = phase_device()
    import jax
    failed = []
    results = {}

    def run(name, fn, *args, **kw):
        """Run one phase; a failure is reported with its traceback and the
        later phases still run, but the script then exits nonzero."""
        t0 = time.perf_counter()
        try:
            results[name] = fn(*args, **kw)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            return
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")

    if a.four:
        run("four", phase_four)
    else:
        run("flagship f32", phase_flagship, dtype="f32")
        run("flagship f64", phase_flagship, dtype="f64")
        run("gpu vs cpu", phase_gpu_vs_cpu)
        run("goldens", phase_goldens)
        import bench
        isl = results.get("flagship f32") or bench.build()
        run("determinism", phase_determinism, isl)
    total = time.perf_counter() - t_start
    if failed:
        log(f"FAILED phases: {', '.join(failed)} ({total:.1f} s)")
        return 1
    log(f"all phases passed in {total:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

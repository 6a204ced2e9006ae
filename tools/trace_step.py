"""Where a warm bench-config ISL step spends its device time, plus the two
timings the DSS route and the IR determinism choice rest on. GPU only.

    python tools/trace_step.py [--out DIR] [--ir-ne 30]

1. Traces 5 warm steps of the bench configuration (bench.py) and charges
   each device kernel to the step phase named by the innermost
   jax.named_scope in its HLO metadata: departure, interp, rho_cdr, dss
   (IslTransport._step_impl). Unscoped kernels are the tracer CDR and
   cell-local limiter. Prints each phase's device ms/step, the bytes it
   must move (from shapes) and its share of the 3.35 TB/s HBM bound.
2. Times the two single-device DSS formulations on an ne30 x 40-tracer
   f64 field: FaceDss roll merges against the gather formulation
   (transport/dss.py).
3. Times one IR step (method ir, no filter, 40 tracers) and checks that
   two runs of it are bitwise equal.

The raw trace and a summary of its device events are written to --out.
"""

import argparse
import glob
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PHASES = ("departure", "interp", "rho_cdr", "dss")
REST = "tracer_cdr+limiter"


def _timeit(fn, *args, iters=20):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _key(name):
    """Kernel names spell HLO instruction names with '_' for '.' and '-'
    (fusion.12 runs as kernel fusion_12)."""
    return re.sub(r"[.\-]", "_", name.lstrip("%"))


def op_phases(hlo_text):
    """HLO instruction name (as _key) -> phase, from the innermost known
    scope in each instruction's op_name metadata."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        hits = [p for p in parts if p in PHASES]
        out[_key(m.group(1))] = hits[-1] if hits else REST
    return out


def device_events(trace_dir):
    """(name, hlo_op, hlo_module, start_ns, dur_ns) of every event on the
    GPU device planes, and the planes' names."""
    import jax
    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    pd = jax.profiler.ProfileData.from_file(path)
    evs, planes = [], []
    for plane in pd.planes:
        planes.append((plane.name, [ln.name for ln in plane.lines]))
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name == "XLA Ops"] or [
            ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines:
            for ev in line.events:
                st = dict(ev.stats)
                evs.append((ev.name, st.get("hlo_op", ev.name),
                            st.get("hlo_module", ""), ev.start_ns,
                            ev.duration_ns))
    return evs, planes


def trace_bench_step(out_dir, nsteps=5):
    import jax
    import bench
    from compose_tpu.gpu import card_info

    model, rho, q = bench.build()
    tables = (model.F, model.mesh.jac_node)
    hlo = model._step.lower(rho, q, 0.0, bench.DT,
                            mesh_tables=tables).compile().as_text()
    phase_of = op_phases(hlo)
    r, qq = model.step(rho, q, 0.0, bench.DT)
    jax.block_until_ready(qq)
    t0 = time.perf_counter()
    for i in range(nsteps):
        r, qq = model.step(r, qq, i * bench.DT, (i + 1) * bench.DT)
    jax.block_until_ready(qq)
    wall = (time.perf_counter() - t0) / nsteps
    tdir = os.path.join(out_dir, "trace")
    jax.profiler.start_trace(tdir)
    r, qq = rho, q
    for i in range(nsteps):
        r, qq = model.step(r, qq, i * bench.DT, (i + 1) * bench.DT)
    jax.block_until_ready(qq)
    jax.profiler.stop_trace()

    evs, planes = device_events(tdir)
    step_evs = [e for e in evs if "step_impl" in e[2]] or evs
    per = {p: 0.0 for p in PHASES + (REST,)}
    by_op = {}
    unmapped = 0.0
    for name, op, mod, t, d in step_evs:
        # Kernels inside a CUDA graph carry hlo_op 'command_buffer'; their
        # event name is the kernel's own.
        ph = phase_of.get(_key(name)) or phase_of.get(_key(op))
        if ph is None:
            unmapped += d
            ph = REST
        per[ph] += d
        by_op[name] = by_op.get(name, 0.0) + d
    iv = sorted((t, t + d) for _, _, _, t, d in step_evs)
    busy, end = 0.0, -1.0
    for a, b in iv:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = (iv[-1][1] - iv[0][0]) if iv else 0.0

    ne, nt = bench.NE, bench.NT
    ndgll = model.mesh.ncell * model.mesh.np2
    f64 = 8
    # Least bytes each phase must move through HBM (f64 unless noted):
    need = {
        # read q (f64, cast to f32 in the gather) + write q_tgt (f64).
        "interp": 2 * f64 * nt * ndgll,
        # dss_q reads q_new and writes q_out; the density DSS reads and
        # writes rho; dss_q reads rho for its weights.
        "dss": f64 * ndgll * (2 * nt + 3),
        # source q (masses, cell min/max), q_tgt and q_new out.
        REST: 3 * f64 * nt * ndgll,
    }
    card = card_info()
    print(f"bench step ne{ne} nt{nt}: wall {wall * 1e3:.3f} ms/step "
          f"(profiler off); traced window {window / 1e6 / nsteps:.3f} "
          f"ms/step, device busy {busy / 1e6 / nsteps:.3f} ms/step, idle "
          f"share {1 - busy / window if window else float('nan'):.3f} "
          f"[{card}]")
    for ph, ns in per.items():
        ms = ns / 1e6 / nsteps
        line = f"  {ph:20s} {ms:8.3f} ms/step device"
        if ph in need:
            bound = need[ph] / HBM_BYTES_PER_S
            line += (f", needs {need[ph] / 1e6:7.1f} MB -> HBM bound "
                     f"{bound * 1e3:.4f} ms, share {bound / (ms / 1e3):.3f}"
                     if ms > 0 else "")
        print(line)
    print(f"  (kernels with no HLO metadata match, charged to {REST}: "
          f"{unmapped / 1e6 / nsteps:.3f} ms/step)")
    with open(os.path.join(out_dir, "trace_summary.txt"), "w") as f:
        f.write(f"card: {card}\nplanes:\n")
        for name, lines in planes:
            f.write(f"  {name}: {lines}\n")
        f.write(f"{len(evs)} device events, {len(step_evs)} in the step\n")
        f.write("top ops by device time (ns over the window):\n")
        for op, d in sorted(by_op.items(), key=lambda x: -x[1])[:60]:
            f.write(f"  {d:12.0f}  {phase_of.get(_key(op), '?'):18s} {op}\n")
        f.write("sample events:\n")
        for e in evs[:20]:
            f.write(f"  {e}\n")


def time_dss(model, q):
    import jax
    import jax.numpy as jnp
    from compose_tpu.transport import dss

    m = model.mesh
    fd = model.face_dss
    rho = 1.0 + 0.1 * jnp.cos(jnp.arange(m.ncell * m.np2, dtype=jnp.float64)
                              ).reshape(m.ncell, m.np2)
    Ff = model.F.reshape(-1)
    roll = jax.jit(fd.dss_q)
    gather = jax.jit(lambda r, qq: dss.dss_q_gather_t(
        r.reshape(-1), qq.reshape(qq.shape[0], -1), model.d2c_map,
        m.c2d_idx, m.c2d_mask, Ff).reshape(qq.shape))
    a, b = np.asarray(roll(rho, q)), np.asarray(gather(rho, q))
    t_roll = _timeit(roll, rho, q)
    t_gather = _timeit(gather, rho, q)
    t_roll2 = _timeit(roll, rho, q)
    print(f"dss_q ne{m.ne} nt{q.shape[0]} f64: roll {t_roll * 1e3:.4f} / "
          f"{t_roll2 * 1e3:.4f} ms, gather {t_gather * 1e3:.4f} ms "
          f"(max |roll - gather| {np.max(np.abs(a - b)):.3e})")


def time_ir(ne, nt):
    import jax
    import bench
    from compose_tpu import driver
    from compose_tpu.mesh import cubed_sphere
    from compose_tpu.transport import gallery
    from compose_tpu.transport.ir import IrConfig, IrTransport

    mesh = cubed_sphere.build(ne, 4)
    ir = IrTransport(mesh, gallery.create_wind("divergent"),
                     IrConfig(ne=ne, np_=4, method="ir", dmc="none",
                              filter="none", limiter="none"))
    rho = jax.numpy.ones((mesh.ncell, mesh.np2))
    q = driver.init_tracers(mesh, (bench.ICS * nt)[:nt])
    t0 = time.perf_counter()
    a = [np.asarray(x) for x in ir.step(rho, q, 0.0, bench.DT)]
    first = time.perf_counter() - t0
    sec = _timeit(lambda: ir.step(rho, q, 0.0, bench.DT), iters=5)
    b = [np.asarray(x) for x in ir.step(rho, q, 0.0, bench.DT)]
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"ir step ne{ne} nt{nt}: first {first:.1f} s, warm "
          f"{sec * 1e3:.3f} ms/step, run-to-run bitwise {same} "
          f"(XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r})")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out")
    p.add_argument("--ir-ne", type=int, default=30)
    a = p.parse_args()
    import jax
    from compose_tpu.gpu import require_gpu
    # Compile afresh: the persistent cache's key ignores metadata, so a
    # cached executable can carry stale named-scope paths.
    jax.config.update("jax_enable_compilation_cache", False)
    require_gpu()
    os.makedirs(a.out, exist_ok=True)
    import bench
    trace_bench_step(a.out)
    dmodel, _, q64 = bench.build(geom_dtype="f64", interp_dtype="f64")
    time_dss(dmodel, q64)
    time_ir(a.ir_ne, 40)
    return 0


if __name__ == "__main__":
    sys.exit(main())

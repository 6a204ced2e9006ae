"""chip_smoke.py and bench.py: their phases rehearsed at a tiny size on the
CPU, their refusal to run without a GPU, and the process-wide settings they
rely on (compile-cache location, f32 contraction precision). Tests marked
`gpu` run the real-size phases and skip unless JAX has a GPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(code_or_script, env_extra=None, timeout=180):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    args = ([sys.executable, code_or_script]
            if code_or_script.endswith(".py")
            else [sys.executable, "-c", code_or_script])
    return subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    """A measurement that finds no card fails fast and prints no result."""
    r = _run(os.path.join(ROOT, script), timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "DOF/s" not in r.stdout
    assert "no GPU" in r.stderr


def test_compile_cache_dir():
    code = ("import compose_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(ROOT, ".jax_cache")
    r = _run(code, {"JAX_COMPILATION_CACHE_DIR": "/nonexistent/cache"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "/nonexistent/cache"


def test_f32_contraction_precision_pinned():
    """f32 contractions lower at HIGHEST precision, so a GPU cannot run
    them in TF32; f64 is always on."""
    assert jax.config.jax_enable_x64
    assert jax.config.jax_default_matmul_precision == "highest"
    a = jnp.ones((3, 16), jnp.float32)
    txt = jax.jit(lambda a, b: jnp.einsum('...cx,cx->...c', a, b)).lower(
        a, a).as_text()
    assert "HIGHEST" in txt, txt


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_flagship_phase_rehearsal(dtype):
    model, rho, q = chip_smoke.phase_flagship(ne=4, nt=4, nsteps=3,
                                              dtype=dtype, ntimed=1)
    assert q.shape == (4, model.mesh.ncell, 16)
    assert model.config.geom_dtype == dtype


def test_gpu_vs_cpu_phase_rehearsal(capsys):
    chip_smoke.phase_gpu_vs_cpu(ne=4, nt=4)
    out = capsys.readouterr().out
    # On the CPU both sides are the same backend: bitwise.
    assert "departure cells differing 0 of" in out
    assert "max rel diff rho 0.000e+00 (tol 1e-12), q 0.000e+00" in out


def test_goldens_phase_rehearsal(capsys):
    chip_smoke.phase_goldens(ne=4)
    out = capsys.readouterr().out
    assert out.count("golden ") == len(chip_smoke.GOLDENS)


def test_determinism_phase_rehearsal(capsys):
    chip_smoke.phase_determinism(bench.build(4, 4), ir_ne=4)
    out = capsys.readouterr().out
    assert "determinism isl ne4: bitwise True" in out
    assert "determinism ir ne4: bitwise True" in out


def test_bench_build_tiles_ics():
    model, rho, q = bench.build(4, 6)
    assert q.shape == (6, model.mesh.ncell, 16)
    # ICs cycle through bench.ICS.
    assert np.array_equal(np.asarray(q[4]), np.asarray(q[0]))
    assert model.config.interp_dtype == "f32"


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """The smoke phases at their real sizes, on the card."""
    isl = chip_smoke.phase_flagship(dtype="f32")
    chip_smoke.phase_gpu_vs_cpu()
    chip_smoke.phase_goldens()
    chip_smoke.phase_determinism(isl)


@pytest.mark.gpu
def test_bench_on_gpu(gpu):
    out = bench.run_bench(nsteps_timed=2)
    assert out["detail"]["platform"] == "gpu"
    assert out["value"] > 0
    json.dumps(out)


def test_four_phase_rehearsal(capsys):
    """The --four path on 4 of the virtual CPU devices at ne6."""
    chip_smoke.phase_four(ne=6, nt=4)
    assert "sharded ir dryrun on 4 devices: ok" in capsys.readouterr().out

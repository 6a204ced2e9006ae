"""Global configuration for compose_tpu.

The reference (E3SM-Project/COMPOSE) enforces mass conservation to ~1e-13 and
bounds to a few ulp (see /root/reference/methods/slmm/slmmir.cpp:955-957 and
cedr/cedr_test_randomized.cpp:293-418), which requires float64 arithmetic.
JAX defaults to float32, so x64 must be enabled before any array is created.
Importing this module (which `compose_tpu/__init__.py` does first) takes care
of it.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# The optional f32 geometry/interpolation paths (IslConfig.geom_dtype,
# interp_dtype) contract in float32. On a GPU, XLA's default precision may
# run such contractions in TF32 (~3 decimal digits) instead of full f32
# (~7); pin full precision so f32 means f32 on every backend. f64
# contractions are unaffected.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: XLA compile times dominate small-problem
# startup. JAX reads JAX_COMPILATION_CACHE_DIR itself; without it, cache at
# a fixed path in the checkout (a path that moves never hits).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

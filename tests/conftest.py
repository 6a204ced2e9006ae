import os

import pytest

# Tests default to the CPU backend with 8 virtual devices, so the sharding
# paths run without a multi-card host. An explicitly set JAX_PLATFORMS wins:
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the card tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import compose_tpu  # noqa: E402,F401  - enables x64 before any jax use


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided when the test
    runs, never at import, so every pytest worker collects the same tests."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]

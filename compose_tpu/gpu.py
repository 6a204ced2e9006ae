"""The GPU a measurement runs on: the check that JAX has one, and the card's
name and power limit as nvidia-smi reports them.

A number measured on the card is only comparable beside the card's power
limit (a card set below its maximum runs slower under load), so every
script that measures prints `card_info()` next to its numbers.
"""

import subprocess
import sys


def require_gpu():
    """Return the first JAX device if JAX's default backend is a GPU;
    otherwise print why to stderr and exit with status 2. A measurement
    that finds no card fails: it never falls back to the CPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        sys.stderr.write(f"error: JAX found no GPU (default backend: "
                         f"{backend}); this needs an NVIDIA GPU\n")
        sys.exit(2)
    return jax.devices()[0]


def card_info():
    """`name, power.limit` of the card(s), as nvidia-smi prints them, one
    line per card. Read by a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip()

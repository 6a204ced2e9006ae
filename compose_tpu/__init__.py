"""compose_tpu: a JAX semi-Lagrangian tracer-transport core.

A from-scratch JAX/XLA re-design of the capabilities of
E3SM-Project/COMPOSE (CEDR property preservation, SIQK sphere kernels, and
the slmmir semi-Lagrangian transport driver), built for accelerators: dense
fixed-shape arrays over cubed-sphere cells, batched local solvers, masked
fixed-trip Newton loops, deterministic fixed-tree reductions, and
`jax.sharding` collectives for multi-chip runs.
"""

from . import config  # noqa: F401  - must run first: enables float64

__version__ = "0.1.0"

"""Multi-chip sharding for the transport step.

The scale axes of this framework are mesh cells x tracers (SURVEY.md §2.5):
cells are the sharded (data-parallel) axis over the device mesh; tracers
and the np^2 DOFs stay dense per chip (exactly the reference's bulk-buffer
vectorization, cedr_qlt.hpp:44-127). We annotate shardings with
`jax.sharding.NamedSharding` and jit the SAME single-chip step function -
GSPMD inserts the collectives (all-gathers for remote departure-cell reads,
psums inside CAAS when axis-mapped). The semi-Lagrangian departure gather
has a CFL-bounded halo (slmmir_remapper.cpp:7), so later rounds can replace
the all-gather with `ppermute` halo exchange; the sharding annotations stay
the same.
"""

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def cell_mesh(n_devices: int = None, devices=None) -> Mesh:
    """1-D device mesh over the 'cells' axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices, ("cells",))


def shard_state(mesh: Mesh, rho, q):
    """Place rho (ncell, np2) and q (nt, ncell, np2) with cells sharded."""
    s_rho = NamedSharding(mesh, P("cells", None))
    s_q = NamedSharding(mesh, P(None, "cells", None))
    return jax.device_put(rho, s_rho), jax.device_put(q, s_q)


def sharded_step(model, mesh: Mesh):
    """Jit the model's step with cell-sharded inputs/outputs. The step closes
    over replicated mesh arrays; GSPMD partitions the per-cell compute and
    inserts collectives for the cross-cell pieces (departure gathers, DSS
    scatter, global reductions)."""
    s_rho = NamedSharding(mesh, P("cells", None))
    s_q = NamedSharding(mesh, P(None, "cells", None))
    s_scalar = NamedSharding(mesh, P())
    return jax.jit(
        model._step_impl,
        in_shardings=(s_rho, s_q, s_scalar, s_scalar),
        out_shardings=(s_rho, s_q))

"""CAAS: clip-and-assured-sum constrained density reconstructor.

Counterpart of /root/reference/cedr/cedr_caas.{hpp,cpp,_inl.hpp}. The
algorithm compresses the global problem to 4 scalars per tracer (clip sum,
mass-target sum, min sum, max sum), allreduces them, then distributes the
mass surplus/deficit proportionally to the remaining headroom. Here it is a
pure function over dense (nt, ncell) arrays; the reduction is either a
deterministic fixed-tree sum (single chip / BFB contract) or `psum` over a
mesh axis (multi-chip; psum is deterministic for a fixed topology, and
the local pre-reduction uses the same fixed tree, reproducing the
UserAllReducer n_accum_in_place contract, cedr_caas.hpp:27-49).
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.reduce import bfb_sum


@partial(jax.jit, static_argnames=("axis_name",))
def run(Qm, Qm_min, Qm_max, Qm_prev=None, axis_name=None):
    """One CAAS solve (cedr_caas.cpp:129-270).

    Qm, Qm_min, Qm_max, Qm_prev: (nt, nlclcells). If `Qm_prev` is given, the
    mass target is sum(Qm_prev) (the 'conserve' problem type); otherwise
    sum(Qm). If `axis_name` is set, sums are completed with a psum over that
    mapped mesh axis (shard_map/pmap context).

    Returns the reconstructed Qm with: global mass == target, local bounds
    respected (up to roundoff), no change when the input is already feasible.
    """
    Qm_clip = jnp.clip(Qm, Qm_min, Qm_max)
    Qm_term = Qm if Qm_prev is None else Qm_prev

    def gsum(x):
        s = bfb_sum(x, axis=-1)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
        return s

    clip_sum = gsum(Qm_clip)
    term_sum = gsum(Qm_term)
    min_sum = gsum(Qm_min)
    max_sum = gsum(Qm_max)

    m = term_sum - clip_sum                                   # (nt,)
    # m < 0: remove mass toward Qm_min; m > 0: add toward Qm_max
    # (cedr_caas.cpp:211-253, finish_locally).
    fac_dn = clip_sum - min_sum
    fac_up = max_sum - clip_sum
    up = m > 0
    fac = jnp.where(up, fac_up, fac_dn)
    ok = fac > 0
    scale = jnp.where(ok, m / jnp.where(ok, fac, 1.0), 0.0)   # (nt,)
    dirn = jnp.where(up[:, None], Qm_max - Qm_clip, Qm_clip - Qm_min)
    out = Qm_clip + scale[:, None] * dirn
    # Final safety clip (the reference clips with min/max against the moved
    # bound inside the adjust lambdas).
    out = jnp.where(up[:, None], jnp.minimum(out, Qm_max),
                    jnp.maximum(out, Qm_min))
    return jnp.where((m == 0)[:, None], Qm_clip, out)

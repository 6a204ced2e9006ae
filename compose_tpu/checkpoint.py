"""Checkpoint / resume for transport runs.

The reference has no checkpointing (SURVEY.md §5: closest is a binary state
dump, slmmir.cpp:245-268); for a production framework we add it as new
design. State is the minimal restart tuple (step index, time, rho, q) plus
the run configuration needed to validate compatibility. Uses orbax when
available (sharded-array friendly), with a plain npz fallback.
"""

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp

try:
    import orbax.checkpoint as ocp
    HAVE_ORBAX = True
except Exception:  # pragma: no cover
    HAVE_ORBAX = False


def save(path, step, t, rho, q, meta=None):
    """Write a checkpoint directory/file at `path`."""
    meta = dict(meta or {})
    meta.update(step=int(step), t=float(t))
    if HAVE_ORBAX:
        path = os.path.abspath(path)
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, {"rho": rho, "q": q}, force=True)
        ckptr.wait_until_finished()
        with open(os.path.join(path, "compose_meta.json"), "w") as f:
            json.dump(meta, f)
    else:
        np.savez(path, rho=np.asarray(rho), q=np.asarray(q),
                 meta=json.dumps(meta))


def restore(path):
    """Read a checkpoint; returns (step, t, rho, q, meta)."""
    if HAVE_ORBAX and os.path.isdir(path):
        path = os.path.abspath(path)
        ckptr = ocp.StandardCheckpointer()
        with open(os.path.join(path, "compose_meta.json")) as f:
            meta = json.load(f)
        out = ckptr.restore(path)
        rho, q = jnp.asarray(out["rho"]), jnp.asarray(out["q"])
    else:
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        d = np.load(path, allow_pickle=False)
        meta = json.loads(str(d["meta"]))
        rho, q = jnp.asarray(d["rho"]), jnp.asarray(d["q"])
    return meta["step"], meta["t"], rho, q, meta

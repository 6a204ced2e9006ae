"""Face-grid DSS via flat lane-rolls: O(1) structured shifts, no gathers.

The reference's D2Cer (methods/slmm/slmmir_d2c.{hpp,cpp}) loops a CSR map
over continuous nodes. The gather formulation in transport/dss.py avoids
scatters but still issues one gather row per (continuous node x <=4
coincident slots).

This module exploits the cubed-sphere structure instead: cells are numbered
(face, cy, cx) row-major and nodes (j, i) within a cell, so in the FLAT
DGLL numbering s = (((f*ne + cy)*ne + cx)*np + j)*np + i almost every
coincidence is a fixed-offset neighbor:

  - x-pairs: slot (j, i=np-1) of (cy, cx) and (j, i=0) of (cy, cx+1)
    differ by dx = np^2 - (np-1);
  - y-pairs: slot (np-1, i) of (cy, cx) and (0, i) of (cy+1, cx)
    differ by dy = ne*np^2 - (np-1)*np.

So each merge pass is `a + mask * roll(a, +-d)` on the fully tile-packed
(rows, ndgll) layout - contiguous lane shifts, zero padding waste, no
transposes. Corner nodes compose through the x-then-y pass order exactly as
a tensor product, giving the full 4-way coincident sums/mins/maxes. The
only nodes the passes miss are on CUBE edges (two or three faces meet,
~12*ne*(np-1) of them); those are fixed afterwards with the exact gather
formula over their <=4 coincident slots.

The construction is validated structurally at build time (union-find over
the pass-merged pairs vs. the mesh's d2c map), so any mesh whose numbering
deviates (e.g. subcell meshes) is rejected and the caller falls back to the
gather path. Results are deterministic (fixed pass order) and agree with
dss.py to roundoff (summation order within a coincident set differs).
"""

import numpy as np

import jax.numpy as jnp


def _decode_slots(ne, np_):
    """Flat DGLL slot -> (face, cy, cx, j, i)."""
    ncell = 6 * ne * ne
    np2 = np_ * np_
    s = np.arange(ncell * np2)
    c, k = s // np2, s % np2
    f, r = c // (ne * ne), c % (ne * ne)
    cy, cx = r // ne, r % ne
    j, i = k // np_, k % np_
    return f, cy, cx, j, i


class FaceDss:
    """Precomputed face-grid DSS for a standard cubed-sphere mesh.

    build() returns None when the mesh numbering is not the standard
    (face, cy, cx, j, i) row-major layout (validated, not assumed).
    """

    def __init__(self, ne, np_, d2c_map_np, c2d_idx_np, c2d_mask_np, F):
        self.ne, self.np_ = ne, np_
        ncell, np2 = 6 * ne * ne, np_ * np_
        ndgll = ncell * np2
        f, cy, cx, j, i = _decode_slots(ne, np_)
        on_perim = (((cx == 0) & (i == 0)) | ((cx == ne - 1) & (i == np_ - 1))
                    | ((cy == 0) & (j == 0))
                    | ((cy == ne - 1) & (j == np_ - 1)))
        # Continuous nodes needing the exact-gather fix: any slot on a face
        # perimeter (cube-edge nodes; also catches ne==1 degenerate cases).
        slot_node = d2c_map_np
        fix_nodes = np.unique(slot_node[on_perim])
        self.fix_idx = jnp.asarray(c2d_idx_np[fix_nodes])       # (nfix, 4)
        self.fix_mask = jnp.asarray(c2d_mask_np[fix_nodes])     # (nfix, 4)
        # Scatter targets: every valid slot of each fix node; masked lanes
        # scatter out of bounds and are dropped.
        tgt = np.where(c2d_mask_np[fix_nodes], c2d_idx_np[fix_nodes], ndgll)
        self.fix_tgt = jnp.asarray(tgt)                         # (nfix, 4)
        self.ndgll = ndgll
        self.shape5 = (6, ne, ne, np_, np_)
        self.F = F                                              # (ncell, np2)
        # Roll-merge structure: offsets and edge masks (row vectors).
        self.dx = np2 - (np_ - 1)
        self.dy = ne * np2 - (np_ - 1) * np_
        mxl = ((i == np_ - 1) & (cx < ne - 1))[None]
        mxr = ((i == 0) & (cx > 0))[None]
        myd = ((j == np_ - 1) & (cy < ne - 1))[None]
        myu = ((j == 0) & (cy > 0))[None]
        self._bmasks = tuple(jnp.asarray(m) for m in (mxl, mxr, myd, myu))
        # den0 (sum of static weights over coincident slots) is static.
        Fm = self._merge_np(np.asarray(F).reshape(-1))
        self.den0 = jnp.asarray(Fm)

    # -- structural validation + factory ---------------------------------
    @staticmethod
    def build(mesh, F=None):
        """Return a FaceDss for `mesh`, or None if the numbering does not
        match the standard face-grid layout.

        F: the dgbfi weights defining the DSS average - MUST be the same
        measure the caller's CDR conserves (d2c with weights w conserves
        sum(w * field) and nothing else, slmmir_d2c.cpp:60-84). Defaults to
        the Homme/GLL weights (-dmc f/eh); pass mesh.dgbfi_sphere for a
        sphere-measure (-dmc es) pipeline."""
        ne, np_ = mesh.ne, mesh.np_
        if 6 * ne * ne != mesh.ncell:
            return None
        d2c = np.asarray(mesh.dgll2cgll).reshape(-1)
        c2d_idx = np.asarray(mesh.c2d_idx)
        c2d_mask = np.asarray(mesh.c2d_mask)
        if not FaceDss._validate(ne, np_, d2c, c2d_idx, c2d_mask):
            return None
        return FaceDss(ne, np_, d2c, c2d_idx, c2d_mask,
                       mesh.dgbfi_gll if F is None else F)

    @staticmethod
    def _validate(ne, np_, d2c_map, c2d_idx, c2d_mask):
        """Union-find over the pairs the passes merge (+ fix-node groups)
        must reproduce the mesh's coincidence classes exactly."""
        ncell, np2 = 6 * ne * ne, np_ * np_
        ndgll = ncell * np2
        f, cy, cx, j, i = _decode_slots(ne, np_)

        def flat(f_, cy_, cx_, j_, i_):
            return (((f_ * ne + cy_) * ne + cx_) * np_ + j_) * np_ + i_

        parent = np.arange(ndgll)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        F, CY, CX, J = np.meshgrid(np.arange(6), np.arange(ne),
                                   np.arange(ne - 1), np.arange(np_),
                                   indexing="ij")
        L = flat(F, CY, CX, J, np_ - 1).ravel()
        R = flat(F, CY, CX + 1, J, 0).ravel()
        for a, b in zip(L, R):
            union(a, b)
        F, CY, CX, I = np.meshgrid(np.arange(6), np.arange(ne - 1),
                                   np.arange(ne), np.arange(np_),
                                   indexing="ij")
        D = flat(F, CY, CX, np_ - 1, I).ravel()
        U = flat(F, CY + 1, CX, 0, I).ravel()
        for a, b in zip(D, U):
            union(a, b)
        on_perim = (((cx == 0) & (i == 0)) | ((cx == ne - 1) & (i == np_ - 1))
                    | ((cy == 0) & (j == 0))
                    | ((cy == ne - 1) & (j == np_ - 1)))
        fix_nodes = np.unique(d2c_map[on_perim])
        for node in fix_nodes:
            slots = c2d_idx[node][c2d_mask[node]]
            for b in slots[1:]:
                union(slots[0], b)
        roots = np.array([find(a) for a in range(ndgll)])
        # Pass-derived classes must equal the mesh's coincidence classes.
        _, class_a = np.unique(roots, return_inverse=True)
        _, class_b = np.unique(d2c_map, return_inverse=True)
        # Same partition <=> the pairing (class_a, class_b) is a bijection.
        pairs = class_a.astype(np.int64) * (class_b.max() + 1) + class_b
        return bool(np.unique(pairs).size == np.unique(class_a).size
                    == np.unique(class_b).size)

    # -- merge passes ------------------------------------------------------
    def _merge_add(self, a):
        """Sum-merge the intra-face coincident slots of (rows, ndgll) `a`
        (cube-edge nodes are finished by the fix pass). Masked neighbors
        enter via `where` selects, not mask multiplies, so no neighbor's
        non-finite value can leak into a slot it does not touch."""
        bxl, bxr, byd, byu = self._bmasks
        dx, dy = self.dx, self.dy
        z = jnp.zeros((), a.dtype)
        xm = (a + jnp.where(bxl, jnp.roll(a, -dx, -1), z)
              + jnp.where(bxr, jnp.roll(a, dx, -1), z))
        return (xm + jnp.where(byd, jnp.roll(xm, -dy, -1), z)
                + jnp.where(byu, jnp.roll(xm, dy, -1), z))

    def _merge_op(self, a, op):
        """min/max-merge of (rows, ndgll) `a`."""
        bxl, bxr, byd, byu = self._bmasks
        dx, dy = self.dx, self.dy
        xm = jnp.where(bxl, op(a, jnp.roll(a, -dx, -1)), a)
        xm = jnp.where(bxr, op(xm, jnp.roll(a, dx, -1)), xm)
        ym = jnp.where(byd, op(xm, jnp.roll(xm, -dy, -1)), xm)
        return jnp.where(byu, op(ym, jnp.roll(xm, dy, -1)), ym)

    def _merge_np(self, flat):
        """Numpy sum-merge of a static (ndgll,) array (for den0)."""
        a = flat.reshape(self.shape5).copy()
        c = a[:, :, :-1, :, -1] + a[:, :, 1:, :, 0]
        a[:, :, :-1, :, -1] = c
        a[:, :, 1:, :, 0] = c
        c = a[:, :-1, :, -1, :] + a[:, 1:, :, 0, :]
        a[:, :-1, :, -1, :] = c
        a[:, 1:, :, 0, :] = c
        return a.reshape(flat.shape)

    # -- cube-edge fix pass (exact <=4-slot formula; XLA) ------------------
    def _fix_q(self, cg, qf, wff, Ff):
        """Overwrite the cube-edge nodes of cg (nt, ndgll) with the exact
        weighted average over their coincident slots of qf; weights wff
        with Ff fallback at zero mass."""
        nt = qf.shape[0]
        qT = jnp.moveaxis(qf, 0, -1)                  # (ndgll, nt)
        vals = qT[self.fix_idx]                       # (nfix, 4, nt)
        wfix = jnp.where(self.fix_mask, wff[self.fix_idx], 0.0)[..., None]
        w0fix = jnp.where(self.fix_mask, Ff[self.fix_idx], 0.0)[..., None]
        numf = jnp.sum(wfix * vals, axis=1)
        denf = jnp.sum(wfix, axis=1)
        num0f = jnp.sum(w0fix * vals, axis=1)
        den0f = jnp.sum(w0fix, axis=1)
        okf = denf > 0
        cgf = jnp.where(okf, numf / jnp.where(okf, denf, 1.0), num0f / den0f)
        mkf = self.fix_mask[..., None]
        cgf = jnp.clip(cgf,
                       jnp.min(jnp.where(mkf, vals, jnp.inf), axis=1),
                       jnp.max(jnp.where(mkf, vals, -jnp.inf), axis=1))
        outT = jnp.moveaxis(cg, 0, -1)
        upd = jnp.broadcast_to(cgf[:, None], (cgf.shape[0], 4, nt))
        outT = outT.at[self.fix_tgt.reshape(-1)].set(
            upd.reshape(-1, nt).astype(cg.dtype), mode="drop")
        return jnp.moveaxis(outT, 0, -1)

    # -- public ops --------------------------------------------------------
    def dss(self, field, clip_minmax=True):
        """DSS a (..., ncell, np2) field with the static dgbfi weights
        (dss.dss_gather equivalent; returns the same shape)."""
        lead = field.shape[:-2]
        vf = field.reshape((-1, self.ndgll)) if lead else \
            field.reshape(1, self.ndgll)
        nt = vf.shape[0]
        Ff = self.F.reshape(-1).astype(vf.dtype)
        num = self._merge_add(Ff[None] * vf)
        cg = num / self.den0[None].astype(vf.dtype)
        if clip_minmax:
            mn = self._merge_op(vf, jnp.minimum)
            mx = self._merge_op(vf, jnp.maximum)
            cg = jnp.clip(cg, mn, mx)
            out = self._fix_q(cg, vf, Ff, Ff)
        else:
            # Unclipped variant: exact weighted average on fix nodes too.
            qT = jnp.moveaxis(vf, 0, -1)
            vals = qT[self.fix_idx]
            w0 = jnp.where(self.fix_mask, Ff[self.fix_idx], 0.0)[..., None]
            cgf = jnp.sum(w0 * vals, axis=1) / jnp.sum(w0, axis=1)
            outT = jnp.moveaxis(cg, 0, -1)
            upd = jnp.broadcast_to(cgf[:, None], vals.shape)
            outT = outT.at[self.fix_tgt.reshape(-1)].set(
                upd.reshape(-1, nt).astype(cg.dtype), mode="drop")
            out = jnp.moveaxis(outT, 0, -1)
        return out.reshape(field.shape)

    def dss_q(self, rho, q):
        """Mixing-ratio DSS (dss.dss_q_gather_t equivalent).

        rho: (ncell, np2); q: (nt, ncell, np2). Weights are dgbfi*rho with
        the dgbfi-only fallback at zero-mass nodes, clipped to the
        coincident-node range (slmmir_d2c.cpp:91-115)."""
        nt = q.shape[0]
        qf = q.reshape(nt, -1)
        wf = (self.F * rho).reshape(1, -1).astype(qf.dtype)
        Ff = self.F.reshape(-1).astype(qf.dtype)
        # Two-stage weights: merge w once to find zero-mass nodes, then
        # blend per-slot (coincident slots share their node's den, so den>0
        # nodes get EXACTLY the w-weighted average while den==0 nodes get
        # the dgbfi fallback) - no extra nt `num0` merge rows for the
        # fallback. One reciprocal replaces the nt per-tracer divides.
        den = self._merge_add(wf)
        w2 = jnp.where(den > 0, wf, Ff[None])
        addm = self._merge_add(jnp.concatenate([w2 * qf, w2], axis=0))
        num, den2 = addm[:nt], addm[nt]
        ming = jnp.concatenate([qf, -qf], axis=0)
        minm = self._merge_op(ming, jnp.minimum)
        mn, mx = minm[:nt], -minm[nt:]
        cg = num * (1.0 / den2)[None]
        cg = jnp.clip(cg, mn, mx)
        out = self._fix_q(cg, qf, wf[0], Ff)
        return out.reshape(q.shape)

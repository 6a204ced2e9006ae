"""Cell-sharded IR/CDG (cell-integrated remap) transport step.

The round-3 review's top structural gap: the whole cell-integrated method
ran single-chip only. This module re-expresses IrTransport._step_impl as a
shard_map program over the 1-D 'cells' device mesh, following the
reference's domain-decomposed remap structure
(/root/reference/methods/slmm/slmmir_remapper.cpp:7,65-151 - the 2-ring
candidate pattern is already halo-shaped):

  - the (rho, q) SOURCE state moves via the neighbor-wise ppermute halo
    exchange (parallel/halo.py; one message per shard pair, matching
    cedr_tree.cpp:185-213);
  - geometry is static, so advected vertices are RECOMPUTED per shard for
    the local+halo cells (elementwise trajectory integration: identical
    inputs give identical bits; no geometry communication);
  - every shard assembles T blocks for ALL pairs whose source it knows
    (local + halo cells), keeps contributions whose target is local, and
    enumerates pairs in GLOBAL (src, cand) order via a static permutation
    of the halo layout - so each target's segment-sum accumulates its
    contributions in exactly the single-chip order (bitwise-equal
    ordered segment sums, transport/ir.segment_sum_ordered; the per-pair
    quadrature runs through the SAME fixed-chunk _assemble_T and the
    explicitly-associated contraction helpers of transport/ir.py);
  - per-source column sums (p_s_ol normalization, facet FsmoFtm) are
    complete on the assembling shard: a source's full candidate ring lies
    within the halo when depth >= CFL rings + 2 (coverage_ok checks the
    actual pair set per step size);
  - the global CDR reuses the sharded CAAS gsum / sharded QLT level
    schedule; the DSS runs the gather formulation on local blocks with a
    ring-1 exchange.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..cdr.bfb import get_reducer
from ..cdr.qlt_sharded import ShardedQLT
from ..cdr import qlt as qlt_mod
from ..mesh import cubed_sphere
from ..ops import sphere
from ..transport import limiter as limiter_mod, spf, timeint
from ..transport.ir import (apply_T_contrib, dot_last, mass_target_terms,
                            mass_solve_blk, segment_sum_ordered,
                            solve_1eq_ls_blk)
from .halo import HaloMaps, halo_exchange
from .sharding import cell_mesh


class ShardedIr:
    """Cell-sharded IrTransport step. Supported: method ir/cdg, dmc in
    {none, es, eh, f, ef}, filter in {none, caas, qlt}, any cell-local
    limiter, d2c on/off, uniform meshes. (mn2 redistributes through one
    global n-dim QP and dmc=geh needs the global-equality solve; both
    stay single-chip for now, like ShardedIsl's exclusions.)"""

    def __init__(self, model, n_shards: int, depth: int = 4, mesh_dev=None,
                 owner=None):
        cfg = model.config
        m = model.mesh
        assert cfg.filter in ("none", "caas", "qlt"), cfg.filter
        assert cfg.dmc != "geh", "dmc=geh: single-chip path"
        assert not m.nonuni, "nonuniform meshes: single-chip path"
        self.model = model
        self.cfg = cfg
        self.m = m
        self.n_shards = n_shards
        # Decomposition: contiguous blocks by default (ragged when ncell %
        # n_shards != 0 - the last shard carries inert pad cells: zero
        # weights, duplicate-id ext slots masked by src_real, outputs
        # sliced), or an explicit owner map (halo.tile_owner 2-D tiles).
        self.maps = HaloMaps(m, n_shards, depth, owner=owner)
        self.B = B = self.maps.block
        self.pad = self.maps.ncell_pad - m.ncell
        self.mesh_dev = mesh_dev if mesh_dev is not None \
            else cell_mesh(n_shards)
        mp = self.maps
        self._perm_flat = mp.perm.reshape(-1)
        self._padmask = (np.arange(B)[None]
                         >= mp.leaf_count[:, None]).reshape(-1)
        self._inv_idx = jnp.asarray(mp.owner * B + mp.leaf_slot)
        self.owner_j = jnp.asarray(mp.owner.astype(np.int32))
        self.leafslot_j = jnp.asarray(mp.leaf_slot.astype(np.int32))
        if mp.contiguous:
            self.r_cells = get_reducer(m.ncell, n_shards, block=B)
        else:
            from ..cdr.bfb import BfbTreeAllReducer
            self.r_cells = BfbTreeAllReducer(m.ncell, n_shards, block=B,
                                             leaf_lists=mp.leaf_lists)
        if cfg.filter == "qlt":
            self.sqlt = ShardedQLT(m.ncell, n_shards,
                                   problem_type=qlt_mod.SHAPEPRESERVE,
                                   owner=None if mp.contiguous
                                   else mp.owner)
        else:
            self.sqlt = None
        self.halo_tabs, self.halo_perms = self.maps.ppermute_tables()

        ird = model.ird
        ncell, np2 = m.ncell, m.np2

        # --- Static per-shard source enumeration: ext layout = [local |
        # per-delta halo buffers] (the halo_exchange/remap layout), plus a
        # permutation into GLOBAL id order so the pair enumeration matches
        # the single chip's (src, cand) order exactly. Ragged pad slots
        # repeat the shard's first cell id; the duplicate is masked by
        # `src_real` below.
        E = B + self.maps.halo_size
        ext_global = np.zeros((n_shards, E), np.int64)
        remap_np = self.maps.remap
        for s in range(n_shards):
            ext_global[s, :B] = self.maps.perm[s]
            halo_ids = np.where(remap_np[s] >= B)[0]
            ext_global[s, remap_np[s][halo_ids]] = halo_ids
            # Padded halo slots keep global id 0; `src_real` masks them.
        perm = np.argsort(ext_global, axis=1, kind="stable")
        sorted_ids = np.take_along_axis(ext_global, perm, axis=1)
        real = np.zeros((n_shards, E), bool)
        for s in range(n_shards):
            g = sorted_ids[s]
            real[s] = np.concatenate([[True], g[1:] != g[:-1]])
        self.E = E
        self.perm = jnp.asarray(perm.astype(np.int32))
        self.src_real = jnp.asarray(real)
        self.src_gid = jnp.asarray(sorted_ids.astype(np.int32))

        # --- Advected-vertex tables: unique corner vertices of each
        # shard's sorted ext cells (padded) + the (cell, corner) -> vertex
        # slot map. Static geometry, closed over.
        c2v = np.asarray(ird.cell2vert)
        vert_xyz = np.asarray(ird.vert_xyz)
        vlists, vmaps = [], []
        for s in range(n_shards):
            cells = sorted_ids[s]
            vids = np.unique(c2v[cells].reshape(-1))
            pos = {v: i for i, v in enumerate(vids)}
            vlists.append(vids)
            vmaps.append(np.vectorize(pos.__getitem__)(c2v[cells]))
        VE = max(len(v) for v in vlists)
        vp = np.zeros((n_shards, VE, 3))
        vm = np.zeros((n_shards, E, 4), np.int32)
        for s in range(n_shards):
            n = len(vlists[s])
            vp[s, :n] = vert_xyz[vlists[s]]
            vp[s, n:] = vp[s, 0]
            vm[s] = vmaps[s]
        self.vert_pos = jnp.asarray(vp)
        self.vmap4 = jnp.asarray(vm)
        # Eulerian corners of the sorted ext sources (CDG Jacobian ratio).
        self.src_corners = jnp.asarray(
            np.asarray(m.corners)[sorted_ids])        # (ns, E, 4, 3)

        # --- DSS tables (gather formulation over [local|halo] slots).
        d2c = np.asarray(m.dgll2cgll)
        c2d_idx = np.asarray(m.c2d_idx)
        c2d_mask = np.asarray(m.c2d_mask)
        slots4 = c2d_idx[d2c.reshape(-1)]
        Ff = np.asarray(model.F_mass).reshape(-1)

        def padc(a, fill=0.0):
            # Block order (shard-major per-shard cell lists; identity for
            # the contiguous divisible case), pad rows filled inertly.
            if self.pad == 0 and self.maps.contiguous:
                return a
            out = np.array(a[self._perm_flat])
            if self._padmask.any():
                out[self._padmask] = fill
            return out

        self.cells4 = jnp.asarray(padc(
            (slots4 // np2).astype(np.int32).reshape(ncell, np2, 4)))
        self.k4 = jnp.asarray(padc(
            (slots4 % np2).astype(np.int32).reshape(ncell, np2, 4)))
        self.mask4 = jnp.asarray(padc(
            c2d_mask[d2c.reshape(-1)].reshape(ncell, np2, 4)))
        self.F4 = jnp.asarray(padc(Ff[slots4].reshape(ncell, np2, 4)))
        _, remap = self.maps.jnp_tables()
        self.remap = remap
        chol = np.asarray(model.ird.chol if not model.facet
                          else jnp.broadcast_to(
                              model.ird.chol_ref,
                              (ncell,) + model.ird.chol_ref.shape))
        # Block order; pad rows get an identity factor (finite solves).
        if self.pad or not self.maps.contiguous:
            chol = np.array(chol[self._perm_flat])
            if self._padmask.any():
                chol[self._padmask] = np.eye(np2)
        self.chol = jnp.asarray(chol)
        # Padded runtime divisor tables (F zero, Jt one on pads; divisors
        # stay runtime operands for bitwise parity, see isl.step).
        self.F_mass_pad = jnp.asarray(padc(np.asarray(model.F_mass)))
        self.Jt_pad = jnp.asarray(padc(np.asarray(ird.Jt), fill=1.0))
        self._step_jit = None
        self._coverage_checked = set()

    # ------------------------------------------------------------------
    def coverage_ok(self, ts, tf):
        """Every single-chip pair (src, tgt) with a LOCAL target must have
        its src in that shard's ext set (IR halo: depth >= CFL + 2)."""
        model = self.model
        adv_vert = jax.jit(lambda: timeint.integrate(
            model.wind.velocity, ts, tf, model.ird.vert_xyz,
            self.cfg.nsub))()
        adv_cells = adv_vert[model.ird.cell2vert]
        ps, pt, pm = model._pairs(adv_cells)
        pm = np.asarray(pm)
        ps = np.asarray(ps)[pm]
        pt = np.asarray(pt)[pm]
        gid = np.asarray(self.src_gid)
        ow = self.maps.owner
        for s in range(self.n_shards):
            sel = ow[pt] == s
            if not set(ps[sel].tolist()) <= set(gid[s].tolist()):
                return False
        return True

    # ------------------------------------------------------------------
    def step(self, rho, q, ts, tf):
        key = round(float(tf) - float(ts), 12)
        if key not in self._coverage_checked:
            if not self.coverage_ok(ts, tf):
                raise ValueError(
                    f"IR halo depth {self.maps.depth} does not cover the "
                    f"pair footprint of a dt={key} step; increase `depth`")
            self._coverage_checked.add(key)
        if self._step_jit is None:
            body = jax.shard_map(
                self._body, mesh=self.mesh_dev,
                in_specs=(P("cells", None), P(None, "cells", None),
                          P(), P(),
                          P("cells", None, None),   # chol block (padded)
                          P("cells", None),         # F_mass block (padded)
                          P(),                      # F_mass full (divisor
                          #   tables as runtime operands; see isl.step)
                          P(), P(),                 # F_sphere, Jt full
                          P("cells", None),         # Jt padded block
                          P("cells", None, None),   # cells4
                          P("cells", None, None),   # k4
                          P("cells", None, None),   # mask4
                          P("cells", None, None),   # F4
                          P()),                     # remap
                out_specs=(P("cells", None), P(None, "cells", None)),
                check_vma=False)
            ird = self.model.ird
            pad = self.pad

            contig = self.maps.contiguous
            perm_j = jnp.asarray(self._perm_flat)
            padm = jnp.asarray(self._padmask)
            inv = self._inv_idx

            def stepfn(rho, q, ts, tf):
                if contig:
                    if pad:
                        rho = jnp.pad(rho, ((0, pad), (0, 0)))
                        q = jnp.pad(q, ((0, 0), (0, pad), (0, 0)))
                else:
                    rho = jnp.where(padm[:, None], 0.0, rho[perm_j])
                    q = jnp.where(padm[None, :, None], 0.0, q[:, perm_j])
                rho_o, q_o = body(rho, q, ts, tf, self.chol,
                                  self.F_mass_pad, self.model.F_mass,
                                  self.model.F_sphere, ird.Jt, self.Jt_pad,
                                  self.cells4, self.k4, self.mask4,
                                  self.F4, self.remap)
                if contig:
                    if pad:
                        rho_o = rho_o[:-pad]
                        q_o = q_o[:, :-pad]
                else:
                    rho_o = rho_o[inv]
                    q_o = q_o[:, inv]
                return rho_o, q_o

            self._step_jit = jax.jit(stepfn)
        return self._step_jit(rho, q, ts, tf)

    # ------------------------------------------------------------------
    def _dss_blk(self, x_blk, eslots4, mask4, F4):
        """dss.dss_gather / dss_gather_t arithmetic on ext slots."""
        lead = x_blk.ndim == 3
        st = x_blk if lead else x_blk[None]
        ext = halo_exchange(st, "cells", self.halo_tabs, self.halo_perms)
        if lead:
            qT = jnp.moveaxis(ext.reshape(ext.shape[0], -1), 0, -1)
            vals = qT[eslots4]                        # (B, np2, 4, nt)
            w = jnp.where(mask4, F4, 0.0)[..., None]
            num = jnp.sum(w * vals, axis=-2)
            den = jnp.sum(w, axis=-2)
            # den == 0 only on ragged pad rows; keep them finite-zero
            # (bitwise neutral on real rows).
            ok = den > 0
            cg = num / jnp.where(ok, den, 1.0)
            big = jnp.where(mask4[..., None], vals, -jnp.inf)
            small = jnp.where(mask4[..., None], vals, jnp.inf)
            cg = jnp.clip(cg, jnp.min(small, axis=-2),
                          jnp.max(big, axis=-2))
            cg = jnp.where(ok, cg, 0.0)
            return jnp.moveaxis(cg, -1, 0)            # (nt, B, np2)
        flat = ext[0].reshape(-1)
        vals = flat[eslots4]                          # (B, np2, 4)
        w = jnp.where(mask4, F4, 0.0)
        den = jnp.sum(w, axis=-1)
        ok = den > 0
        cg = jnp.sum(w * vals, axis=-1) / jnp.where(ok, den, 1.0)
        big = jnp.where(mask4, vals, -jnp.inf)
        small = jnp.where(mask4, vals, jnp.inf)
        cg = jnp.clip(cg, jnp.min(small, axis=-1), jnp.max(big, axis=-1))
        return jnp.where(ok, cg, 0.0)

    def _gsum_cells(self, x):
        return self.r_cells.allreduce(x, "cells")

    # ------------------------------------------------------------------
    def _body(self, rho, q, ts, tf, chol, F_mass_blk, F_mass, F_sphere,
              Jt, Jt_padded, cells4, k4, mask4, F4, remap):
        model, cfg, m = self.model, self.cfg, self.m
        ird = model.ird
        s = jax.lax.axis_index("cells")
        B, np2 = rho.shape
        nt = q.shape[0]
        rmp = remap[s]
        my_perm = self.perm[s]                        # (E,)
        my_real = self.src_real[s]
        my_gid = self.src_gid[s]                      # (E,) global ids
        eslots4 = rmp[cells4] * np2 + k4

        # --- Source state over ext cells, into sorted-global order.
        st = jnp.concatenate([rho[None], q], axis=0)
        ext = halo_exchange(st, "cells", self.halo_tabs, self.halo_perms)
        ext_sorted = ext[:, my_perm, :]               # (nt+1, E, np2)
        rho_s, q_s = ext_sorted[0], ext_sorted[1:]

        # --- Advect this shard's ext vertices (recompute; elementwise).
        adv_vert = timeint.integrate(model.wind.velocity, ts, tf,
                                     self.vert_pos[s], cfg.nsub)
        adv_cells = adv_vert[self.vmap4[s]]           # (E, 4, 3)

        # --- Pairs for every ext source, in sorted-global order.
        ctr = sphere.normalize(jnp.mean(adv_cells, axis=1))
        land = cubed_sphere.locate_cell(m, ctr)
        ncand = ird.cands.shape[1]
        E = adv_cells.shape[0]
        pair_src = jnp.repeat(jnp.arange(E), ncand)
        pair_tgt = ird.cands[land].reshape(-1)        # GLOBAL targets
        pair_mask = (ird.cands_mask[land].reshape(-1)
                     & jnp.repeat(my_real, ncand))

        T, ps_raw = model._assemble_T(adv_cells, pair_src, pair_tgt,
                                      pair_mask,
                                      src_corners=self.src_corners[s])

        # --- FsmoFtm per ext source (complete on this shard).
        if cfg.method == "ir":
            if model.facet:
                colsum_p = jnp.sum(T, axis=-2)
                colsum = segment_sum_ordered(colsum_p, pair_src, E)
                colsum = jnp.where(colsum == 0, 1.0, colsum)
                FsmoFtm = ird.gll_w2[None, :] / colsum
            else:
                F_adv = cubed_sphere._dgbfi_sphere(
                    adv_cells, ird.tq_bary, ird.tq_w, m.np_
                ).reshape(E, np2)
                FsmoFtm = F_sphere[my_gid] / F_adv
        else:
            FsmoFtm = jnp.ones((E, np2))

        # --- p_s_ol shares (colsum per source; sorted order = the single
        # chip's per-source pair order).
        colsum_ps = segment_sum_ordered(ps_raw, pair_src, E)
        cs = colsum_ps[pair_src]
        ps = ps_raw / jnp.where(cs == 0, 1.0, cs)

        # --- Local-target masking; contributions accumulate per local
        # cell in single-chip pair order (sorted global (src, cand)).
        # Layout-general: ownership/slot via the owner/leaf_slot tables
        # (for contiguous blocks these are c // B and c - s*B).
        tgt_local = self.leafslot_j[pair_tgt]
        is_local = pair_mask & (self.owner_j[pair_tgt] == s)
        seg_tgt = jnp.where(is_local, tgt_local, B)   # id B: dropped

        Jt_src = Jt[my_gid]
        Jt_blk = Jt_padded                      # this shard's (B, np2) block

        def apply_T(x):
            xs = x[..., pair_src, :]
            xs = jnp.where(is_local[..., None], xs, 0.0)
            contrib = apply_T_contrib(T, xs)
            cm = jnp.moveaxis(contrib, -2, 0)
            y = segment_sum_ordered(cm, seg_tgt, B)
            return jnp.moveaxis(y, 0, -2)

        def project(x):
            if model.facet:
                # J first, then the density factor (the single-chip
                # _project / reference apply_T_cell rounding order).
                xin = x * Jt_src
                if cfg.method == "ir":
                    xin = xin * FsmoFtm
            else:
                xin = x * FsmoFtm if cfg.method == "ir" else x
            y = apply_T(xin)
            if cfg.dmc in ("es", "eh", "ef"):
                xs = x[..., pair_src, :]
                xs = jnp.where(is_local[..., None], xs, 0.0)
                dp = mass_target_terms(ps, F_mass[my_gid][pair_src], xs)
                dpm = jnp.moveaxis(dp, -1, 0)
                d = jnp.moveaxis(segment_sum_ordered(dpm, seg_tgt, B), 0, -1)
                c = F_mass_blk / Jt_blk if model.facet else F_mass_blk
                out = solve_1eq_ls_blk(chol, y, c, d)
            elif model.facet and cfg.method == "ir":
                # dmc 'f' + IR: explicit per-cell enforcement of the exact-
                # arithmetic facet mass identity w2' Mref^{-1} y = 1' y
                # (see the single-chip _project for the drift analysis).
                ones = jnp.ones(np2, y.dtype)
                d = dot_last(jnp.broadcast_to(
                    ones, y.shape[:-1] + (np2,)), y)
                out = solve_1eq_ls_blk(chol, y, F_mass_blk / Jt_blk, d)
            else:
                out = mass_solve_blk(chol, y)
            if model.facet:
                out = out / Jt_blk
            return out

        Q = q_s * rho_s[None]
        rho_tgt = project(rho_s)
        Q_tgt = project(Q)

        if cfg.filter != "none":
            rho_tgt = limiter_mod.limit_density(
                F_mass_blk, rho_tgt, jnp.zeros(B))
            q_src = Q / jnp.where(rho_s == 0, 1.0, rho_s)[None]
            qs_min = jnp.min(q_src, axis=-1)          # (nt, E)
            qs_max = jnp.max(q_src, axis=-1)
            pmin = jnp.where(is_local, qs_min[..., pair_src], jnp.inf)
            pmax = jnp.where(is_local, qs_max[..., pair_src], -jnp.inf)
            q_min = jnp.moveaxis(jax.ops.segment_min(
                jnp.moveaxis(pmin, -1, 0), seg_tgt,
                num_segments=B + 1)[:B], 0, -1)
            q_max = jnp.moveaxis(jax.ops.segment_max(
                jnp.moveaxis(pmax, -1, 0), seg_tgt,
                num_segments=B + 1)[:B], 0, -1)
            q_min = jnp.maximum(q_min, 0.0)
            q_max = jnp.minimum(q_max, 1.0)
            q_min = jnp.where(jnp.isfinite(q_min), q_min, 0.0)
            q_max = jnp.where(jnp.isfinite(q_max), q_max, 1.0)

            F = F_mass_blk
            rhom = F[None] * rho_tgt[None]
            rho_mass = jnp.sum(F * rho_tgt, axis=-1)
            Qc_mass = jnp.sum(F[None] * Q_tgt, axis=-1)
            Qc_min = q_min * jnp.sum(rhom, axis=-1)
            Qc_max = q_max * jnp.sum(rhom, axis=-1)
            if cfg.filter == "caas":
                redist = spf.glbl_caas_gsum(Qc_min, Qc_mass, Qc_max,
                                            jnp.zeros(nt),
                                            self._gsum_cells)
            else:
                redist = self.sqlt.run(rho_mass, Qc_mass, Qc_min, Qc_max,
                                       root_extra=jnp.zeros(nt))
            delta = redist - Qc_mass
            qmin_n = jnp.broadcast_to(q_min[..., None], (nt, B, np2))
            qmax_n = jnp.broadcast_to(q_max[..., None], (nt, B, np2))
            lim = jax.vmap(
                lambda Qi, qmin, qmax, di: limiter_mod.limit_tracer(
                    F, rho_tgt, Qi, qmin, qmax, di, limiter=cfg.limiter,
                    expand_bounds_allowed=True))
            Q_tgt = lim(Q_tgt, qmin_n, qmax_n, delta)

        if not cfg.d2c:
            q_out = jnp.where(rho_tgt[None] == 0, 0.0,
                              Q_tgt / jnp.where(rho_tgt == 0, 1.0,
                                                rho_tgt)[None])
            return rho_tgt, q_out
        rho_out = self._dss_blk(rho_tgt, eslots4, mask4, F4)
        Q_out = self._dss_blk(Q_tgt, eslots4, mask4, F4)
        q_out = Q_out / jnp.where(rho_out == 0, 1.0, rho_out)[None]
        return rho_out, q_out


def dryrun_ir(n_devices: int, mesh_dev=None):
    """Compile+run one cell-sharded IR step and check agreement with the
    single-chip cell-integrated step (the dryrun's IR leg).

    The pure projection (T assembly, p_s_ol shares, FsmoFtm, equality-
    constrained per-cell solves) is asserted BITWISE; the full step with
    CDR + DSS is pinned at <= 2 ulp (the same fusion-context FMA effect
    the no-filter ISL config documents in tests/test_sharding.py - XLA
    contracts mul+add chains differently in the two whole programs; no
    conservation or bounds invariant depends on those bits)."""
    from compose_tpu import driver
    from compose_tpu.transport import gallery
    from compose_tpu.transport.ir import IrConfig, IrTransport

    ne = 4
    mesh = cubed_sphere.build(ne, 4)
    wind = gallery.create_wind("divergent")
    rho = jnp.ones((mesh.ncell, mesh.np_ ** 2))
    q = driver.init_tracers(mesh, ("gaussianhills", "cosinebells"))
    dt = 86400.0 / 10
    # Bitwise leg: unfiltered projection (dmc=es exercises the
    # equality-constrained solve + mass-target machinery).
    cfg = IrConfig(ne=ne, np_=4, method="ir", dmc="es", filter="none",
                   limiter="none", nsub=2, d2c=False)
    model = IrTransport(mesh, wind, cfg)
    ref_rho, ref_q = model.step(rho, q, 0.0, dt)
    sh = ShardedIr(model, n_devices, mesh_dev=mesh_dev)
    out_rho, out_q = sh.step(rho, q, 0.0, dt)
    d_rho = np.abs(np.asarray(out_rho) - np.asarray(ref_rho)).max()
    d_q = np.abs(np.asarray(out_q) - np.asarray(ref_q)).max()
    assert d_rho == 0.0, f"sharded IR projection: rho differs by {d_rho:.3e}"
    assert d_q == 0.0, f"sharded IR projection: q differs by {d_q:.3e}"
    # Full-step leg: CDR + limiter + DSS, <= 2 ulp.
    cfg2 = IrConfig(ne=ne, np_=4, method="ir", dmc="es", filter="caas",
                    limiter="caas", nsub=2, d2c=True)
    model2 = IrTransport(mesh, wind, cfg2)
    ref_rho, ref_q = model2.step(rho, q, 0.0, dt)
    sh2 = ShardedIr(model2, n_devices, mesh_dev=mesh_dev)
    out_rho, out_q = sh2.step(rho, q, 0.0, dt)
    ulp = float(jnp.finfo(jnp.float64).eps)
    d_rho = np.abs(np.asarray(out_rho) - np.asarray(ref_rho)).max()
    d_q = np.abs(np.asarray(out_q) - np.asarray(ref_q)).max()
    assert d_rho <= 2 * ulp, \
        f"sharded IR full step: rho differs by {d_rho:.3e}"
    assert d_q <= 2 * ulp, f"sharded IR full step: q differs by {d_q:.3e}"

"""Cell-integrated remap (IR / CDG) transport.

Counterpart of /root/reference/methods/slmm/slmmir_remapper.cpp (calc_T_fwd,
fill_T_fwd_sphere, fill_T_fwd_facet, project_nolimiter /
project_and_limit_cdr) and slmmir_remap_data.cpp (RemapData::remap,
FullMassMatrix). Per step:

  1. advect the deduplicated cell-corner vertices FORWARD ts->tf
     (slmmir.cpp:1291-1295, fwd stepping for cell-integrated methods);
  2. for every (target cell, candidate source) pair in a static 2-ring
     table, clip the advected source quad against the Eulerian target cell
     (batched Sutherland-Hodgman, ops/clip.py), fan-triangulate, and
     accumulate the np^2 x np^2 mixed-mass-matrix block by triangle
     quadrature. Two integration geometries:
       - sphere (dmc none/es/eh/geh): quadrature on the spherical overlap
         with two batched Newton inverse maps per point
         (fill_T_fwd_sphere, :369-463);
       - facet (dmc f/ef): Newton inverse maps only at the overlap
         VERTICES, then planar quadrature in the reference square; the
         transported field becomes (rho J) with J the ref->sphere node
         Jacobian, and the mass matrix becomes the ref-square GLL mass
         matrix (fill_T_fwd_facet, :244-367; apply_T_cell,
         slmmir_remap_data.cpp:283-307);
  3. density factor FsmoFtm = (Eulerian src basis integrals) / (advected
     src basis integrals) for IR (:731-757; facet: GLL weights over T
     column sums, :734-750); CDG instead multiplies the Jacobian ratio
     inside the quadrature (sphere) or integrates in source ref coords
     (facet);
  4. project: per-cell y = sum_cand T_block . (src * FsmoFtm), then a
     Cholesky solve with the full mass matrix; DMC options
     (Dmc, slmmir.hpp:13-77):
       none - plain M^{-1} T;
       es/eh/ef - per-cell mass equality constraint (solve_1eq_ls,
         slmmir_remap_data.cpp:78-116) in the sphere (es) or Homme/GLL
         (eh, ef) mass measure;
       f - facet transport alone (exact-arithmetic DMC);
       geh - one GLOBAL mass equality constraint in the Homme measure
         (RemapData::remap, slmmir_remap_data.cpp:371-400);
  5. optional CDR: per-cell q bounds from the T-graph neighborhood, global
     mass redistribution (zero net discrepancy), cell-local limiter
     (project_and_limit_cdr, :566-647).

All pair work is chunked through lax.map so peak memory stays bounded while
each chunk is one fused kernel.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .. import basis as basis_mod
from ..mesh import cubed_sphere, ir_data
from ..ops import clip, sphere, sqr
from ..ops.reduce import bfb_sum
from . import dss, limiter as limiter_mod, spf, timeint

def apply_T_contrib(T, xs):
    """contrib[..., p, a] = sum_b T[p, a, b] xs[..., p, b], as an
    explicitly left-to-right associated elementwise chain (NOT einsum:
    dot_general's reduction association depends on the batch shape, and
    the sharded step evaluates the same pairs with a different batch -
    this form is bitwise identical for any pair-axis length)."""
    np2 = T.shape[-1]
    acc = T[:, :, 0] * xs[..., 0][..., None]
    for b in range(1, np2):
        acc = acc + T[:, :, b] * xs[..., b][..., None]
    return acc


def segment_sum_ordered(data, segment_ids, num_segments: int):
    """jax.ops.segment_sum(data, segment_ids, num_segments) with a fixed
    order: each segment adds its rows left to right in ascending row order,
    starting from 0.0 - the order of XLA:CPU's sequential scatter-add, so
    the bits equal segment_sum's on the CPU. On a GPU, segment_sum's
    scatter-add accumulates with atomics in an order that changes from run
    to run; this form is bitwise reproducible on every backend and, since
    the sharded IR step enumerates its pairs in the same global order,
    across decompositions. Rows whose id is outside [0, num_segments) are
    dropped.

    The rows are sorted by segment (stable) and a loop over the k-th row
    of every segment runs max(segment size) times; no size bound is
    assumed."""
    n = segment_ids.shape[0]
    seg = jnp.where((segment_ids >= 0) & (segment_ids < num_segments),
                    segment_ids, num_segments)
    order = jnp.argsort(seg, stable=True)
    sorted_seg = seg[order]
    ids = jnp.arange(num_segments)
    start = jnp.searchsorted(sorted_seg, ids, side="left")
    count = jnp.searchsorted(sorted_seg, ids, side="right") - start
    bshape = (num_segments,) + (1,) * (data.ndim - 1)

    def body(k, acc):
        row = order[jnp.minimum(start + k, n - 1)]
        take = (k < count).reshape(bshape)
        # acc + 0.0 == acc exactly: acc starts at +0.0 and a sum of
        # nonzero terms never rounds to -0.0.
        return acc + jnp.where(take, data[row], 0.0)

    acc = jnp.zeros((num_segments,) + data.shape[1:], data.dtype)
    return jax.lax.fori_loop(0, jnp.max(count), body, acc)


def dot_last(a, b):
    """sum_i a[..., i] b[..., i] as an explicit left-to-right chain (the
    batch-shape-stable replacement for einsum/jnp.sum contractions shared
    by the single-chip and sharded per-cell solvers)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def mass_solve_blk(L, y):
    """Per-cell M^{-1} y via Cholesky factors L (nc, np2, np2); y
    (..., nc, np2); batched over leading dims."""
    yy = jnp.moveaxis(y, -2, 0)
    sol = jax.vmap(
        lambda Lc, yc: jax.scipy.linalg.cho_solve(
            (Lc, True), yc.reshape(-1, yc.shape[-1]).T).T.reshape(
                yc.shape))(L, yy)
    return jnp.moveaxis(sol, 0, -2)


def solve_1eq_ls_blk(L, y, c, d):
    """Equality-constrained per-cell solve (FullMassMatrix::solve_1eq_ls,
    slmmir_remap_data.cpp:78-116) on a block of cells; shared by the
    single-chip and sharded paths (explicitly-associated contractions so
    both round identically for any block size)."""
    lower = partial(jax.scipy.linalg.solve_triangular, lower=True)
    s = jax.vmap(lambda Lc, cc: lower(Lc, cc))(L, c)      # L s = c
    a1 = jax.vmap(
        lambda Lc, yc: lower(Lc, yc.reshape(-1, yc.shape[-1]).T).T.reshape(
            yc.shape))(L, jnp.moveaxis(y, -2, 0))
    a1m = jnp.moveaxis(a1, 0, -2)
    a2 = d - dot_last(jnp.broadcast_to(s, a1m.shape), a1m)
    s2 = dot_last(s, s)
    mu = a2 / s2
    x1 = a1m + mu[..., None] * s
    upperT = partial(jax.scipy.linalg.solve_triangular, lower=True,
                     trans='T')
    x = jax.vmap(
        lambda Lc, xc: upperT(Lc, xc.reshape(-1, xc.shape[-1]).T).T.reshape(
            xc.shape))(L, jnp.moveaxis(x1, -2, 0))
    return jnp.moveaxis(x, 0, -2)


def mass_target_terms(ps, F_src, xs):
    """dp[..., p] = sum_i ps[p, i] F_src[p, i] xs[..., p, i], explicitly
    associated (see apply_T_contrib)."""
    w = ps * F_src
    acc = w[:, 0] * xs[..., 0]
    for i in range(1, w.shape[-1]):
        acc = acc + w[:, i] * xs[..., i]
    return acc


_EQ_LOCAL = ("es", "eh", "ef")       # Dmc::is_locally_constrained
_FACET = ("f", "ef")                 # Dmc::is_facet
_HOMME_MASS = ("eh", "geh", "f", "ef")   # Dmc::use_homme_mass


@dataclasses.dataclass(frozen=True)
class IrConfig:
    ne: int
    np_: int = 4
    method: str = "ir"           # ir | cdg
    dmc: str = "none"            # none | es | eh | f | ef | geh
    filter: str = "none"         # global CDR: qlt | caas | mn2 | none
    limiter: str = "mn2"
    nsub: int = 8
    # Fixed lax.map chunk SIZE over (tgt, cand) pairs. A fixed size (not a
    # fixed chunk COUNT) keeps the per-chunk einsum shapes identical
    # between the single-chip and cell-sharded assemblies, which keeps the
    # nq-contraction lowering - and therefore the bits - identical.
    pair_chunk: int = 1024
    # Triangle-quadrature order for the T fill (-tq, slmmir.cpp:30-32;
    # default None = accuracy-matched order per np, 4 = the reference's
    # reduced-quadrature regression rows, slmm_runtests.py:244-265).
    tq: int = None
    # Make fields continuous after the remap (-d2c, slmmir.cpp:66-69).
    # The reference's CI rows run discontinuous unless -d2c is passed.
    d2c: bool = True


class IrTransport:
    def __init__(self, mesh: cubed_sphere.CubedSphereMesh, wind,
                 config: IrConfig):
        self.mesh = mesh
        self.config = config
        self.wind = wind
        # Default -tq for facet transport is (np-1)*4, not the QOS
        # accuracy-matched order (slmmir.cpp:1816-1822).
        tq = config.tq
        if tq is None and config.dmc in _FACET:
            tq = (config.np_ - 1) * 4
        self.ird = ir_data.build(mesh, tq_order=tq)
        self.gll = basis_mod.GLL(config.np_)
        self.facet = config.dmc in _FACET
        self.F_sphere = mesh.dgbfi_sphere
        # dgbfi_mass: sphere integrals vs Homme (GLL) mass
        # (Dmc::use_homme_mass, slmmir.hpp:74-76).
        self.F_mass = (mesh.dgbfi_gll if config.dmc in _HOMME_MASS
                       else mesh.dgbfi_sphere)
        self.d2c_map = mesh.dgll2cgll.reshape(-1)
        if config.filter != "none":
            self.mrd = spf.MassRedistributor(mesh.ncell, config.filter)
        else:
            self.mrd = None
        self._step = jax.jit(self._step_impl)
        self._remap_rho_jit = None

    def step(self, rho, q, ts, tf):
        # Divisor-ish mesh tables (F_mass, F_sphere, Jt) ride as runtime
        # operands, NOT closed-over constants: XLA folds multiplies/
        # divides by constants (e.g. x/Jt -> x * (1/Jt)) and the sharded
        # step necessarily receives its blocks as operands - threading
        # them here keeps the two programs bitwise identical (same
        # contract as IslTransport.step's mesh_tables).
        tables = (self.F_mass, self.F_sphere, self.ird.Jt)
        return self._step(rho, q, ts, tf, mesh_tables=tables)

    def remap_rho(self, rho, ts, tf):
        """Density-only cell-integrated remap (+ positivity limiter) - the
        density leg of the mixed `isl` method (slmmir.cpp:1314-1317)."""
        if self._remap_rho_jit is None:
            self._remap_rho_jit = jax.jit(self._remap_rho_impl)
        return self._remap_rho_jit(rho, ts, tf)

    def _remap_rho_impl(self, rho, ts, tf):
        cfg = self.config
        m = self.mesh
        tables = (self.F_mass, self.F_sphere, self.ird.Jt)
        adv_vert = timeint.integrate(
            self.wind.velocity, ts, tf, self.ird.vert_xyz, cfg.nsub)
        adv_cells = adv_vert[self.ird.cell2vert]
        pair_src, pair_tgt, pair_mask = self._pairs(adv_cells)
        T, ps_raw = self._assemble_T(adv_cells, pair_src, pair_tgt,
                                     pair_mask)
        FsmoFtm = (self._fsmoftm(adv_cells, T, pair_src)
                   if cfg.method == "ir" else jnp.ones_like(rho))
        ps = self._normalize_ps(ps_raw, pair_src)
        rho_tgt = self._project(T, ps, pair_src, pair_tgt, pair_mask,
                                rho, FsmoFtm, tables)
        return limiter_mod.limit_density(
            self.F_mass, rho_tgt, jnp.zeros(m.ncell))

    # ------------------------------------------------------------------
    def _pairs(self, adv_cells):
        """(src, tgt) candidate pairs: each advected source cell is paired
        with the 2-ring of Eulerian cells around its LANDING cell (the cell
        containing its advected center). This replaces the reference's
        octree search over advected bounding boxes
        (calc_T_pattern_fwd, slmmir_remapper.cpp:65-151) with O(1) index
        math - displacement is unbounded, only the advected cell's SPREAD
        must fit the ring (max_hits=25, :7)."""
        m, ird = self.mesh, self.ird
        ncell = m.ncell
        ncand = ird.cands.shape[1]
        ctr = sphere.normalize(jnp.mean(adv_cells, axis=1))
        land = cubed_sphere.locate_cell(m, ctr)               # (ncell,)
        pair_src = jnp.repeat(jnp.arange(ncell), ncand)
        pair_tgt = ird.cands[land].reshape(-1)
        pair_mask = ird.cands_mask[land].reshape(-1)
        return pair_src, pair_tgt, pair_mask

    def _assemble_T(self, adv_cells, pair_src, pair_tgt, pair_mask,
                    src_corners=None):
        """Build per-pair T blocks (npair, np2, np2) and src-share integrals
        p_s_ol (npair, np2) from advected source cells.

        adv_cells: (nsrc, 4, 3) advected corner quads; pair_src indexes
        INTO adv_cells (global cell ids on the single chip, ext-local
        sorted ids on a shard); pair_tgt is always a GLOBAL Eulerian cell
        id (target geometry is static). `src_corners` (nsrc, 4, 3) are the
        EULERIAN corners of each source (defaults to mesh.corners; a shard
        passes its ext-sorted gather) - the CDG Jacobian ratio needs them."""
        m, ird, cfg = self.mesh, self.ird, self.config
        if src_corners is None:
            src_corners = m.corners
        ncell, np2 = m.ncell, m.np2
        euler_v = ird.vert_xyz[ird.cell2vert]            # (ncell, 4, 3)

        tgt_idx = pair_tgt
        src_idx = pair_src

        nq = ird.tq_w.shape[0]
        bary = ird.tq_bary
        qw = ird.tq_w
        is_cdg = cfg.method == "cdg"
        facet = self.facet

        def pair_fn(args):
            tci, sci, pmask = args
            tgt_v = euler_v[tci]                          # (B, 4, 3)
            tgt_nml = ird.edge_nmls[tci]
            src_v = adv_cells[sci]
            tgt_corners = m.corners[tci]
            # Clip advected source quad against the target cell.
            poly0 = jnp.concatenate(
                [src_v, jnp.zeros_like(src_v)], axis=-2)  # (B, 8, 3)
            n0 = jnp.where(pmask, 4, 0).astype(jnp.int32)
            vo, no = clip.clip_against_poly(tgt_v, tgt_nml, poly0, n0)
            T = jnp.zeros(tci.shape + (np2, np2))
            ps = jnp.zeros(tci.shape + (np2,))

            if facet:
                # fill_T_fwd_facet (slmmir_remapper.cpp:244-367): Newton
                # inverse maps at the overlap VERTICES only, then planar
                # triangle quadrature in the reference square(s).
                valid = (jnp.arange(clip.MAX_NVERT)[None, :]
                         < no[..., None])                  # (B, 8)
                ctr = sphere.normalize(jnp.mean(tgt_v, axis=-2))
                von = jnp.where(valid[..., None], vo,
                                ctr[..., None, :])
                # Guarded normalize: a degenerate clip of a folded source
                # quad can emit a (near-)zero vertex; 0/0 would NaN the
                # whole pair even though its triangles are masked.
                von = von / jnp.maximum(
                    sphere.norm(von)[..., None], jnp.finfo(von.dtype).tiny)
                # "The global mass is sensitive to the quality of the
                # following nonlinear solves" (:289-299): tol = eps.
                ftol = 2.220446049250313e-16
                tva, tvb = sqr.sphere_to_ref(
                    tgt_corners[..., None, :, :], von,
                    max_its=15, tol=ftol)                  # (B, 8)
                sva, svb = sqr.sphere_to_ref(
                    src_v[..., None, :, :], von, max_its=15, tol=ftol)
                # Empty-overlap lanes feed the Newton a far-away point and
                # can diverge; true overlap vertices are inside both
                # elements (|a|,|b| <= 1+ulp), so clamping only touches
                # lanes that the act mask zeroes - and keeps the masked
                # basis products finite (inf * 0 would poison the sum).
                clamp = lambda u: jnp.clip(u, -2.0, 2.0)
                tva, tvb, sva, svb = map(clamp, (tva, tvb, sva, svb))
                # Integration coords: target ref square for IR ("just a
                # projection"), source ref square for CDG (:309-318).
                ja, jb_ = (sva, svb) if is_cdg else (tva, tvb)
                for k in range(1, clip.MAX_NVERT - 1):
                    act = (k + 1) < no                     # (B,)
                    tri2 = ((ja[..., k] - ja[..., 0])
                            * (jb_[..., k + 1] - jb_[..., 0])
                            - (jb_[..., k] - jb_[..., 0])
                            * (ja[..., k + 1] - ja[..., 0]))
                    d0 = 0.5 * tri2[..., None] * qw[None, :]  # (B, nq)
                    d0 = jnp.where(act[..., None], d0, 0.0)
                    # Quadrature points by linear barycentric interpolation
                    # of the ref-coordinates of the triangle's vertices.
                    def bary_pts(u):
                        tri = jnp.stack(
                            [u[..., 0], u[..., k], u[..., k + 1]],
                            axis=-1)                       # (B, 3)
                        return jnp.einsum('qv,bv->bq', bary, tri)
                    ta, tb = bary_pts(tva), bary_pts(tvb)
                    sa, sb = bary_pts(sva), bary_pts(svb)
                    tgi = self.gll.eval(ta)                # (B, nq, np)
                    tgj = self.gll.eval(tb)
                    sgi = self.gll.eval(sa)
                    sgj = self.gll.eval(sb)
                    tphi = (tgj[..., :, None]
                            * tgi[..., None, :]).reshape(ta.shape + (np2,))
                    sphi = (sgj[..., :, None]
                            * sgi[..., None, :]).reshape(sa.shape + (np2,))
                    T = T + jnp.einsum('bq,bqa,bqc->bac', d0, tphi, sphi)
                    ps = ps + jnp.einsum('bq,bqc->bc', d0, sphi)
                return T, ps

            for k in range(1, clip.MAX_NVERT - 1):
                act = (k + 1) < no                         # (B,)
                jac, pq = sphere.tri_jacobian(
                    vo[..., 0, :][..., None, :],
                    vo[..., k, :][..., None, :],
                    vo[..., k + 1, :][..., None, :],
                    bary[None, :, :])                      # (B, nq), (B,nq,3)
                ta, tb = sqr.sphere_to_ref(
                    tgt_corners[..., None, :, :], pq)
                sa, sb = sqr.sphere_to_ref(src_v[..., None, :, :], pq)
                # Degenerate lanes (empty overlap, or a folded advected quad
                # under extreme deformation) can make the Newton diverge;
                # genuine overlap points satisfy |a|,|b| <= 1+ulp, so the
                # clamp only touches lanes the act/d0 masks zero - and keeps
                # the masked basis products finite (inf * 0 -> NaN).
                clamp = lambda u: jnp.clip(u, -2.0, 2.0)
                ta, tb, sa, sb = map(clamp, (ta, tb, sa, sb))
                d0 = 0.5 * qw[None, :] * jac
                if is_cdg:
                    # CDG: Jacobian ratio Euler/advected at the src ref
                    # coords (fill_T_fwd_sphere, :430-432).
                    je = sqr.bilinear_jacobian_norm(
                        src_corners[sci][..., None, :, :], sa, sb)
                    ja = sqr.bilinear_jacobian_norm(
                        src_v[..., None, :, :], sa, sb)
                    d0 = d0 * (je / ja)
                d0 = jnp.where(act[..., None], d0, 0.0)
                tgi = self.gll.eval(ta)                    # (B, nq, np)
                tgj = self.gll.eval(tb)
                sgi = self.gll.eval(sa)
                sgj = self.gll.eval(sb)
                tphi = (tgj[..., :, None] * tgi[..., None, :]).reshape(
                    ta.shape + (np2,))
                sphi = (sgj[..., :, None] * sgi[..., None, :]).reshape(
                    sa.shape + (np2,))
                T = T + jnp.einsum('bq,bqa,bqc->bac', d0, tphi, sphi)
                ps = ps + jnp.einsum('bq,bqc->bc', d0, sphi)
            return T, ps

        # Chunked map over pairs (fixed chunk SIZE; see IrConfig.pair_chunk).
        P = tgt_idx.shape[0]
        B = self.config.pair_chunk
        C = -(-P // B)
        pad = C * B - P
        def pad_to(x, fill):
            return jnp.concatenate(
                [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])
        ti = pad_to(tgt_idx, 0).reshape(C, B)
        si = pad_to(src_idx, 0).reshape(C, B)
        pm = pad_to(pair_mask, False).reshape(C, B)
        Tc, psc = jax.lax.map(pair_fn, (ti, si, pm))
        T = Tc.reshape(-1, np2, np2)[:P]
        ps = psc.reshape(-1, np2)[:P]
        return T, ps

    def _fsmoftm(self, adv_cells, T=None, pair_src=None, F_sphere=None):
        """IR density factor: Eulerian / advected source basis integrals
        per DGLL node (slmmir_remapper.cpp:751-757). Facet variant
        (:734-750): advected integral = T column sum; Eulerian integral =
        tensor GLL weight."""
        m = self.mesh
        if self.facet:
            colsum_p = jnp.sum(T, axis=-2)                  # (P, np2)
            colsum = segment_sum_ordered(colsum_p, pair_src, m.ncell)
            colsum = jnp.where(colsum == 0, 1.0, colsum)
            return self.ird.gll_w2[None, :] / colsum
        F_adv = cubed_sphere._dgbfi_sphere(
            adv_cells, self.ird.tq_bary, self.ird.tq_w, m.np_
        ).reshape(m.ncell, m.np2)
        F_sphere = self.F_sphere if F_sphere is None else F_sphere
        return F_sphere / F_adv

    def _normalize_ps(self, ps_raw, pair_src):
        """Normalize p_s_ol columns to source shares (finish_p_s_ol,
        slmmir_remapper.cpp:170-205)."""
        colsum = segment_sum_ordered(ps_raw, pair_src, self.mesh.ncell)
        cs = colsum[pair_src]
        return ps_raw / jnp.where(cs == 0, 1.0, cs)

    def _apply_T(self, T, pair_src, pair_tgt, pair_mask, x,
                 num_segments=None):
        """y_tgt = sum over pairs with this target of T_pair @ x[src]
        (batched over leading tracer dims of x: (..., ncell, np2))."""
        xs = x[..., pair_src, :]                       # (..., P, np2)
        xs = jnp.where(pair_mask[..., None], xs, 0.0)
        contrib = apply_T_contrib(T, xs)
        cm = jnp.moveaxis(contrib, -2, 0)              # (P, ..., np2)
        y = segment_sum_ordered(
            cm, pair_tgt,
            self.mesh.ncell if num_segments is None else num_segments)
        return jnp.moveaxis(y, 0, -2)

    def _chol(self):
        """Per-cell Cholesky factors: ref-square (shared) for facet
        transport, spherical-cell M otherwise."""
        if self.facet:
            return jnp.broadcast_to(
                self.ird.chol_ref,
                (self.mesh.ncell,) + self.ird.chol_ref.shape)
        return self.ird.chol

    def _mass_solve(self, y):
        """Per-cell M^{-1} y via the precomputed Cholesky factors; batched
        over leading dims of y (..., ncell, np2)."""
        return mass_solve_blk(self._chol(), y)

    def _solve_1eq_ls(self, y, c, d):
        """Equality-constrained per-cell solve (see solve_1eq_ls_blk).
        y: (..., ncell, np2) RHS (= T src); c: (ncell, np2) constraint
        vector (dgbfi_mass; divided by Jt in the facet case,
        init_dgbfi_mass slmmir_remap_data.cpp:250-256); d: (..., ncell)."""
        return solve_1eq_ls_blk(self._chol(), y, c, d)

    def _solve_glbl_eq(self, y, x_src):
        """Single GLOBAL mass equality constraint (dmc geh; RemapData::remap,
        slmmir_remap_data.cpp:371-400): forward-substitute per cell, shift
        along L^{-1}F to match the global source mass, back-substitute."""
        L = self.ird.chol
        F = self.F_mass
        lower = partial(jax.scipy.linalg.solve_triangular, lower=True)
        s = jax.vmap(lambda Lc, cc: lower(Lc, cc))(L, F)      # (ncell, np2)
        z = jax.vmap(
            lambda Lc, yc: lower(Lc, yc.reshape(-1, yc.shape[-1]).T).T.reshape(
                yc.shape))(L, jnp.moveaxis(y, -2, 0))
        z = jnp.moveaxis(z, 0, -2)                            # (..., nc, np2)
        mass = bfb_sum((F * x_src).reshape(x_src.shape[:-2] + (-1,)))
        a2 = mass - jnp.sum(s * z, axis=(-2, -1))
        s2 = jnp.sum(s * s)
        mu = a2 / s2
        z = z + mu[..., None, None] * s
        upperT = partial(jax.scipy.linalg.solve_triangular, lower=True,
                         trans='T')
        x = jax.vmap(
            lambda Lc, xc: upperT(Lc, xc.reshape(-1, xc.shape[-1]).T).T.reshape(
                xc.shape))(L, jnp.moveaxis(z, -2, 0))
        return jnp.moveaxis(x, 0, -2)

    def _project(self, T, ps, pair_src, pair_tgt, pair_mask, x, FsmoFtm,
                 tables=None):
        """remap_cell / remap (slmmir_remap_data.cpp:333-406) for one field
        batch x (..., ncell, np2)."""
        cfg, m = self.config, self.mesh
        F_mass, _, Jt = tables if tables is not None else (
            self.F_mass, self.F_sphere, self.ird.Jt)
        if self.facet:
            # Source field from the transport method's perspective is
            # (Q J) (apply_T_cell :283-307); J first, then the density
            # factor - the reference's rounding order (:291-300).
            xin = x * Jt
            if cfg.method == "ir":
                xin = xin * FsmoFtm
        else:
            xin = x * FsmoFtm if cfg.method == "ir" else x
        y = self._apply_T(T, pair_src, pair_tgt, pair_mask, xin)
        if cfg.dmc in _EQ_LOCAL:
            # Local mass target = this cell's share of each source basis
            # function's mass (remap_cell, slmmir_remap_data.cpp:340-357).
            xs = x[..., pair_src, :]
            xs = jnp.where(pair_mask[..., None], xs, 0.0)
            dp = mass_target_terms(ps, F_mass[pair_src], xs)
            dpm = jnp.moveaxis(dp, -1, 0)
            d = jnp.moveaxis(segment_sum_ordered(dpm, pair_tgt, m.ncell),
                             0, -1)
            # Facet: remove J_ref^sphere from the constraint vector because
            # it is part of the field (init_dgbfi_mass :250-256).
            c = F_mass / Jt if self.facet else F_mass
            out = self._solve_1eq_ls(y, c, d)
        elif cfg.dmc == "geh":
            out = self._solve_glbl_eq(y, x)
        elif self.facet and cfg.method == "ir":
            # dmc 'f': conservation is the exact-arithmetic identity
            # w2' Mref^{-1} y = 1' y (Mref 1 = w2, the partition of unity
            # of the ref-square mass matrix) - the facet telescope
            # (slmmir_remapper.cpp:244-307). In floating point the plain
            # Cholesky solve carries a FIXED per-cell defect
            # w2' Mhat^{-1} - 1', which biases the mass drift linearly in
            # steps (measured ~7.8e-16/step). Enforce the identity
            # explicitly with the same constrained solve the eq paths use
            # (c'x = 1'y with c = F/Jt): in exact arithmetic the solution
            # is unchanged (mu = 0), and the float drift drops an order of
            # magnitude (96 steps: 7.5e-14 -> 3.8e-15, restoring the
            # reference's 4e-14 tolerance, slmm_runtests.py:234). CDG's
            # plain solve already meets its rows (and measured WORSE with
            # the pinned mass: its T carries the Jacobian ratio, so 1'y is
            # a noisier mass estimate there) - IR only.
            ones = jnp.ones(m.np2, y.dtype)
            d = dot_last(jnp.broadcast_to(ones, y.shape[:-1] + (m.np2,)),
                         y)
            out = self._solve_1eq_ls(y, F_mass / Jt, d)
        else:
            out = self._mass_solve(y)
        if self.facet:
            out = out / Jt
        return out

    # ------------------------------------------------------------------
    def _step_impl(self, rho, q, ts, tf, mesh_tables=None):
        cfg = self.config
        m = self.mesh
        tables = mesh_tables if mesh_tables is not None else (
            self.F_mass, self.F_sphere, self.ird.Jt)
        F_mass, F_sphere, _ = tables
        adv_vert = timeint.integrate(
            self.wind.velocity, ts, tf, self.ird.vert_xyz, cfg.nsub)
        adv_cells = adv_vert[self.ird.cell2vert]
        pair_src, pair_tgt, pair_mask = self._pairs(adv_cells)
        T, ps_raw = self._assemble_T(adv_cells, pair_src, pair_tgt,
                                     pair_mask)

        if cfg.method == "ir":
            FsmoFtm = self._fsmoftm(adv_cells, T, pair_src,
                                    F_sphere=F_sphere)
        else:
            FsmoFtm = jnp.ones_like(rho)
        ps = self._normalize_ps(ps_raw, pair_src)

        def project(x):
            return self._project(T, ps, pair_src, pair_tgt, pair_mask,
                                 x, FsmoFtm, tables)

        # Transport Q = rho * q (the driver passes mixing ratios; cell-
        # integrated methods remap tracer masses, slmmir.cpp:1168-1176).
        Q = q * rho[None]
        rho_tgt = project(rho)
        Q_tgt = project(Q)

        if cfg.filter != "none":
            # Density positivity (project_and_limit_cdr :583-603).
            rho_tgt = limiter_mod.limit_density(
                F_mass, rho_tgt, jnp.zeros(m.ncell))
            # Per-target-cell q bounds over the T-graph source neighborhood,
            # clamped to [0, 1] (MonoData::calc_q_min_max,
            # slmmir_mono_data.cpp:107-128).
            q_src = Q / jnp.where(rho == 0, 1.0, rho)[None]
            qs_min = jnp.min(q_src, axis=-1)            # (nt, ncell)
            qs_max = jnp.max(q_src, axis=-1)
            pmin = jnp.where(pair_mask, qs_min[..., pair_src], jnp.inf)
            pmax = jnp.where(pair_mask, qs_max[..., pair_src], -jnp.inf)
            q_min = jnp.moveaxis(jax.ops.segment_min(
                jnp.moveaxis(pmin, -1, 0), pair_tgt,
                num_segments=m.ncell), 0, -1)
            q_max = jnp.moveaxis(jax.ops.segment_max(
                jnp.moveaxis(pmax, -1, 0), pair_tgt,
                num_segments=m.ncell), 0, -1)
            q_min = jnp.maximum(q_min, 0.0)
            q_max = jnp.minimum(q_max, 1.0)
            # Cells with no contributions (shouldn't happen): neutral bounds.
            q_min = jnp.where(jnp.isfinite(q_min), q_min, 0.0)
            q_max = jnp.where(jnp.isfinite(q_max), q_max, 1.0)

            F = F_mass
            rhom = F[None] * rho_tgt[None]
            rho_mass = jnp.sum(F * rho_tgt, axis=-1)
            Qc_mass = jnp.sum(F[None] * Q_tgt, axis=-1)
            Qc_min = q_min * jnp.sum(rhom, axis=-1)
            Qc_max = q_max * jnp.sum(rhom, axis=-1)
            redist = self.mrd.redistribute(
                rho_mass, Qc_min, Qc_mass, Qc_max,
                jnp.zeros(Q.shape[0]))
            delta = redist - Qc_mass
            nt = Q.shape[0]
            np2 = m.np2
            qmin_n = jnp.broadcast_to(q_min[..., None],
                                      (nt, m.ncell, np2))
            qmax_n = jnp.broadcast_to(q_max[..., None],
                                      (nt, m.ncell, np2))
            lim = jax.vmap(
                lambda Qi, qmin, qmax, di: limiter_mod.limit_tracer(
                    F, rho_tgt, Qi, qmin, qmax, di, limiter=cfg.limiter,
                    expand_bounds_allowed=True))
            Q_tgt = lim(Q_tgt, qmin_n, qmax_n, delta)

        # DSS (plain, on rho and Q; slmmir.cpp:1335-1339 with
        # mixing_ratio_input false for cell-integrated methods). Gated by
        # -d2c: without it the reference leaves CI fields discontinuous.
        if not cfg.d2c:
            # Zero-density nodes carry q = 0 (same guard as the isl paths).
            q_out = jnp.where(rho_tgt[None] == 0, 0.0,
                              Q_tgt / jnp.where(rho_tgt == 0, 1.0,
                                                rho_tgt)[None])
            return rho_tgt, q_out
        # Gather-formulation DSS (same per-node arithmetic the sharded IR
        # step reproduces bitwise; the scatter/segment formulation orders
        # the coincident-slot adds identically but lowers differently).
        Ff = F_mass.reshape(-1)
        rho_out = dss.dss_gather(rho_tgt.reshape(-1), self.d2c_map,
                                 m.c2d_idx, m.c2d_mask,
                                 Ff).reshape(m.ncell, m.np2)
        Q_out = dss.dss_gather_t(Q_tgt.reshape(Q.shape[0], -1),
                                 self.d2c_map, m.c2d_idx, m.c2d_mask,
                                 Ff).reshape(Q_tgt.shape)
        q_out = Q_out / jnp.where(rho_out == 0, 1.0, rho_out)[None]
        return rho_out, q_out

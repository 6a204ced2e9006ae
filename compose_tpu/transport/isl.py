"""Interpolation semi-Lagrangian (ISL) transport step.

Counterpart of /root/reference/methods/slmm/slmmir_remapper_isl.cpp. One
transport step is a single jitted function:

  1. departure points: backward trajectory integration of the unique CGLL
     nodes (timeint.integrate; reference slmmir.cpp:1296-1301 uses bwd
     integration for ISL);
  2. source cell per node: O(1) equiangular index math (mesh.get_cell_idx;
     reference find_src_cell, slmmir_remapper_isl.cpp:1101-1122);
  3. batched Newton sphere->ref + tensor-product basis eval
     (calc_departure_data, :1124-1153);
  4. interpolation: gather each node's source cell values and contract with
     the np^2 weight tensor - one einsum over all nodes and all tracers
     (interp, :1183-1238); density additionally carries the departure/arrival
     Jacobian ratio (calc_jacobian_departure, :1155-1181);
  5. property preservation: global mass redistribution over cells
     (transport/spf.py) + cell-local limiter (transport/limiter.py), the
     isl_cdr flow (:1292-1455);
  6. DSS to restore continuity (transport/dss.py).

Everything is fixed-shape and batched; tracers are a dense leading axis.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .. import basis as basis_mod
from ..mesh import cubed_sphere
from ..ops import local_qp, sphere, sqr
from ..ops.reduce import bfb_sum, bfb_sum_cells
from . import dss, limiter as limiter_mod, spf, timeint
from .dss_face import FaceDss


@dataclasses.dataclass(frozen=True)
class IslConfig:
    ne: int
    np_: int = 4
    basis: str = "GllNodal"
    filter: str = "qlt"          # global CDR: qlt | caas | mn2 | none
    limiter: str = "mn2"         # cell-local: mn2 | caas | caags | none
    rho_isl: bool = True         # pisl: transport rho by ISL too
    nsub: int = 8                # trajectory substeps per transport step
    # Mass definition for the CDR (-dmc, slmmir.hpp:13-77): 'f'/'eh' use
    # the Homme (GLL) weights, 'es' the spherical basis-function
    # integrals - conservation then holds in that measure.
    dmc: str = "f"
    positive_only: bool = False  # -mono *-pve: nonnegativity only
    fitext: bool = False         # -fitext: quadratic sub-grid bound relaxation
    # Trajectory integration: 'exact' integrates every fine-grid node;
    # 'interp' integrates a coarse np=v_np velocity grid and interpolates
    # departure points to the fine grid (slmmir -timeint interp;
    # VelocityInterpolatorMeshIntegrator, slmmir_time_int.{hpp,cpp});
    # 'line'/'interpline' use the reference's 2-evaluation midpoint study
    # integrator (StudyTimeIntegrator, slmmir_time_int_exp.cpp).
    timeint: str = "exact"
    v_np: int = 4
    # Precision of the geometric pipeline (trajectories, point location,
    # Newton inverse map, basis weights). 'f32' halves the bytes and doubles
    # the arithmetic rate of geometry while every mass-critical stage
    # (interp values, CDR, limiter, DSS, reductions) stays f64, so
    # conservation/bounds invariants are unchanged and only O(1e-7)
    # interpolation-weight noise enters the (1e-2-scale) solution error.
    # 'f64' reproduces the reference tolerances everywhere.
    geom_dtype: str = "f64"
    # Grid rotation spec ((axis), angle) for the -timeint interp coarse
    # velocity grid: it must share the fine mesh's rotation
    # (slmmir.cpp:456-459 rotates geo_p before grid derivation).
    rotate: tuple = None
    # Tracer interpolation precision. With f32 geometry the interp WEIGHTS
    # already carry O(1e-7) noise, so gathering/contracting the tracer
    # VALUES in f32 adds nothing new to the error budget, and moves half
    # the bytes of the f64 gather.
    # Mass is still restored exactly by the f64 CDR (redistribution against
    # the f64 source mass) and bounds by the f64 clip/limiter, so the
    # conservation and shape-preservation invariants are unaffected. 'f64'
    # (default) keeps the strict tracer-consistency tolerance (~3e-15).
    interp_dtype: str = "f64"


class IslTransport:
    """Holds static mesh/basis data + the jitted step."""

    def __init__(self, mesh: cubed_sphere.CubedSphereMesh, wind,
                 config: IslConfig):
        assert mesh.ne == config.ne and mesh.np_ == config.np_
        self.mesh = mesh
        self.config = config
        self.wind = wind
        self.basis = basis_mod.create(config.basis, config.np_)
        self.gll = basis_mod.GLL(config.np_)
        # Derivative matrix at the GLL nodes for the isoparametric Jacobian
        # (the reference always uses plain GLL derivatives here,
        # slmmir_remapper_isl.cpp:178-183).
        self.deriv_at_nodes = self.gll.eval_deriv(self.gll.x)  # (node, bf)
        # Mass definition (dgbfi_mass_, slmmir_remap_data.cpp): Homme (GLL)
        # weights for -dmc f/eh/geh, spherical integrals for -dmc es.
        self.F = (mesh.dgbfi_sphere if config.dmc == "es"
                  else mesh.dgbfi_gll)
        self.d2c_map = mesh.dgll2cgll.reshape(-1)
        # Face-grid DSS (O(perimeter) slice arithmetic; transport/dss_face)
        # when the mesh has the standard numbering, else the gather path.
        # Built with THIS model's mass measure F: d2c conserves exactly the
        # measure it averages with, so -dmc es (sphere measure) must DSS
        # with dgbfi_sphere or every step leaks sphere mass through the
        # inter-element jumps (the round-3 pref0_es_caas cv failure).
        self.face_dss = FaceDss.build(mesh, self.F)
        if config.filter not in ("none", "caas-node"):
            self.mrd = spf.MassRedistributor(mesh.ncell, config.filter)
        else:
            self.mrd = None
        if config.fitext:
            from .fit_extremum import FitExtremum
            self.fitext = FitExtremum(config.np_)
        else:
            self.fitext = None
        if config.timeint in ("interp", "interpline") \
                and config.v_np < config.np_:
            # Coarse velocity grid + fine-node interpolation data.
            self.vmesh = cubed_sphere.build(mesh.ne, config.v_np, "Gll",
                                            rotate=config.rotate)
            vb = basis_mod.GLL(config.v_np)
            # Fine cgll node -> owner cell + ref coords -> coarse basis
            # weights. Nodes with the same local index share weights.
            import numpy as np_mod
            rep = np_mod.asarray(mesh.cgll_rep)
            own_cell = rep // mesh.np2
            k = rep % mesh.np2
            gx = np_mod.asarray(basis_mod.gll_nodes_weights(config.np_)[0])
            a = jnp.asarray(gx[k % mesh.np_])
            b = jnp.asarray(gx[k // mesh.np_])
            va = vb.eval(a)            # (cnn, v_np)
            vbv = vb.eval(b)
            self.v_weights = (vbv[:, :, None] * va[:, None, :]).reshape(
                mesh.cnn, config.v_np ** 2)
            self.v_own_cell = jnp.asarray(own_cell.astype(np_mod.int32))
        else:
            self.vmesh = None
        self._step = jax.jit(self._step_impl)
        self._step_ext = None

    # ------------------------------------------------------------------
    def step(self, rho, q, ts, tf, rho_tgt=None):
        """Advance one transport step from ts to tf.

        rho: (ncell, np2); q: (nt, ncell, np2) mixing ratios. For the
        mixed `isl` method (rho transported by cell-integrated remap,
        slmmir.cpp:1314-1322) pass the remapped target density as
        `rho_tgt`; with rho_isl=False and no rho_tgt, density is held.
        Returns (rho', q').
        """
        # The mesh tables that appear as DIVISORS downstream (F, jac_node)
        # are passed as runtime jit arguments, NOT closed-over constants:
        # XLA rewrites divide-by-constant into multiply-by-reciprocal, and
        # the sharded step (parallel/sharded.py) necessarily receives its
        # table BLOCKS as runtime operands - threading them here keeps the
        # two paths bitwise identical.
        tables = (self.F, self.mesh.jac_node)
        if rho_tgt is None:
            return self._step(rho, q, ts, tf, mesh_tables=tables)
        if self._step_ext is None:
            self._step_ext = jax.jit(self._step_impl)
        return self._step_ext(rho, q, ts, tf, rho_tgt, mesh_tables=tables)

    # ------------------------------------------------------------------
    def _departure_data(self, ts, tf):
        m = self.mesh
        f32 = self.config.geom_dtype == "f32"
        if self.vmesh is not None:
            # Integrate the coarse velocity grid, then interpolate departure
            # points to the fine nodes through each node's owner cell.
            vm = self.vmesh
            vnodes = (vm.cgll_xyz.astype(jnp.float32) if f32
                      else vm.cgll_xyz)
            if self.config.timeint == "interpline":
                vdep = timeint.integrate_line(self.wind.velocity, tf, ts,
                                              vnodes)
            else:
                vdep = timeint.integrate(self.wind.velocity, tf, ts, vnodes,
                                         self.config.nsub)
            vdep_cells = vdep[vm.dgll2cgll]          # (ncell, v_np2, 3)
            dep = timeint.interp_departure(
                self.v_weights.astype(vdep.dtype),
                vdep_cells[self.v_own_cell])
            dep = sphere.normalize(dep)
        else:
            nodes = m.cgll_xyz.astype(jnp.float32) if f32 else m.cgll_xyz
            if self.config.timeint == "line":
                dep = timeint.integrate_line(self.wind.velocity, tf, ts,
                                             nodes)
            else:
                dep = timeint.integrate(self.wind.velocity, tf, ts, nodes,
                                        self.config.nsub)
        if m.nonuni:
            # Nonuniform mesh: inverse-warp + ring-1 Newton selection
            # (cubed_sphere.locate; the reference's octree find_src_cell).
            ci, a, b = cubed_sphere.locate(m, dep)
        else:
            # Warm-started Newton: the closed-form equiangular (or
            # parent-subcell) estimate is O(h^2)-accurate, so a few
            # quadratic iterations reach precision.
            ci, a0, b0 = cubed_sphere.locate(m, dep)
            corners = m.corners[ci]
            if f32:
                corners = corners.astype(jnp.float32)
                tol = 1e1 * float(jnp.finfo(jnp.float32).eps)
                a, b = sqr.sphere_to_ref(corners, dep, max_its=3, tol=tol,
                                         a0=a0, b0=b0)
            else:
                a, b = sqr.sphere_to_ref(corners, dep, max_its=4,
                                         a0=a0, b0=b0)
        va = self.basis.eval(a)          # (cnn, np)
        vb = self.basis.eval(b)
        w = (vb[:, :, None] * va[:, None, :]).reshape(m.cnn, m.np2)
        if f32:
            # dep stays f32: its only downstream use is the departure
            # Jacobian, whose input noise is already f32-level - running
            # that algebra in f64 emulation buys no accuracy (the ratio is
            # cast back to f64 in _step_impl).
            w = w.astype(jnp.float64)
        return dep, ci, w

    def _interp(self, field, ci, w):
        """field: (..., ncell, np2) -> (..., cnn) interpolated at departure
        points. np > 4 uses an explicit left-to-right chain: einsum's
        64-wide reduction lowers batch-shape-dependently, breaking the
        sharded bitwise contract (np4's 16-wide contraction is stable, and
        it is the bench's hot kernel - keep einsum there)."""
        src = field[..., ci, :]                      # (..., cnn, np2)
        if self.mesh.np_ > 4:
            return self._interp_chain(src, w)
        return jnp.einsum('...cx,cx->...c', src, w)

    @staticmethod
    def _interp_chain(src, w):
        acc = src[..., 0] * w[..., 0]
        for k in range(1, w.shape[-1]):
            acc = acc + src[..., k] * w[..., k]
        return acc

    def _dss(self, field, F=None):
        """DSS of a (ncell, np2) or (nt, ncell, np2) field.

        Route: the FaceDss roll-merge path whenever the mesh has the
        standard face-grid numbering (FaceDss.build), else the gather
        formulation (transport/dss.py) - the exact arithmetic the sharded
        step (parallel/sharded.py) reproduces bitwise; callers that compare
        against the sharded step set face_dss = None to select it."""
        with jax.named_scope("dss"):
            if self.face_dss is not None:
                return self.face_dss.dss(field)
            m = self.mesh
            Ff = (self.F if F is None else F).reshape(-1)
            flat = field.reshape(field.shape[:-2] + (-1,))
            if flat.ndim == 2:
                out = dss.dss_gather_t(flat, self.d2c_map, m.c2d_idx,
                                       m.c2d_mask, Ff)
            else:
                out = dss.dss_gather(flat, self.d2c_map, m.c2d_idx,
                                     m.c2d_mask, Ff)
            return out.reshape(field.shape)

    def _dss_q(self, rho_dg, q, F=None):
        """Mixing-ratio DSS; q: (nt, ncell, np2). See _dss for routing."""
        with jax.named_scope("dss"):
            if self.face_dss is not None:
                return self.face_dss.dss_q(rho_dg, q)
            m = self.mesh
            Ff = (self.F if F is None else F).reshape(-1)
            out = dss.dss_q_gather_t(rho_dg.reshape(-1),
                                     q.reshape(q.shape[0], -1), self.d2c_map,
                                     m.c2d_idx, m.c2d_mask, Ff)
            return out.reshape(q.shape)

    def _jacobian_cells(self, pc):
        """Isoparametric |J| for cells whose nodal departure positions are
        pc (..., np, np, 3) in [j, i] layout. The D-contractions are
        EXPLICITLY left-to-right associated elementwise chains (not
        einsum/dot_general, whose reduction association is
        batch-shape-dependent) so the sharded step - which evaluates the
        same cells in per-shard blocks - reproduces the single-chip bits."""
        m = self.mesh
        D = self.deriv_at_nodes.astype(pc.dtype)     # (node, basisfn)
        # Cells-last (lanes-last) layout: every elementwise op vectorizes
        # over the cell axis instead of the 3-wide coordinate axis (a
        # (cells, ..., 3) layout puts 3 elements per 128-lane vector).
        # The arithmetic chain (explicit left-to-right) is unchanged, so
        # the values are bitwise identical to the cells-first form.
        lead = pc.shape[:-3]
        pcT = jnp.moveaxis(pc.reshape((-1,) + pc.shape[-3:]), 0, -1)
        # pcT: (j, i, d, cells).
        f = pcT
        # fa[j, t, d, c] = sum_i D[t, i] pcT[j, i, d, c]; fb likewise
        # along j.
        fa = D[None, :, 0, None, None] * pcT[:, 0, None, :, :]
        fb = D[:, 0, None, None, None] * pcT[0][None, :, :, :]
        for i in range(1, m.np_):
            fa = fa + D[None, :, i, None, None] * pcT[:, i, None, :, :]
            fb = fb + D[:, i, None, None, None] * pcT[i][None, :, :, :]

        def dot_d(a, b):
            return (a[..., 0, :] * b[..., 0, :]
                    + a[..., 1, :] * b[..., 1, :]) \
                + a[..., 2, :] * b[..., 2, :]

        def cross_d(a, b):
            a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
            b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
            return jnp.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                              a0 * b1 - a1 * b0], axis=-2)

        r2 = dot_d(f, f)[..., None, :]               # (j, i, 1, c)
        r = jnp.sqrt(r2)
        ua = (fa - f * (dot_d(f, fa)[..., None, :] / r2)) / r
        ub = (fb - f * (dot_d(f, fb)[..., None, :] / r2)) / r
        cr = cross_d(ua, ub)
        jac = jnp.sqrt(dot_d(cr, cr))                # (j, i, cells)
        jac = jnp.moveaxis(jac, -1, 0)               # (cells, j, i)
        return jac.reshape(lead + (m.np2,))

    def _jacobian_departure(self, dep):
        """Isoparametric |J| of the departure mesh at every DGLL node
        (slmmir_remapper_isl.cpp:152-224, calc_isoparametric_jacobian).
        Runs at the dtype of dep (f32 geometry stays native f32)."""
        m = self.mesh
        # Departure positions of each cell's np x np nodes, [j, i] layout.
        pc = dep[m.dgll2cgll].reshape(m.ncell, m.np_, m.np_, 3)
        return self._jacobian_cells(pc)

    def footprint_stats(self, ts, tf):
        """ISL communication-footprint statistics for the step ts->tf
        (FootprintTracker, slmmir_remapper_isl.cpp:291-355): per target
        cell, the number of departure nodes whose source cell is foreign,
        plus 2 per unique foreign source cell (the min/max of the source
        element); returns (min, median, mean, max) over cells."""
        import numpy as np
        m = self.mesh
        _, ci, _ = self._departure_data(ts, tf)
        node_src = np.asarray(ci)[np.asarray(self.d2c_map)].reshape(
            m.ncell, m.np2)
        tgt = np.arange(m.ncell)[:, None]
        out = node_src != tgt
        nout = out.sum(axis=1)
        s = np.sort(np.where(out, node_src, -1), axis=1)
        nuniq = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(axis=1)
        nuniq = nuniq + (s[:, 0] >= 0)
        nout = nout + 2 * nuniq
        med = np.partition(nout, len(nout) // 2)[len(nout) // 2]
        return int(nout.min()), int(med), float(nout.mean()), int(nout.max())

    def phase_times(self, rho, q, ts, tf, iters: int = 10):
        """Per-phase wall times of one step (the reference's SLMM_TIME
        Timer breakdown, slmmir.hpp:253-299): each separable phase is
        jitted and timed on its own; the CDR+limiter share is the residual
        of the full step. Returns an ordered {phase: sec} dict."""
        import time as _time

        def tm(fn, *args):
            out = fn(*args)                       # compile + warm
            jax.block_until_ready(out)
            t0 = _time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
            return (_time.perf_counter() - t0) / iters, out

        t = {}
        dep_fn = jax.jit(self._departure_data)
        t["departure"], (dep, ci, w) = tm(dep_fn, ts, tf)

        f32 = self.config.interp_dtype == "f32"

        def interp_scatter(q, ci, w):
            if f32:
                qi = self._interp(q.astype(jnp.float32), ci,
                                  w.astype(jnp.float32)).astype(jnp.float64)
            else:
                qi = self._interp(q, ci, w)
            return jnp.moveaxis(
                jnp.moveaxis(qi, 0, -1)[self.d2c_map], -1, 0).reshape(
                    q.shape[0], self.mesh.ncell, self.mesh.np2)

        t["tracer interp+scatter"], q_tgt = tm(
            jax.jit(interp_scatter), q, ci, w)
        if self.config.rho_isl:
            def rho_phase(rho, dep, ci, w):
                if self.config.interp_dtype == "f32":
                    f32_ = jnp.float32
                    ri = self._interp(rho.astype(f32_), ci, w.astype(f32_))
                    Jdep = self._jacobian_departure(dep)
                    ratio32 = Jdep.astype(f32_) \
                        / self.mesh.jac_node.astype(f32_)
                    return (ratio32 * ri[self.d2c_map].reshape(
                        self.mesh.ncell, self.mesh.np2)).astype(jnp.float64)
                ri = self._interp(rho, ci, w)
                Jdep = self._jacobian_departure(dep)
                ratio = Jdep.astype(self.mesh.jac_node.dtype) \
                    / self.mesh.jac_node
                return ratio * ri[self.d2c_map].reshape(
                    self.mesh.ncell, self.mesh.np2)
            t["rho interp+jacobian"], rho_tgt = tm(
                jax.jit(rho_phase), rho, dep, ci, w)
        else:
            rho_tgt = rho
        t["dss_q"], _ = tm(jax.jit(self._dss_q), rho_tgt, q_tgt)
        # The PRODUCTION step (mesh tables threaded as runtime operands -
        # the constant-folded variant compiles to a different program).
        t["full step"], _ = tm(lambda *a: self.step(*a), rho, q, ts, tf)
        t["cdr+limiter (residual)"] = t["full step"] - sum(
            v for k, v in t.items() if k != "full step")
        return t

    # ------------------------------------------------------------------
    def _step_impl(self, rho, q, ts, tf, rho_tgt_ext=None, mesh_tables=None):
        cfg = self.config
        m = self.mesh
        # See step(): mesh_tables threads (F, jac_node) as runtime operands
        # so divides by them are not constant-folded into reciprocal
        # multiplies (bitwise parity with the sharded step).
        if mesh_tables is not None:
            F, jac_node = mesh_tables
        else:
            F, jac_node = self.F, m.jac_node
        with jax.named_scope("departure"):
            dep, ci, w = self._departure_data(ts, tf)
        node_src_flat = None

        # --- Density transport + tracer interpolation.
        with jax.named_scope("interp"):
            if cfg.interp_dtype == "f32" and cfg.rho_isl:
                # f32 path: the CDR restores mass against the f64 pre-step
                # masses and the bounds in f64, so the invariants are
                # unchanged. ci (as exact small-int f32), the interpolated
                # rho, and the interpolated tracers share ONE wide-row d2c
                # gather - three scalar/narrow gathers fused into one (pure
                # copies, so every downstream value is bitwise what the
                # separate gathers gave).
                f32 = jnp.float32
                w32 = w.astype(f32)
                ri = self._interp(rho.astype(f32), ci, w32)   # (cnn,)
                qi = self._interp(q.astype(f32), ci, w32)     # (nt, cnn)
                pack = jnp.concatenate(
                    [ci.astype(f32)[:, None], ri[:, None],
                     jnp.moveaxis(qi, 0, -1)], axis=1)        # (cnn, nt+2)
                g = pack[self.d2c_map]                        # (ndgll, nt+2)
                node_src_flat = g[:, 0].astype(jnp.int32)
                Jdep = self._jacobian_departure(dep)
                ratio32 = Jdep.astype(f32) / jac_node.astype(f32)
                rho_tgt = (ratio32 * g[:, 1].reshape(
                    m.ncell, m.np2)).astype(jnp.float64)
                q_tgt = jnp.moveaxis(g[:, 2:], -1, 0).astype(jnp.float64) \
                    .reshape(q.shape[0], m.ncell, m.np2)
            else:
                if cfg.rho_isl:
                    rho_interp = self._interp(rho, ci, w)     # (cnn,)
                    Jdep = self._jacobian_departure(dep)      # (ncell, np2)
                    ratio = Jdep.astype(jac_node.dtype) / jac_node
                    rho_tgt = ratio * rho_interp[self.d2c_map].reshape(
                        m.ncell, m.np2)
                elif rho_tgt_ext is not None:
                    rho_tgt = rho_tgt_ext
                else:
                    rho_tgt = rho
                if cfg.interp_dtype == "f32":
                    q_interp = self._interp(
                        q.astype(jnp.float32), ci,
                        w.astype(jnp.float32)).astype(jnp.float64)
                else:
                    q_interp = self._interp(q, ci, w)         # (nt, cnn)
                # Scatter to DGLL slots tracer-innermost: indexing the last
                # axis of (nt, cnn) gathers scalars; (cnn, nt) rows are
                # nt-wide.
                q_tgt = jnp.moveaxis(
                    jnp.moveaxis(q_interp, 0, -1)[self.d2c_map], -1,
                    0).reshape(q.shape[0], m.ncell, m.np2)

        if cfg.filter == "none":
            rho_out = (self._dss(rho_tgt, F) if cfg.rho_isl else rho_tgt)
            q_out = self._dss_q(rho_out, q_tgt, F)
            return rho_out, q_out

        # --- CDR for rho (isl_cdr_rho, slmmir_remapper_isl.cpp:1240-1289).
        with jax.named_scope("rho_cdr"):
            Ff = F.reshape(-1)
            if cfg.rho_isl and cfg.filter == "caas-node":
                # Global-only nodal filter: uniform mass restoration
                # (glbl_only_pve, slmmir_remapper_isl.cpp:366-387).
                mm = bfb_sum_cells(jnp.stack([F * rho, F * rho_tgt]))
                mass_src, mass_tgt = mm[0], mm[1]
                rho_tgt = rho_tgt + (mass_src - mass_tgt) / bfb_sum(Ff)
                rho_tgt = self._dss(rho_tgt, F)
            elif cfg.rho_isl:
                mm = bfb_sum_cells(jnp.stack([F * rho, F * rho_tgt]))
                mass_src, mass_tgt = mm[0], mm[1]
                # Bounds [0, 2] on cell-mean density (reference
                # record(ti,0,2,..)).
                rho_mass, R_min, R_mass, R_max = spf.record(
                    F, rho_tgt, rho_tgt,
                    jnp.zeros_like(rho_tgt), jnp.full_like(rho_tgt, 2.0))
                redist = self.mrd.redistribute(
                    rho_mass, R_min, R_mass, R_max, mass_src - mass_tgt)
                delta = redist - R_mass
                rho_tgt = limiter_mod.limit_density(F, rho_tgt, delta)
                rho_tgt = self._dss(rho_tgt, F)

        # --- CDR for tracers (isl_cdr, :1292-1455), vectorized over nt.
        Q_tgt = q_tgt * rho_tgt[None]
        QQ = bfb_sum_cells(jnp.stack([F[None] * q * rho[None],
                                      F[None] * Q_tgt]))
        Q_mass_src, Q_mass_tgt = QQ[0], QQ[1]

        # Source-cell q bounds -> per-target-node bounds via the departure
        # cell of each node. Positive-only filters (-mono qlt-pve;
        # Filter::is_positive_only, slmmir.hpp:167-169) replace them with
        # the fixed [0, 2] record of slmmir_remapper_isl.cpp:1332-1336.
        if cfg.positive_only:
            q_min_node = jnp.zeros_like(q_tgt)
            q_max_node = jnp.full_like(q_tgt, 2.0)
            rhom = F[None] * rho_tgt[None]
            Qc_min = jnp.zeros(Q_tgt.shape[:2], Q_tgt.dtype)
            Qc_max = 2.0 * jnp.sum(rhom, axis=-1)
            Qc_mass = jnp.sum(F[None] * Q_tgt, axis=-1)
            redist = self.mrd.redistribute(
                jnp.sum(F * rho_tgt, axis=-1), Qc_min, Qc_mass, Qc_max,
                Q_mass_src - Q_mass_tgt)
            delta = redist - Qc_mass
            # Local step: the nonnegativity limiter on the tracer MASSES
            # (md.limit_density(ti, tgti, Qm_extra),
            # slmmir_remapper_isl.cpp:1400-1402).
            Q_tgt = jax.vmap(
                lambda Qi, di: limiter_mod.limit_density(F, Qi, di))(
                    Q_tgt, delta)
            # Q -> q without the bounds clip (:1443-1449: zero-density
            # nodes get 0; no min/max cleanup in the positive-only path).
            rho_inv = 1.0 / jnp.where(rho_tgt == 0, 1.0, rho_tgt)
            q_new = jnp.where(rho_tgt[None] == 0, 0.0,
                              Q_tgt * rho_inv[None])
            q_out = self._dss_q(rho_tgt, q_new, F)
            return rho_tgt, q_out

        q_min_cell = jnp.min(q, axis=-1)                     # (nt, ncell)
        q_max_cell = jnp.max(q, axis=-1)
        if self.fitext is not None:
            # Relax bounds toward reconstructed sub-grid extrema
            # (slmmir_remapper_isl.cpp:1355-1365).
            fmin, fmax, fuse = self.fitext.calc(q)
            q_min_cell = jnp.where(fuse, jnp.minimum(q_min_cell, fmin),
                                   q_min_cell)
            q_max_cell = jnp.where(fuse, jnp.maximum(q_max_cell, fmax),
                                   q_max_cell)
        node_src_cell = (node_src_flat if node_src_flat is not None
                         else ci[self.d2c_map]).reshape(m.ncell, m.np2)

        # Tracer-innermost bounds gather (wide rows; see q_tgt above).
        qmm = jnp.stack([q_min_cell, q_max_cell])            # (2, nt, ncell)
        qmm_n = jnp.moveaxis(
            jnp.moveaxis(qmm, (0, 1), (-2, -1))[node_src_cell], (-2, -1),
            (0, 1))                                          # (2, nt, nc, np2)
        q_min_node, q_max_node = qmm_n[0], qmm_n[1]

        if cfg.filter == "caas-node":
            # Global-only node-granularity CAAS (glbl_only_lcldyn,
            # slmmir_remapper_isl.cpp:389-445): a RELAXED-bounds cell-local
            # prefilter (limit_tracer with bounds widened by
            # lcl_cdr_relax_fac=1e-2 of the range, expandable, zero mass
            # delta - :1405-1412, :471), then clip every node's tracer
            # mass to its strict source bounds and distribute the global
            # mass discrepancy proportionally to remaining nodal headroom.
            nt_ = q.shape[0]
            if cfg.limiter != "none":
                rel = 1e-2 * (q_max_node - q_min_node)
                lim = jax.vmap(
                    lambda Qi, qmin, qmax: limiter_mod.limit_tracer(
                        F, rho_tgt, Qi, qmin, qmax,
                        jnp.zeros(Qi.shape[0], Qi.dtype),
                        limiter=cfg.limiter, expand_bounds_allowed=True))
                # Per-cell mass is conserved exactly (Qm_extra = 0), so the
                # pre-prefilter Q_mass_tgt stays the right global target.
                Q_tgt = lim(Q_tgt, q_min_node - rel, q_max_node + rel)
            lo = (q_min_node * rho_tgt[None]).reshape(nt_, -1)
            hi = (q_max_node * rho_tgt[None]).reshape(nt_, -1)
            aF = jnp.broadcast_to(Ff[None], lo.shape)
            # Fixed-tree global sums (bfb_sum) so the sharded caas-node
            # path can reproduce this solve bitwise with its distributed
            # BFB reducer.
            Qf = local_qp.caas_gsum(aF, Q_mass_src, lo, hi,
                                    Q_tgt.reshape(nt_, -1), gsum=bfb_sum)
            Q_tgt = Qf.reshape(Q_tgt.shape)
            rho_inv = 1.0 / jnp.where(rho_tgt == 0, 1.0, rho_tgt)
            q_new = jnp.where(rho_tgt[None] == 0, q_min_node,
                              Q_tgt * rho_inv[None])
            q_new = jnp.clip(q_new, q_min_node, q_max_node)
            q_out = self._dss_q(rho_tgt, q_new, F)
            return rho_tgt, q_out

        # Per-cell records (nt-batched).
        rhom1 = F * rho_tgt                        # (ncell, np2)
        rhom = rhom1[None]
        Qc_min = jnp.sum(rhom * q_min_node, axis=-1)
        Qc_max = jnp.sum(rhom * q_max_node, axis=-1)
        Qc_mass = jnp.sum(F[None] * Q_tgt, axis=-1)

        redist = self.mrd.redistribute(
            jnp.sum(F * rho_tgt, axis=-1), Qc_min, Qc_mass, Qc_max,
            Q_mass_src - Q_mass_tgt)
        delta = redist - Qc_mass                             # (nt, ncell)

        if cfg.limiter != "none":
            # Hand the limiter the records this CDR already computed
            # (bitwise-identical expressions; saves ~3 full passes over
            # the tracer state), and take its mixing-ratio solution
            # directly - it is already bounds-clipped, so the Q -> q round
            # trip (x*rho*(1/rho) + re-clip) is pure added rounding
            # (round-3 CDR+limiter perf ask).
            Qm_tot = Qc_mass + delta
            lim = jax.vmap(
                lambda Qi, qmin, qmax, di, qt, qn, qx:
                limiter_mod.limit_tracer(
                    F, rho_tgt, Qi, qmin, qmax, di, limiter=cfg.limiter,
                    precomp=(rhom1, qt, qn, qx), return_q=True))
            x_q = lim(Q_tgt, q_min_node, q_max_node, delta, Qm_tot,
                      Qc_min, Qc_max)
            q_new = jnp.where(rho_tgt[None] == 0, q_min_node, x_q)

        # limiter='none': Q -> q with zero-density guard and
        # numerical-noise clip (:1429-1452).
        if cfg.limiter == "none":
            rho_inv = 1.0 / jnp.where(rho_tgt == 0, 1.0, rho_tgt)
            q_new = jnp.where(rho_tgt[None] == 0, q_min_node,
                              Q_tgt * rho_inv[None])
            q_new = jnp.clip(q_new, q_min_node, q_max_node)

        # --- DSS for tracers (mixing-ratio form; slmmir.cpp:1335-1339).
        if rho_tgt_ext is not None:
            # Mixed `isl` method: DSS density and tracer masses together
            # after the CDR (slmmir.cpp:1335-1339 with dss_rho=true).
            Q = q_new * rho_tgt[None]
            rho_out = self._dss(rho_tgt, F)
            Q_out = self._dss(Q, F)
            q_out = Q_out / jnp.where(rho_out == 0, 1.0, rho_out)[None]
            # Clip the Q/rho roundoff to the coincident-node range of the
            # pre-DSS (already bounds-clipped) q - same per-node clip
            # philosophy as d2c (slmmir_d2c.cpp:108-113); continuity-safe
            # because the bounds are per continuous node.
            nt_ = q.shape[0]
            qf = q_new.reshape(nt_, -1)
            vals = qf[..., m.c2d_idx]
            qn_min = jnp.min(jnp.where(m.c2d_mask, vals, jnp.inf), -1)
            qn_max = jnp.max(jnp.where(m.c2d_mask, vals, -jnp.inf), -1)
            q_out = jnp.clip(q_out.reshape(nt_, -1),
                             qn_min[..., self.d2c_map],
                             qn_max[..., self.d2c_map]).reshape(q_out.shape)
            return rho_out, q_out
        q_out = self._dss_q(rho_tgt, q_new, F)
        return rho_tgt, q_out

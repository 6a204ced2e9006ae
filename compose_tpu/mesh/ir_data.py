"""Static data for the cell-integrated remap (IR/CDG).

Counterpart of the reference's RemapData setup
(/root/reference/methods/slmm/slmmir_remap_data.cpp): per-cell full mass
matrix (assembled by triangle quadrature on the sphere, then Cholesky
factored) plus what the array-based redesign needs instead of the octree:

  - a deduplicated corner-vertex array + cell->vertex map, so advected cells
    stay watertight (every cell sees bitwise-identical advected corners);
  - exact inward edge normals for the Eulerian cells (the reference stresses
    normals must be computed accurately offline, siqk_intersect.hpp:23-30;
    for the equiangular cubed sphere they are closed-form);
  - a static 2-ring neighbor table (<= 25 candidates incl. self) replacing
    the octree hit search: the overlap footprint is CFL-bounded
    (slmmir_remapper.cpp:7, max_hits = 25 'covers at least a 2-halo').
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from .. import basis as basis_mod
from ..ops import quadrature, sphere, sqr
from . import cubed_sphere

MAX_CANDS = 25


@dataclasses.dataclass(frozen=True)
class IrData:
    vert_xyz: jnp.ndarray       # (nvert, 3) unique cell corner vertices
    cell2vert: jnp.ndarray      # (ncell, 4) int32
    edge_nmls: jnp.ndarray      # (ncell, 4, 3) inward edge normals
    cands: jnp.ndarray          # (ncell, MAX_CANDS) int32 candidate src cells
    cands_mask: jnp.ndarray     # (ncell, MAX_CANDS) bool
    chol: jnp.ndarray           # (ncell, np2, np2) Cholesky factors of M
    tq_bary: jnp.ndarray        # (nq, 3)
    tq_w: jnp.ndarray           # (nq,)
    # Facet-transport extras (Dmc::is_facet, slmmir.hpp:71-76): the mass
    # matrix becomes the ref-square GLL mass matrix (identical per cell,
    # CalcM facet branch, slmmir_remap_data.cpp:149-182) and the transported
    # field is (rho J) with J the ref->sphere node Jacobian
    # (RemapData::apply_T_cell, slmmir_remap_data.cpp:283-307).
    chol_ref: jnp.ndarray       # (np2, np2) Cholesky of ref-square mass mat
    Jt: jnp.ndarray             # (ncell, np2) node Jacobians (slmmir_util
    #                             .cpp:26-41)
    gll_w2: jnp.ndarray         # (np2,) tensor GLL weights w_i*w_j


_CACHE = {}


def build(mesh: cubed_sphere.CubedSphereMesh, tq_order: int = None) -> IrData:
    rot = (None if mesh.rot_R is None
           else tuple(np.asarray(mesh.rot_R).ravel().tolist()))
    # The key must separate meshes that share (ne, np): a gllsubcell
    # ne5/np4 mesh, a runisubcell ne5/np4 mesh, and a geometric ne15/np2
    # mesh all present as ne=15, np=2 but have different vertex geometry -
    # include the subcell identity (parent ne + break positions).
    sub = (mesh.sub_parent_ne,
           None if mesh.sub_breaks is None
           else tuple(np.asarray(mesh.sub_breaks).tolist()))
    key = (mesh.ne, mesh.np_, tq_order, rot, mesh.nonuni, sub)
    if key not in _CACHE:
        _CACHE[key] = _build(mesh, tq_order)
    return _CACHE[key]


def _build(mesh, tq_order):
    ne, np_ = mesh.ne, mesh.np_
    ncell, np2 = mesh.ncell, mesh.np2
    # slmmir default for IR (slmmir.cpp:1816-1822).
    m_order = {3: 14, 4: 18, 5: 20}.get(np_, 8 if np_ < 3 else 20)
    if tq_order is None:
        tq_order = m_order
    # The mass matrix is one-time setup data; it always uses the
    # accuracy-matched order (a reduced -tq like 4 underspans the np^2
    # basis products for np > 2 and would make M singular - the reference
    # only combines -tq 4 with np=2 subcell transport,
    # slmm_runtests.py:244-265).
    m_order = max(m_order, tq_order)

    corners = np.asarray(mesh.corners)               # (ncell, 4, 3)

    # --- Unique corner vertices via the same integer cube keys as the CGLL
    # numbering (cubed_sphere._face_key with lattice N = ne).
    f_idx, iy, ix = np.unravel_index(np.arange(ncell), (6, ne, ne))
    # Corner lattice coords (gx, gy) per CCW corner: (ix,iy), (ix+1,iy),
    # (ix+1,iy+1), (ix,iy+1).
    gx = np.stack([ix, ix + 1, ix + 1, ix], axis=-1)   # (ncell, 4)
    gy = np.stack([iy, iy, iy + 1, iy + 1], axis=-1)
    gx2 = 2 * gx.astype(np.int64) - ne
    gy2 = 2 * gy.astype(np.int64) - ne
    keys = np.empty((ncell, 4, 3), np.int64)
    for f in range(6):
        sel = f_idx == f
        keys[sel] = cubed_sphere._face_key(f, gx2[sel], gy2[sel], ne)
    uniq, first, inverse = np.unique(keys.reshape(-1, 3), axis=0,
                                     return_index=True, return_inverse=True)
    cell2vert = inverse.astype(np.int32).reshape(ncell, 4)
    vert_xyz = corners.reshape(-1, 3)[first]

    # --- Inward edge normals from the canonical vertex coordinates. Using
    # the SAME vertex array on both sides of an edge makes adjacent cells'
    # clip planes identical up to sign, keeping the tiling watertight.
    v = vert_xyz[cell2vert]                           # (ncell, 4, 3)
    nml = np.cross(v, np.roll(v, -1, axis=1))
    nml /= np.linalg.norm(nml, axis=-1, keepdims=True)

    # --- 2-ring candidate table.
    v2c = {}
    for c in range(ncell):
        for k in range(4):
            v2c.setdefault(cell2vert[c, k], []).append(c)
    ring1 = [set() for _ in range(ncell)]
    for c in range(ncell):
        for k in range(4):
            ring1[c].update(v2c[cell2vert[c, k]])
    cands = np.full((ncell, MAX_CANDS), -1, np.int32)
    mask = np.zeros((ncell, MAX_CANDS), bool)
    for c in range(ncell):
        r2 = set()
        for c1 in ring1[c]:
            r2.update(ring1[c1])
        r2 = sorted(r2)
        assert len(r2) <= MAX_CANDS, (c, len(r2))
        cands[c, :len(r2)] = r2
        mask[c, :len(r2)] = True
    cands[~mask] = 0  # safe gather index; masked out in use

    # --- Full mass matrix per cell + Cholesky (slmmir_remap_data.cpp:118-231).
    bary, qw = quadrature.get_coef(m_order)
    jb = jnp.asarray(bary)
    jqw = jnp.asarray(qw)
    jc = mesh.corners
    gll = basis_mod.GLL(np_)
    M = 0.0
    for (k1, k2) in ((1, 2), (2, 3)):
        v1 = jc[:, 0, :][:, None, :]
        v2 = jc[:, k1, :][:, None, :]
        v3 = jc[:, k2, :][:, None, :]
        jac, pq = sphere.tri_jacobian(v1, v2, v3, jb[None, :, :])
        al, be = sqr.sphere_to_ref(jc[:, None, :, :], pq)
        gi = gll.eval(al)
        gj = gll.eval(be)
        phi = (gj[..., :, None] * gi[..., None, :]).reshape(
            ncell, -1, np2)                          # (ncell, nq, np2)
        M = M + jnp.einsum('q,cq,cqa,cqb->cab', 0.5 * jqw, jac, phi, phi)
    chol = jnp.linalg.cholesky(M)

    # --- Facet extras: exact ref-square mass matrix (tensor product of the
    # 1-D Lagrange mass matrix, integrated by Gauss-Legendre of sufficient
    # order) and node Jacobians of the corner-bilinear sphere map.
    gx, gw = np.polynomial.legendre.leggauss(np_ + 2)
    gv = np.asarray(gll.eval(jnp.asarray(gx)))        # (ngauss, np)
    M1 = np.einsum('q,qa,qb->ab', gw, gv, gv)
    M_ref = np.kron(M1, M1)                           # (np2, np2), [j*np+i]
    chol_ref = jnp.linalg.cholesky(jnp.asarray(M_ref))
    xn = np.asarray(gll.x)
    A = jnp.asarray(np.tile(xn, np_))                 # (np2,) a coords
    B = jnp.asarray(np.repeat(xn, np_))               # (np2,) b coords
    Jt = sqr.bilinear_jacobian_norm(
        jc[:, None, :, :], A[None, :], B[None, :])    # (ncell, np2)
    w1 = np.asarray(gll.w)
    gll_w2 = jnp.asarray(np.repeat(w1, np_) * np.tile(w1, np_))

    return IrData(
        vert_xyz=jnp.asarray(vert_xyz),
        cell2vert=jnp.asarray(cell2vert),
        edge_nmls=jnp.asarray(nml),
        cands=jnp.asarray(cands),
        cands_mask=jnp.asarray(mask),
        chol=chol,
        tq_bary=jnp.asarray(quadrature.get_coef(tq_order)[0]),
        tq_w=jnp.asarray(quadrature.get_coef(tq_order)[1]),
        chol_ref=chol_ref,
        Jt=Jt,
        gll_w2=gll_w2,
    )

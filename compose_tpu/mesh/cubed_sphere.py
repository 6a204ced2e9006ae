"""Quasiuniform equiangular cubed-sphere spectral-element mesh.

Array-based counterpart of /root/reference/methods/slmm/slmm_mesh.cpp. The
reference builds six planar meshes, stitches shared vertices by bookkeeping,
and derives CGLL/DGLL numberings by sequential traversal. Here everything is
closed-form and array-based:

  - Cell (face, iy, ix) has id face*ne^2 + iy*ne + ix; its corners are images
    of the equiangular box corners under the face's gnomonic frame. The cell
    ordering and face frames match the reference's `get_cell_idx`
    (slmm_mesh.cpp:751-806), so point location is O(1) index arithmetic - no
    octree on the hot path.
  - All np^2 nodes of a cell are the bilinear-sphere-map images of the
    reference-square GLL grid over the cell corners. (This is exactly what
    the reference's make_cgll_from_geo chord-interpolation construction
    produces - lerp of lerps == bilinear - followed by one normalization;
    slmm_mesh.cpp:259-353.)
  - The CGLL (continuous) numbering is combinatorial: each node gets an exact
    integer key on the cube surface, so shared nodes dedupe without floating
    point tolerance games. This stays robust at any resolution.

Mesh construction runs once on the host in numpy; the result is a pytree of
static jnp arrays the jitted transport step closes over.
"""

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import basis as basis_mod
from ..ops import quadrature, sphere, sqr

# Python float (not np.float64): numpy scalars are strongly typed in jax and
# would silently promote float32 geometry pipelines back to f64.
_QUARTER_PI = float(0.25 * np.pi)


def _face_point(face, X, Y):
    """Map gnomonic coords (X, Y) (tangents, in [-1,1]) on `face` to an
    (unnormalized) cube point. Frames follow the reference's face transforms
    (slmm_mesh.cpp:108-137) and agree with get_cell_idx's face coords."""
    O = np.ones_like(X)
    if face == 0:
        return np.stack([X, -O, Y], axis=-1)
    if face == 1:
        return np.stack([O, X, Y], axis=-1)
    if face == 2:
        return np.stack([-X, O, Y], axis=-1)
    if face == 3:
        return np.stack([-O, -X, Y], axis=-1)
    if face == 4:
        return np.stack([X, Y, O], axis=-1)
    return np.stack([-X, Y, -O], axis=-1)


def _face_key(face, gx2, gy2, N):
    """Exact integer cube-surface key for a face lattice point, where
    gx2 = 2*gx - N in [-N, N]. Shared edge/corner nodes from different faces
    produce identical keys."""
    O = np.full_like(gx2, N)
    if face == 0:
        k = (gx2, -O, gy2)
    elif face == 1:
        k = (O, gx2, gy2)
    elif face == 2:
        k = (-gx2, O, gy2)
    elif face == 3:
        k = (-O, -gx2, gy2)
    elif face == 4:
        k = (gx2, gy2, O)
    else:
        k = (-gx2, gy2, -O)
    return np.stack(k, axis=-1)


@dataclasses.dataclass(frozen=True)
class CubedSphereMesh:
    """Static mesh data. All jnp arrays; safe to close over in jit."""
    ne: int
    np_: int                      # nodes per cell edge
    ncell: int
    cnn: int                      # number of unique (continuous) nodes
    basis_name: str
    corners: jnp.ndarray          # (ncell, 4, 3) cell corner unit vectors
    cell_nodes_xyz: jnp.ndarray   # (ncell, np, np, 3) node positions [j, i]
    dgll2cgll: jnp.ndarray        # (ncell, np*np) int32 -> continuous node id
    cgll_xyz: jnp.ndarray         # (cnn, 3) canonical node coordinates
    cgll_rep: jnp.ndarray         # (cnn,) int32: a representative dgll index
    # Inverse map: the (<= 4) DGLL slots coinciding at each continuous node,
    # padded (gather-based DSS: no scatter-add, so no atomics).
    c2d_idx: jnp.ndarray          # (cnn, 4) int32
    c2d_mask: jnp.ndarray         # (cnn, 4) bool
    jac_node: jnp.ndarray         # (ncell, np*np) corner-bilinear |J| at nodes
    dgbfi_gll: jnp.ndarray        # (ncell, np*np) Homme mass weights
    dgbfi_sphere: jnp.ndarray     # (ncell, np*np) spherical basis integrals
    basis_x: jnp.ndarray          # (np,) basis node coords
    basis_w: jnp.ndarray          # (np,) basis weights (islet-modified if any)
    rot_R: jnp.ndarray = None     # (3,3) grid rotation, or None
    # Nonuniform warp (slmm_mesh.cpp:808-833, make_nonuniform): the analytic
    # diffeomorphism lets point location stay O(1) - invert the warp, use
    # the equiangular index for a candidate, then pick among its ring-1
    # neighbors by the Newton inverse (replacing the reference's octree).
    warp_R: jnp.ndarray = None    # (3,3) warp rotation, or None (uniform)
    ring1: jnp.ndarray = None     # (ncell, 9) int32 corner-sharing neighbors
    ring1_mask: jnp.ndarray = None
    # Subcell meshes (MeshType gllsubcell/runisubcell, slmmir.hpp:79-107;
    # make_cubedsphere_subcell_mesh, slmm_mesh.hpp:50-62): each geometric
    # parent cell is split into (np_geo-1)^2 np=2 subcells at GLL or
    # uniform break points of the parent's reference square. Point location
    # goes parent-first: equiangular index + Newton on the parent, then a
    # searchsorted over the static breaks.
    sub_parent_ne: int = 0        # parent ne (0 = not a subcell mesh)
    sub_breaks: jnp.ndarray = None        # (np_geo,) ref-square breaks
    sub_parent_corners: jnp.ndarray = None  # (6*ne^2, 4, 3)

    @property
    def is_subcell(self):
        return self.sub_parent_ne > 0

    @property
    def np2(self):
        return self.np_ * self.np_

    @property
    def nonuni(self):
        return self.warp_R is not None


_BUILD_CACHE = {}


def form_rotation(axis, angle):
    """Rodrigues rotation matrix about `axis` by `angle` (the reference's
    form_rotation, slmm_util)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


_WARP_F = 0.5  # squash factor (make_nonuniform, slmm_mesh.cpp:811)


def _warp_points(p, R, inverse=False):
    """Nonuniform warp w(p) = R' normalize(S (R p)), S = diag(1, f, f)
    (make_nonuniform, slmm_mesh.cpp:808-833); inverse uses S^{-1}. Works on
    numpy (build time) and jnp (traced) arrays alike."""
    xp = jnp if isinstance(p, jnp.ndarray) else np
    f = (1.0 / _WARP_F) if inverse else _WARP_F
    Rm = xp.asarray(R)
    if xp is jnp:
        Rm = Rm.astype(p.dtype)
    # Reference: p1 = R' p; scale (1, f, f); normalize; p' = R p1.
    q = p @ Rm
    q = q * xp.asarray([1.0, f, f]).astype(q.dtype)
    q = q / xp.sqrt((q * q).sum(-1))[..., None]
    return q @ Rm.T


def build(ne: int, np_: int = 4, basis_name: str = "GllNodal",
          tq_order: int = 18, rotate=None, nonuni=False,
          mesh_type: str = "geometric") -> CubedSphereMesh:
    """Cached mesh construction (meshes are static data). `rotate` is an
    optional (axis, angle) grid rotation (slmmir -rotate-grid,
    slmm_mesh.cpp:835-848); `nonuni` applies the reference's nonuniform
    warp (slmmir -nonunimesh); `mesh_type` in {geometric, gllsubcell,
    runisubcell} selects the subcell refinements (np forced to 2 there,
    slmmir.cpp:445)."""
    key = (ne, np_, basis_name, tq_order,
           None if rotate is None else (tuple(rotate[0]), rotate[1]), nonuni,
           mesh_type)
    if key not in _BUILD_CACHE:
        _BUILD_CACHE[key] = _build(ne, np_, basis_name, tq_order, rotate,
                                   nonuni, mesh_type)
    return _BUILD_CACHE[key]


def _build(ne: int, np_: int = 4, basis_name: str = "GllNodal",
           tq_order: int = 18, rotate=None, nonuni=False,
           mesh_type: str = "geometric") -> CubedSphereMesh:
    subcell = mesh_type in ("gllsubcell", "runisubcell")
    ne_geo, np_geo = ne, np_
    if subcell:
        assert not nonuni, "subcell + nonuni not supported"
        np_ = 2  # transport runs np=2 on subcell meshes (slmmir.cpp:445)
        basis_name = "Gll"
    ncell = 6 * ne * ne
    np2 = np_ * np_
    bas = basis_mod.create(basis_name, np_)
    gx, gw = basis_mod.gll_nodes_weights(np_)
    # Node grid: the islet GLL-noded bases share the GLL nodes and the
    # reference passes GLL() for the mass weights even then; bases with
    # NON-GLL nodes (uniform_reduced, constant_cell, UniformOffsetNodal)
    # place the mesh nodes at the basis's own nodes with its own weights
    # (Basis::get_x/get_w via make_cgll_from_geo, slmm_mesh.cpp:366).
    bx = np.asarray(bas.x)
    if bx.shape == np.asarray(gx).shape and \
            not np.allclose(bx, np.asarray(gx), atol=1e-13):
        gx, gw = bx, np.asarray(bas.w)

    # --- Cell corners, all faces at once.
    i = np.arange(ne)
    fx0 = -1.0 + 2.0 * i / ne             # lower cell edges in face coords
    fx1 = -1.0 + 2.0 * (i + 1) / ne
    Xe = np.tan(_QUARTER_PI * np.concatenate([fx0, [1.0]]))  # (ne+1,) edges
    corners = np.empty((6, ne, ne, 4, 3))
    # Corner order CCW: (x0,y0), (x1,y0), (x1,y1), (x0,y1); arrays are
    # indexed [iy, ix].
    XX0, YY0 = np.meshgrid(Xe[:-1], Xe[:-1], indexing='xy')
    XX1, YY1 = np.meshgrid(Xe[1:], Xe[1:], indexing='xy')
    for f in range(6):
        corners[f, :, :, 0] = _face_point(f, XX0, YY0)
        corners[f, :, :, 1] = _face_point(f, XX1, YY0)
        corners[f, :, :, 2] = _face_point(f, XX1, YY1)
        corners[f, :, :, 3] = _face_point(f, XX0, YY1)
    corners = corners.reshape(ncell, 4, 3)
    corners /= np.linalg.norm(corners, axis=-1, keepdims=True)
    rot_R = None
    if rotate is not None:
        # Rotate the geometry; all downstream quantities (nodes, Jacobians,
        # integrals) are computed from the rotated corners, and point
        # location un-rotates (get_cell_coords with R).
        rot_R = form_rotation(*rotate)
        corners = corners @ rot_R.T
        corners /= np.linalg.norm(corners, axis=-1, keepdims=True)
    warp_R = None
    ring1 = ring1_mask = None
    if nonuni:
        warp_R = form_rotation((1.0, 1.0, 1.0), 0.2 * np.pi)
        corners = _warp_points(corners, warp_R)
        # Corner-sharing ring-1 neighbor table for the candidate search in
        # locate() (replaces the reference's octree for nonuniform meshes).
        f_i, iy_i, ix_i = np.unravel_index(np.arange(ncell), (6, ne, ne))
        gcx = np.stack([ix_i, ix_i + 1, ix_i + 1, ix_i], -1).astype(np.int64)
        gcy = np.stack([iy_i, iy_i, iy_i + 1, iy_i + 1], -1).astype(np.int64)
        ckeys = np.empty((ncell, 4, 3), np.int64)
        for f in range(6):
            sel = f_i == f
            ckeys[sel] = _face_key(f, 2 * gcx[sel] - ne, 2 * gcy[sel] - ne,
                                   ne)
        _, vinv = np.unique(ckeys.reshape(-1, 3), axis=0,
                            return_inverse=True)
        vinv = vinv.reshape(ncell, 4)
        v2c = {}
        for c in range(ncell):
            for k in range(4):
                v2c.setdefault(vinv[c, k], []).append(c)
        ring1 = np.zeros((ncell, 9), np.int32)
        ring1_mask = np.zeros((ncell, 9), bool)
        for c in range(ncell):
            nb = sorted({cc for k in range(4) for cc in v2c[vinv[c, k]]})
            assert len(nb) <= 9
            ring1[c, :len(nb)] = nb
            ring1_mask[c, :len(nb)] = True
            ring1[c, len(nb):] = nb[0]

    sub_parent_ne = 0
    sub_breaks = sub_parent_corners = None
    if subcell:
        # Refine each geometric cell into (np_geo-1)^2 subcells whose
        # corners are the bilinear-sphere images of the GLL (gllsubcell) or
        # uniform (runisubcell) break grid. Shared edges evaluate to
        # bitwise-identical floats from both parents (symmetric breaks +
        # identical chord expressions), so the refinement is watertight.
        sub_parent_ne = ne_geo
        sub_parent_corners = corners.copy()
        if mesh_type == "gllsubcell":
            breaks = np.asarray(basis_mod.gll_nodes_weights(np_geo)[0])
        else:
            breaks = np.linspace(-1.0, 1.0, np_geo)
        sub_breaks = breaks
        ns = np_geo - 1
        AX0, AY0 = np.meshgrid(breaks[:-1], breaks[:-1], indexing='xy')
        AX1, AY1 = np.meshgrid(breaks[1:], breaks[1:], indexing='xy')

        def bil(a, b):
            qtr = 0.25
            N = np.stack([qtr * (1 - a) * (1 - b), qtr * (1 + a) * (1 - b),
                          qtr * (1 + a) * (1 + b), qtr * (1 - a) * (1 + b)],
                         axis=-1)
            p = np.einsum('yxk,ckd->cyxd', N, corners)
            return p / np.linalg.norm(p, axis=-1, keepdims=True)

        pts = np.stack([bil(AX0, AY0), bil(AX1, AY0),
                        bil(AX1, AY1), bil(AX0, AY1)], axis=-2)
        # Global (face, IY, IX) lattice ordering with IY = iy*ns + sy.
        NE = ne_geo * ns
        pts = pts.reshape(6, ne_geo, ne_geo, ns, ns, 4, 3)
        pts = pts.transpose(0, 1, 3, 2, 4, 5, 6)
        corners = np.ascontiguousarray(pts.reshape(6 * NE * NE, 4, 3))
        ne = NE
        ncell = 6 * NE * NE

    # --- Cell nodes: bilinear-sphere map of the GLL reference grid.
    A, B = np.meshgrid(gx, gx, indexing='xy')  # A varies along i (fast)
    # N_k(a,b) quarter-bilinear weights, (np, np, 4)
    qtr = 0.25
    N = np.stack([
        qtr * (1 - A) * (1 - B), qtr * (1 + A) * (1 - B),
        qtr * (1 + A) * (1 + B), qtr * (1 - A) * (1 + B)], axis=-1)
    nodes = np.einsum('jik,ckd->cjid', N, corners)
    nodes /= np.linalg.norm(nodes, axis=-1, keepdims=True)

    # --- Combinatorial CGLL numbering via exact integer cube keys.
    # Node (ci=(f,iy,ix), local (i,j)) has face-lattice coords
    # gx = ix*(np-1)+i in [0, N_], N_ = ne*(np-1). Key scale: to keep keys
    # integral AND shared across faces, use gx2 = 2*gx - N_.
    N_ = ne * (np_ - 1)
    f_idx, iy_idx, ix_idx = np.unravel_index(np.arange(ncell), (6, ne, ne))
    li = np.arange(np_)
    lat_i = (ix_idx[:, None, None] * (np_ - 1) + li[None, None, :])  # (ncell,1,np)
    lat_j = (iy_idx[:, None, None] * (np_ - 1) + li[None, :, None])  # (ncell,np,1)
    gx2 = (2 * lat_i - N_) * np.ones((1, np_, 1), dtype=np.int64)
    gy2 = (2 * lat_j - N_) * np.ones((1, 1, np_), dtype=np.int64)
    keys = np.empty((ncell, np_, np_, 3), dtype=np.int64)
    for f in range(6):
        sel = f_idx == f
        keys[sel] = _face_key(f, gx2[sel], gy2[sel], N_)
    # Interior basis nodes may not sit on the integer lattice when the basis
    # node layout is not GLL; still fine - geometry grid is always GLL here.
    flat_keys = keys.reshape(ncell * np2, 3)
    uniq, first_idx, inverse = np.unique(
        flat_keys, axis=0, return_index=True, return_inverse=True)
    cnn = uniq.shape[0]
    dgll2cgll = inverse.astype(np.int32).reshape(ncell, np2)
    cgll_rep = first_idx.astype(np.int32)
    cgll_xyz = nodes.reshape(ncell * np2, 3)[first_idx]

    # Inverse (continuous -> coincident DGLL slots) map, padded to 4 (the
    # max multiplicity on a cubed sphere: face-interior 1, edges 2,
    # vertices 4; cube corners 3).
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=cnn)
    assert counts.max() <= 4
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    c2d_idx = np.zeros((cnn, 4), np.int32)
    c2d_mask = np.zeros((cnn, 4), bool)
    for k in range(4):
        sel = counts > k
        c2d_idx[sel, k] = order[starts[sel] + k]
        c2d_mask[sel, k] = True
    c2d_idx[~c2d_mask] = np.repeat(c2d_idx[:, 0], 4).reshape(cnn, 4)[
        ~c2d_mask]

    # --- Corner-bilinear Jacobians at nodes (slmmir_util.cpp:26-41).
    jcorners = jnp.asarray(corners)
    aa = jnp.asarray(A.ravel())
    bb = jnp.asarray(B.ravel())
    jac = sqr.bilinear_jacobian_norm(
        jcorners[:, None, :, :], aa[None, :], bb[None, :])
    jac_node = np.asarray(jac)  # (ncell, np2)

    # --- Homme (QOF) mass weights: J * w_i * w_j with standard GLL weights
    # (slmmir_util.cpp:101-128 computes 0.25 * J01 * wi * wj with the
    # Jacobian taken w.r.t. [0,1]^2 ref coords; our Jacobian is w.r.t.
    # [-1,1]^2, which absorbs the 0.25. The reference passes GLL() explicitly
    # even when the transport basis is an islet basis.)
    w2 = np.outer(gw, gw).ravel()  # [j, i] flattened to j*np + i
    dgbfi_gll = jac_node * w2[None, :]

    # --- Spherical basis-function integrals (QOS) by triangle quadrature
    # (slmmir_util.cpp:49-86): split each cell into triangles (0,1,2), (0,2,3),
    # evaluate GLL basis at each quadrature point via the inverse sphere map.
    bary, qw = quadrature.get_coef(tq_order)
    dgbfi_sphere = np.asarray(
        _dgbfi_sphere(jcorners, jnp.asarray(bary), jnp.asarray(qw), np_)
    ).reshape(ncell, np2)

    return CubedSphereMesh(
        ne=ne, np_=np_, ncell=ncell, cnn=cnn, basis_name=basis_name,
        corners=jnp.asarray(corners),
        cell_nodes_xyz=jnp.asarray(nodes),
        dgll2cgll=jnp.asarray(dgll2cgll),
        cgll_xyz=jnp.asarray(cgll_xyz),
        cgll_rep=jnp.asarray(cgll_rep),
        c2d_idx=jnp.asarray(c2d_idx),
        c2d_mask=jnp.asarray(c2d_mask),
        jac_node=jnp.asarray(jac_node),
        dgbfi_gll=jnp.asarray(dgbfi_gll),
        dgbfi_sphere=jnp.asarray(dgbfi_sphere),
        basis_x=jnp.asarray(bas.x),
        basis_w=jnp.asarray(bas.w),
        rot_R=None if rot_R is None else jnp.asarray(rot_R),
        warp_R=None if warp_R is None else jnp.asarray(warp_R),
        ring1=None if ring1 is None else jnp.asarray(ring1),
        ring1_mask=None if ring1_mask is None else jnp.asarray(ring1_mask),
        sub_parent_ne=sub_parent_ne,
        sub_breaks=None if sub_breaks is None else jnp.asarray(sub_breaks),
        sub_parent_corners=(None if sub_parent_corners is None
                            else jnp.asarray(sub_parent_corners)),
    )


@partial(jax.jit, static_argnames=("np_",))
def _dgbfi_sphere(corners, bary, qw, np_):
    gll_bas = basis_mod.GLL(np_)
    # Both triangles (0,1,2) and (0,2,3) of each cell, batched together.
    v1 = jnp.concatenate([corners[:, 0, :], corners[:, 0, :]])[:, None, :]
    v2 = jnp.concatenate([corners[:, 1, :], corners[:, 2, :]])[:, None, :]
    v3 = jnp.concatenate([corners[:, 2, :], corners[:, 3, :]])[:, None, :]
    cc = jnp.concatenate([corners, corners])[:, None, :, :]
    jacq, pq = sphere.tri_jacobian(v1, v2, v3, bary[None, :, :])
    al, be = sqr.sphere_to_ref(cc, pq)
    # Quadrature points of a valid cell satisfy |a|,|b| <= 1+ulp; a folded
    # quad (CFL far beyond the method's validity) can make the Newton
    # diverge, and the overflowed basis products would poison downstream
    # sums with NaN. Clamp so extreme inputs degrade gracefully instead.
    al = jnp.clip(al, -2.0, 2.0)
    be = jnp.clip(be, -2.0, 2.0)
    gi = gll_bas.eval(al)   # (2*ncell, nq, np)
    gj = gll_bas.eval(be)
    out = jnp.einsum('q,cq,cqj,cqi->cji', 0.5 * qw, jacq, gj, gi)
    n = corners.shape[0]
    return out[:n] + out[n:]


@partial(jax.jit, static_argnames=("ne",))
def get_cell_coords(ne: int, p, R=None):
    """Point location with local coordinates: returns (cell_idx, a0, b0)
    where (a0, b0) is the closed-form equiangular estimate of the in-cell
    reference coordinates - an O(h^2)-accurate warm start for the bilinear
    Newton inverse (sqr.sphere_to_ref). `R` is the grid rotation if the
    mesh was built rotated (R' p brings the point to the unrotated grid,
    slmm_mesh.cpp:782-790)."""
    if R is not None:
        p = p @ R.astype(p.dtype)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    face = jnp.where(
        ax >= ay,
        jnp.where(ax >= az, jnp.where(x > 0, 1, 3), jnp.where(z > 0, 4, 5)),
        jnp.where(ay >= az, jnp.where(y > 0, 2, 0), jnp.where(z > 0, 4, 5)))
    dmap = jnp.stack([ay, ax, ay, ax, az, az], axis=-1)
    d = jnp.take_along_axis(dmap, face[..., None], axis=-1)[..., 0]
    fx = jnp.select(
        [face == 0, face == 1, face == 2, face == 3, face == 4],
        [x / d, y / d, -x / d, -y / d, x / d], -x / d)
    fy = jnp.where(face >= 4, y / d, z / d)
    fx = jnp.arctan(fx) / _QUARTER_PI
    fy = jnp.arctan(fy) / _QUARTER_PI
    gx = 0.5 * (1 + fx) * ne
    gy = 0.5 * (1 + fy) * ne
    ix = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, ne - 1)
    iy = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, ne - 1)
    ci = (ne * ne * face + ne * iy + ix).astype(jnp.int32)
    a0 = 2.0 * (gx - ix) - 1.0
    b0 = 2.0 * (gy - iy) - 1.0
    return ci, a0, b0


@partial(jax.jit, static_argnames=("ne",))
def get_cell_idx(ne: int, p, R=None):
    """O(1) point -> cell id on the quasiuniform equiangular mesh
    (slmm_mesh.cpp:751-806). `p` is (..., 3) on (or near) the unit sphere;
    `R` is the optional grid rotation."""
    if R is not None:
        p = p @ R.astype(p.dtype)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    # Face selection matching get_cube_face_idx exactly.
    face = jnp.where(
        ax >= ay,
        jnp.where(ax >= az, jnp.where(x > 0, 1, 3), jnp.where(z > 0, 4, 5)),
        jnp.where(ay >= az, jnp.where(y > 0, 2, 0), jnp.where(z > 0, 4, 5)))
    # Face coordinates.
    dmap = jnp.stack([ay, ax, ay, ax, az, az], axis=-1)
    d = jnp.take_along_axis(dmap, face[..., None], axis=-1)[..., 0]
    fx = jnp.select(
        [face == 0, face == 1, face == 2, face == 3, face == 4],
        [x / d, y / d, -x / d, -y / d, x / d], -x / d)
    fy = jnp.where(face >= 4, y / d, z / d)
    fx = jnp.arctan(fx) / _QUARTER_PI
    fy = jnp.arctan(fy) / _QUARTER_PI
    ix = jnp.clip(jnp.floor(0.5 * (1 + fx) * ne).astype(jnp.int32), 0, ne - 1)
    iy = jnp.clip(jnp.floor(0.5 * (1 + fy) * ne).astype(jnp.int32), 0, ne - 1)
    return (ne * ne * face + ne * iy + ix).astype(jnp.int32)


def locate(mesh: CubedSphereMesh, p, max_its: int = 10):
    """Point location with reference coordinates on any mesh built here.

    Uniform meshes: closed-form equiangular estimate (O(h^2) warm start;
    callers polish with their own Newton). Nonuniform meshes (the reference
    uses an octree, slmmir_remapper_isl.cpp find_src_cell): invert the
    analytic warp, take the equiangular candidate, and select among its
    ring-1 neighbors by the Newton inverse - the returned (a, b) are fully
    converged. Subcell meshes locate the PARENT cell first (equiangular
    index + Newton on the parent), then pick the subcell by a searchsorted
    over the static break grid; returned coords are O(h^2) estimates like
    the uniform case. Returns (ci, a, b)."""
    if mesh.is_subcell:
        pne = mesh.sub_parent_ne
        ci_p, a0, b0 = get_cell_coords(pne, p, mesh.rot_R)
        pc = mesh.sub_parent_corners[ci_p].astype(p.dtype)
        a, b = sqr.sphere_to_ref(pc, p, a0=a0, b0=b0, max_its=6)
        br = mesh.sub_breaks
        ns = br.shape[0] - 1
        sx = jnp.clip(jnp.searchsorted(br, a, side='right') - 1, 0, ns - 1)
        sy = jnp.clip(jnp.searchsorted(br, b, side='right') - 1, 0, ns - 1)
        lox, hix = br[sx], br[sx + 1]
        loy, hiy = br[sy], br[sy + 1]
        a_s = 2.0 * (a - lox) / (hix - lox) - 1.0
        b_s = 2.0 * (b - loy) / (hiy - loy) - 1.0
        f = ci_p // (pne * pne)
        r = ci_p % (pne * pne)
        iy, ix = r // pne, r % pne
        NE = pne * ns
        ci = (f * NE * NE + (iy * ns + sy) * NE
              + (ix * ns + sx)).astype(jnp.int32)
        return ci, a_s.astype(p.dtype), b_s.astype(p.dtype)
    if not mesh.nonuni:
        return get_cell_coords(mesh.ne, p, mesh.rot_R)
    p0 = _warp_points(p, mesh.warp_R, inverse=True)
    c0 = get_cell_idx(mesh.ne, p0, mesh.rot_R)
    cands = mesh.ring1[c0]                              # (..., 9)
    corners = mesh.corners[cands].astype(p.dtype)       # (..., 9, 4, 3)
    p9 = jnp.broadcast_to(p[..., None, :], cands.shape + (3,))
    a, b = sqr.sphere_to_ref(corners, p9, max_its=max_its)
    # Select by actual Newton residual (a non-converged iterate can sit at
    # plausible in-range coords), penalizing out-of-element solutions.
    rec = sqr.ref_to_sphere(corners, a, b)
    resid = jnp.sqrt(sphere.norm2(rec - p9))
    outside = jnp.maximum(jnp.abs(a), jnp.abs(b)) > 1.0 + 1e-10
    score = resid + jnp.where(outside, 1e3, 0.0)
    score = jnp.where(mesh.ring1_mask[c0], score, jnp.inf)
    k = jnp.argmin(score, axis=-1)
    ci = jnp.take_along_axis(cands, k[..., None], axis=-1)[..., 0]
    a = jnp.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    b = jnp.take_along_axis(b, k[..., None], axis=-1)[..., 0]
    return ci, a, b


def locate_cell(mesh: CubedSphereMesh, p):
    """Point -> containing cell id (the get_cell_idx / octree dispatch)."""
    if not mesh.nonuni and not mesh.is_subcell:
        return get_cell_idx(mesh.ne, p, mesh.rot_R)
    return locate(mesh, p)[0]

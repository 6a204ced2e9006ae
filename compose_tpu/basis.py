"""Nodal bases on [-1, 1]: GLL and the stabilized Islet bases.

Counterparts of /root/reference/methods/slmm/slmm_gll.hpp (GLL tables +
Lagrange eval), slmm_basis.hpp (Basis interface) and slmm_islet.{hpp,cpp}
(stabilized interpolation bases). Differences from the reference, by design:

  - GLL nodes/weights are computed at import time by a Newton solve on the
    Legendre derivative (instead of hard-coded tables); they agree with the
    reference tables to machine precision.
  - Evaluation is vectorized over query points and returns (..., np) arrays;
    region-wise Islet evaluation uses branch-free masked selection so it jits
    cleanly.

The Islet modified quadrature weights ARE copied as numeric data - they are
offline-derived constants (see slmm_islet.hpp:55-95; SURVEY.md notes they are
data, produced by the methods/islet search tools).
"""

import functools

import numpy as np
import jax.numpy as jnp


# ----------------------------------------------------------------------------
# GLL nodes and weights (computed, not copied).

@functools.lru_cache(maxsize=None)
def gll_nodes_weights(np_: int):
    """Gauss-Lobatto-Legendre nodes and weights on [-1, 1] as numpy arrays.

    Nodes are the roots of (1 - x^2) P'_{np-1}(x); weights are
    2 / (np (np-1) P_{np-1}(x)^2). Matches slmm_gll.hpp tables to ~1 ulp.
    """
    n = np_
    if n < 2:
        raise ValueError("np must be >= 2")
    # Chebyshev-Lobatto initial guess, then Newton on P'_{n-1}.
    x = -np.cos(np.pi * np.arange(n) / (n - 1))
    leg = np.polynomial.legendre
    cPn = np.zeros(n)
    cPn[-1] = 1.0  # coefficients of P_{n-1}
    dPn = leg.legder(cPn)
    d2Pn = leg.legder(dPn)
    if n > 2:
        for _ in range(100):
            xi = x[1:-1]
            f = leg.legval(xi, dPn)
            fp = leg.legval(xi, d2Pn)
            dx = f / fp
            x[1:-1] = xi - dx
            if np.max(np.abs(dx)) < 1e-16:
                break
    Pn = leg.legval(x, cPn)
    w = 2.0 / (n * (n - 1) * Pn * Pn)
    # Enforce exact symmetry.
    x = 0.5 * (x - x[::-1])
    w = 0.5 * (w + w[::-1])
    return x, w


def lagrange_eval_np(xnodes, x):
    """Numpy Lagrange basis eval: xnodes (m,), x (...,) -> (..., m)."""
    xn = np.asarray(xnodes)
    m = xn.shape[0]
    x = np.asarray(x)[..., None]
    diff_x = x - xn  # (..., m)
    denom = xn[:, None] - xn[None, :]
    np.fill_diagonal(denom, 1.0)
    v = np.ones(x.shape[:-1] + (m,))
    for i in range(m):
        num = np.prod(np.delete(diff_x, i, axis=-1), axis=-1)
        den = np.prod(np.delete(xn[i] - xn, i))
        v[..., i] = num / den
    return v


def _prod_chain(t):
    """prod over the last axis as an explicit left-to-right multiply chain.
    jnp.prod lowers to a reduce whose association is batch-shape-dependent
    (np>=8 showed ulp-level differences between the single-chip and the
    per-shard-block basis evals); a chain is fusion- and batch-stable."""
    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = acc * t[..., j]
    return acc


def _lagrange_eval(xnodes, x):
    """JAX Lagrange basis eval, exact at nodes: x (...,) -> (..., m).
    Computes in x's dtype (f32 geometry pipelines stay f32)."""
    xn = jnp.asarray(xnodes).astype(jnp.asarray(x).dtype)
    m = xn.shape[0]
    d = x[..., None] - xn  # (..., m)
    v = []
    for i in range(m):
        num = _prod_chain(jnp.concatenate(
            [d[..., :i], d[..., i + 1:]], axis=-1))
        den = jnp.prod(jnp.asarray(
            [xn[i] - xn[j] for j in range(m) if j != i]))
        v.append(num / den)
    return jnp.stack(v, axis=-1)


def _lagrange_eval_derivative(xnodes, x):
    """Derivative of the Lagrange basis: (...,) -> (..., m)."""
    xn = jnp.asarray(xnodes)
    m = xn.shape[0]
    d = x[..., None] - xn
    out = []
    for i in range(m):
        den = jnp.prod(jnp.asarray(
            [xn[i] - xn[j] for j in range(m) if j != i]))
        acc = 0.0
        for k in range(m):
            if k == i:
                continue
            idx = [j for j in range(m) if j != i and j != k]
            if idx:
                term = _prod_chain(
                    jnp.stack([d[..., j] for j in idx], axis=-1))
            else:
                term = jnp.ones_like(x)
            acc = acc + term
        out.append(acc / den)
    return jnp.stack(out, axis=-1)


class GLL:
    """Standard GLL nodal basis (slmm_gll.hpp)."""

    name = "Gll"

    def __init__(self, np_: int):
        self.np = np_
        x, w = gll_nodes_weights(np_)
        self.x = jnp.asarray(x)
        self.w = jnp.asarray(w)

    def eval(self, x):
        """x (...,) -> basis values (..., np)."""
        return _lagrange_eval(self.x, x)

    def eval_deriv(self, x):
        return _lagrange_eval_derivative(self.x, x)


# ----------------------------------------------------------------------------
# Islet bases.

# Modified quadrature weights for islet::GllOffsetNodal (data;
# slmm_islet.hpp:55-70).
_GLL_OFFSET_NODAL_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [1.6666666666666666e-01, 8.3333333333333337e-01,
        8.3333333333333337e-01, 1.6666666666666666e-01],
    5: [7.2438673929622860e-02, 6.0875420527532442e-01,
        6.3761424159010549e-01, 6.0875420527532442e-01,
        7.2438673929622860e-02],
    6: [6.6666666666666624e-02, 3.7847495629784700e-01,
        5.5485837703548646e-01, 5.5485837703548646e-01,
        3.7847495629784700e-01, 6.6666666666666624e-02],
    7: [5.6454983633034334e-02, 2.5552182504453469e-01,
        4.5835116513528573e-01, 4.5934405237429038e-01,
        4.5835116513528573e-01, 2.5552182504453469e-01,
        5.6454983633034334e-02],
    8: [4.3144193831569533e-02, 1.9497214769017937e-01,
        3.5470956393990549e-01, 4.0717409453834563e-01,
        4.0717409453834563e-01, 3.5470956393990549e-01,
        1.9497214769017937e-01, 4.3144193831569533e-02],
    9: [4.1812271854496312e-02, 1.3123902435694160e-01,
        3.1866016571917827e-01, 2.9686582599803263e-01,
        4.2284542414270215e-01, 2.9686582599803263e-01,
        3.1866016571917827e-01, 1.3123902435694160e-01,
        4.1812271854496312e-02],
    10: [1.5509733280217758e-02, 1.4842357596604355e-01,
         2.0911374516621034e-01, 3.0367249606634206e-01,
         3.2328044952118629e-01, 3.2328044952118629e-01,
         3.0367249606634206e-01, 2.0911374516621034e-01,
         1.4842357596604355e-01, 1.5509733280217758e-02],
    11: [1.4115415593113077e-02, 1.1746481483677482e-01,
         1.8251645617210899e-01, 2.4597010811609454e-01,
         2.9538296815410536e-01, 2.8910047425560659e-01,
         2.9538296815410536e-01, 2.4597010811609454e-01,
         1.8251645617210899e-01, 1.1746481483677482e-01,
         1.4115415593113077e-02],
    12: [9.2548354381213702e-03, 1.0539058985971034e-01,
         1.4237539955323250e-01, 2.2648452767205887e-01,
         2.4168148450452953e-01, 2.7481316297234754e-01,
         2.7481316297234754e-01, 2.4168148450452953e-01,
         2.2648452767205887e-01, 1.4237539955323250e-01,
         1.0539058985971034e-01, 9.2548354381213702e-03],
    13: [1.5986387115823793e-02, 7.1039463009726772e-02,
         1.4100673941822789e-01, 1.8090611106261884e-01,
         2.1922209886060423e-01, 2.4908449372434635e-01,
         2.4550941361730400e-01, 2.4908449372434635e-01,
         2.1922209886060423e-01, 1.8090611106261884e-01,
         1.4100673941822789e-01, 7.1039463009726772e-02,
         1.5986387115823793e-02],
    16: [6.6054381853532362e-03, 5.4731980471730592e-02,
         8.5313396530798766e-02, 1.2750075018473614e-01,
         1.5206243160880162e-01, 1.7830331300698002e-01,
         1.9354559587015541e-01, 2.0193709414144417e-01,
         2.0193709414144417e-01, 1.9354559587015541e-01,
         1.7830331300698002e-01, 1.5206243160880162e-01,
         1.2750075018473614e-01, 8.5313396530798766e-02,
         5.4731980471730592e-02, 6.6054381853532362e-03],
}

# Region specs for islet::GllOffsetNodal (slmm_islet.cpp:99-120): per
# half-region i (region [x_i, x_{i+1}], x <= 0), a contiguous node window
# (offset, subnp). subnp == np means the full Lagrange polynomial.
_GLL_OFFSET_REGIONS = {
    5: [(0, 3), (0, 4)],
    6: [(0, 6), (0, 5)],
    7: [(0, 5), (0, 5), (0, 6)],
    8: [(0, 6), (0, 6), (0, 7), (1, 6)],
    9: [(0, 7), (0, 8), (0, 7), (1, 7)],
    10: [(0, 7), (0, 7), (0, 7), (0, 8), (1, 8)],
    11: [(0, 8), (0, 9), (0, 8), (0, 9), (1, 8)],
    12: [(0, 9), (0, 9), (0, 10), (0, 10), (1, 9), (1, 10)],
    13: [(0, 10), (0, 10), (0, 10), (0, 10), (0, 11), (1, 10)],
    16: [(0, 12), (0, 13), (0, 13), (0, 13), (0, 13), (0, 14), (1, 13),
         (2, 12)],
}

# Modified quadrature weights for islet::GllNodal (data; slmm_islet.hpp:77-90).
_GLL_NODAL_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [1.6666666666666666e-01, 8.3333333333333337e-01,
        8.3333333333333337e-01, 1.6666666666666666e-01],
    5: [7.2438673929622860e-02, 6.0875420527532442e-01,
        6.3761424159010549e-01, 6.0875420527532442e-01,
        7.2438673929622860e-02],
    6: [6.6666666666666624e-02, 3.7847495629784705e-01,
        5.5485837703548646e-01, 5.5485837703548646e-01,
        3.7847495629784705e-01, 6.6666666666666624e-02],
    7: [5.6454983633034334e-02, 2.5552182504453469e-01,
        4.5835116513528573e-01, 4.5934405237429038e-01,
        4.5835116513528573e-01, 2.5552182504453469e-01,
        5.6454983633034334e-02],
    8: [4.3144193831569533e-02, 1.9497214769017937e-01,
        3.5470956393990549e-01, 4.0717409453834563e-01,
        4.0717409453834563e-01, 3.5470956393990549e-01,
        1.9497214769017937e-01, 4.3144193831569533e-02],
    9: [3.6046050775536347e-02, 1.4531360464413259e-01,
        3.0053239765036854e-01, 3.1722918197442412e-01,
        4.0175752991107733e-01, 3.1722918197442412e-01,
        3.0053239765036854e-01, 1.4531360464413259e-01,
        3.6046050775536347e-02],
}

# Explicit (non-contiguous) node subsets for islet::GllNodal where it
# differs from GllOffsetNodal (slmm_islet.cpp:178-204): np=6 and np=9.
_GLL_NODAL_SUBSETS = {
    6: [[0, 1, 2, 3, 4], [0, 1, 2, 3, 5], [0, 1, 2, 3, 4, 5]],
    9: [[0, 1, 2, 3, 4, 5, 8], [0, 1, 2, 3, 4, 5, 7, 8],
        [0, 1, 2, 3, 4, 5, 6, 8], [1, 2, 3, 4, 5, 6, 7]],
}


def _regions_to_subsets(np_):
    return [list(range(os, os + sub))
            for (os, sub) in _GLL_OFFSET_REGIONS[np_]]


def _np4_subgrid_eval(xn, x):
    """Stabilized np=4 eval (slmm_islet.cpp:80-96): blend the full cubic with
    the one-sided quadratic in the outer regions."""
    c1 = 0.306
    y4 = _lagrange_eval(xn, x)
    # Outer-left quadratic over nodes 0..2, outer-right over 1..3.
    yl3 = _lagrange_eval(xn[0:3], x)
    yr3 = _lagrange_eval(xn[1:4], x)
    zero = jnp.zeros_like(x)
    yl = jnp.stack([yl3[..., 0], yl3[..., 1], yl3[..., 2], zero], axis=-1)
    yr = jnp.stack([zero, yr3[..., 0], yr3[..., 1], yr3[..., 2]], axis=-1)
    left = x < xn[1]
    right = x > xn[2]
    ysub = jnp.where(left[..., None], yl, yr)
    x0 = 2 * (1 - jnp.abs(x)) / (1 - xn[2]) - 1
    alpha = (c1 + (0.5 - c1) * x0) * (x0 + 1)
    yblend = alpha[..., None] * ysub + (1 - alpha[..., None]) * y4
    return jnp.where((left | right)[..., None], yblend, y4)


def _regionwise_eval(xn, subsets, x):
    """Branch-free region-wise sub-Lagrange evaluation with left-half
    symmetry (slmm_islet.cpp: islet::eval / evalon). xn: (np,) nodes;
    subsets: per-region node index lists for the left-half regions."""
    n = xn.shape[0]
    # Evaluate on the mirrored coordinate xm = -|x| (regions are defined on
    # the left half; symmetry maps the right half).
    xm = -jnp.abs(x)
    nreg = len(subsets)
    vals = []
    for nodes in subsets:
        sub_x = xn[jnp.asarray(nodes)]
        sub_v = _lagrange_eval(sub_x, xm)  # (..., len(nodes))
        full = jnp.zeros(x.shape + (n,), x.dtype)
        for j, node in enumerate(nodes):
            full = full.at[..., node].set(sub_v[..., j])
        vals.append(full)
    vals = jnp.stack(vals, axis=-2)  # (..., nreg, np)
    # Region of xm: smallest i with xm <= xn[i+1] (i in [0, nreg-1]).
    r = jnp.searchsorted(xn[1:nreg], xm, side='left')
    v = jnp.take_along_axis(vals, r[..., None, None], axis=-2)[..., 0, :]
    # Mirror for x > 0.
    return jnp.where((x > 0)[..., None], v[..., ::-1], v)


class IsletGllOffsetNodal(GLL):
    """islet::GllOffsetNodal - GLL nodes, modified weights, stabilized
    region-wise evaluation with contiguous node windows (slmm_islet.cpp:
    99-125)."""

    name = "GllOffsetNodal"

    def __init__(self, np_: int):
        super().__init__(np_)
        if np_ in _GLL_OFFSET_NODAL_W:
            self.w = jnp.asarray(np.array(_GLL_OFFSET_NODAL_W[np_]))
        else:
            raise NotImplementedError(
                f"islet GllOffsetNodal np={np_} not tabulated")

    def _subsets(self):
        return _regions_to_subsets(self.np)

    def eval(self, x):
        n = self.np
        if n <= 3:
            return _lagrange_eval(self.x, x)
        if n == 4:
            return _np4_subgrid_eval(self.x, x)
        return _regionwise_eval(self.x, self._subsets(), x)


class IsletGllNodal(IsletGllOffsetNodal):
    """islet::GllNodal - like GllOffsetNodal but with free node subsets for
    np in {6, 9} and its own weights (slmm_islet.cpp:127-209). The default
    `-basis` in slmmir."""

    name = "GllNodal"

    def __init__(self, np_: int):
        super().__init__(np_)
        if np_ in _GLL_NODAL_W:
            self.w = jnp.asarray(np.array(_GLL_NODAL_W[np_]))

    def _subsets(self):
        if self.np in _GLL_NODAL_SUBSETS:
            return _GLL_NODAL_SUBSETS[self.np]
        return _regions_to_subsets(self.np)


# islet::UniformOffsetNodal (slmm_islet.cpp:211-272): uniform nodes,
# contiguous sub-polynomial windows, tabulated weights (slmm_islet.hpp).
_UNIFORM_OFFSET_W = {
    2: [1.0, 1.0],
    3: [1.0 / 3.0, 4.0 / 3.0, 1.0 / 3.0],
    4: [2.4999999999999992e-01, 7.5e-01, 7.5e-01, 2.4999999999999992e-01],
    5: [1.8750000000000006e-01, 5.8333333333333337e-01,
        4.5833333333333343e-01, 5.8333333333333337e-01,
        1.8750000000000006e-01],
    6: [1.5305555555555561e-01, 4.5750000000000002e-01,
        3.8944444444444448e-01, 3.8944444444444448e-01,
        4.5750000000000002e-01, 1.5305555555555561e-01],
    7: [1.2754629629629630e-01, 3.8379629629629636e-01,
        3.1689814814814821e-01, 3.4351851851851856e-01,
        3.1689814814814821e-01, 3.8379629629629636e-01,
        1.2754629629629630e-01],
    8: [9.5238095238095247e-02, 3.6904761904761907e-01,
        2.3809523809523803e-01, 2.9761904761904762e-01,
        2.9761904761904762e-01, 2.3809523809523803e-01,
        3.6904761904761907e-01, 9.5238095238095247e-02],
    9: [8.3333333333333329e-02, 3.2291666666666669e-01,
        2.0833333333333337e-01, 2.6041666666666669e-01,
        2.5000000000000006e-01, 2.6041666666666669e-01,
        2.0833333333333337e-01, 3.2291666666666669e-01,
        8.3333333333333329e-02],
    10: [7.7469135802469141e-02, 2.7345679012345675e-01,
         2.0555555555555555e-01, 2.1790123456790123e-01,
         2.2561728395061736e-01, 2.2561728395061736e-01,
         2.1790123456790123e-01, 2.0555555555555555e-01,
         2.7345679012345675e-01, 7.7469135802469141e-02],
    11: [6.9722222222222227e-02, 2.4611111111111111e-01,
         1.8500000000000008e-01, 1.9611111111111118e-01,
         2.0305555555555560e-01, 1.9999999999999998e-01,
         2.0305555555555560e-01, 1.9611111111111118e-01,
         1.8500000000000008e-01, 2.4611111111111111e-01,
         6.9722222222222227e-02],
    12: [6.3383838383838390e-02, 2.2651515151515156e-01,
         1.5707070707070694e-01, 1.9494949494949498e-01,
         1.7348484848484846e-01, 1.8459595959595959e-01,
         1.8459595959595959e-01, 1.7348484848484846e-01,
         1.9494949494949498e-01, 1.5707070707070694e-01,
         2.2651515151515156e-01, 6.3383838383838390e-02],
    13: [5.9374999999999990e-02, 2.0127314814814809e-01,
         1.5671296296296305e-01, 1.6597222222222227e-01,
         1.6539351851851855e-01, 1.6793981481481482e-01,
         1.6666666666666663e-01, 1.6793981481481482e-01,
         1.6539351851851855e-01, 1.6597222222222227e-01,
         1.5671296296296305e-01, 2.0127314814814809e-01,
         5.9374999999999990e-02],
}
_UNIFORM_OFFSET_REGIONS = {
    4: [(0, 3), (0, 4)],
    5: [(0, 3), (0, 4)],
    6: [(0, 3), (0, 4), (0, 6)],
    7: [(0, 3), (0, 4), (1, 4)],
    8: [(0, 4), (0, 4), (1, 4), (2, 4)],
    9: [(0, 4), (0, 4), (1, 4), (2, 4)],
    10: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4)],
    11: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4)],
    12: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4), (4, 4)],
    13: [(0, 4), (0, 4), (1, 4), (2, 4), (3, 4), (4, 4)],
}

# islet::FreeNodal (slmm_islet.{hpp,cpp}): freely-placed nodes + explicit
# subsets, all offline-derived data.
_FREE_NODAL_X = {
    4: [-1, -4.4721359549995793e-01, 4.4721359549995793e-01, 1],
    5: [-1, -6.6678658540509828e-01, 0, 6.6678658540509828e-01, 1],
    6: [-1, -7.6692663677851514e-01, -3.0080515728048823e-01,
        3.0080515728048823e-01, 7.6692663677851514e-01, 1],
    7: [-1, -9.0990710644769845e-01, -5.2121920370139296e-01, 0,
        5.2121920370139296e-01, 9.0990710644769845e-01, 1],
    8: [-1, -8.5140924689985531e-01, -6.8076136583943381e-01,
        -3.3295319583926342e-01, 3.3295319583926342e-01,
        6.8076136583943381e-01, 8.5140924689985531e-01, 1],
    10: [-1, -9.1953390816645886e-01, -7.3979280618087628e-01,
         -5.5608644784645889e-01, -2.3500601793189407e-01,
         2.3500601793189407e-01, 5.5608644784645889e-01,
         7.3979280618087628e-01, 9.1953390816645886e-01, 1],
}
_FREE_NODAL_W = {
    4: [1.6666666666666666e-01, 8.3333333333333326e-01,
        8.3333333333333326e-01, 1.6666666666666666e-01],
    5: [4.9870438822580979e-02, 6.3756212508301224e-01,
        6.2513487218881347e-01, 6.3756212508301224e-01,
        4.9870438822580979e-02],
    6: [7.2085444326295170e-02, 3.5621719740552549e-01,
        5.7169735826817936e-01, 5.7169735826817936e-01,
        3.5621719740552549e-01, 7.2085444326295170e-02],
    7: [6.5052894249013657e-02, 1.3476067847565915e-01,
        5.7683298128860117e-01, 4.4670689197345193e-01,
        5.7683298128860117e-01, 1.3476067847565915e-01,
        6.5052894249013657e-02],
    8: [1.2725008869179433e-02, 3.3555941579644766e-01,
        1.4505431324948675e-02, 6.3721014400942422e-01,
        6.3721014400942422e-01, 1.4505431324948675e-02,
        3.3555941579644766e-01, 1.2725008869179433e-02],
    10: [2.8881226543594377e-02, 1.1714238963320928e-01,
         2.3127422749964027e-01, 1.7494931493842375e-01,
         4.4775284138513227e-01, 4.4775284138513227e-01,
         1.7494931493842375e-01, 2.3127422749964027e-01,
         1.1714238963320928e-01, 2.8881226543594377e-02],
}
_FREE_NODAL_SUBSETS = {
    4: [[0, 1, 2], [0, 1, 2, 3]],
    5: [[0, 1, 2, 3], [0, 1, 2, 3]],
    6: [[0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 5]],
    7: [[0, 1, 2, 4, 5, 6], [0, 1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5]],
    8: [[0, 1, 2, 3, 4, 5, 7], [0, 1, 2, 3, 4, 5, 6, 7],
        [0, 1, 2, 3, 4, 5, 6], [0, 1, 2, 3, 4, 5, 6, 7]],
    10: [[0, 1, 2, 3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5, 7, 8, 9],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6, 7, 8],
         [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]],
}


class IsletUniformOffsetNodal(GLL):
    """islet::UniformOffsetNodal - uniform nodes, offset sub-polynomials."""

    name = "UniformOffsetNodal"

    def __init__(self, np_: int):
        self.np = np_
        x = np.linspace(-1.0, 1.0, np_)
        self.x = jnp.asarray(x)
        if np_ not in _UNIFORM_OFFSET_W:
            raise NotImplementedError(f"UniformOffsetNodal np={np_}")
        self.w = jnp.asarray(np.array(_UNIFORM_OFFSET_W[np_]))

    def eval(self, x):
        if self.np <= 3:
            return _lagrange_eval(self.x, x)
        subsets = [list(range(os, os + sub))
                   for (os, sub) in _UNIFORM_OFFSET_REGIONS[self.np]]
        return _regionwise_eval(self.x, subsets, x)


class IsletFreeNodal(GLL):
    """islet::FreeNodal - freely-placed stabilized nodes."""

    name = "FreeNodal"

    def __init__(self, np_: int):
        if np_ not in _FREE_NODAL_X:
            raise NotImplementedError(f"FreeNodal np={np_}")
        self.np = np_
        self.x = jnp.asarray(np.array(_FREE_NODAL_X[np_]))
        self.w = jnp.asarray(np.array(_FREE_NODAL_W[np_]))

    def eval(self, x):
        return _regionwise_eval(self.x, _FREE_NODAL_SUBSETS[self.np], x)


def compute_weights(bas):
    """Basis::compute_weights (slmm_basis.cpp:61-92): integrate each basis
    function numerically per nodal region with 10-node GLL quadrature
    (exact to degree 17), then symmetrize. Returns (np,) weights."""
    xn = np.asarray(bas.x)
    n = xn.shape[0]
    qx, qw = (np.asarray(a) for a in gll_nodes_weights(10))
    integral = np.zeros(n)
    for ireg in range(n - 1):
        alpha = 0.5 * (qx + 1.0)
        xs = (1 - alpha) * xn[ireg] + alpha * xn[ireg + 1]
        v = np.asarray(bas.eval(jnp.asarray(xs)))      # (10, np)
        integral += 0.5 * (xn[ireg + 1] - xn[ireg]) * (qw[:, None] * v).sum(0)
    for i in range(n // 2):
        integral[i] = integral[n - i - 1] = \
            0.5 * (integral[i] + integral[n - i - 1])
    return integral


class UniformReduced:
    """slmm::UniformNodeReduced (slmm_basis_reduced.{hpp,cpp}): uniform
    nodes, piecewise-LINEAR region-wise evaluation (every region's subset
    is its two bracketing nodes; max_degree 1), weights generated the
    reference's way (compute_weights; the hpp tables are exactly these)."""

    name = "UniformReduced"

    def __init__(self, np_: int):
        if np_ > 13 and np_ != 16:
            raise NotImplementedError(f"UniformReduced np={np_}")
        self.np = np_
        self.x = jnp.asarray(np.linspace(-1.0, 1.0, np_))
        self.w = jnp.asarray(compute_weights(self))

    def eval(self, x):
        subsets = [[i, i + 1] for i in range(self.np // 2)]
        return _regionwise_eval(self.x, subsets, x)


class ConstantCell:
    """Basis::Type::constant_cell (slmm_basis.hpp:17): declared in the
    reference's enum but never implemented there (Basis::create has no
    case for it); provided here as the natural degree-0 member - uniform
    nodes, one-hot evaluation by nearest subinterval."""

    name = "ConstantCell"

    def __init__(self, np_: int):
        self.np = np_
        self.x = jnp.asarray(np.linspace(-1.0, 1.0, np_))
        self.w = jnp.asarray(compute_weights(self))

    def eval(self, x):
        xn = np.linspace(-1.0, 1.0, self.np)
        mid = jnp.asarray(0.5 * (xn[1:] + xn[:-1]))
        r = jnp.searchsorted(mid, x)
        return (r[..., None] == jnp.arange(self.np)).astype(
            jnp.result_type(float))


class GllNodalFromString(GLL):
    """islet::GllNodalFromString (slmm_islet_string.cpp:228-258): a
    region-wise nodal-subset basis over the GLL nodes defined by a string
    "np 1 | 0 subnp: n0 n1 .. | 1 subnp: ..." (one group per left-half
    region; Nodes::init, :' slmm_islet_string.cpp:231-258'). Weights are
    generated with compute_weights, as in the reference."""

    def __init__(self, np_: int, subsets):
        super().__init__(np_)
        self.name = "GllNodalFromString"
        self._subsets = subsets
        self.w = jnp.asarray(compute_weights(self))

    def eval(self, x):
        return _regionwise_eval(self.x, self._subsets, x)


class FreeNodalFromString(GLL):
    """islet::FreeNodalFromString (slmm_islet.hpp:157-168,
    slmm_islet_string.cpp:281-330): a region-wise nodal-subset basis over
    FREELY-PLACED nodes. The string is the GllNodalFromString format
    followed by "x <np node coordinates>" (read_xnodes,
    slmm_islet_string.cpp:285-297); the presence of "x" selects this class
    (Basis::create_basis_from_string, slmm_basis.cpp:48-59). Weights are
    generated with compute_weights, as in the reference."""

    def __init__(self, np_: int, subsets, xnodes):
        self.np = np_
        self.name = "FreeNodalFromString"
        if len(xnodes) != np_:
            raise ValueError(f"basis string needs {np_} x-nodes, got "
                             f"{len(xnodes)}")
        x = np.asarray(xnodes, dtype=np.float64)
        if np.any(np.diff(x) <= 0) or x[0] != -1.0 or x[-1] != 1.0:
            raise ValueError("x-nodes must strictly increase from -1 to 1")
        self.x = jnp.asarray(x)
        self._subsets = subsets
        self.w = jnp.asarray(compute_weights(self))

    def eval(self, x):
        return _regionwise_eval(self.x, self._subsets, x)


def parse_basis_string(s: str):
    """Parse the reference's basis-string format. Returns (np, subsets,
    xnodes-or-None); a trailing "x c0 c1 ..." coordinate list marks a
    free-nodal basis (slmm_basis.cpp:48-59)."""
    xnodes = None
    if "x" in s:
        s, _, tail = s.partition("x")
        xnodes = [float(v) for v in tail.split()]
    head, *regions = s.split("|")
    vals = head.split()
    np_, include_bdy = int(vals[0]), int(vals[1])
    assert include_bdy == 1, "include_bdy=0 strings are not supported"
    nh = np_ // 2
    if len(regions) != nh:
        raise ValueError(f"basis string needs {nh} regions, got "
                         f"{len(regions)}")
    subsets = []
    for ni, reg in enumerate(regions):
        pre, nodes_s = reg.split(":")
        ni_chk, subnp = (int(v) for v in pre.split())
        if ni_chk != ni:
            raise ValueError(f"region {ni} labeled {ni_chk}")
        nodes = [int(v) for v in nodes_s.split()]
        if len(nodes) != subnp:
            raise ValueError(f"region {ni}: expected {subnp} nodes")
        # ok_to_eval checks (slmm_islet_string.cpp:260-273).
        if subnp < 2 or any(b <= a for a, b in zip(nodes, nodes[1:])):
            raise ValueError(f"region {ni}: nodes must strictly increase")
        if sum(1 for v in nodes if v in (ni, ni + 1)) != 2:
            raise ValueError(f"region {ni}: must contain nodes "
                             f"{ni} and {ni + 1}")
        subsets.append(nodes)
    return np_, subsets, xnodes


_BASIS_REGISTRY = {
    "gll": GLL,
    "Gll": GLL,
    "gllnodal": IsletGllNodal,
    "GllNodal": IsletGllNodal,
    "glloffsetnodal": IsletGllOffsetNodal,
    "GllOffsetNodal": IsletGllOffsetNodal,
    "uniformoffsetnodal": IsletUniformOffsetNodal,
    "UniformOffsetNodal": IsletUniformOffsetNodal,
    "freenodal": IsletFreeNodal,
    "FreeNodal": IsletFreeNodal,
    "uniform_reduced": UniformReduced,
    "UniformReduced": UniformReduced,
    "uniformreduced": UniformReduced,
    "constant_cell": ConstantCell,
    "ConstantCell": ConstantCell,
    "constantcell": ConstantCell,
}


def create(name: str, np_: int):
    """Basis factory (slmm_basis.cpp: Basis::create /
    create_basis_from_string): known names dispatch to the registry;
    anything containing '|' is parsed as a string-defined basis
    (slmmir.cpp:1541)."""
    if "|" in name:
        np_s, subsets, xnodes = parse_basis_string(name)
        if np_s != np_:
            raise ValueError(f"basis string np={np_s} but mesh np={np_}")
        if xnodes is not None:
            return FreeNodalFromString(np_, subsets, xnodes)
        return GllNodalFromString(np_, subsets)
    key = name if name in _BASIS_REGISTRY else name.lower()
    if key not in _BASIS_REGISTRY:
        raise ValueError(f"unknown basis '{name}'")
    return _BASIS_REGISTRY[key](np_)

"""Separable global-operator apply on a uniform tensor grid.

Port of ``tpufem/ops/separable.py``.  On a uniform Cartesian grid with
constant coefficient the assembled Laplace operator factors exactly into
assembled 1D stiffness/mass matrices:

  A = K_z (x) M_y (x) M_x + M_z (x) K_y (x) M_x + M_z (x) M_y (x) K_x

``laplace_apply_separable`` applies it as dense 1D contractions along each
grid axis, in the JAX package's order; it is the plain PyTorch version of
both CUDA kernels in ``tpufem_torch.ops.kernel_separable`` (K1, K2).

An orthogonal curved mesh (polar/spherical shell, ``Mesh.separable_metric``)
or a separable variable coefficient makes the operator a SUM of tensor
products of weighted 1D matrices, ``A = sum_a (x)_b X_{a,b}``; a generic
smooth coefficient gets there through a CP expansion.
``laplace_apply_separable_terms`` applies such a sum; it is the plain
PyTorch version of the CUDA kernels in ``tpufem_torch.ops.kernel_terms``
(K3, K4).

The host builders are numpy copies of the JAX module's (pinned equal to
them by tests/test_torch_separable.py and tests/test_torch_terms.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo


@lru_cache(maxsize=None)
def global_1d_matrices(p: int, n: int, nq1: int) -> tuple[np.ndarray, np.ndarray]:
    """Assembled 1D reference matrices on n cells of the unit interval,
    f64 and UNSCALED: the caller multiplies K1 by 1/h and M1 by h per axis."""
    si = ShapeInfo(p, Quadrature.gauss(nq1))
    w = si.quad.weights_1d
    k1 = np.einsum("qi,q,qj->ij", si.D, w, si.D)  # reference-cell stiffness
    m1 = np.einsum("qi,q,qj->ij", si.S, w, si.S)
    npts = n * p + 1
    K1 = np.zeros((npts, npts))
    M1 = np.zeros((npts, npts))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        K1[sl, sl] += k1
        M1[sl, sl] += m1
    return K1, M1


def global_1d_gradient(p: int, n: int, nq1: int) -> np.ndarray:
    """Assembled mixed 1D matrix on [0, 1] (n cells), f64:
    G[i,j] = sum_cells int phi_i'(x) phi_j(x) dx, free of the cell width
    (the 1/h of phi' cancels the h of dx)."""
    si = ShapeInfo(p, Quadrature.gauss(nq1))
    w = si.quad.weights_1d
    g1 = np.einsum("qi,q,qj->ij", si.D, w, si.S)
    npts = n * p + 1
    G = np.zeros((npts, npts))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        G[sl, sl] += g1
    return G


def _assemble_weighted(p: int, n: int, nq1: int, wq_cells, kind: str
                       ) -> np.ndarray:
    """Assembled 1D matrix on [0, 1] (n cells) whose cell c carries the
    quadrature weights ``wq_cells(c)`` (nq1,): kind 'K' assembles
    phi' phi', 'M' phi phi, with the cell width folded in."""
    si = ShapeInfo(p, Quadrature.gauss(nq1))
    h = 1.0 / n
    npts = n * p + 1
    X = np.zeros((npts, npts))
    B = si.D if kind == "K" else si.S
    scale = (1.0 / h) if kind == "K" else h
    for c in range(n):
        loc = np.einsum("qi,q,qj->ij", B, wq_cells(c), B) * scale
        sl = slice(c * p, c * p + p + 1)
        X[sl, sl] += loc
    return X


def global_1d_weighted(p: int, n: int, nq1: int, wfun, kind: str
                       ) -> np.ndarray:
    """Assembled 1D matrix on [0, 1] (n cells) with a variable weight:
    kind 'K': X[i,j] = sum_c int w(x) phi_i' phi_j' dx, kind 'M': the
    same with values.  wfun: vectorized callable on logical x (None =
    weight 1), integrated with the Gauss rule of the per-qpoint path."""
    quad = Quadrature.gauss(nq1)
    wq, xq = quad.weights_1d, quad.points_1d
    h = 1.0 / n
    return _assemble_weighted(
        p, n, nq1,
        lambda c: wq * (1.0 if wfun is None
                        else np.asarray(wfun((c + xq) * h))), kind)


def global_1d_weighted_values(p: int, n: int, nq1: int, wvals: np.ndarray,
                              kind: str) -> np.ndarray:
    """``global_1d_weighted`` with the weight given as per-cell
    per-qpoint values (n, nq1) (the CP expansion's factors)."""
    wq = Quadrature.gauss(nq1).weights_1d
    wvals = np.asarray(wvals, np.float64).reshape(n, nq1)
    return _assemble_weighted(p, n, nq1, lambda c: wq * wvals[c], kind)


def build_separable_metric_terms(p, dim, nq1, n, separable_metric, dtype):
    """Per-term per-axis 1D matrices of an orthogonal separable metric:
    terms[a][b] is K-type for b == a, else M-type, weighted by the mesh's
    1D functions ``separable_metric[a][b]`` (axes in xyz order)."""
    return [[np.asarray(global_1d_weighted(p, n, nq1, separable_metric[a][b],
                                           "K" if b == a else "M"), dtype)
             for b in range(dim)] for a in range(dim)]


def cartesian_coef_terms(p, dim, nq1, n, lower, upper, coef_axes, dtype):
    """terms[a][b] for a uniform Cartesian mesh with a separable variable
    coefficient c(x) = prod_b c_b(x_b):

        A = sum_a (x)_b X_ab,   X_aa = int c_a phi' phi' dx_a,
                                X_ab = int c_b phi phi dx_b  (b != a)

    assembled with the tensor Gauss rule of the per-qpoint path, so the
    factorisation is exact to rounding.  Physical extents are folded into
    the 1D weights (K-type: /L, M-type: *L)."""
    table = []
    for a in range(dim):
        row = []
        for b in range(dim):
            L = float(upper[b] - lower[b])
            lo = float(lower[b])
            cb = coef_axes[b]
            if a == b:
                row.append(lambda xi, cb=cb, L=L, lo=lo:
                           np.asarray(cb(lo + xi * L)) / L)
            else:
                row.append(lambda xi, cb=cb, L=L, lo=lo:
                           np.asarray(cb(lo + xi * L)) * L)
        table.append(row)
    return build_separable_metric_terms(p, dim, nq1, n, table, dtype)


def cp_decompose_grid(T: np.ndarray, max_rank: int, tol: float,
                      iters: int = 30):
    """CP decomposition of a dim-D tensor sampled on the quadrature grid,
    T ~= sum_r f_r,0 (x) f_r,1 (x) ...: returns (factors, rel_err) with
    factors[r][a] the value vector of the TENSOR's axis a.  2D: truncated
    SVD.  3D: CP-ALS with an increasing-rank search, warm-started."""
    T = np.asarray(T, np.float64)
    d = T.ndim
    nrm0 = float(np.linalg.norm(T))
    if nrm0 == 0.0:
        return [], 0.0
    if d == 2:
        U, s, Vt = np.linalg.svd(T, full_matrices=False)
        tail = np.sqrt(np.concatenate(
            [np.cumsum((s**2)[::-1])[::-1][1:], [0.0]])) / nrm0
        R = int(np.searchsorted(-tail, -tol) + 1)
        R = min(max(R, 1), max_rank, len(s))
        facs = [[U[:, r] * s[r], Vt[r]] for r in range(R)]
        err = float(tail[R - 1]) if R <= len(tail) else 0.0
        return facs, err
    if d != 3:
        raise ValueError("cp_decompose_grid supports dim 2 and 3")
    rng = np.random.default_rng(0)
    best = ([], 1.0)
    prev = None
    for R in range(1, max_rank + 1):
        A = [rng.standard_normal((T.shape[a], R)) for a in range(3)]
        if prev is not None:
            # keep the converged rank-(R-1) factors, add one small column
            for a in range(3):
                A[a][:, : R - 1] = prev[a]
                A[a][:, R - 1] *= 0.01 * np.abs(prev[a]).max()
        for _ in range(iters):
            for a in range(3):
                o1, o2 = [b for b in range(3) if b != a]
                G = (A[o1].T @ A[o1]) * (A[o2].T @ A[o2])
                lbl = "zyx"
                M = np.einsum(
                    f"{lbl},{lbl[o1]}r,{lbl[o2]}r->{lbl[a]}r",
                    T, A[o1], A[o2], optimize=True)
                A[a] = M @ np.linalg.pinv(G)
        recon = np.einsum("zr,yr,xr->zyx", A[0], A[1], A[2], optimize=True)
        err = float(np.linalg.norm(T - recon) / nrm0)
        if err < best[1]:
            best = ([[A[a][:, r].copy() for a in range(3)]
                     for r in range(R)], err)
        prev = A
        if err <= tol:
            break
    return best


def cp_coef_terms(p, dim, nq1, n, lower, upper, coefficient, dtype,
                  tol: float = 1e-6, max_rank: int = 8):
    """terms for a generic smooth coefficient by CP expansion: c(x) ~=
    sum_r prod_a f_r,a(x_a) at the tensor quadrature grid; each rank
    gives dim terms.  Returns (terms, rel_err), rel_err the relative
    Frobenius error of the coefficient at the quadrature points: the
    operator equals the per-qpoint operator of the reconstructed
    coefficient exactly."""
    xq = np.asarray(Quadrature.gauss(nq1).points_1d)
    ax_pts = []  # per spatial axis (x first): (n*nq1,) physical points
    for a in range(dim):
        L = float(upper[a] - lower[a])
        h = L / n
        ax_pts.append((np.arange(n)[:, None] * h + xq[None, :] * h
                       + float(lower[a])).reshape(-1))
    Q = n * nq1
    # tensor axes (z, ..., x): tensor axis t holds spatial axis dim-1-t;
    # sampled in chunks
    grids = np.meshgrid(*[ax_pts[dim - 1 - t] for t in range(dim)],
                        indexing="ij")
    pts_all = np.stack([grids[dim - 1 - a] for a in range(dim)],
                       axis=-1).reshape(-1, dim)
    step = max(1, int(2e7 // dim))
    vals = np.empty(pts_all.shape[0])
    for i0 in range(0, len(pts_all), step):
        vals[i0:i0 + step] = np.asarray(coefficient(pts_all[i0:i0 + step]))
    facs, rel_err = cp_decompose_grid(vals.reshape((Q,) * dim), max_rank,
                                      tol)
    terms = []
    for fr in facs:  # fr[t]: tensor-axis t values (t = 0 is z)
        for a in range(dim):  # the K-type axis
            row = []
            for b in range(dim):  # spatial axis of the matrix
                L = float(upper[b] - lower[b])
                w = fr[dim - 1 - b]
                X = (global_1d_weighted_values(p, n, nq1, w / L, "K")
                     if a == b else
                     global_1d_weighted_values(p, n, nq1, w * L, "M"))
                row.append(np.asarray(X, dtype))
            terms.append(row)
    return terms, rel_err


def build_separable_operators(p, dim, nq1, n, h, dtype):
    """Per-axis scaled (K1_a, M1_a) as numpy arrays of ``dtype``.

    h: (dim,) physical cell widths; K scales by 1/h, M by h.
    """
    K1u, M1u = global_1d_matrices(p, n, nq1)
    Ks, Ms = [], []
    for a in range(dim):
        Ks.append(np.asarray(K1u / h[a], dtype))
        Ms.append(np.asarray(M1u * h[a], dtype))
    return Ks, Ms


def _contract_grid(t: torch.Tensor, M: torch.Tensor, axis: int,
                   dim: int) -> torch.Tensor:
    """Contract the grid dimension holding spatial axis ``axis`` (0 = x,
    the last grid dimension) with M: out[..., o, ...] = sum_i M[o, i] t[..., i, ...]."""
    pos = dim - 1 - axis
    out = torch.matmul(t.movedim(pos, -1), M.T)
    return out.movedim(-1, pos)


def laplace_apply_separable(u: torch.Tensor, dim: int, npts: int, Ks,
                            Ms) -> torch.Tensor:
    """y = A u via the separable factorisation (8 contractions in 3D, 4 in
    2D, with shared partials).  u is flat (npts**dim,); Ks/Ms are per-axis
    (npts, npts) tensors on u's device, x first."""
    t = u.reshape((npts,) * dim)
    if dim == 2:
        r = _contract_grid(_contract_grid(t, Ms[0], 0, dim), Ks[1], 1, dim)
        r = r + _contract_grid(_contract_grid(t, Ks[0], 0, dim), Ms[1], 1, dim)
        return r.reshape(-1)
    a = _contract_grid(t, Ms[0], 0, dim)  # Mx u
    b = _contract_grid(a, Ms[1], 1, dim)  # My Mx u
    r = _contract_grid(b, Ks[2], 2, dim)  # Kz My Mx u
    c = _contract_grid(a, Ks[1], 1, dim)  # Ky Mx u
    r = r + _contract_grid(c, Ms[2], 2, dim)
    e = _contract_grid(t, Ks[0], 0, dim)  # Kx u
    f = _contract_grid(e, Ms[1], 1, dim)
    r = r + _contract_grid(f, Ms[2], 2, dim)
    return r.reshape(-1)


def laplace_apply_separable_terms(u: torch.Tensor, dim: int, npts: int,
                                  terms) -> torch.Tensor:
    """y = sum_a (X_{a,dim-1} (x) ... (x) X_{a,0}) u: d contractions per
    term, x first, terms summed in order.  terms[a][b] are (npts, npts)
    tensors on u's device, b = 0 the x axis."""
    t0 = u.reshape((npts,) * dim)
    r = None
    for term in terms:
        t = t0
        for b in range(dim):
            t = _contract_grid(t, term[b], b, dim)
        r = t if r is None else r + t
    return r.reshape(-1)

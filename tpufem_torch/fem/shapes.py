"""1D Lagrange shape functions and the matrices driving sum factorization.

Reference analogue: the 1D ``shape_values`` / ``shape_gradients`` tables the
reference uploads to CUDA ``__constant__`` memory and contracts with in
``tensor_ops.cuh`` (SURVEY.md §2 "Sum-factorization kernels", §3.2 last line).
Here they become compile-time constants baked into jitted functions / Pallas
kernels.

Conventions:
- Reference interval [0, 1]; degree-p element has n1 = p+1 nodes.
- Support points are Gauss-Lobatto-Legendre for p >= 2 (deal.II FE_Q choice),
  endpoints {0,1} for p = 1.
- ``S[q, i] = phi_i(x_q)``, ``D[q, i] = phi_i'(x_q)`` for quadrature points
  x_q — note (n_q, n1) layout: contraction "dof -> quad" is ``S @ u``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from tpufem_torch.fem.quadrature import Quadrature, gauss_lobatto


@lru_cache(maxsize=None)
def support_points_1d(p: int) -> np.ndarray:
    """Nodal support points of FE_Q(p) on [0,1] in increasing order."""
    if p < 1:
        raise ValueError("degree must be >= 1")
    if p == 1:
        return np.array([0.0, 1.0])
    x, _ = gauss_lobatto(p + 1)
    return x


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """V[q, i] = L_i(x_q) for the Lagrange basis on ``nodes``.

    Uses the stable barycentric form (exact at nodes).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(nodes)
    # barycentric weights
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    bw = 1.0 / np.prod(diff, axis=1)
    V = np.empty((len(x), n))
    for q, xq in enumerate(x):
        d = xq - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            row = np.zeros(n)
            row[np.argmax(hit)] = 1.0
        else:
            t = bw / d
            row = t / t.sum()
        V[q] = row
    return V


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Dm[q, i] = L_i'(x_q), via differentiation matrix at arbitrary points.

    L_i'(x) = L_i(x) * sum_{j != i} 1/(x - x_j) away from nodes; at nodes use
    the classical differentiation-matrix formula.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(nodes)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    bw = 1.0 / np.prod(diff, axis=1)
    D = np.empty((len(x), n))
    for q, xq in enumerate(x):
        d = xq - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            k = int(np.argmax(hit))  # xq == nodes[k]
            row = np.empty(n)
            for i in range(n):
                if i == k:
                    row[i] = np.sum(1.0 / (nodes[k] - np.delete(nodes, k)))
                else:
                    row[i] = (bw[i] / bw[k]) / (nodes[k] - nodes[i])
            D[q] = row
        else:
            # generic point: L_i(x) known from barycentric values
            t = bw / d
            Lsum = t.sum()
            L = t / Lsum
            s = np.sum(1.0 / d)
            # L_i'(x) = L_i(x) * (s - 1/d_i) - ... use exact formula:
            # L_i'(x) = L_i(x) * sum_{j!=i} 1/(x-x_j)  is wrong for barycentric
            # normalized basis; use product-rule exact evaluation instead:
            row = np.empty(n)
            for i in range(n):
                # L_i(x) = bw[i]/d[i] / Lsum ; derivative computed via
                # d/dx [N_i/Denom] with N_i = bw_i/d_i, Denom = sum_j bw_j/d_j
                Ni = bw[i] / d[i]
                dNi = bw[i] / d[i] ** 2  # -d/dx (bw_i/d_i) = bw_i/d_i^2; sign:
                # d/dx (1/(x-x_j)) = -1/(x-x_j)^2, so dNi/dx = -bw_i/d_i^2
                dNi = -dNi
                dDen = -np.sum(bw / d**2)
                row[i] = (dNi * Lsum - Ni * dDen) / Lsum**2
            D[q] = row
    return D


class ShapeInfo:
    """All 1D matrices needed for a (degree p, quadrature) pair.

    Attributes (all float64 numpy, shapes noted):
      S      (nq, n1): values  phi_i(x_q)
      D      (nq, n1): derivs  phi_i'(x_q)
      D_col  (nq, nq): collocation derivative D @ S^{-1} (only if nq == n1) —
                       the deal.II "collocation" fast path: transform to values
                       at quadrature points (d contractions with S) then
                       differentiate in quadrature space (d contractions with
                       D_col), 2d total instead of d + d^2.
      nodes  (n1,)   : support points.
    """

    def __init__(self, p: int, quad: Quadrature):
        self.p = p
        self.n1 = p + 1
        self.quad = quad
        self.nq1 = quad.n_1d
        self.nodes = support_points_1d(p)
        self.S = lagrange_values(self.nodes, quad.points_1d)
        self.D = lagrange_derivatives(self.nodes, quad.points_1d)
        if self.nq1 == self.n1:
            self.D_col = self.D @ np.linalg.inv(self.S)
        else:
            self.D_col = None

    @classmethod
    @lru_cache(maxsize=None)
    def gauss(cls, p: int, n_q: int | None = None) -> "ShapeInfo":
        return cls(p, Quadrature.gauss(n_q if n_q is not None else p + 1))


@lru_cache(maxsize=None)
def subface_interpolation_1d(p: int, subface: int) -> np.ndarray:
    """C[i, j] = phi_j(child_node_i mapped into parent coords).

    The 1D hanging-node / multigrid-embedding matrix: values of the coarse
    (parent) basis at the nodes of child ``subface`` (0 = left half [0,1/2],
    1 = right half). Used for:
      - hanging-node constraint resolution (reference ``hanging_nodes.cuh``,
        SURVEY.md §2): child face values = C @ parent face values;
      - GMG prolongation (reference ``mg_transfer_matrix_free_gpu``).
    """
    nodes = support_points_1d(p)
    child_x = 0.5 * nodes + (0.5 if subface == 1 else 0.0)
    return lagrange_values(nodes, child_x)

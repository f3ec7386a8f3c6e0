"""1D quadrature rules on the reference interval [0, 1].

Reference analogue: deal.II ``QGauss<1>`` as consumed by the reference's
``MatrixFreeGpu::reinit`` (SURVEY.md §3.2); the reference always uses
QGauss(p+1) for degree-p elements.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]. Exact for degree <= 2n-1."""
    x, w = np.polynomial.legendre.leggauss(n)
    # map from [-1, 1] to [0, 1]
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre rule on [0, 1] (includes endpoints).

    Nodes are the roots of (1-x^2) P'_{n-1}(x); used as FE_Q support points
    (deal.II uses GLL support points for p >= 2 for conditioning).
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    # Interior nodes: roots of P'_{n-1}
    leg = np.polynomial.legendre.Legendre.basis(n - 1)
    dleg = leg.deriv()
    interior = dleg.roots()
    x = np.concatenate(([-1.0], np.sort(np.real(interior)), [1.0]))
    # Weights: w_i = 2 / (n(n-1) P_{n-1}(x_i)^2)
    pvals = leg(x)
    w = 2.0 / (n * (n - 1) * pvals**2)
    return 0.5 * (x + 1.0), 0.5 * w


class Quadrature:
    """Tensor-product quadrature on the reference cell [0,1]^dim."""

    def __init__(self, points_1d: np.ndarray, weights_1d: np.ndarray):
        self.points_1d = np.asarray(points_1d, dtype=np.float64)
        self.weights_1d = np.asarray(weights_1d, dtype=np.float64)

    @property
    def n_1d(self) -> int:
        return len(self.points_1d)

    @classmethod
    def gauss(cls, n: int) -> "Quadrature":
        return cls(*gauss_legendre(n))

    def tensor_points(self, dim: int) -> np.ndarray:
        """All quadrature points of the dim-dimensional tensor rule.

        Returns (n_1d**dim, dim), ordered lexicographically with the FIRST
        axis (x) fastest — matching the DoF/qpoint ordering used throughout
        (see tpufem.fem.dof_handler).
        """
        grids = np.meshgrid(*([self.points_1d] * dim), indexing="ij")
        # meshgrid 'ij' makes the LAST index fastest when raveled with order
        # 'C' on the reversed list; build explicitly: q = qx + nq*qy + ...
        pts = np.stack([g.ravel(order="F") for g in grids], axis=-1)
        return pts

    def tensor_weights(self, dim: int) -> np.ndarray:
        """(n_1d**dim,) tensor weights, same ordering as tensor_points."""
        w = self.weights_1d
        n = self.n_1d
        idx = np.arange(n**dim)
        out = np.ones(n**dim)
        for d in range(dim):
            out *= w[(idx // n**d) % n]
        return out

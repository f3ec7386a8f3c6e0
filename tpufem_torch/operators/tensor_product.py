"""Sum-of-tensor-product operators: the mass/Helmholtz fast tier.

Port of ``tpufem/operators/tensor_product.py``.  On a uniform Cartesian
grid the assembled global operators factor exactly

    M         =  Mz (x) My (x) Mx
    alpha M + beta K
              =  beta [ Mz(x)My(x)Kx + Mz(x)Ky(x)Mx + Kz(x)My(x)Mx ]
               + alpha Mz (x) My (x) Mx

(1D matrices assembled with the quadrature path's Gauss rule, so parity
with the assembled oracle is rounding-level), the contract of the terms
kernels: K4 (``ResidentTerms``, 3D) and K3 (``ResidentTerms2D``, 2D),
attached by ``ops.matrix_free._terms_with_kernel``.  The implicit-Euler
heat step (M + dt K) u^{n+1} = M u^n (``apps/heat.py --resident``) runs on
it, and so does elasticity, as blocks of such sums
(``SeparableElasticityOperator``: nine K4 instances in 3D).

A kernel request is never dropped: a kernel that cannot be built raises,
and so does ``use_pallas`` on the 2D elasticity tier, which has no
kernel (the JAX package takes its XLA path there without a word).
"""

from __future__ import annotations

import dataclasses
from functools import reduce

import numpy as np
import torch

from tpufem_torch.operators.vector import VectorOperator
from tpufem_torch.ops.kernel_terms import ResidentTerms
from tpufem_torch.ops.matrix_free import MatrixFree, _terms_with_kernel
from tpufem_torch.ops.separable import (
    build_separable_operators,
    global_1d_gradient,
    laplace_apply_separable_terms,
)


def helmholtz_separable_terms(p, dim, nq1, n, h, alpha=1.0, beta=1.0):
    """Per-axis 1D factor matrices of alpha M + beta K on a uniform
    Cartesian grid (n cells per axis, physical cell widths h (dim,)).

    A list of terms, each a list of dim (npts, npts) f64 numpy matrices in
    spatial-axis order (index 0 = x): the ``terms`` contract of
    ``laplace_apply_separable_terms`` / ``ResidentTerms``.  beta is folded
    into the K factor of each stiffness term, alpha into the x factor of
    the mass term: dim + 1 terms in general, dim for pure stiffness
    (alpha = 0), one for pure mass (beta = 0)."""
    Ks, Ms = build_separable_operators(p, dim, nq1, n, np.asarray(h),
                                       np.float64)
    terms = []
    if beta != 0.0:
        for a in range(dim):
            terms.append([np.asarray(beta * Ks[b]) if b == a
                          else np.asarray(Ms[b]) for b in range(dim)])
    if alpha != 0.0:
        terms.append([np.asarray(alpha * Ms[0])]
                     + [np.asarray(Ms[b]) for b in range(1, dim)])
    return terms


def mass_separable_terms(p, dim, nq1, n, h):
    """The assembled global mass matrix as one tensor-product term."""
    return helmholtz_separable_terms(p, dim, nq1, n, h, alpha=1.0, beta=0.0)


def _uniform_grid(mf: MatrixFree, what: str) -> tuple[int, int]:
    """(cells per axis, npts) of the MatrixFree's full uniform Cartesian
    grid without hanging nodes; raises otherwise."""
    if mf.host_metric.kind != "cartesian" or mf.has_hanging:
        raise ValueError(
            f"{what} needs a uniform Cartesian mesh without hanging nodes "
            f"(curved meshes: Mesh.separable_metric terms; otherwise the "
            f"generic-functor tier)")
    cfg = mf.config
    n = int(mf.mesh.U // mf.mesh.sizes[0])
    npts = n * cfg.degree + 1
    if npts**cfg.dim != mf.n_dofs:
        raise ValueError("mesh is not a full uniform tensor grid")
    return n, npts


def _masked_tensor_diagonal(mf: MatrixFree, terms, npts: int
                            ) -> np.ndarray:
    """diag(sum_a (x)_b X_ab) of the constrained operator, flat (grid axis
    order z..x), f64: the tensor product of the 1D diagonals summed over
    terms (the host analogue of the reference's unit-basis
    compute_diagonal); constrained DoFs get 1."""
    dim = mf.config.dim
    total = np.zeros((npts,) * dim)
    for t in terms:
        diags = [np.diag(np.asarray(t[b], np.float64))
                 for b in reversed(range(dim))]
        total += reduce(np.multiply.outer, diags)
    mask = mf.interior_mask.cpu().to(torch.float64).numpy()
    return total.reshape(-1) * mask + (1.0 - mask)


class TensorProductOperator:
    """Constrained operator for A = sum_a (x)_b X_ab on a uniform grid.

    The plain apply contracts the 1D matrices with ``torch.matmul``; with
    a kernel (``use_pallas``; None reads ``mf.config.use_pallas``; the
    mode is ``mf.config.pallas_mode``) K4 (3D) or K3 (2D) applies it,
    ``self.resident`` with the mask fused by ``_fuse_mask``'s rule, which
    makes the operator a drop-in for ``solvers.resident.
    resident_jacobi_cg``.  The keyword stands in for the JAX package's
    ``MatrixFree(use_pallas=)``, which the port's cell-loop tiers refuse.

    Constrained semantics match ``LaplaceOperator``: identity on
    constrained rows and columns, y = m * A(m * x) + (1 - m) * x."""

    def __init__(self, mf: MatrixFree, terms, use_pallas: bool | None = None):
        _, npts = _uniform_grid(mf, "TensorProductOperator")
        cfg = mf.config
        self.mf = mf
        self.n_dofs = mf.n_dofs
        self.npts = npts
        d, p = cfg.dim, cfg.degree
        dt = mf.interior_mask.dtype
        self.terms64 = [[np.asarray(m, np.float64) for m in t] for t in terms]
        self.terms = [[torch.as_tensor(m, dtype=dt, device=mf.device)
                       for m in t] for t in self.terms64]
        kcfg = cfg if use_pallas is None else dataclasses.replace(
            cfg, use_pallas=bool(use_pallas))
        interior = mf.interior_mask.cpu().to(torch.float64).numpy()
        self.resident = _terms_with_kernel(self.terms64, npts, p, d, kcfg,
                                           mf.device, interior, mf.dofs)

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x, no constraint handling (the kernel's unmasked apply on
        flat vectors when attached)."""
        if self.resident is not None:
            return self.resident(x)
        return laplace_apply_separable_terms(x, self.mf.config.dim,
                                             self.npts, self.terms)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with identity rows and columns on constrained DoFs."""
        m = self.mf.interior_mask
        return m * self.vmult_raw(m * x) + (1.0 - m) * x

    __call__ = vmult

    def diagonal(self) -> torch.Tensor:
        """Closed form (``_masked_tensor_diagonal``)."""
        return torch.as_tensor(
            _masked_tensor_diagonal(self.mf, self.terms64, self.npts),
            dtype=self.mf.interior_mask.dtype, device=self.mf.device)


def helmholtz_tensor_operator(mf: MatrixFree, alpha=1.0, beta=1.0,
                              use_pallas: bool | None = None
                              ) -> TensorProductOperator:
    """alpha M + beta K as a TensorProductOperator (the fast-tier twin of
    ``operators.generic.helmholtz_operator``)."""
    cfg = mf.config
    n, _ = _uniform_grid(mf, "TensorProductOperator")
    h = 1.0 / np.asarray(mf.host_metric.inv_h[0], np.float64)
    terms = helmholtz_separable_terms(cfg.degree, cfg.dim, cfg.nq1, n, h,
                                      alpha=alpha, beta=beta)
    return TensorProductOperator(mf, terms, use_pallas)


def mass_tensor_operator(mf: MatrixFree, use_pallas: bool | None = None
                         ) -> TensorProductOperator:
    """M as a TensorProductOperator (the fast-tier twin of
    ``operators.generic.mass_operator``)."""
    return helmholtz_tensor_operator(mf, 1.0, 0.0, use_pallas)


# ---------------------------------------------------------------------
# the vector-valued fast tier: elasticity as blocks of tensor products
def elasticity_separable_blocks(p, dim, nq1, n, h, mu=1.0, lam=1.0):
    """Exact per-block tensor-product factorisation of the step-8
    elasticity operator on a uniform Cartesian grid:

        Block(c,c) = (2 mu + lam) K_c + mu sum_{a != c} K_a
        Block(c,a) = mu [axis c: G^T, axis a: G, rest: M]
                   + lam [axis c: G,  axis a: G^T, rest: M]   (c != a)

    with K_b / M_b the scaled 1D stiffness and mass factors and
    G[i,j] = int phi_i' phi_j (scale-free, ``ops.separable.
    global_1d_gradient``).  Rows are test functions; the mu off-diagonal
    term is int d_c u_a d_a v_c, the lam term int d_a u_a d_c v_c.

    Returns blocks[c][a], a list of terms, each ``[X_x, ..., X_{dim-1}]``
    (the ``ResidentTerms`` contract), f64 numpy."""
    h = np.asarray(h, np.float64)
    Ks, Ms = build_separable_operators(p, dim, nq1, n, h, np.float64)
    G = global_1d_gradient(p, n, nq1)
    blocks = [[None] * dim for _ in range(dim)]
    for c in range(dim):
        for a in range(dim):
            if c == a:
                terms = []
                for b in range(dim):
                    coef = (2.0 * mu + lam) if b == c else mu
                    terms.append([np.asarray(coef * Ks[x]) if x == b
                                  else np.asarray(Ms[x]) for x in range(dim)])
            else:
                t_mu, t_lam = [], []
                for x in range(dim):
                    if x == c:
                        t_mu.append(np.asarray(mu * G.T))
                        t_lam.append(np.asarray(lam * G))
                    elif x == a:
                        t_mu.append(np.asarray(G))
                        t_lam.append(np.asarray(G.T))
                    else:
                        t_mu.append(np.asarray(Ms[x]))
                        t_lam.append(np.asarray(Ms[x]))
                terms = [t_mu, t_lam]
            blocks[c][a] = terms
    return blocks


class SeparableElasticityOperator:
    """Elasticity at the separable tier's speed (uniform Cartesian grids):
    the exact block factorisation above, plain (``torch.matmul`` 1D
    contractions) or, with ``use_pallas`` (3D only), one K4 instance per
    block: the components padded once into the resident layout, the nine
    block outputs summed there in the compute dtype, three unpads.

    The blocks are built unmasked (``dirichlet=False``): K4's fused mask
    carries the (1 - m) x identity, which an off-diagonal block must not
    add, so the mask algebra stays outside, per component:
    y = m A(m x) + (1 - m) x with the scalar interior mask
    (``TensorProductOperator.vmult``).  Vectors are (C, n_dofs),
    C = dim = ``n_components``, as ``VectorOperator``'s.  ``mode`` is the
    kernels' mode (``ResidentTerms``: "f32", "bf16" or "bf16s")."""

    def __init__(self, mf: MatrixFree, mu=1.0, lam=1.0, use_pallas=False,
                 mode="f32"):
        n, npts = _uniform_grid(mf, "SeparableElasticityOperator")
        cfg = mf.config
        d, p = cfg.dim, cfg.degree
        self.mf = mf
        self.n_components = d
        self.npts = npts
        self.n_dofs = mf.n_dofs
        h = 1.0 / np.asarray(mf.host_metric.inv_h[0], np.float64)
        self.blocks64 = elasticity_separable_blocks(p, d, cfg.nq1, n, h, mu,
                                                    lam)
        dt = mf.interior_mask.dtype
        self.blocks = [[[[torch.as_tensor(m, dtype=dt, device=mf.device)
                          for m in t] for t in blk] for blk in row]
                       for row in self.blocks64]
        self.kernels = None
        if use_pallas:
            if d != 3:
                raise ValueError(
                    "SeparableElasticityOperator: use_pallas runs K4, a 3D "
                    "kernel; the 2D elasticity tier has none (use the plain "
                    "apply, use_pallas=False)")
            self.kernels = [[ResidentTerms(npts, p, self.blocks64[c][a], dt,
                                           mode=mode, dirichlet=False,
                                           device=mf.device)
                             for a in range(d)] for c in range(d)]

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on (C, n_dofs), no constraint handling."""
        d = self.n_components
        if self.kernels is not None:
            k00 = self.kernels[0][0]
            pads = [k00.pad(x[a]) for a in range(d)]
            outs = []
            for c in range(d):
                acc = None
                for a in range(d):
                    t = self.kernels[c][a].raw(pads[a]).to(k00.compute_dt)
                    acc = t if acc is None else acc + t
                outs.append(k00.unpad(acc))
            return torch.stack(outs).to(x.dtype)
        outs = []
        for c in range(d):
            acc = None
            for a in range(d):
                t = laplace_apply_separable_terms(x[a], d, self.npts,
                                                  self.blocks[c][a])
                acc = t if acc is None else acc + t
            outs.append(acc)
        return torch.stack(outs)

    vmult = __call__ = TensorProductOperator.vmult
    vmult_flat = VectorOperator.vmult_flat

    def diagonal(self) -> torch.Tensor:
        """(C, n_dofs): the off-diagonal blocks never touch the global
        diagonal (their component indices differ), so diag[c] is the
        tensor diagonal of Block(c,c); constrained rows get 1."""
        return torch.as_tensor(np.stack([
            _masked_tensor_diagonal(self.mf, self.blocks64[c][c], self.npts)
            for c in range(self.n_components)]),
            dtype=self.mf.interior_mask.dtype, device=self.mf.device)

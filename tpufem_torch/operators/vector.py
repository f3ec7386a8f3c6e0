"""Vector-valued matrix-free operators (multi-component FEEvaluation).

Port of ``tpufem/operators/vector.py``.  A vector field with C components
is stored block-wise as a ``(C, n_dofs)`` tensor (deal.II's
``FESystem(FE_Q(p), C)`` block convention: every component shares the
scalar DoF layout), and the component axis is folded into the cell batch
of the sum-factorised contractions (``ops.tensor_ops``): each 1D
contraction is one matmul with C·nc·(p+1)^(d-1) rows.

The quadrature-point functor contract is ``operators/generic.py``'s with
a leading component axis:

    quad_op(values (C, nc, nq) | None, grads (C, nc, dim, nq) | None, ctx)
        -> (submit_values | None, submit_grads | None)

Cross-component coupling (elasticity's stress) happens in the functor in
physical space; the basis transforms, the metric, the gather/scatter and
the constraints (the scalar tables, per component) are the framework's.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpufem_torch.operators.generic import (
    QuadContext,
    eval_fields,
    integrate_fields,
    prepare_cell_loop,
)
from tpufem_torch.ops.matrix_free import MatrixFree


def _local_apply(mf: MatrixFree, quad_op: Callable, needs_values: bool,
                 needs_gradients: bool, u_loc: torch.Tensor) -> torch.Tensor:
    """Cell-local vector apply (C, nc, nn) -> (C, nc, nn): evaluate,
    functor, integrate, no gather/scatter (shared by the apply and the
    diagonal).  The components ride in the cell batch."""
    ctx = QuadContext(config=mf.config, metric_kind=mf.metric_kind,
                      coef_q=mf.coef_dev)
    vals, grads = eval_fields(mf, u_loc, needs_values, needs_gradients)
    sv, sg = quad_op(vals, grads, ctx)
    if isinstance(sv, (list, tuple)):
        sv = torch.stack(list(sv))
    if isinstance(sg, (list, tuple)):
        sg = torch.stack(list(sg))
    return integrate_fields(mf, sv, sg)


def make_vector_cell_operator(mf: MatrixFree, quad_op: Callable,
                              n_components: int, needs_values: bool = True,
                              needs_gradients: bool = True) -> Callable:
    """Raw vector operator u (C, n_dofs) -> integral contributions
    (C, n_dofs), no constraints."""
    prepare_cell_loop(mf)

    def apply(u: torch.Tensor) -> torch.Tensor:
        out = _local_apply(mf, quad_op, needs_values, needs_gradients,
                           u[:, mf.cell_dofs])
        return torch.stack([mf.scatter(out[c])
                            for c in range(n_components)])

    return apply


class VectorOperator:
    """Constrained vector-valued operator around a component-coupling
    quadrature functor; the Dirichlet and hanging-node constraints are the
    scalar tables applied per component."""

    def __init__(self, mf: MatrixFree, quad_op: Callable, n_components: int,
                 needs_values: bool = True, needs_gradients: bool = True):
        self.mf = mf
        self.quad_op = quad_op
        self.n_components = n_components
        self.needs_values = needs_values
        self.needs_gradients = needs_gradients
        self.n_dofs = mf.n_dofs
        self._raw = make_vector_cell_operator(mf, quad_op, n_components,
                                              needs_values, needs_gradients)

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        return self._raw(x)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        mf = self.mf
        m = mf.interior_mask
        xm = m[None] * x
        xh = torch.stack([mf.distribute(v) for v in xm])
        y = self._raw(xh)
        y = torch.stack([mf.distribute_transpose(v) for v in y])
        return m[None] * y + (1.0 - m[None]) * x

    __call__ = vmult

    def vmult_flat(self, xf: torch.Tensor) -> torch.Tensor:
        """Apply on a flat (C*n_dofs,) vector, the shape the scalar Krylov
        solvers take: ``cg_solve(op.vmult_flat, ...)``."""
        return self.vmult(xf.reshape(self.n_components, -1)).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        """diag[(c, i)] of the constrained operator by the unit-basis trick
        (SURVEY.md §2 "Laplace operator"): the unit local field e_{c,j} on
        every cell at once (the cell operator is block-diagonal over
        cells), C·(p+1)^dim cell-local applies, summed per DoF by the
        scatter.  Constrained rows get 1.  Returns (C, n_dofs)."""
        mf = self.mf
        C = self.n_components
        nc, nn = mf.cell_dofs.shape
        dt = mf.interior_mask.dtype
        entries = []
        for c in range(C):
            cols = []
            for j in range(nn):
                u_loc = torch.zeros((C, nc, nn), dtype=dt, device=mf.device)
                u_loc[c, :, j] = 1.0
                out = _local_apply(mf, self.quad_op, self.needs_values,
                                   self.needs_gradients, u_loc)
                cols.append(out[c, :, j])
            entries.append(mf.scatter(torch.stack(cols, dim=1)))
        diag = torch.stack(entries)
        m = mf.interior_mask
        return m[None] * diag + (1.0 - m[None])


def elasticity_qop(dim: int, mu=1.0, lam=1.0) -> Callable:
    """The step-8 stress functor: submit_grad[c] = sigma(u)[c, :] with
    sigma = 2 mu eps + lam tr(eps) I."""

    def qop(vals, grads, ctx):
        # grads: (C=dim, nc, dim, nq); eps[c,:,a,:] = (d_a u_c + d_c u_a)/2
        eps = 0.5 * (grads + torch.swapaxes(grads, 0, 2))
        tr = torch.einsum("anaq->nq", grads)
        eye = torch.eye(dim, dtype=grads.dtype,
                        device=grads.device)[:, None, :, None]
        sg = 2.0 * mu * eps + lam * tr[None, :, None, :] * eye
        return None, sg

    return qop


def elasticity_operator(mf: MatrixFree, mu=1.0, lam=1.0) -> VectorOperator:
    """Linear elasticity a(u,v) = int 2 mu eps(u):eps(v) + lam (div u)
    (div v) dx, the deal.II step-8 form, as a component-coupling functor.
    SPD for mu > 0, lam >= 0 under Dirichlet constraints."""
    dim = mf.config.dim
    return VectorOperator(mf, elasticity_qop(dim, mu, lam), n_components=dim,
                          needs_values=False, needs_gradients=True)

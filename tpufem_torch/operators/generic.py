"""Generic matrix-free operators from user quadrature-point functors.

Port of ``tpufem/operators/generic.py`` (the reference's
``FEEvaluationGpu`` contract, SURVEY.md §2 and §3.4): a local operator is
what it does at each quadrature point.  The functor maps whole batched
tensors

  (values (nc, nq) | None, grads (nc, dim, nq) | None, ctx)
    -> (submit_values | None, submit_grads | None)

in physical space; the framework does the basis transforms
(``ops.tensor_ops``), the metric (J^-T, JxW) and the gather/scatter of the
MatrixFree's cell-loop tier (incidence or colored, built on first use on
any scheme).  ``ctx.coef_q`` is the coefficient at the quadrature points.

The JAX package threads its device arrays through ``jit`` as arguments
(``device_args``, the ``*_with`` forms); the port is eager and reads the
MatrixFree's own tensors, so those forms have no counterpart here.
``NonlinearOperator.solve`` is a plain call of ``solvers.newton``, whose
Jacobian is ``torch.func.linearize`` through the same chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tpufem_torch.fem.mapping import compute_metric
from tpufem_torch.ops import tensor_ops as tops
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.newton import newton_solve


@dataclasses.dataclass
class QuadContext:
    """What a quadrature-point functor may read: the static config plus
    the per-cell tensors of the current apply."""

    config: Any
    metric_kind: str
    coef_q: torch.Tensor | None  # (nc, nq) or None


def ref_to_phys_grad(mf: MatrixFree, g_ref: torch.Tensor) -> torch.Tensor:
    """g_phys[a] = sum_b invJ[b,a] g_ref[b]; g_ref (..., nc, d, nq), any
    leading axes (the vector operators' components)."""
    if mf.metric_kind == "cartesian":
        return g_ref * mf.inv_h[:, :, None]
    return torch.einsum("cqba,...cbq->...caq", mf.inv_jac, g_ref)


def phys_to_ref_grad_weighted(mf: MatrixFree,
                              g_phys: torch.Tensor) -> torch.Tensor:
    """t_ref[b] = sum_a invJ[b,a] g_phys[a] * JxW."""
    if mf.metric_kind == "cartesian":
        jxw = mf.det[:, None] * mf.w_q[None, :]
        return g_phys * mf.inv_h[:, :, None] * jxw[:, None, :]
    gw = g_phys * mf.jxw[:, None, :]
    return torch.einsum("cqba,...caq->...cbq", mf.inv_jac, gw)


def jxw(mf: MatrixFree) -> torch.Tensor:
    """(nc, nq) JxW."""
    if mf.metric_kind == "cartesian":
        return mf.det[:, None] * mf.w_q[None, :]
    return mf.jxw


def eval_fields(mf: MatrixFree, u_loc: torch.Tensor, needs_values: bool,
                needs_gradients: bool):
    """Local DoF values (..., nc, nn) -> (values (..., nc, nq), physical
    gradients (..., nc, d, nq)), either None where not asked for; leading
    axes (the vector operators' components) ride in the cell batch."""
    dim = mf.config.dim
    lead = tuple(u_loc.shape[:-1])
    u_loc = u_loc.reshape(-1, u_loc.shape[-1])
    unfold = lambda t: t.reshape(lead + tuple(t.shape[1:]))
    vals = grads = None
    if mf.D_col is not None:
        if needs_gradients:
            v, g_ref = tops.eval_gradients_collocation(u_loc, mf.S, mf.D_col,
                                                       dim)
            vals = unfold(v) if needs_values else None
            grads = ref_to_phys_grad(mf, unfold(g_ref))
        else:
            vals = unfold(tops.eval_values(u_loc, mf.S, dim))
    else:
        if needs_values:
            vals = unfold(tops.eval_values(u_loc, mf.S, dim))
        if needs_gradients:
            grads = ref_to_phys_grad(mf, unfold(
                tops.eval_gradients_basis(u_loc, mf.S, mf.D, dim)))
    return vals, grads


def integrate_fields(mf: MatrixFree, sv, sg) -> torch.Tensor:
    """Physical-space submissions (sv (..., nc, nq), sg (..., nc, d, nq),
    either None) -> local integrals (..., nc, nn)."""
    dim = mf.config.dim
    if sv is not None:
        sv = sv * jxw(mf)
        lead = tuple(sv.shape[:-1])  # (..., nc)
        sv = sv.reshape(-1, sv.shape[-1])
    if sg is not None:
        sg = phys_to_ref_grad_weighted(mf, sg)
        lead = tuple(sg.shape[:-2])
        sg = sg.reshape((-1,) + tuple(sg.shape[-2:]))
    if mf.D_col is not None:
        out = tops.integrate_collocation(sv, sg, mf.S, mf.D_col, dim)
    else:
        out = None
        if sv is not None:
            out = tops.integrate_values(sv, mf.S, dim)
        if sg is not None:
            gi = tops.integrate_gradients_basis(sg, mf.S, mf.D, dim)
            out = gi if out is None else out + gi
    return out.reshape(lead + (out.shape[-1],))


def prepare_cell_loop(mf: MatrixFree) -> None:
    """Upload the cell data and build the scatter tables once, so an apply
    does no setup (and ``torch.func.linearize`` traces none)."""
    if mf.S is None:
        raise ValueError(
            "the functor tier needs a cell-loop MatrixFree (scatter "
            "'incidence', 'colored', 'structured' or 'dense'), not the "
            f"{mf.scheme!r} scheme")
    mf.cell_data()
    if mf.scheme == "colored":
        mf._ensure_colors()
    else:
        mf._ensure_incidence()


def make_cell_operator(mf: MatrixFree, quad_op: Callable,
                       needs_values: bool = True,
                       needs_gradients: bool = True) -> Callable:
    """Raw operator u -> integral contributions (no constraints).

    quad_op(values, grads, ctx) returns (submit_values, submit_grads) in
    physical space; either may be None."""
    prepare_cell_loop(mf)

    def apply(u: torch.Tensor) -> torch.Tensor:
        ctx = QuadContext(config=mf.config, metric_kind=mf.metric_kind,
                          coef_q=mf.coef_dev)
        vals, grads = eval_fields(mf, mf.gather(u), needs_values,
                                  needs_gradients)
        sv, sg = quad_op(vals, grads, ctx)
        return mf.scatter(integrate_fields(mf, sv, sg))

    return apply


class GenericOperator:
    """Constrained operator around a quadrature-point functor (the role
    LaplaceOperatorGpu plays for LocalLaplace, SURVEY.md §3.4):
    ``vmult`` is y = m·C^T A C(m·x) + (1-m)·x."""

    def __init__(self, mf: MatrixFree, quad_op: Callable,
                 needs_values: bool = True, needs_gradients: bool = True):
        self.mf = mf
        self.n_dofs = mf.n_dofs
        self._raw = make_cell_operator(mf, quad_op, needs_values,
                                       needs_gradients)

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        return self._raw(x)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        mf = self.mf
        m = mf.interior_mask
        y = mf.distribute_transpose(self._raw(mf.distribute(m * x)))
        return m * y + (1.0 - m) * x

    __call__ = vmult


class NonlinearOperator:
    """Nonlinear residual operator from a quadrature-point functor.

    ``quad_op`` may be nonlinear in values and gradients (quasilinear
    diffusion, minimal surface, p-Laplacian ...):

      F(u)_i = sum_q [ sv(u_q, grad u_q) phi_i + sg(u_q, grad u_q) .
               grad phi_i ] JxW  -  b_i      on free rows (0 elsewhere).

    The gather/evaluate/functor/integrate/scatter chain is the residual,
    and the Newton Jacobian is its exact derivative by AD
    (``solvers.newton``).  Dirichlet values ride in the iterate (``u0``);
    hanging-node rows are zero in both F and J v, and the iterate's
    hanging entries are refreshed by C at every residual and on the
    returned solution."""

    def __init__(self, mf: MatrixFree, quad_op: Callable,
                 needs_values: bool = True, needs_gradients: bool = True):
        self.mf = mf
        self.n_dofs = mf.n_dofs
        self._raw = make_cell_operator(mf, quad_op, needs_values,
                                       needs_gradients)

    def residual_with(self, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """m · C^T (R(C u) - b): the whole residual is condensed, so the
        RHS's hanging rows credit their masters too."""
        mf = self.mf
        r = mf.distribute_transpose(self._raw(mf.distribute(u)) - b)
        return mf.interior_mask * r

    def residual(self, u, b) -> torch.Tensor:
        dt = self.mf.interior_mask.dtype
        dev = self.mf.device
        return self.residual_with(torch.as_tensor(b, dtype=dt, device=dev),
                                  torch.as_tensor(u, dtype=dt, device=dev))

    def solve(self, b, u0=None, jacobi_diag=None, **newton_kw):
        """Newton-Krylov solve of F(u) = 0 (``solvers.newton.newton_solve``
        for the keywords: rtol, linear="cg"|"gmres"|"bicgstab", ...).

        ``jacobi_diag``: an optional (n_dofs,) diagonal used as a fixed
        Jacobi preconditioner of every inner Krylov solve (e.g. the
        linear problem's diagonal); zero entries map to 1."""
        mf = self.mf
        dt = mf.interior_mask.dtype
        b = torch.as_tensor(b, dtype=dt, device=mf.device)
        u0 = (torch.zeros_like(b) if u0 is None
              else torch.as_tensor(u0, dtype=dt, device=mf.device))
        M_inv = None
        if jacobi_diag is not None:
            d = torch.as_tensor(jacobi_diag, dtype=dt, device=mf.device)
            inv_d = torch.where(d != 0, 1.0 / d, torch.ones_like(d))
            M_inv = lambda r: inv_d * r
        res = newton_solve(self.residual_with, b, mf.distribute(u0),
                           mask=mf.interior_mask, M_inv=M_inv, **newton_kw)
        return res._replace(x=mf.distribute(res.x))


# ------------------------------------------------------------------
# stock operators
def mass_operator(mf: MatrixFree, coefficient_q=None) -> GenericOperator:
    """M u: quad op = submit_value(coef * value)."""

    def qop(vals, grads, ctx):
        v = vals if coefficient_q is None else vals * coefficient_q
        return v, None

    return GenericOperator(mf, qop, needs_values=True, needs_gradients=False)


def helmholtz_operator(mf: MatrixFree, alpha=1.0, beta=1.0) -> GenericOperator:
    """(alpha M + beta K) u: submit both value and gradient."""

    def qop(vals, grads, ctx):
        sg = beta * grads
        if ctx.coef_q is not None:
            sg = sg * ctx.coef_q[:, None, :]
        return alpha * vals, sg

    return GenericOperator(mf, qop, needs_values=True, needs_gradients=True)


def convection_diffusion_operator(mf: MatrixFree, velocity,
                                  nu=1.0) -> GenericOperator:
    """Nonsymmetric a(u,v) = int nu grad(u).grad(v) + (b.grad(u)) v dx.

    ``velocity``: a callable ``(npts, dim) -> (npts, dim)`` evaluated at
    the quadrature points of ``mf``'s rule, or a precomputed
    ``(nc, dim, nq)`` array; held on the device in the operator's dtype.
    Pair with ``solvers.bicgstab.bicgstab_solve`` or ``gmres_solve``: CG
    does not apply to this form."""
    if callable(velocity):
        gen = compute_metric(mf.mesh, mf.quad, need_points=True).to_general()
        d = mf.config.dim
        bq = velocity(gen.quad_points.reshape(-1, d)).reshape(
            mf.mesh.n_cells, -1, d)
        velocity_q = np.ascontiguousarray(np.moveaxis(bq, -1, 1))
    else:
        velocity_q = np.asarray(velocity)
    vq = torch.as_tensor(velocity_q, dtype=mf.interior_mask.dtype,
                         device=mf.device)

    def qop(vals, grads, ctx):
        sv = torch.sum(vq * grads, dim=1)  # (nc, nq)
        sg = nu * grads
        if ctx.coef_q is not None:
            sg = sg * ctx.coef_q[:, None, :]
        return sv, sg

    return GenericOperator(mf, qop, needs_values=False, needs_gradients=True)

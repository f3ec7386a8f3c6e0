"""Matrix-free Newton-Krylov for nonlinear forms.

Port of ``tpufem/solvers/newton.py``.  The Jacobian is never written
down: the nonlinear residual F(u) is a chain of tensor operations (gather
-> evaluate -> nonlinear quadrature functor -> integrate -> scatter), and
the Newton linearisation is ``torch.func.linearize`` through the whole
chain (the reference's ``jax.linearize``): the exact Gateaux derivative of
the discrete residual by AD, one traced forward graph replayed per Krylov
apply, no hand-derived linearised functor and no assembled matrix.  The
residual must therefore be traceable: no host reads and no branches on
tensor values inside it.

The JAX package runs the Newton loop, the inner Krylov solve, the
backtracking line search and the Eisenstat-Walker forcing in one
``while_loop``; here they are Python loops that read ||F|| on the host
once per trial point (the value the reference's loop carries), and the
forcing term is computed from those host floats.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.solvers.bicgstab import bicgstab_solve
from tpufem_torch.solvers.cg import _default_dot, cg_solve
from tpufem_torch.solvers.gmres import gmres_solve


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # Newton steps taken
    residual: float  # final ||F(x)||
    converged: bool  # residual <= tol
    linear_iterations: int  # total inner Krylov steps
    stalled: bool  # the line search found no decreasing step


def newton_solve(
    residual: Callable,
    args,
    u0: torch.Tensor,
    mask: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 30,
    linear: str = "cg",
    linear_rtol: Optional[float] = None,
    linear_maxiter: int = 2000,
    ls_max: int = 10,
    dot: Callable = _default_dot,
    M_inv: Optional[Callable] = None,
) -> NewtonResult:
    """Solve F(u) = 0 by inexact Newton with an AD matrix-free Jacobian.

    ``residual(args, u)``: the nonlinear residual, zero on constrained
    rows (Dirichlet by masking, hanging nodes by C/C^T inside it); ``args``
    is passed through (an RHS vector, say).

    ``mask``: the interior mask (1 = free DoF).  The Krylov systems use
    ``J_c v = mask * J v + (1 - mask) * v``, so constrained rows act as
    the identity; with a masked residual the update is exactly zero there
    and Dirichlet values set in ``u0`` are kept bit for bit.

    ``M_inv``: an optional fixed preconditioner of the inner Krylov solves
    (for "gmres" applied on the right, so no symmetry is needed).

    ``linear``: "cg" (symmetric Jacobians: gradient-form nonlinearities),
    "gmres" or "bicgstab".  ``linear_rtol=None`` turns on Eisenstat-Walker
    choice-2 forcing: eta_k = gamma (||F_k|| / ||F_{k-1}||)^2, gamma = 0.9,
    kept >= gamma eta_{k-1}^2 whenever that exceeds 0.1, and >= 0.5 tol /
    ||F_k||, clipped to [1e-12, 0.1].

    Globalisation: backtracking (halving) line search with an Armijo-style
    sufficient-decrease test on ||F||; each trial costs one residual, and
    the accepted trial's residual vector is carried.  If ``ls_max``
    halvings find no decreasing step the step is rejected (alpha = 0),
    the iteration stops and ``stalled`` is set."""
    dtype = u0.dtype
    if mask is None:
        mask = torch.ones_like(u0)
    solvers = {"cg": cg_solve, "gmres": gmres_solve,
               "bicgstab": bicgstab_solve}
    if linear not in solvers:
        raise ValueError(f"unknown linear solver {linear!r}")
    lin_solve = solvers[linear]

    def fnorm_of(u):
        f = residual(args, u)
        return f, float(torch.sqrt(dot(f, f)))  # the host read of a trial

    small = torch.finfo(dtype).tiny
    ew_gamma, ew_max = 0.9, 0.1
    u = u0
    f, fn = fnorm_of(u0)
    tol = max(rtol * fn, atol)
    # eta_prev starts at ew_max, so the first step's forcing is the cap
    fn_prev, eta_prev = fn, ew_max
    k, lin_total, stalled = 0, 0, False
    while fn > tol and k < maxiter and math.isfinite(fn) and not stalled:
        # the exact Gateaux derivative of the discrete residual, by AD
        with warnings.catch_warnings():
            # torch's constant folding of the traced graph warns about its
            # own attribute nodes; the graph it returns is complete
            warnings.filterwarnings("ignore", category=UserWarning,
                                    message="Attempted to insert a get_attr")
            _, jvp = torch.func.linearize(lambda v: residual(args, v), u)

        def J(v):
            return mask * jvp(v) + (1.0 - mask) * v

        if linear_rtol is None:  # Eisenstat-Walker choice 2
            eta = ew_gamma * (fn / max(fn_prev, small)) ** 2
            safe = ew_gamma * eta_prev**2
            if safe > ew_max:
                eta = max(eta, safe)
            eta = max(eta, 0.5 * tol / max(fn, small))
            eta = min(max(eta, 1e-12), ew_max)
        else:
            eta = linear_rtol
        res = lin_solve(J, -f, rtol=eta, maxiter=linear_maxiter, dot=dot,
                        M_inv=M_inv)
        delta = res.x
        lin_total += res.iterations

        def decrease_ok(alpha, fn_t):
            return math.isfinite(fn_t) and fn_t <= (1.0 - 1e-4 * alpha) * fn

        # backtracking line search on ||F||; the trial's residual vector is
        # carried, so the accepted step needs no new residual
        alpha = 1.0
        f_t, fn_t = fnorm_of(u + alpha * delta)
        j = 0
        while not decrease_ok(alpha, fn_t) and j < ls_max:
            alpha = 0.5 * alpha
            f_t, fn_t = fnorm_of(u + alpha * delta)
            j += 1
        fn_prev, eta_prev = fn, eta
        if decrease_ok(alpha, fn_t):
            u, f, fn = u + alpha * delta, f_t, fn_t
        else:
            # exhausted without sufficient decrease: reject the step
            # (alpha = 0) and flag the stall
            stalled = True
        k += 1
    return NewtonResult(u, k, fn, fn <= tol, lin_total, stalled)

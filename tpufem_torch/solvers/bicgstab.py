"""BiCGStab for nonsymmetric operators.

Port of ``tpufem/solvers/bicgstab.py`` (deal.II's ``SolverBicgstab`` over
the device vector, SURVEY.md §1 L5).  The JAX package runs the iteration
in one ``lax.while_loop``; here the loop is Python and reads the residual
norm on the host once per step, as ``solvers/cg.py`` does.  The scalars
rho, alpha and omega stay on the device, and the arithmetic follows the
reference operation for operation (breakdown and non-finite exits, the
stall counter, the injectable ``dot``), so f64 iteration counts equal
tpufem's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.solvers.cg import _default_dot


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # full BiCGStab steps
    residual: float  # final ||r||
    converged: bool  # residual <= tol


def bicgstab_solve(
    A: Callable,
    b: torch.Tensor,
    M_inv: Optional[Callable] = None,
    x0: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 10000,
    dot: Callable = _default_dot,
    stall_iters: Optional[int] = None,
) -> BiCGStabResult:
    """Solve A x = b with right-preconditioned BiCGStab.

    A need not be symmetric.  ``M_inv`` is applied to the search
    directions (right preconditioning), so the reported residual is the
    true residual of the original system.  Breakdown (a zero rho or omega
    denominator) shows as a non-finite residual and exits; ``converged``
    reports whether the tolerance was met.  The mid-step check (||s||
    small after the alpha half-step) is folded into the exit test on the
    updated r, as in the reference."""
    if M_inv is None:
        M_inv = lambda r: r
    if x0 is None:
        x0 = torch.zeros_like(b)
    if stall_iters is None:
        stall_iters = (maxiter if b.element_size() >= 8
                       else max(100, maxiter // 10))

    bnorm = torch.sqrt(dot(b, b))
    tol = max(rtol * float(bnorm), atol)

    x = x0
    r = b - A(x0)
    rhat = r  # fixed shadow residual
    rnorm = float(torch.sqrt(dot(r, r)))
    p = v = torch.zeros_like(r)
    rho = alpha = omega = 1.0
    k, rn_best, since_best = 0, rnorm, 0

    while (rnorm > tol and k < maxiter and math.isfinite(rnorm)
           and since_best < stall_iters):
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M_inv(p)
        v = A(ph)
        alpha = rho_new / dot(rhat, v)
        sres = r - alpha * v
        sh = M_inv(sres)
        t = A(sh)
        omega = dot(t, sres) / dot(t, t)
        x = x + alpha * ph + omega * sh
        r = sres - omega * t
        rho = rho_new
        rnorm = float(torch.sqrt(dot(r, r)))  # the one host read per step
        k += 1
        if rnorm < rn_best:
            rn_best, since_best = rnorm, 0
        else:
            since_best += 1
    return BiCGStabResult(x, k, rnorm, rnorm <= tol)

"""Preconditioned conjugate-gradient solver.

Port of ``tpufem/solvers/cg.py::cg_solve``.  The JAX package runs the
whole iteration in one ``lax.while_loop``; PyTorch has no traced loop, so
here the loop is Python and reads the residual norm on the host once per
iteration, as deal.II's ``SolverCG`` does.  The arithmetic follows
``cg.py:92-128`` operation for operation, so f64 iteration counts equal
tpufem's, and the injectable ``dot``, ``stall_iters``, ``track_best``,
``p_dtype``, the NaN exit and the best-iterate return keep their meaning.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float  # final ||r||
    converged: bool  # residual <= tol (False on stall/maxiter/NaN)


def _default_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def cg_solve(
    A: Callable,
    b: torch.Tensor,
    M_inv: Optional[Callable] = None,
    x0: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 10000,
    dot: Callable = _default_dot,
    stall_iters: Optional[int] = None,
    track_best: Optional[bool] = None,
    p_dtype: torch.dtype | None = None,
) -> CGResult:
    """Solve A x = b with (optionally preconditioned) CG.

    ``stall_iters``: exit once no new residual minimum has been seen for
    this many iterations (f32 solves plateau at the rounding floor).
    Default: disabled for f64, max(100, maxiter // 10) otherwise.

    ``track_best``: keep the best iterate and return it on a stall/NaN
    exit; default on exactly when stall detection is active.  Iterates
    are fresh tensors, so keeping one is a reference, not a copy.

    ``p_dtype``: storage dtype of the search direction p (A receives the
    stored p and its result is cast back); x and r stay in b's dtype.
    """
    if M_inv is None:
        M_inv = lambda r: r
    if x0 is None:
        x0 = torch.zeros_like(b)
    if stall_iters is None:
        stall_iters = maxiter if b.element_size() >= 8 else max(100, maxiter // 10)
    if track_best is None:
        track_best = stall_iters < maxiter

    cdt = b.dtype
    store_p = (lambda v: v.to(p_dtype)) if p_dtype is not None else (lambda v: v)
    load_p = (lambda v: v.to(cdt)) if p_dtype is not None else (lambda v: v)

    bnorm = torch.sqrt(dot(b, b))
    tol = max(rtol * float(bnorm), atol)

    x = x0
    r = b - load_p(A(store_p(x0)))
    z = M_inv(r)
    rz = dot(r, z)
    p = store_p(z)
    rnorm = float(torch.sqrt(dot(r, r)))
    k, rn_best, since_best, x_best = 0, rnorm, 0, x0

    while (rnorm > tol and k < maxiter and math.isfinite(rnorm)
           and since_best < stall_iters):
        v = load_p(A(p))
        pf = load_p(p)
        pv = dot(pf, v)
        alpha = rz / pv
        x = x + alpha * pf
        r = r - alpha * v
        rnorm = float(torch.sqrt(dot(r, r)))  # the one host read per step
        z = M_inv(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = store_p(z + beta * pf)
        rz = rz_new
        k += 1
        if rnorm < rn_best:
            rn_best, since_best = rnorm, 0
            if track_best:
                x_best = x
        else:
            since_best += 1

    # exited on stall/NaN: return the best iterate seen; without the
    # best-iterate carry keep the final iterate and its residual
    use_best = since_best >= stall_iters or not math.isfinite(rnorm)
    if track_best and use_best:
        x, rnorm = x_best, rn_best
    return CGResult(x, k, rnorm, rnorm <= tol)


def make_jacobi(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner."""
    inv = 1.0 / diag
    return lambda r: inv * r

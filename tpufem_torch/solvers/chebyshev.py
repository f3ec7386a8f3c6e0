"""Chebyshev smoother and preconditioner (Jacobi-preconditioned).

Port of ``tpufem/solvers/chebyshev.py``, the counterpart of deal.II's
``PreconditionChebyshev`` over the device diagonal: the GMG smoother of
the reference's ``poisson_mg.cu`` (SURVEY.md §3.5: k operator applies
and a diagonal scale).  A Chebyshev step needs operator applies and
axpys only, no dot product.

The JAX package keeps theta and delta on the device and threads them
through ``jit``; here they are Python floats, read once when the
parameters are made.  The power iteration's start vector comes from
``power_start``, a ``torch.Generator`` draw (the parity tests put the
JAX package's draw in its place, so both packages estimate the same
eigenvalue).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ChebyshevParams(NamedTuple):
    theta: float  # (lam_max + lam_min) / 2 of D^-1 A
    delta: float  # (lam_max - lam_min) / 2
    degree: int


def power_start(n: int, seed: int, dtype: torch.dtype,
                device: torch.device | str) -> torch.Tensor:
    """The power iteration's start vector: n standard normal values from a
    CPU ``torch.Generator`` seeded with ``seed`` (the same vector on every
    device), in ``dtype`` on ``device``."""
    g = torch.Generator().manual_seed(seed)
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.randn(n, generator=g, dtype=draw).to(device=device,
                                                      dtype=dtype)


def estimate_lambda_max(A: Callable, inv_diag: torch.Tensor, n: int,
                        iters: int = 25, seed: int = 0) -> float:
    """Largest eigenvalue of D^-1 A by power iteration, times 1.05 for
    safety.  deal.II estimates it by CG-Lanczos; the smoothing range only
    needs a sound upper bound."""
    v = power_start(n, seed, inv_diag.dtype, inv_diag.device)
    for _ in range(iters):
        w = inv_diag * A(v)
        v = w / torch.linalg.norm(w)
    w = inv_diag * A(v)
    return float(torch.dot(v, w) / torch.dot(v, v)) * 1.05


def make_chebyshev_params(A: Callable, diag: torch.Tensor, n: int,
                          degree: int = 4, smoothing_range: float = 20.0
                          ) -> ChebyshevParams:
    """deal.II's convention: smooth the eigencomponents of D^-1 A in
    [lam_max / smoothing_range, 1.2 lam_max]."""
    lam_max = estimate_lambda_max(A, 1.0 / diag, n)
    upper = 1.2 * lam_max
    lower = lam_max / smoothing_range
    return ChebyshevParams(theta=0.5 * (upper + lower),
                           delta=0.5 * (upper - lower), degree=degree)


def chebyshev_smooth(A: Callable, inv_diag: torch.Tensor,
                     params: ChebyshevParams, b: torch.Tensor,
                     x0: torch.Tensor | None = None) -> torch.Tensor:
    """x ~ A^-1 b after ``degree`` Chebyshev steps (Saad, Alg. 12.1).

    With x0 None this is linear in b (a symmetric preconditioner); with x0
    it smooths an existing iterate (the V-cycle's pre- and
    post-smoothing)."""
    theta, delta, m = params.theta, params.delta, params.degree
    sigma1 = theta / delta
    rho0 = 1.0 / sigma1
    if x0 is None:
        r = b
        x = torch.zeros_like(b)
    else:
        x = x0
        r = b - A(x)
    d = (1.0 / theta) * (inv_diag * r)
    x = x + d
    rho_prev, d_prev = rho0, d
    for _ in range(m - 1):
        r = b - A(x)
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = rho * rho_prev * d_prev + (2.0 * rho / delta) * (inv_diag * r)
        x = x + d
        rho_prev, d_prev = rho, d
    return x

"""Restarted GMRES for nonsymmetric operators.

Port of ``tpufem/solvers/gmres.py`` (deal.II's ``SolverGMRES`` over the
device vector, SURVEY.md §1 L5).  The JAX package nests ``while_loop``s
in one program; here the restart cycles and the Arnoldi steps are Python
loops.  Each Arnoldi step reads its Hessenberg column (m + 1 values and
||w||) on the host once; the Givens rotations, the breakdown guards and
the least-squares solve of a cycle then run on those host floats (f64),
and only the basis and the iterate stay on the device.  The arithmetic
keeps the reference's order: CGS2 orthogonalisation through the injected
``dot``, vmapped over the basis rows (rows beyond j are zero, so their
products are exact zeros), the breakdown threshold relative to
the column's scale, the roll-back of a degenerate step, the stall
counter over cycles, and right preconditioning (``M_inv`` linear; the
reported residual is the true residual of the original system).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.solvers.cg import _default_dot


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # total Arnoldi steps
    residual: float  # final true ||r||
    converged: bool  # residual <= tol


def _back_substitute(R: list, g: list, j: int) -> list:
    """y solving the upper-triangular R[:j, :j] y = g[:j] (host floats)."""
    y = [0.0] * j
    for i in range(j - 1, -1, -1):
        s = g[i]
        for c in range(i + 1, j):
            s -= R[i][c] * y[c]
        y[i] = s / R[i][i]
    return y


def gmres_solve(
    A: Callable,
    b: torch.Tensor,
    M_inv: Optional[Callable] = None,
    x0: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 1000,
    restart: int = 30,
    dot: Callable = _default_dot,
    stall_cycles: int = 4,
) -> GMRESResult:
    """Solve A x = b with right-preconditioned restarted GMRES(m).

    ``maxiter`` counts Arnoldi steps (operator applies), not cycles.
    ``stall_cycles``: exit once no new residual minimum has been seen for
    this many restart cycles (f32 solves plateau at the rounding floor).
    The returned iterate is whatever the last completed cycle produced;
    ``converged`` reports whether the tolerance was met."""
    if M_inv is None:
        M_inv = lambda r: r
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = int(restart)
    finfo = torch.finfo(b.dtype)
    tiny, eps = finfo.tiny, finfo.eps

    def norm(v):
        return torch.sqrt(dot(v, v))

    tol = max(rtol * float(norm(b)), atol)

    def basis_dot(V, w):
        """(m + 1,) products of w with the basis rows, one batched call of
        the injected ``dot``; rows beyond j are zero."""
        return torch.func.vmap(lambda vi: dot(vi, w))(V)

    def cycle(x, k):
        """One restart cycle: Arnoldi to m (or convergence), then the
        least-squares update.  Returns (x, k, true residual)."""
        r = b - A(x)
        beta = float(norm(r))
        V = torch.stack([torch.zeros_like(b)] * (m + 1))
        V[0] = r / max(beta, tiny)
        R = [[0.0] * m for _ in range(m)]
        cs, sn = [0.0] * m, [0.0] * m
        g = [0.0] * (m + 1)
        g[0] = beta
        j, res, stop = 0, beta, False
        while (j < m and k < maxiter and res > tol and not stop
               and math.isfinite(res)):
            # one CGS2 Arnoldi step
            w = A(M_inv(V[j]))
            h1 = basis_dot(V, w)
            w = w - torch.tensordot(h1, V, dims=1)
            h2 = basis_dot(V, w)
            w = w - torch.tensordot(h2, V, dims=1)
            hnext_t = norm(w)
            col = torch.cat([h1 + h2, hnext_t[None]]).tolist()  # host read
            h, hnext = col[:m + 1], col[m + 1]
            # the breakdown threshold is relative to the column's scale
            # ||A M^-1 v_j|| (rotations keep it): rounding leaves ~eps*scale
            scale = math.sqrt(sum(v * v for v in h) + hnext * hnext)
            bk = eps * scale
            # hnext ~ 0: w / hnext is a noise direction that can overflow;
            # store a zero row instead (outside the live columns either way)
            V[j + 1] = (w / hnext_t.clamp_min(tiny) if hnext > bk
                        else torch.zeros_like(w))
            for i in range(j):  # the accumulated Givens rotations
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            hj = h[j]
            denom = math.sqrt(hj * hj + hnext * hnext)
            k += 1
            if denom <= bk:
                # degenerate column (the Krylov space hit the null space):
                # roll the step back (j unchanged) and end the cycle; the
                # last well-defined iterate is returned
                stop = True
                continue
            c, s = hj / max(denom, tiny), hnext / max(denom, tiny)
            cs[j], sn[j] = c, s
            h[j] = denom
            for i in range(m):
                R[i][j] = h[i]
            res = abs(-s * g[j])
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            j += 1
        if j:
            y = b.new_tensor(_back_substitute(R, g, j))
            x = x + M_inv(torch.tensordot(y, V[:j], dims=1))
        return x, k, float(norm(b - A(x)))

    x = x0
    rnorm = float(norm(b - A(x0)))
    k, rn_best, since_best = 0, rnorm, 0
    while (rnorm > tol and k < maxiter and math.isfinite(rnorm)
           and since_best < stall_cycles):
        x, k, rnorm = cycle(x, k)
        if rnorm < rn_best:
            rn_best, since_best = rnorm, 0
        else:
            since_best += 1
    return GMRESResult(x, k, rnorm, rnorm <= tol)

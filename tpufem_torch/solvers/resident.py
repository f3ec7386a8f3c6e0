"""Solver-resident Jacobi-CG: every solver vector lives in the K1 kernel's
resident layout, so each apply is one kernel launch.

Port of ``tpufem/solvers/resident.py::resident_jacobi_cg``.  The port's
resident layout is the plain ``(npts,)*3`` grid (``ResidentSeparable``),
so the padding of the JAX version reduces to reshapes; the constraint
mask algebra y = m·A(m·x) + (1-m)·x is either fused into the kernel
(``dirichlet=True``) or applied around it.
"""

from __future__ import annotations

import torch

from tpufem_torch.solvers.cg import CGResult, cg_solve


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Deterministic full-grid dot."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def resident_jacobi_cg(op, b: torch.Tensor, diag: torch.Tensor | None = None,
                       rtol: float = 1e-5, maxiter: int = 10000,
                       x0: torch.Tensor | None = None,
                       track_best: bool | None = None) -> CGResult:
    """Jacobi-preconditioned CG with solver-resident vectors.

    op: a ``LaplaceOperator`` whose MatrixFree carries a resident kernel
    (3D separable with ``use_pallas``), or an operator carrying its own
    ``.resident``.  b/diag/x0 are flat (n_dofs,) vectors on the kernel's
    device; the returned x is flat.  ``track_best`` is forwarded to
    :func:`cg_solve`.
    """
    rk = getattr(op, "resident", None)
    if rk is None:
        rk = op.mf.resident
    if rk is None:
        if op.mf.config.dim == 2:
            raise NotImplementedError(
                "ResidentTerms2D (K3) not ported yet (ROADMAP.md, queue 2)")
        raise ValueError("operator has no resident kernel (needs the 3D "
                         "separable scheme with use_pallas=True)")
    cdt, sdt = rk.compute_dt, rk.dt
    m = rk.pad_any(op.mf.interior_mask.to(cdt))
    bp = rk.pad_any(b.to(cdt))
    d = diag if diag is not None else op.diagonal()
    inv_diag = rk.pad_any(1.0 / d.to(cdt))
    x0p = None if x0 is None else rk.pad_any(x0.to(cdt))

    # bf16s kernels: the search direction is STORED in the kernel's bf16
    # layout (p_dtype), so the kernel reads half the bytes, while x and r
    # stay in the compute dtype.  The kernel's bf16 output drifts the
    # recurrence residual from the true one below ~1e-3, so for bf16s the
    # returned residual/converged come from the TRUE residual, recomputed
    # with one extra apply.
    p_dtype = None if sdt == cdt else sdt
    if rk.dirichlet:  # the kernel applies y = m·A(m·x) + (1-m)·x itself
        def A(gp):
            return rk.raw(gp.to(sdt)).to(cdt)
    else:
        ms = m.to(sdt)

        def A(gp):
            gp = gp.to(sdt)
            return m * rk.raw(ms * gp).to(cdt) + (1.0 - m) * gp.to(cdt)

    res = cg_solve(A, bp, M_inv=lambda r: inv_diag * r, x0=x0p, rtol=rtol,
                   maxiter=maxiter, dot=_dot3, p_dtype=p_dtype,
                   track_best=track_best)
    rn, converged = res.residual, res.converged
    if p_dtype is not None:
        rt = bp - A(res.x)
        rn = float(torch.sqrt(_dot3(rt, rt)))
        converged = rn <= rtol * float(torch.sqrt(_dot3(bp, bp)))
    return CGResult(rk.unpad(res.x), res.iterations, rn, converged)

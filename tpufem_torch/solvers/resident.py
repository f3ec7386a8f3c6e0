"""Solver-resident CG: every solver vector lives in the resident kernel's
layout, so each apply is one kernel launch.

Port of ``tpufem/solvers/resident.py``: ``resident_jacobi_cg`` and
``resident_gmg_cg`` (the V-cycle's fine level resident).  The port's
resident kernels are K1 (``ResidentSeparable``, the 3D Laplace), K4
(``ResidentTerms``, 3D terms) and K3 (``ResidentTerms2D``, 2D).  They
keep their vectors in the ring's resident layout, ``(npts, npts, X)`` in
3D and ``(npts, X)`` in 2D, x zero-padded to X (``pad_any``).  The mask,
the RHS, the inverse diagonal and x0 are computed flat, then padded with
zeros; the dots run over the whole layout, where the pad adds nothing.
The constraint mask algebra y = m·A(m·x) + (1-m)·x is either fused into
the kernel (``dirichlet=True``: the full-box boundary) or applied around
it.
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
    (separable scheme with ``use_pallas``), or an operator carrying its
    own ``.resident``.  b/diag/x0 are flat (n_dofs,) vectors on the kernel's
    device; the returned x is flat.  ``track_best`` is forwarded to
    :func:`cg_solve`.
    """
    rk = getattr(op, "resident", None)
    if rk is None:
        rk = op.mf.resident
    if rk is None:
        raise ValueError("operator has no resident kernel (needs the "
                         "separable scheme with use_pallas=True)")
    cdt, sdt = rk.compute_dt, rk.dt
    # computed flat, then padded with zeros (1/diag of the pad: 0, not inf)
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


def resident_gmg_cg(mg, b: torch.Tensor, rtol: float = 1e-5,
                    maxiter: int = 10000,
                    track_best: bool | None = None) -> CGResult:
    """GMG-preconditioned CG with the fine level solver-resident.

    mg: a ``GeometricMultigrid`` whose fine level carries a resident
    kernel (``mg.resident_context()`` not None).  b is flat (n_dofs,) on
    the kernel's device; the returned x is flat.  ``track_best`` is
    forwarded to :func:`cg_solve`.
    """
    ctx = mg.resident_context()
    if ctx is None:
        raise ValueError("multigrid fine level has no resident kernel (needs "
                         "use_pallas=True and at least two levels)")
    A, m_inv, rk = ctx
    res = cg_solve(A, rk.pad(b), M_inv=m_inv, rtol=rtol, maxiter=maxiter,
                   dot=_dot3, track_best=track_best)
    return CGResult(rk.unpad(res.x), res.iterations, res.residual,
                    res.converged)

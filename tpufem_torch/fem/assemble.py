"""Host-side (numpy, f64) assembled-matrix oracle and CPU operator twin.

Reference analogue: two components in one —
- ``laplace_operator_cpu.h``: the CPU verification twin used for the 1e-10
  parity acceptance test (SURVEY.md §2, §4.2);
- the assembled ``SparseMatrix`` fed to the cuSPARSE SpMV baseline
  (``cuda_sparse_matrix.h`` / ``bmspmv.cu``, SURVEY.md §2, §4.3) — here a
  scipy CSR that also seeds the BCOO SpMV benchmark (tpufem.ops.sparse).

Assembly is naive quadrature (no sum factorization) on purpose: an
independent formulation, so agreement with the matrix-free device path is a
meaningful cross-check.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mapping import Metric, compute_metric
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo


def cell_basis_gradients(p: int, dim: int, quad: Quadrature) -> np.ndarray:
    """G[q, j, a] = d phi_j / d xi_a at tensor qpoint q (reference cell).

    j runs over the (p+1)^dim lexicographic local nodes (x fastest), q over
    the nq1^dim lexicographic tensor qpoints (x fastest).
    """
    si = ShapeInfo(p, quad)
    n1, nq1 = si.n1, si.nq1
    S, D = si.S, si.D
    nq, nn = nq1**dim, n1**dim
    qi = np.arange(nq)
    ji = np.arange(nn)
    Q = np.stack([(qi // nq1**a) % nq1 for a in range(dim)], axis=-1)
    Jn = np.stack([(ji // n1**a) % n1 for a in range(dim)], axis=-1)
    G = np.empty((nq, nn, dim))
    for a in range(dim):
        val = np.ones((nq, nn))
        for b in range(dim):
            M = D if b == a else S
            val *= M[Q[:, b]][:, Jn[:, b]]
        G[:, :, a] = val
    return G


def cell_basis_values(p: int, dim: int, quad: Quadrature) -> np.ndarray:
    """V[q, j] = phi_j(xi_q)."""
    si = ShapeInfo(p, quad)
    n1, nq1 = si.n1, si.nq1
    nq, nn = nq1**dim, n1**dim
    qi = np.arange(nq)
    ji = np.arange(nn)
    Q = np.stack([(qi // nq1**a) % nq1 for a in range(dim)], axis=-1)
    Jn = np.stack([(ji // n1**a) % n1 for a in range(dim)], axis=-1)
    V = np.ones((nq, nn))
    for b in range(dim):
        V *= si.S[Q[:, b]][:, Jn[:, b]]
    return V


def assemble_laplace(
    dofs: DoFHandler,
    quad: Quadrature | None = None,
    coefficient=None,
    metric: Metric | None = None,
) -> sp.csr_matrix:
    """Assemble the (unconstrained) global Laplace stiffness matrix.

    K[i,j] = sum_cells int coef * grad(phi_i) . grad(phi_j) dx, evaluated by
    per-cell quadrature with the same metric data the device path caches.
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 1)
    if metric is None:
        metric = compute_metric(mesh, quad, need_points=coefficient is not None)
    gen = metric.to_general()
    G = cell_basis_gradients(p, d, quad)  # (nq, nn, d)
    # physical gradients: Gp[c,q,j,a] = inv_jac[c,q,b,a] * G[q,j,b]
    Gp = np.einsum("cqba,qjb->cqja", gen.inv_jac, G)
    w = gen.jxw  # (nc, nq)
    if coefficient is not None:
        if gen.quad_points is None:
            gen2 = compute_metric(mesh, quad, need_points=True)
            pts = gen2.quad_points
        else:
            pts = gen.quad_points
        w = w * coefficient(pts.reshape(-1, d)).reshape(w.shape)
    Ke = np.einsum("cqja,cqka,cq->cjk", Gp, Gp, w)
    nn = Ke.shape[1]
    rows = np.repeat(dofs.cell_dofs, nn, axis=1).ravel()
    cols = np.tile(dofs.cell_dofs, (1, nn)).ravel()
    K = sp.coo_matrix(
        (Ke.ravel(), (rows, cols)), shape=(dofs.n_dofs, dofs.n_dofs)
    ).tocsr()
    return K


def assemble_mass(
    dofs: DoFHandler,
    quad: Quadrature | None = None,
    coefficient=None,
) -> sp.csr_matrix:
    """Assemble the global mass matrix M[i,j] = int coef phi_i phi_j dx
    with the same quadrature the device path uses (oracle for the generic
    mass/Helmholtz operators)."""
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 1)
    metric = compute_metric(mesh, quad, need_points=coefficient is not None)
    gen = metric.to_general()
    V = cell_basis_values(p, d, quad)  # (nq, nn)
    w = gen.jxw
    if coefficient is not None:
        pts = (
            gen.quad_points
            if gen.quad_points is not None
            else compute_metric(mesh, quad, need_points=True).quad_points
        )
        w = w * coefficient(pts.reshape(-1, d)).reshape(w.shape)
    Me = np.einsum("qj,qk,cq->cjk", V, V, w)
    nn = Me.shape[1]
    rows = np.repeat(dofs.cell_dofs, nn, axis=1).ravel()
    cols = np.tile(dofs.cell_dofs, (1, nn)).ravel()
    return sp.coo_matrix(
        (Me.ravel(), (rows, cols)), shape=(dofs.n_dofs, dofs.n_dofs)
    ).tocsr()


def assemble_convection(
    dofs: DoFHandler,
    velocity,
    quad: Quadrature | None = None,
) -> sp.csr_matrix:
    """Assemble the global convection matrix
    C[i,j] = sum_cells int phi_i (b . grad(phi_j)) dx
    for a velocity field ``velocity(pts) -> (npts, dim)``.

    Oracle for the nonsymmetric generic operators
    (tpufem.operators.generic.convection_diffusion_operator).
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 1)
    metric = compute_metric(mesh, quad, need_points=True)
    gen = metric.to_general()
    V = cell_basis_values(p, d, quad)  # (nq, nn)
    G = cell_basis_gradients(p, d, quad)  # (nq, nn, d)
    Gp = np.einsum("cqba,qjb->cqja", gen.inv_jac, G)
    bvals = velocity(gen.quad_points.reshape(-1, d)).reshape(
        mesh.n_cells, -1, d
    )  # (nc, nq, d)
    Ce = np.einsum("qj,cqka,cqa,cq->cjk", V, Gp, bvals, gen.jxw)
    nn = Ce.shape[1]
    rows = np.repeat(dofs.cell_dofs, nn, axis=1).ravel()
    cols = np.tile(dofs.cell_dofs, (1, nn)).ravel()
    return sp.coo_matrix(
        (Ce.ravel(), (rows, cols)), shape=(dofs.n_dofs, dofs.n_dofs)
    ).tocsr()


def assemble_elasticity(
    dofs: DoFHandler,
    mu: float = 1.0,
    lam: float = 1.0,
    quad: Quadrature | None = None,
) -> sp.csr_matrix:
    """Assemble the global linear-elasticity stiffness matrix for
    a(u,v) = int 2 mu eps(u):eps(v) + lam (div u)(div v) dx with
    block-wise component ordering: global index = a * n_dofs + i for
    component a, scalar dof i (the layout of operators.vector).

    Uses the expanded step-8 identity
    K[(a i),(b j)] = int mu d_b phi_i d_a phi_j
                   + mu delta_ab grad(phi_i).grad(phi_j)
                   + lam d_a phi_i d_b phi_j dx
    — an independent formulation from the device functor's
    sigma(eps)-based submission, so agreement cross-checks the algebra.
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 1)
    gen = compute_metric(mesh, quad).to_general()
    G = cell_basis_gradients(p, d, quad)  # (nq, nn, d)
    Gp = np.einsum("cqba,qjb->cqja", gen.inv_jac, G)  # (nc, nq, nn, d)
    w = gen.jxw  # (nc, nq)
    # per-cell blocks Ke[c, a, i, b, j]
    grad_dot = np.einsum("cqia,cqja,cq->cij", Gp, Gp, w)
    cross = np.einsum("cqib,cqja,cq->cabij", Gp, Gp, w)  # d_b phi_i d_a phi_j
    nc, _, nn, _ = Gp.shape
    Ke = np.zeros((nc, d, nn, d, nn))
    for a in range(d):
        for b in range(d):
            blk = mu * cross[:, a, b]  # int mu d_b phi_i d_a phi_j
            if a == b:
                blk = blk + mu * grad_dot
            blk = blk + lam * np.einsum(
                "cqi,cqj,cq->cij", Gp[..., a], Gp[..., b], w
            )
            Ke[:, a, :, b, :] = blk
    n = dofs.n_dofs
    cd = dofs.cell_dofs  # (nc, nn)
    rows = (
        np.arange(d)[None, :, None, None, None] * n
        + cd[:, None, :, None, None]
    )
    cols = (
        np.arange(d)[None, None, None, :, None] * n
        + cd[:, None, None, None, :]
    )
    rows, cols = np.broadcast_arrays(rows, cols)
    return sp.coo_matrix(
        (Ke.ravel(), (rows.ravel(), cols.ravel())), shape=(d * n, d * n)
    ).tocsr()


def assemble_rhs(
    dofs: DoFHandler, f, quad: Quadrature | None = None
) -> np.ndarray:
    """b[i] = sum_cells int f * phi_i dx (host quadrature).

    Reference analogue: the host-assembled RHS in poisson.cu (SURVEY.md §3.1).
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 2)
    metric = compute_metric(mesh, quad, need_points=True).to_general()
    V = cell_basis_values(p, d, quad)  # (nq, nn)
    fvals = f(metric.quad_points.reshape(-1, d)).reshape(mesh.n_cells, -1)
    be = np.einsum("qj,cq,cq->cj", V, fvals, metric.jxw)
    b = np.zeros(dofs.n_dofs)
    np.add.at(b, dofs.cell_dofs.ravel(), be.ravel())
    return b


def _error_parts(dofs, u_h, u_exact, grad_exact, quad, want_l2, want_h1):
    """(L2², H1-seminorm²) by quadrature in ONE metric sweep."""
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    if quad is None:
        quad = Quadrature.gauss(p + 2)
    metric = compute_metric(mesh, quad, need_points=True).to_general()
    u_loc = u_h[dofs.cell_dofs]  # (nc, nn)
    pts = metric.quad_points.reshape(-1, d)
    l2_sq = semi_sq = 0.0
    if want_l2:
        V = cell_basis_values(p, d, quad)
        uh_q = u_loc @ V.T  # (nc, nq)
        ue_q = u_exact(pts).reshape(uh_q.shape)
        l2_sq = np.sum((uh_q - ue_q) ** 2 * metric.jxw)
    if want_h1:
        if grad_exact is None:
            raise ValueError(
                "H1 norms need grad_exact(pts) -> (npts, dim)")
        G = cell_basis_gradients(p, d, quad)  # (nq, nn, d)
        # physical gradient of u_h (same convention as assemble_laplace)
        gh = np.einsum("cqba,qjb,cj->cqa", metric.inv_jac, G, u_loc)
        ge = grad_exact(pts).reshape(gh.shape)
        semi_sq = np.sum(np.sum((gh - ge) ** 2, axis=-1) * metric.jxw)
    return float(l2_sq), float(semi_sq)


def integrate_difference(
    dofs: DoFHandler,
    u_h: np.ndarray,
    u_exact,
    quad: Quadrature | None = None,
    norm: str = "l2",
    grad_exact=None,
) -> float:
    """Quadrature norm of (u_h - u_exact) — VectorTools::
    integrate_difference analogue (SURVEY.md §3.1 last line).

    ``norm``: "l2" (default), "h1_semi" (gradient error only) or "h1"
    (sqrt(L2^2 + semi^2)) — the deal.II L2_norm / H1_seminorm / H1_norm
    trio.  The H1 variants need ``grad_exact(pts) -> (npts, dim)``.
    For both L2 and H1 at once use :func:`integrate_errors` (one metric
    sweep instead of two).
    """
    if norm not in ("l2", "h1_semi", "h1"):
        raise ValueError(f"norm must be 'l2', 'h1_semi' or 'h1', got "
                         f"{norm!r}")
    l2_sq, semi_sq = _error_parts(
        dofs, u_h, u_exact, grad_exact, quad,
        want_l2=norm in ("l2", "h1"), want_h1=norm in ("h1_semi", "h1"))
    return float(np.sqrt(l2_sq + semi_sq))


def integrate_errors(
    dofs: DoFHandler,
    u_h: np.ndarray,
    u_exact,
    grad_exact,
    quad: Quadrature | None = None,
) -> tuple[float, float]:
    """(L2 error, H1-seminorm error) in ONE metric/quadrature sweep."""
    l2_sq, semi_sq = _error_parts(dofs, u_h, u_exact, grad_exact, quad,
                                  want_l2=True, want_h1=True)
    return float(np.sqrt(l2_sq)), float(np.sqrt(semi_sq))

"""Geometry mapping: cached inverse Jacobians and JxW per quadrature point.

Reference analogue: the ``inv_jac`` / ``JxW`` (and optional quadrature-point)
arrays the reference's ``MatrixFreeGpu::reinit`` computes with deal.II
``FEValues`` and uploads per color (SURVEY.md §3.2).  Two storage modes:

- ``cartesian``: axis-aligned box cells — J is a constant diagonal per cell;
  store per-cell 1/h and detJ only (memory O(nc·d) instead of O(nc·nq·d²)).
  This is the fast path for hyper_cube meshes, including adaptive ones.
- ``general``: per-cell-per-qpoint dense J⁻¹ and JxW from the Q1 multilinear
  geometry mapping of (possibly transformed) corner vertices; needed for
  curved/transformed meshes (deal.II MappingQ1 analogue).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.fem.mesh import Mesh, _corner_offsets
from tpufem_torch.fem.quadrature import Quadrature


@dataclasses.dataclass
class Metric:
    kind: str  # 'cartesian' | 'general'
    dim: int
    n_cells: int
    nq: int  # total quadrature points per cell
    # cartesian fields
    inv_h: np.ndarray | None = None  # (nc, d)
    det: np.ndarray | None = None  # (nc,)
    w_q: np.ndarray | None = None  # (nq,) tensor weights
    # general fields
    inv_jac: np.ndarray | None = None  # (nc, nq, d, d)
    jxw: np.ndarray | None = None  # (nc, nq)
    # optional
    quad_points: np.ndarray | None = None  # (nc, nq, d) physical coords

    def to_general(self) -> "Metric":
        """Expand a cartesian metric to general arrays (oracle/debug use)."""
        if self.kind == "general":
            return self
        nc, nq, d = self.n_cells, self.nq, self.dim
        inv_jac = np.zeros((nc, nq, d, d))
        for a in range(d):
            inv_jac[:, :, a, a] = self.inv_h[:, a][:, None]
        jxw = self.det[:, None] * self.w_q[None, :]
        return Metric(
            "general", d, nc, nq, inv_jac=inv_jac, jxw=jxw,
            quad_points=self.quad_points,
        )


def _lagrange_1d(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the Lagrange basis at ``nodes``
    evaluated at ``x``: (V[q, j], D[q, j])."""
    n = len(nodes)
    V = np.ones((len(x), n))
    D = np.zeros((len(x), n))
    for j in range(n):
        for k in range(n):
            if k == j:
                continue
            fac = (x - nodes[k]) / (nodes[j] - nodes[k])
            # derivative via product rule before multiplying this factor
            D[:, j] = D[:, j] * fac + V[:, j] / (nodes[j] - nodes[k])
            V[:, j] = V[:, j] * fac
    return V, D


def compute_metric(
    mesh: Mesh, quad: Quadrature, need_points: bool = False
) -> Metric:
    d = mesh.dim
    nq1 = quad.n_1d
    nq = nq1**d
    nc = mesh.n_cells
    qp_ref = quad.tensor_points(d)  # (nq, d), x fastest

    # DISCRETE polynomial geometry (MappingQ analogue, SURVEY.md §2 L0):
    # per-qpoint J from the Q_m interpolant of the stored support points
    # — geometry known only discretely (perturbed nodes, imported
    # meshes); takes precedence over transform/transform_jac
    sp = getattr(mesh, "support_points", None)
    if sp is not None:
        m = mesh.mapping_degree
        n1 = m + 1
        nodes = np.linspace(0.0, 1.0, n1)
        V1, D1 = _lagrange_1d(nodes, quad.points_1d)  # (nq1, n1)
        nv = n1**d
        kidx = np.arange(nv)
        qidx = np.arange(nq)
        N = np.ones((nq, nv))
        dN = np.ones((nq, nv, d))
        for a in range(d):
            ka = (kidx // n1**a) % n1  # node 1D index on axis a
            qa = (qidx // nq1**a) % nq1  # qpoint 1D index on axis a
            Va = V1[qa][:, ka]  # (nq, nv)
            Da = D1[qa][:, ka]
            N = N * Va
            for b in range(d):
                dN[:, :, b] = dN[:, :, b] * (Da if b == a else Va)
        J = np.einsum("cka,qkb->cqab", np.asarray(sp, np.float64), dN)
        det = np.linalg.det(J)
        if np.any(det <= 0):
            raise ValueError(
                "mapping produced non-positive Jacobian determinant")
        metric = Metric(
            "general", d, nc, nq,
            inv_jac=np.linalg.inv(J),
            jxw=det * quad.tensor_weights(d)[None, :],
        )
        if need_points:
            metric.quad_points = np.einsum(
                "qk,cka->cqa", N, np.asarray(sp, np.float64))
        return metric

    if mesh.transform is None:
        # axis-aligned boxes: h_a = size * (upper-lower)_a / U
        h = (
            mesh.sizes[:, None].astype(np.float64)
            * (mesh.upper - mesh.lower)[None, :]
            / mesh.U
        )  # (nc, d)
        metric = Metric(
            "cartesian", d, nc, nq,
            inv_h=1.0 / h,
            det=np.prod(h, axis=1),
            w_q=quad.tensor_weights(d),
        )
        if need_points:
            logical = (
                mesh.origins[:, None, :] + mesh.sizes[:, None, None] * qp_ref[None]
            ) / mesh.U
            metric.quad_points = mesh.to_physical(logical)
        return metric

    # general + analytic Jacobian: EXACT mapping geometry (the
    # reference's higher-order MappingQ analogue) — per-qpoint J from the
    # transform's closed-form derivative, chained through the per-cell
    # affine reference->logical map
    if getattr(mesh, "transform_jac", None) is not None:
        logical = (
            mesh.origins[:, None, :] + mesh.sizes[:, None, None] * qp_ref[None]
        ) / mesh.U  # (nc, nq, d)
        span = mesh.upper - mesh.lower
        x = (mesh.lower + span * logical).reshape(-1, d)
        tj = mesh.transform_jac(x).reshape(nc, nq, d, d)
        # d phys_a / d xi_b = tj[a, b] * span_b * size_cell / U
        scale = (
            span[None, None, :] * mesh.sizes[:, None].astype(np.float64)[
                :, :, None] / mesh.U
        )  # (nc, 1, d)
        J = tj * scale[:, :, None, :]
        det = np.linalg.det(J)
        if np.any(det <= 0):
            raise ValueError(
                "mapping produced non-positive Jacobian determinant"
            )
        metric = Metric(
            "general", d, nc, nq,
            inv_jac=np.linalg.inv(J),
            jxw=det * quad.tensor_weights(d)[None, :],
        )
        if need_points:
            metric.quad_points = mesh.to_physical(logical)
        return metric

    # general: Q1 multilinear mapping of transformed corner vertices
    verts = mesh.cell_vertices()  # (nc, 2^d, d) physical
    corners = _corner_offsets(d)  # (2^d, d)
    # multilinear shape gradients at reference qpoints:
    # dN_k/dxi_b (xi) = (+-1) * prod_{a != b} (xi_a if c_a else 1-xi_a)
    nv = 2**d
    dN = np.empty((nq, nv, d))
    for k in range(nv):
        c = corners[k]
        fac = np.where(c[None, :] == 1, qp_ref, 1.0 - qp_ref)  # (nq, d)
        for b in range(d):
            others = [a for a in range(d) if a != b]
            prod = np.prod(fac[:, others], axis=1) if others else np.ones(nq)
            dN[:, k, b] = (1.0 if c[b] == 1 else -1.0) * prod
    # J[c,q,a,b] = sum_k verts[c,k,a] dN[q,k,b]
    J = np.einsum("cka,qkb->cqab", verts, dN)
    det = np.linalg.det(J)
    if np.any(det <= 0):
        raise ValueError("mapping produced non-positive Jacobian determinant")
    inv_jac = np.linalg.inv(J)
    jxw = det * quad.tensor_weights(d)[None, :]
    metric = Metric("general", d, nc, nq, inv_jac=inv_jac, jxw=jxw)
    if need_points:
        N = np.empty((nq, nv))
        for k in range(nv):
            c = corners[k]
            fac = np.where(c[None, :] == 1, qp_ref, 1.0 - qp_ref)
            N[:, k] = np.prod(fac, axis=1)
        metric.quad_points = np.einsum("qk,cka->cqa", N, verts)
    return metric

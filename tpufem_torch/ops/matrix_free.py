"""MatrixFree: the port's device data for the matrix-free Laplace apply.

Port of ``tpufem/ops/matrix_free.py::MatrixFree.build`` for the separable
scheme (``scatter="separable"``) on a uniform mesh.  The operator is
either
- the Laplace factorisation of a uniform Cartesian grid, per-axis 1D
  operators ``Ks``/``Ms`` (the plain apply); with ``use_pallas`` the CUDA
  kernels attach where the JAX package attaches its Pallas kernels
  (``matrix_free.py:357-424``): K2 (``KernelSeparable``) in 2D and 3D, K1
  (``ResidentSeparable``) in 3D and K3 (``ResidentTerms2D``) in 2D; or
- a sum of tensor products of weighted 1D matrices, ``terms``: an
  orthogonal curved mesh (``Mesh.separable_metric``, the hyper_shell), a
  separable coefficient (``coefficient_axes``) or a CP-expanded generic
  one (``coefficient_cp_tol``); with ``use_pallas`` K4 (``ResidentTerms``)
  or K3 attaches (``_terms_with_kernel``).
A kernel that cannot be built raises; nothing falls back to the plain
apply on a CUDA device.

Every scheme, mesh and option outside the slice raises
NotImplementedError naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mapping import Metric, compute_metric
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.ops.kernel_separable import KernelSeparable, ResidentSeparable
from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
from tpufem_torch.ops.separable import (
    build_separable_metric_terms,
    build_separable_operators,
    cartesian_coef_terms,
    cp_coef_terms,
)
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype

_NOT_PORTED = {
    "auto": "the structured tier (the JAX 'auto' default)",
    "structured": "the structured tier (the JAX 'auto' default)",
    "incidence": "incidence, colored and dense with hanging nodes",
    "colored": "incidence, colored and dense with hanging nodes",
    "dense": "incidence, colored and dense with hanging nodes",
    "boxes": "the adaptive box tier",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


def resolve_device(device: torch.device | str) -> torch.device:
    """The requested device; a CUDA device that is absent raises (the port
    never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch version on the CPU")
    return device


def _fuse_mask(config, interior: np.ndarray, dofs: DoFHandler,
               npts: int) -> bool:
    """Whether a 3D resident kernel (K1, K4) fuses the Dirichlet mask: the
    constrained set is the DoF handler's boundary and that is the full
    boundary of the (npts,)^3 box, whose mask is separable (the kernels
    fold it into their 1D tables).  ``config.pallas_dirichlet``: None =
    auto, fuse exactly when representable; True requires it."""
    g = np.arange(npts)
    e = (g == 0) | (g == npts - 1)
    box = (e[:, None, None] | e[None, :, None] | e[None, None, :]).reshape(-1)
    plain_mask = (np.array_equal(interior == 0.0, dofs.boundary_mask)
                  and np.array_equal(dofs.boundary_mask, box))
    if config.pallas_dirichlet and not plain_mask:
        # the fused kernel bakes the FULL-boundary separable mask in; any
        # other constraint set would be mis-masked
        raise ValueError(
            "pallas_dirichlet=True requires the plain full-boundary "
            "Dirichlet mask (no extra constraints / custom "
            "constrained_mask)")
    return plain_mask if config.pallas_dirichlet is None \
        else config.pallas_dirichlet


def _terms_with_kernel(terms, npts, p, d, config, device, interior, dofs):
    """The K4 (3D, the mask fused by ``_fuse_mask``'s rule) or K3 (2D)
    wrapper of a sum-of-tensor-products operator under ``use_pallas``,
    else None (JAX ``matrix_free.py:44-66``, which falls back to its XLA
    apply where the kernel's tiling is unmet; here a kernel that cannot be
    built raises)."""
    if not config.use_pallas:
        return None
    dt = torch_dtype(config.dtype)
    if d == 3:
        return ResidentTerms(npts, p, terms, dt, mode=config.pallas_mode,
                             dirichlet=_fuse_mask(config, interior, dofs,
                                                  npts),
                             device=device)
    return ResidentTerms2D(npts, p, terms, dt, mode=config.pallas_mode,
                           device=device)


@dataclasses.dataclass
class MatrixFree:
    """Static + device data for one (uniform mesh, degree) instance."""

    config: FemConfig
    mesh: Mesh
    dofs: DoFHandler
    device: torch.device
    n_dofs: int
    npts: int  # grid points per axis: cells per axis * p + 1
    interior_mask: torch.Tensor  # (n_dofs,) 1 unconstrained, 0 constrained
    Ks: list | None = None  # per-axis (npts, npts) 1D stiffness, x first
    Ms: list | None = None  # per-axis 1D mass (both config dtype)
    # sum-of-tensor-products operator: terms[a][b] (npts, npts), b = 0 is x
    terms: list | None = None
    kernel: KernelSeparable | None = None  # K2: flat vmult (use_pallas)
    # solver-resident kernel: K1 (3D Laplace), K3 (2D), K4 (3D terms)
    resident: ResidentSeparable | ResidentTerms | ResidentTerms2D | None = None
    quad: Quadrature | None = None
    host_metric: Metric | None = None  # for the host closed-form diagonal
    coef_q: np.ndarray | None = None  # (nc, nq) f64 coefficient at qpoints
    # certified relative coefficient error of a CP-expanded operator
    coef_cp_err: float | None = None
    jacobi_diag: torch.Tensor | None = None  # given diagonal (bridge.py)

    @classmethod
    def build(cls, mesh: Mesh, dofs: DoFHandler, config: FemConfig,
              device: torch.device | str, coefficient=None,
              constrained_mask: np.ndarray | None = None,
              coefficient_axes: list | None = None,
              coefficient_cp_tol: float | None = None,
              coefficient_cp_max_rank: int = 6) -> "MatrixFree":
        """Host setup (the reference's ``reinit``) for the separable
        scheme on a uniform mesh.

        ``coefficient_axes``: a separable variable coefficient, d
        per-axis callables with c(x) = prod_a c_a(x_a); the operator
        factors exactly into weighted 1D matrices.  The pointwise
        coefficient is synthesized from it for the diagonal.

        ``coefficient_cp_tol``: with a generic pointwise ``coefficient``,
        CP-expand it at the quadrature grid to this relative tolerance
        (up to ``coefficient_cp_max_rank`` ranks, d terms each); the
        achieved error is ``coef_cp_err``.
        """
        p, d = config.degree, config.dim
        if mesh.dim != d or dofs.degree != p:
            raise ValueError("mesh/dofs do not match the config's dim/degree")
        if config.scatter != "separable":
            raise not_ported(f"scatter={config.scatter!r}",
                             _NOT_PORTED[config.scatter])
        if coefficient_axes is not None:
            if coefficient is not None:
                raise ValueError(
                    "pass either coefficient or coefficient_axes, not both")
            if len(coefficient_axes) != d:
                raise ValueError(f"coefficient_axes needs {d} callables")
            cax = list(coefficient_axes)

            def coefficient(pts, _cax=cax):  # noqa: F811
                out = np.ones(pts.shape[0])
                for a, ca in enumerate(_cax):
                    out = out * np.asarray(ca(pts[:, a]))
                return out
        elif coefficient is not None and coefficient_cp_tol is None:
            raise not_ported("a pointwise variable coefficient without "
                             "coefficient_cp_tol",
                             "the structured tier (the JAX 'auto' default)")
        if not mesh.is_uniform:
            raise not_ported("hanging nodes",
                             "incidence, colored and dense with hanging "
                             "nodes")
        if mesh.support_points is not None or (
                mesh.transform is not None and mesh.separable_metric is None):
            raise not_ported("a curved mesh without a separable metric",
                             "the structured tier (the JAX 'auto' default)")
        if config.nq1 != p + 1:
            raise ValueError("separable scheme needs nq1 == p+1")
        quad = Quadrature.gauss(config.nq1)
        metric = compute_metric(mesh, quad,
                                need_points=coefficient is not None)
        if metric.kind == "general" and coefficient is not None:
            raise ValueError("the separable scheme takes a variable "
                             "coefficient on a Cartesian mesh only")
        coef_q = None
        if coefficient is not None:
            coef_q = np.asarray(coefficient(metric.quad_points.reshape(
                -1, d)), np.float64).reshape(mesh.n_cells, -1)
        if constrained_mask is None:
            constrained_mask = dofs.boundary_mask
        interior = (~constrained_mask).astype(np.float64)
        n = int(mesh.U // mesh.sizes[0])
        common = dict(interior=interior, quad=quad, host_metric=metric)
        if metric.kind == "general":
            # orthogonal curved mesh (polar/spherical shell): the operator
            # factors exactly into sums of tensor products of weighted 1D
            # matrices (JAX matrix_free.py:262-279)
            terms = build_separable_metric_terms(
                p, d, config.nq1, n, mesh.separable_metric, np.float64)
            return cls.from_terms(config, mesh, dofs, device, terms,
                                  **common)
        if coefficient_axes is not None:
            terms = cartesian_coef_terms(p, d, config.nq1, n, mesh.lower,
                                         mesh.upper, coefficient_axes,
                                         np.float64)
            return cls.from_terms(config, mesh, dofs, device, terms,
                                  coef_q=coef_q, **common)
        if coefficient is not None:  # with coefficient_cp_tol
            terms, cp_err = cp_coef_terms(
                p, d, config.nq1, n, mesh.lower, mesh.upper, coefficient,
                np.float64, tol=coefficient_cp_tol,
                max_rank=coefficient_cp_max_rank)
            return cls.from_terms(config, mesh, dofs, device, terms,
                                  coef_q=coef_q, coef_cp_err=cp_err,
                                  **common)
        h = 1.0 / metric.inv_h[0]  # (d,) physical cell widths
        Ks, Ms = build_separable_operators(p, d, config.nq1, n, h,
                                           np.float64)
        return cls.from_operators(config, mesh, dofs, device, Ks, Ms,
                                  **common)

    @classmethod
    def from_operators(cls, config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                       device: torch.device | str, Ks, Ms,
                       interior: np.ndarray, quad=None, host_metric=None,
                       jacobi_diag: np.ndarray | None = None) -> "MatrixFree":
        """MatrixFree from host arrays: per-axis f64 1D operators and the
        interior mask; attaches the kernels under ``config.use_pallas``."""
        p, d = config.degree, config.dim
        device = resolve_device(device)
        dt = torch_dtype(config.dtype)
        npts = int(mesh.U // mesh.sizes[0]) * p + 1
        Ks = [np.asarray(K, np.float64) for K in Ks]
        Ms = [np.asarray(M, np.float64) for M in Ms]
        kernel = resident = None
        if config.use_pallas:
            kernel = KernelSeparable(d, npts, p, Ks, Ms, dt, device)
            if d == 3:
                resident = ResidentSeparable(
                    npts, p, Ks, Ms, dt, mode=config.pallas_mode,
                    dirichlet=_fuse_mask(config, interior, dofs, npts),
                    device=device)
            else:
                # the 2-term Laplace factorisation through K3: the 2D
                # resident CG (JAX matrix_free.py:408-424)
                resident = ResidentTerms2D(
                    npts, p, [[Ks[0], Ms[1]], [Ms[0], Ks[1]]], dt,
                    mode=config.pallas_mode, device=device)
        as_dev = lambda a: torch.tensor(np.asarray(a), dtype=dt,
                                        device=device)
        return cls(
            config=config, mesh=mesh, dofs=dofs, device=device,
            n_dofs=dofs.n_dofs, npts=npts, interior_mask=as_dev(interior),
            Ks=[as_dev(K) for K in Ks], Ms=[as_dev(M) for M in Ms],
            kernel=kernel, resident=resident, quad=quad,
            host_metric=host_metric,
            jacobi_diag=None if jacobi_diag is None else as_dev(jacobi_diag))

    @classmethod
    def from_terms(cls, config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                   device: torch.device | str, terms, interior: np.ndarray,
                   quad=None, host_metric=None, coef_q=None,
                   coef_cp_err=None,
                   jacobi_diag: np.ndarray | None = None) -> "MatrixFree":
        """MatrixFree of a sum-of-tensor-products operator from host
        arrays: ``terms[a][b]`` f64 1D matrices (b = 0 is x) and the
        interior mask; K4/K3 attaches under ``config.use_pallas``."""
        p, d = config.degree, config.dim
        device = resolve_device(device)
        dt = torch_dtype(config.dtype)
        npts = int(mesh.U // mesh.sizes[0]) * p + 1
        terms = [[np.asarray(X, np.float64) for X in term] for term in terms]
        resident = _terms_with_kernel(terms, npts, p, d, config, device,
                                      interior, dofs)
        as_dev = lambda a: torch.tensor(np.asarray(a), dtype=dt,
                                        device=device)
        return cls(
            config=config, mesh=mesh, dofs=dofs, device=device,
            n_dofs=dofs.n_dofs, npts=npts, interior_mask=as_dev(interior),
            terms=[[as_dev(X) for X in term] for term in terms],
            resident=resident, quad=quad, host_metric=host_metric,
            coef_q=coef_q, coef_cp_err=coef_cp_err,
            jacobi_diag=None if jacobi_diag is None else as_dev(jacobi_diag))

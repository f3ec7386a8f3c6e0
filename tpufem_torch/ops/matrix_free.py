"""MatrixFree: the port's device data for the matrix-free Laplace apply.

Port of ``tpufem/ops/matrix_free.py::MatrixFree.build`` for what the
separable slice needs: a uniform Cartesian mesh with ``scatter=
"separable"``.  It carries the per-axis 1D operators (the plain apply),
the interior mask, and, with ``use_pallas``, the CUDA kernels attached
where the JAX package attaches its Pallas kernels
(``matrix_free.py:357-424``): K2 (``KernelSeparable``) in 2D and 3D, and
K1 (``ResidentSeparable``) in 3D.  A kernel that cannot be built raises.

Every scheme, mesh and option outside the slice raises
NotImplementedError naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mapping import Metric, compute_metric
from tpufem.fem.mesh import Mesh
from tpufem.fem.quadrature import Quadrature
from tpufem.utils.config import FemConfig
from tpufem_torch.ops.kernel_separable import KernelSeparable, ResidentSeparable
from tpufem_torch.ops.separable import build_separable_operators
from tpufem_torch.utils.precision import torch_dtype

_NOT_PORTED = {
    "auto": "the structured tier (the JAX 'auto' default)",
    "structured": "the structured tier (the JAX 'auto' default)",
    "incidence": "incidence, colored and dense with hanging nodes",
    "colored": "incidence, colored and dense with hanging nodes",
    "dense": "incidence, colored and dense with hanging nodes",
    "boxes": "the adaptive box tier",
}
_K4_ITEM = "tensor-product terms with the K4 kernel"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


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
    Ks: list  # per-axis (npts, npts) 1D stiffness, x first, config dtype
    Ms: list  # per-axis 1D mass
    kernel: KernelSeparable | None = None  # K2: flat vmult (use_pallas)
    resident: ResidentSeparable | None = None  # K1: 3D resident solves
    quad: Quadrature | None = None
    host_metric: Metric | None = None  # for the host closed-form diagonal
    jacobi_diag: torch.Tensor | None = None  # given diagonal (bridge.py)

    @classmethod
    def build(cls, mesh: Mesh, dofs: DoFHandler, config: FemConfig,
              device: torch.device | str, coefficient=None,
              constrained_mask: np.ndarray | None = None) -> "MatrixFree":
        """Host setup (the reference's ``reinit``) for the separable
        scheme on a uniform Cartesian mesh."""
        p, d = config.degree, config.dim
        if mesh.dim != d or dofs.degree != p:
            raise ValueError("mesh/dofs do not match the config's dim/degree")
        if config.scatter != "separable":
            raise not_ported(f"scatter={config.scatter!r}",
                             _NOT_PORTED[config.scatter])
        if coefficient is not None:
            raise not_ported("a variable coefficient", _K4_ITEM)
        if not mesh.is_uniform:
            raise not_ported("hanging nodes",
                             "incidence, colored and dense with hanging "
                             "nodes")
        if (mesh.transform is not None or mesh.separable_metric is not None
                or mesh.support_points is not None):
            raise not_ported("a curved mesh", _K4_ITEM)
        if config.nq1 != p + 1:
            raise ValueError("separable scheme needs nq1 == p+1")
        quad = Quadrature.gauss(config.nq1)
        metric = compute_metric(mesh, quad)
        if constrained_mask is None:
            constrained_mask = dofs.boundary_mask
        n = int(mesh.U // mesh.sizes[0])
        h = 1.0 / metric.inv_h[0]  # (d,) physical cell widths
        Ks, Ms = build_separable_operators(p, d, config.nq1, n, h,
                                           np.float64)
        return cls.from_operators(
            config, mesh, dofs, device, Ks, Ms,
            interior=(~constrained_mask).astype(np.float64),
            quad=quad, host_metric=metric)

    @classmethod
    def from_operators(cls, config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                       device: torch.device | str, Ks, Ms,
                       interior: np.ndarray, quad=None, host_metric=None,
                       jacobi_diag: np.ndarray | None = None) -> "MatrixFree":
        """MatrixFree from host arrays: per-axis f64 1D operators and the
        interior mask; attaches the kernels under ``config.use_pallas``."""
        p, d = config.degree, config.dim
        device = torch.device(device)
        dt = torch_dtype(config.dtype)
        n = int(mesh.U // mesh.sizes[0])
        npts = n * p + 1
        Ks = [np.asarray(K, np.float64) for K in Ks]
        Ms = [np.asarray(M, np.float64) for M in Ms]
        kernel = resident = None
        if config.use_pallas:
            kernel = KernelSeparable(d, npts, p, Ks, Ms, dt, device)
            if d == 3:
                plain_mask = np.array_equal(interior == 0.0,
                                            dofs.boundary_mask)
                if config.pallas_dirichlet and not plain_mask:
                    # the fused kernel bakes the FULL-boundary separable
                    # mask in; any other constraint set would be mis-masked
                    raise ValueError(
                        "pallas_dirichlet=True requires the plain "
                        "full-boundary Dirichlet mask (no extra "
                        "constraints / custom constrained_mask)")
                # None = auto: fuse exactly when representable
                fuse_mask = (plain_mask if config.pallas_dirichlet is None
                             else config.pallas_dirichlet)
                resident = ResidentSeparable(npts, p, Ks, Ms, dt,
                                             mode=config.pallas_mode,
                                             dirichlet=fuse_mask,
                                             device=device)
        as_dev = lambda a: torch.tensor(np.asarray(a), dtype=dt,
                                        device=device)
        return cls(
            config=config, mesh=mesh, dofs=dofs, device=device,
            n_dofs=dofs.n_dofs, npts=npts, interior_mask=as_dev(interior),
            Ks=[as_dev(K) for K in Ks], Ms=[as_dev(M) for M in Ms],
            kernel=kernel, resident=resident, quad=quad,
            host_metric=host_metric,
            jacobi_diag=None if jacobi_diag is None else as_dev(jacobi_diag))

"""Carry operator state from the JAX package into the port.

``matrix_free_from_arrays`` builds the port's MatrixFree from plain numpy
arrays: the per-axis 1D operators, the interior mask and the Jacobi
diagonal.  A caller holding a ``tpufem`` MatrixFree converts its arrays
with ``np.asarray`` and hands them over; both packages then apply the same
operator and run the same solve.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.utils.config import FemConfig
from tpufem_torch.ops.matrix_free import MatrixFree


def matrix_free_from_arrays(config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                            arrays: dict, device: torch.device | str = "cpu"
                            ) -> MatrixFree:
    """MatrixFree from host arrays.

    arrays: ``"Ks"`` and ``"Ms"`` (per-axis (npts, npts) 1D operators, x
    first), ``"interior_mask"`` ((n_dofs,), 1 on unconstrained DoFs) and
    ``"diagonal"`` ((n_dofs,) Jacobi diagonal, 1 on constrained DoFs).
    Kernels attach under ``config.use_pallas`` exactly as in
    ``MatrixFree.build``.
    """
    if config.scatter != "separable":
        raise ValueError("the bridge carries the separable scheme only")
    return MatrixFree.from_operators(
        config, mesh, dofs, device,
        [np.asarray(K, np.float64) for K in arrays["Ks"]],
        [np.asarray(M, np.float64) for M in arrays["Ms"]],
        interior=np.asarray(arrays["interior_mask"], np.float64),
        jacobi_diag=np.asarray(arrays["diagonal"], np.float64))

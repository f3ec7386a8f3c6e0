"""A MatrixFree built through tpufem_torch.bridge from a tpufem
MatrixFree's arrays gives the same vmult and the same solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.cg import cg_solve as j_cg_solve
from tpufem.utils.config import FemConfig
from tpufem_torch.bridge import matrix_free_from_arrays
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.solvers.cg import cg_solve


@pytest.mark.parametrize("dim,p,r", [(2, 3, 3), (3, 2, 2)])
def test_bridge_vmult_and_solve(dim, p, r):
    # a box with a distinct extent per axis, so per-axis operators differ
    mesh = Mesh.hyper_cube(dim, r, upper=[1.0, 2.0, 0.5][:dim])
    dofs = DoFHandler(mesh, p)
    cfg = FemConfig(dim, p, scatter="separable", use_pallas=True)
    jmf = JMatrixFree.build(mesh, dofs, cfg)
    jop = JLaplace(jmf)
    jdiag = jop.diagonal()
    arrays = {"Ks": [np.asarray(K) for K in jmf.sep_ops[0]],
              "Ms": [np.asarray(M) for M in jmf.sep_ops[1]],
              "interior_mask": np.asarray(jmf.interior_mask),
              "diagonal": np.asarray(jdiag)}
    tmf = matrix_free_from_arrays(cfg, mesh, dofs, arrays, "cpu")
    assert tmf.kernel is not None and (tmf.resident is not None) == (dim == 3)
    top = LaplaceOperator(tmf)
    assert np.array_equal(top.diagonal().numpy(), arrays["diagonal"])

    x = np.random.default_rng(6).standard_normal(dofs.n_dofs)
    y_j = np.asarray(jop.vmult(jnp.asarray(x)))
    y_t = top.vmult(torch.as_tensor(x)).numpy()
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-13

    b = arrays["interior_mask"] * np.random.default_rng(8).standard_normal(
        dofs.n_dofs)
    rj = j_cg_solve(jop.vmult, jnp.asarray(b), M_inv=lambda v: v / jdiag,
                    rtol=1e-10)
    dt = top.diagonal()
    rt = cg_solve(top.vmult, torch.as_tensor(b), M_inv=lambda v: v / dt,
                  rtol=1e-10)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)

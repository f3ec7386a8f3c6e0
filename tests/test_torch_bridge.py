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
from torch_threads import one_torch_thread  # noqa: F401


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
    # the resident kernels attach as in tpufem: K1 in 3D, K3 in 2D
    assert tmf.kernel is not None and tmf.resident is not None
    assert jmf.resident is not None
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


@pytest.mark.parametrize("dim", [2, 3])
def test_bridge_carries_shell_terms(dim):
    """A tpufem shell operator's per-term, per-axis 1D matrices
    (``sep_ops[1]``) carried across: the port builds its K4/K3 wrapper
    and applies the same operator."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D

    mesh = Mesh.hyper_shell_3d(2) if dim == 3 else Mesh.hyper_shell_2d(3)
    dofs = DoFHandler(mesh, 2)
    cfg = FemConfig(dim, 2, scatter="separable", use_pallas=True)
    jmf = JMatrixFree.build(mesh, dofs, cfg)
    assert jmf.sep_ops[0] == "terms"
    jop = JLaplace(jmf)
    arrays = {"terms": [[np.asarray(X) for X in t] for t in jmf.sep_ops[1]],
              "interior_mask": np.asarray(jmf.interior_mask),
              "diagonal": np.asarray(jop.diagonal())}
    tmf = matrix_free_from_arrays(cfg, mesh, dofs, arrays, "cpu")
    assert isinstance(tmf.resident,
                      ResidentTerms if dim == 3 else ResidentTerms2D)
    top = LaplaceOperator(tmf)
    x = np.random.default_rng(9).standard_normal(dofs.n_dofs)
    for name in ("vmult_raw", "vmult"):
        y_j = np.asarray(getattr(jop, name)(jnp.asarray(x)))
        y_t = getattr(top, name)(torch.as_tensor(x)).numpy()
        assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-13

"""Port parity: the K1 wrapper (ResidentSeparable) and resident_jacobi_cg
of tpufem_torch against tpufem (f64, CPU; Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops import pallas_separable as jps
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.ops.separable import global_1d_matrices
from tpufem.solvers.resident import resident_jacobi_cg as j_resident_cg
from tpufem.utils.config import FemConfig
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.resident import resident_jacobi_cg

H_AXES = (1.0 / 4, 1.0 / 3, 1.0 / 5)


def _operators(p, n):
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    return ([K1u / H_AXES[a] for a in range(3)],
            [M1u * H_AXES[a] for a in range(3)])


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dirichlet", [False, True])
def test_resident_matches_tpufem(p, dirichlet):
    n = 4
    npts = n * p + 1
    Ks, Ms = _operators(p, n)
    u = np.random.default_rng(5).standard_normal(npts**3)
    jk = jps.ResidentSeparable(npts, p, Ks, Ms, "float64", interpret=True,
                               dirichlet=dirichlet)
    y_j = np.asarray(jk.unpad(jk.raw(jk.pad(jnp.asarray(u)))))
    before = tks.ResidentSeparable.launches
    tk = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float64,
                               dirichlet=dirichlet, device="cpu")
    y_t = tk.unpad(tk.raw(tk.pad(torch.as_tensor(u)))).numpy()
    assert tks.ResidentSeparable.launches == before  # plain, not a launch
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-12
    # chaining stays in the resident layout
    y2_j = np.asarray(jk.unpad(jk.raw(jk.raw(jk.pad(jnp.asarray(u))))))
    y2_t = tk.unpad(tk.raw(tk.raw(tk.pad(torch.as_tensor(u))))).numpy()
    assert np.linalg.norm(y2_t - y2_j) / np.linalg.norm(y2_j) < 1e-12


def test_resident_bf16_storage_mode():
    """bf16s: bf16 storage, f32 arithmetic; against the f64 plain apply of
    the same (bf16-quantised) input, within the 4e-3 class."""
    p, n = 2, 4
    npts = n * p + 1
    Ks, Ms = _operators(p, n)
    tk = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float32, mode="bf16s",
                               dirichlet=True, device="cpu")
    assert tk.dt == torch.bfloat16 and tk.compute_dt == torch.float32
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(npts**3))
    gp = tk.pad(u)
    y = tk.raw(gp)
    assert y.dtype == torch.bfloat16 and y.shape == (npts,) * 3
    ref = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float64,
                                dirichlet=True, device="cpu")
    y_ref = ref.raw(gp.to(torch.float64))
    err = (y.to(torch.float64) - y_ref).abs().max() / y_ref.abs().max()
    assert err <= 4e-3


@pytest.mark.parametrize("pallas_dirichlet", [None, False])
def test_resident_cg_matches_tpufem(pallas_dirichlet):
    """Resident Jacobi-CG on a seeded masked random RHS: the port's
    iteration count equals tpufem's, solutions agree to 1e-10."""
    mesh = Mesh.hyper_cube(3, 3)
    dofs = DoFHandler(mesh, 2)
    cfg = FemConfig(3, 2, scatter="separable", use_pallas=True,
                    pallas_dirichlet=pallas_dirichlet)
    jmf = JMatrixFree.build(mesh, dofs, cfg)
    tmf = MatrixFree.build(mesh, dofs, cfg, "cpu")
    assert tmf.resident.dirichlet == jmf.resident.dirichlet
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    mask = np.asarray(jmf.interior_mask)
    b = mask * np.random.default_rng(3).standard_normal(dofs.n_dofs)
    rj = j_resident_cg(jop, jnp.asarray(b), diag=jop.diagonal(), rtol=1e-8,
                       maxiter=400)
    rt = resident_jacobi_cg(top, torch.as_tensor(b), diag=top.diagonal(),
                            rtol=1e-8, maxiter=400)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)


def test_resident_cg_bf16s_through_matrix_free():
    """pallas_mode="bf16s" reaches the resident kernel through
    MatrixFree.build (as the on-card smoke drives it); the solve returns the
    residual recomputed with its own operator, not the recurrence's, and x
    stays within the bf16-storage operator class of the f32 solution."""
    from tpufem_torch.apps.poisson import poisson_operator

    op16 = poisson_operator(3, 2, 3, "float32", True, "cpu",
                            pallas_mode="bf16s")
    op32 = poisson_operator(3, 2, 3, "float32", True, "cpu")
    assert op16.mf.resident.mode == "bf16s"
    assert op16.mf.resident.dt == torch.bfloat16
    mask = op32.mf.interior_mask.numpy().astype(np.float64)
    b = torch.tensor(mask * np.random.default_rng(4).standard_normal(
        op32.mf.n_dofs), dtype=torch.float32)
    r16 = resident_jacobi_cg(op16, b, diag=op16.diagonal(), rtol=1e-5)
    r32 = resident_jacobi_cg(op32, b, diag=op32.diagonal(), rtol=1e-5)
    assert r32.converged and r16.x.dtype == torch.float32
    assert torch.isfinite(r16.x).all()
    rk = op16.mf.resident
    Ax = rk.unpad(rk.raw(rk.pad(r16.x))).to(torch.float32)
    true_res = float((b - Ax).norm())
    assert abs(r16.residual - true_res) <= 1e-3 * true_res
    rel = float((r16.x - r32.x).norm() / r32.x.norm())
    assert rel <= 1e-2, rel  # bf16 storage: a 4e-3-class operator


def test_resident_2d_not_ported():
    """A 2D operator without use_pallas carries no resident kernel, and the
    resident solver refuses it rather than run something else; with
    use_pallas, K3 (ResidentTerms2D) attaches as in tpufem (its solve is
    held to tpufem's in tests/test_torch_terms.py)."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms2D

    mesh = Mesh.hyper_cube(2, 2)
    dofs = DoFHandler(mesh, 2)
    b = torch.zeros(dofs.n_dofs, dtype=torch.float64)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="separable"),
                          "cpu")
    assert mf.resident is None and mf.kernel is None
    with pytest.raises(ValueError, match="no resident kernel"):
        resident_jacobi_cg(LaplaceOperator(mf), b)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="separable",
                                                use_pallas=True), "cpu")
    assert isinstance(mf.resident, ResidentTerms2D) and mf.kernel is not None

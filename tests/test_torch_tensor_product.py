"""Port parity for the tensor-product fast tier (``operators/
tensor_product.py``): the Helmholtz and mass term sets, the plain terms
apply and the K4/K3 wrappers (their plain versions on the CPU) against
tpufem's XLA apply and its Pallas kernels in interpret mode, the closed-form
diagonal, and resident_jacobi_cg on the operator, in f64 (applies and
diagonals 1e-12, solutions 1e-10, equal iterations)."""

import numpy as np
import pytest
import torch

from tpufem.fem.assemble import assemble_laplace, assemble_mass
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators import tensor_product as jtp
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.resident import resident_jacobi_cg as j_resident_cg
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators import tensor_product as ttp
from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401


def pair(dim, degree, refine, use_pallas=False, scatter="incidence"):
    """tpufem's MatrixFree as its tests build it (incidence, use_pallas
    read by the operator) and the port's (the kernel asked of the
    operator: the port's cell-loop tiers refuse use_pallas)."""
    mj = JMesh.hyper_cube(dim, refine)
    dj = JDoFHandler(mj, degree)
    mfj = JMatrixFree.build(mj, dj, JFemConfig(
        dim=dim, degree=degree, scatter="incidence", use_pallas=use_pallas))
    mt = Mesh.hyper_cube(dim, refine)
    mft = MatrixFree.build(mt, DoFHandler(mt, degree),
                           FemConfig(dim=dim, degree=degree, scatter=scatter),
                           "cpu")
    return dj, mfj, mft


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("p,n,alpha,beta", [(2, 3, 1.0, 0.37),
                                            (4, 2, 0.0, 1.0),
                                            (3, 2, 1.0, 0.0)])
@pytest.mark.parametrize("dim", [2, 3])
def test_separable_terms_equal(dim, p, n, alpha, beta):
    """The term sets (Helmholtz, pure stiffness, mass) bit for bit."""
    h = np.array([0.5, 0.25, 0.125])[:dim]
    tj = jtp.helmholtz_separable_terms(p, dim, p + 1, n, h, alpha, beta)
    tt = ttp.helmholtz_separable_terms(p, dim, p + 1, n, h, alpha, beta)
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    mj = jtp.mass_separable_terms(p, dim, p + 1, n, h)
    mt = ttp.mass_separable_terms(p, dim, p + 1, n, h)
    assert all(np.array_equal(x, y) for x, y in zip(mj[0], mt[0]))


@pytest.mark.parametrize("dim,degree,refine,scatter", [
    (2, 3, 3, "incidence"), (3, 2, 2, "separable"), (2, 1, 4, "structured")])
def test_helmholtz_tensor_parity(dim, degree, refine, scatter):
    """raw, constrained and diagonal of alpha M + beta K and of M against
    tpufem and the assembled oracle, on MatrixFrees of three schemes."""
    dj, mfj, mft = pair(dim, degree, refine, scatter=scatter)
    alpha, beta = 1.0, 0.37
    Aj = jtp.helmholtz_tensor_operator(mfj, alpha=alpha, beta=beta)
    At = ttp.helmholtz_tensor_operator(mft, alpha=alpha, beta=beta)
    Mj, Mt = jtp.mass_tensor_operator(mfj), ttp.mass_tensor_operator(mft)
    assert At.resident is None and Mt.resident is None
    x = np.random.default_rng(0).standard_normal(dj.n_dofs)
    xt = torch.as_tensor(x)
    A_mat = (alpha * assemble_mass(dj).toarray()
             + beta * assemble_laplace(dj).toarray())
    for opj, opt, mat in ((Aj, At, A_mat), (Mj, Mt,
                                            assemble_mass(dj).toarray())):
        y = opt.vmult_raw(xt).numpy()
        assert rel_max(y, np.asarray(opj.vmult_raw(x))) <= 1e-12
        assert rel_max(y, mat @ x) <= 1e-12
        assert rel_max(opt.vmult(xt), np.asarray(opj.vmult(x))) <= 1e-12
    mask = mft.interior_mask.numpy()
    d = At.diagonal().numpy()
    assert rel_max(d, np.asarray(Aj.diagonal())) <= 1e-12
    assert rel_max(d, np.diag(A_mat) * mask + (1 - mask)) <= 1e-12


@pytest.mark.parametrize("dim,degree,refine", [(3, 2, 3), (2, 4, 4)])
def test_helmholtz_kernel_parity(dim, degree, refine):
    """use_pallas: the K4 (3D) / K3 (2D) wrapper attaches with the mask
    fused (its plain version on the CPU) and matches tpufem's
    ResidentTerms in interpret mode and the assembled oracle; the mass
    operator too."""
    dj, mfj, mft = pair(dim, degree, refine, use_pallas=True)
    dt = 0.11
    Aj = jtp.helmholtz_tensor_operator(mfj, alpha=1.0, beta=dt)
    At = ttp.helmholtz_tensor_operator(mft, alpha=1.0, beta=dt,
                                       use_pallas=True)
    Mt = ttp.mass_tensor_operator(mft, use_pallas=True)
    cls = ResidentTerms if dim == 3 else ResidentTerms2D
    assert Aj.resident is not None
    assert isinstance(At.resident, cls) and At.resident.dirichlet
    assert At.resident.n_terms == dim + 1 and Mt.resident.n_terms == 1
    x = np.random.default_rng(1).standard_normal(dj.n_dofs)
    xt = torch.as_tensor(x)
    y = At.vmult_raw(xt).numpy()
    assert rel_max(y, np.asarray(Aj.vmult_raw(x))) <= 1e-12
    A_mat = (assemble_mass(dj).toarray()
             + dt * assemble_laplace(dj).toarray())
    assert rel_max(y, A_mat @ x) <= 1e-12
    assert rel_max(At.vmult(xt), np.asarray(Aj.vmult(x))) <= 1e-12
    assert rel_max(Mt.vmult_raw(xt), assemble_mass(dj) @ x) <= 1e-12
    # the resident apply (mask fused) against the constrained operator
    rk = At.resident
    yr = rk.unpad(rk.raw(rk.pad(xt))).numpy()
    assert rel_max(yr, At.vmult(xt).numpy()) <= 1e-12


def test_kernel_request_reads_the_config():
    """use_pallas=None reads mf.config.use_pallas (and its mode); False
    attaches nothing even where the config asks."""
    mesh = Mesh.hyper_cube(3, 2)
    dofs = DoFHandler(mesh, 2)
    mf = MatrixFree.build(mesh, dofs, FemConfig(
        3, 2, scatter="separable", use_pallas=True, pallas_mode="bf16"),
        "cpu")
    assert ttp.helmholtz_tensor_operator(mf).resident.mode == "bf16"
    assert ttp.helmholtz_tensor_operator(mf, use_pallas=False).resident \
        is None


def test_resident_jacobi_cg_on_tensor_operator():
    """resident_jacobi_cg takes an operator carrying its own kernel: solve
    (M + dt K) x = b with tpufem's iteration count and x to 1e-10, the
    true residual to 1e-9; the flat Jacobi-CG on the operator without a
    kernel takes the same count."""
    from tpufem_torch.solvers.cg import cg_solve, make_jacobi

    dj, mfj, mft = pair(3, 2, 3, use_pallas=True)
    Aj = jtp.helmholtz_tensor_operator(mfj, alpha=1.0, beta=1e-2)
    At = ttp.helmholtz_tensor_operator(mft, alpha=1.0, beta=1e-2,
                                       use_pallas=True)
    mask = mft.interior_mask.numpy()
    b = mask * np.random.default_rng(2).standard_normal(dj.n_dofs)
    bt = torch.as_tensor(b)
    rj = j_resident_cg(Aj, b, rtol=1e-10)
    rt = resident_jacobi_cg(At, bt, rtol=1e-10)
    assert rt.converged and rt.iterations == int(rj.iterations)
    x = rt.x.numpy()
    assert np.linalg.norm(x - np.asarray(rj.x)) \
        <= 1e-10 * np.linalg.norm(np.asarray(rj.x))
    A_mat = (assemble_mass(dj).toarray()
             + 1e-2 * assemble_laplace(dj).toarray())
    r = b - mask * (A_mat @ (mask * x))
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)
    Af = ttp.helmholtz_tensor_operator(mft, alpha=1.0, beta=1e-2)
    rf = cg_solve(Af.vmult, bt, M_inv=make_jacobi(Af.diagonal()),
                  rtol=1e-10)
    assert rf.converged and rf.iterations == rt.iterations
    assert np.linalg.norm(rf.x.numpy() - x) <= 1e-10 * np.linalg.norm(x)


def test_tensor_operator_refuses_hanging_and_curved_meshes():
    from tpufem_torch.fem.constraints import make_hanging_node_constraints

    mesh = Mesh.hyper_cube(2, 2)
    mesh = mesh.refine(np.arange(mesh.n_cells) == 0)
    dofs = DoFHandler(mesh, 2)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="incidence"),
                          "cpu",
                          constraints=make_hanging_node_constraints(dofs))
    with pytest.raises(ValueError, match="hanging"):
        ttp.mass_tensor_operator(mf)
    curved = Mesh.hyper_cube(2, 2)
    curved.transform = lambda x: x + 0.05 * np.sin(np.pi * x[:, ::-1])
    mfs = MatrixFree.build(curved, DoFHandler(curved, 2),
                           FemConfig(2, 2, scatter="incidence"), "cpu")
    with pytest.raises(ValueError, match="Cartesian"):
        ttp.mass_tensor_operator(mfs)

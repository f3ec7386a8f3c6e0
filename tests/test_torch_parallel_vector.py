"""Port parity for the distributed vector operators
(``tpufem_torch.parallel.vector``: the component axis through the general
partitioner's plans) against tpufem's under ``shard_map`` on the 8
virtual CPU devices of tests/conftest.py, in f64.  Mirrors
tests/test_distributed_vector.py: the step-8 elasticity vmult (uniform
2D/3D, adaptive with hanging nodes) to 1e-12, the Jacobi-CG with tpufem's
distributed count and solution to 1e-10 (and within one iteration of the
single-device flat solve, as tpufem's test allows), and the Chebyshev-CG
with tpufem's count."""

import numpy as np
import pytest
import torch

from tpufem.fem.constraints import make_hanging_node_constraints as j_mhnc
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.parallel.general import GeneralPartitioner as JPart
from tpufem.parallel.vector import (
    distributed_elasticity_operator as j_elasticity,
)
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.vector import elasticity_operator
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.parallel.general import GeneralPartitioner
from tpufem_torch.parallel.vector import (
    GeneralDistributedVectorOperator,
    distributed_elasticity_operator,
)
from tpufem_torch.solvers.cg import cg_solve, make_jacobi
from tpufem_torch.utils.config import FemConfig

MU, LAM = 0.8, 1.7
N_SHARDS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(dim, p, refine, adaptive):
    out = []
    for M, D, C, MF, cfg, dev in (
            (Mesh, DoFHandler, make_hanging_node_constraints, MatrixFree,
             FemConfig, ("cpu",)),
            (JMesh, JDoFHandler, j_mhnc, JMatrixFree, JFemConfig, ())):
        mesh = M.hyper_cube(dim, refine)
        if adaptive:
            c = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
            mesh = mesh.refine(np.linalg.norm(c - 0.3, axis=1) < 0.4)
        dofs = D(mesh, p)
        ac = C(dofs) if adaptive else None
        out.append(MF.build(mesh, dofs, cfg(dim, p, scatter="incidence"),
                            *dev, constraints=ac))
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def host(t):
    return t.detach().to("cpu", torch.float64).numpy()


@pytest.mark.parametrize("dim,p,refine,adaptive", [
    (3, 2, 2, False), (2, 2, 3, True)], ids=["uniform-3d", "adaptive-2d"])
def test_elasticity_vmult_matches_tpufem(dim, p, refine, adaptive):
    mf, jmf = pair(dim, p, refine, adaptive)
    dop = distributed_elasticity_operator(
        GeneralPartitioner.build(mf, N_SHARDS), mu=MU, lam=LAM)
    jop = j_elasticity(JPart.build(jmf, N_SHARDS), mu=MU, lam=LAM)
    x = np.random.default_rng(17).standard_normal((dim, mf.n_dofs))
    y = dop._to_global(dop.vmult(dop.put_vector(x)))
    yj = jop._to_global(np.asarray(jop.vmult(jop.put_vector(x))))
    assert rel(y, yj) < 1e-12
    y1 = host(elasticity_operator(mf, mu=MU, lam=LAM).vmult(
        torch.as_tensor(x)))
    assert rel(y, y1) < 1e-12


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["uniform", "adaptive"])
def test_elasticity_cg_matches_tpufem(adaptive):
    dim, p = 2, 2
    mf, jmf = pair(dim, p, 3, adaptive)
    op = elasticity_operator(mf, mu=MU, lam=LAM)
    diag = host(op.diagonal())
    mask = host(mf.interior_mask)
    rng = np.random.default_rng(19)
    b = np.stack([mask * rng.standard_normal(mf.n_dofs) for _ in range(dim)])
    dop = distributed_elasticity_operator(
        GeneralPartitioner.build(mf, N_SHARDS), mu=MU, lam=LAM)
    jop = j_elasticity(JPart.build(jmf, N_SHARDS), mu=MU, lam=LAM)
    x, it, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=2000)
    xj, itj, _ = jop.cg_solve(b, diag, rtol=1e-10, maxiter=2000)
    assert it == itj and rel(x, xj) < 1e-10
    ref = cg_solve(op.vmult_flat, torch.as_tensor(b.reshape(-1)),
                   M_inv=make_jacobi(torch.as_tensor(diag.reshape(-1))),
                   rtol=1e-10, maxiter=2000)
    assert abs(it - ref.iterations) <= 1
    assert rel(x, host(ref.x).reshape(dim, -1)) < 1e-8


def test_elasticity_chebyshev_matches_tpufem():
    dim, p = 2, 2
    mf, jmf = pair(dim, p, 3, False)
    diag = host(elasticity_operator(mf, mu=MU, lam=LAM).diagonal())
    mask = host(mf.interior_mask)
    rng = np.random.default_rng(23)
    b = np.stack([mask * rng.standard_normal(mf.n_dofs) for _ in range(dim)])
    dop = distributed_elasticity_operator(
        GeneralPartitioner.build(mf, N_SHARDS), mu=MU, lam=LAM)
    jop = j_elasticity(JPart.build(jmf, N_SHARDS), mu=MU, lam=LAM)
    x, it, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=2000,
                            precond="chebyshev")
    xj, itj, _ = jop.cg_solve(b, diag, rtol=1e-10, maxiter=2000,
                              precond="chebyshev")
    assert it == itj and rel(x, xj) < 1e-10
    _, it_j, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=2000)
    assert it < it_j
    with pytest.raises(ValueError, match="quad_op"):
        GeneralDistributedVectorOperator(dop.part, None, 2)
    with pytest.raises(ValueError, match="expected"):
        dop.put_vector(np.zeros((3, mf.n_dofs)))

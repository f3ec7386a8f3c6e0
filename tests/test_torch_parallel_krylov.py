"""Port parity for the distributed Newton-Krylov
(``GeneralDistributedOperator.newton_solve``: the port's
``solvers.newton`` on Sharded vectors, its Jacobian
``torch.func.linearize`` of the distributed residual through the ghost
exchanges) against tpufem's under ``shard_map`` on the 8 virtual CPU
devices of tests/conftest.py, in f64: ``dryrun_multichip`` section 8's
minimal surface with inhomogeneous Dirichlet data, its inner solves by
GMRES on Sharded vectors (its basis a Sharded stack, its CGS2 products
vmapped over the psum'd dot; BiCGStab, plain vector arithmetic on the
same dot, runs as the single-device tests hold it),
with tpufem's Newton and Krylov counts and solution to 1e-10, the
Dirichlet rows kept bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.constraints import make_hanging_node_constraints as j_mhnc
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.parallel import general as jg
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.parallel.general import (
    GeneralDistributedOperator,
    GeneralPartitioner,
)
from tpufem_torch.utils.config import FemConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(refine, steps):
    out = []
    for M, D, C, MF, cfg, dev in (
            (Mesh, DoFHandler, make_hanging_node_constraints, MatrixFree,
             FemConfig, ("cpu",)),
            (JMesh, JDoFHandler, j_mhnc, JMatrixFree, JFemConfig, ())):
        mesh = M.hyper_cube(2, refine)
        for _ in range(steps):
            c = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
            mesh = mesh.refine(np.linalg.norm(c - 0.3, axis=1) < 0.4)
        dofs = D(mesh, 2)
        ac = C(dofs) if steps else None
        out.append(MF.build(mesh, dofs, cfg(2, 2, scatter="incidence"),
                            *dev, constraints=ac))
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("linear", ["gmres"])
def test_minimal_surface_matches_tpufem(linear):
    def qop(vals, grads, ctx):
        g2 = torch.sum(grads * grads, dim=1)
        return None, grads / torch.sqrt(1.0 + g2)[:, None, :]

    def jqop(vals, grads, ctx):
        g2 = jnp.sum(grads * grads, axis=1)
        return None, grads / jnp.sqrt(1.0 + g2)[:, None, :]

    mf, jmf = pair(2, 0)
    dofs = mf.dofs
    u0 = np.where(dofs.boundary_mask,
                  np.sin(2 * np.pi * dofs.dof_coords[:, 0]), 0.0)
    b = np.zeros(dofs.n_dofs)
    kw = dict(u0_global=u0, rtol=1e-9, atol=1e-12, linear=linear)
    res = GeneralDistributedOperator(
        GeneralPartitioner.build(mf, 2), quad_op=qop,
        needs_values=False).newton_solve(b, **kw)
    rj = jg.GeneralDistributedOperator(
        jg.GeneralPartitioner.build(jmf, 2), quad_op=jqop,
        needs_values=False).newton_solve(b, **kw)
    assert res.converged and bool(rj.converged)
    assert res.iterations == int(rj.iterations)
    assert res.linear_iterations == int(rj.linear_iterations)
    assert rel(res.x, np.asarray(rj.x)) < 1e-10
    bd = dofs.boundary_mask
    assert np.array_equal(res.x[bd], u0[bd])

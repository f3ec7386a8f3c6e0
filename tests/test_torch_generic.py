"""Port parity for the generic-functor tier (``operators/generic.py``):
mass, Helmholtz, convection-diffusion and custom functors, the
constrained apply on Dirichlet and hanging-node meshes, and the nonlinear
residual with its AD Jacobian, against tpufem in f64 on the CPU (1e-12
relative) and against the assembled oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.assemble import (
    assemble_convection,
    assemble_laplace,
    assemble_mass,
    cell_basis_gradients,
    cell_basis_values,
)
from tpufem.fem.constraints import (
    make_hanging_node_constraints as j_hanging,
)
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mapping import compute_metric
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.fem.quadrature import Quadrature
from tpufem.operators import generic as jg
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators import generic as tg
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(9)


def warp(x):
    y = x.copy()
    y[:, 0] += 0.07 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return y


def coef(pts):
    return 1.0 + 0.5 * np.sin(3.0 * pts[:, 0]) + pts[:, 1] ** 2


def velocity_2d(pts):
    return np.stack([1.0 + 0.3 * pts[:, 1], -0.5 * pts[:, 0]], axis=-1)


def velocity_3d(pts):
    return np.stack(
        [1.0 + 0.2 * pts[:, 2], 0.4 * pts[:, 0], -0.3 * pts[:, 1]], axis=-1)


def pair(dim, p, refine, curved=False, coefficient=None, adaptive=0,
         scatter="incidence"):
    """The same mesh and MatrixFree in both packages (hanging-node
    constraints after ``adaptive`` refinements toward a ball)."""
    out = []
    for M, D, F, MF, hang, kw in (
            (JMesh, JDoFHandler, JFemConfig, JMatrixFree, j_hanging, {}),
            (Mesh, DoFHandler, FemConfig, MatrixFree,
             make_hanging_node_constraints, {"device": "cpu"})):
        mesh = M.hyper_cube(dim, refine)
        for _ in range(adaptive):
            c = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
            mesh = mesh.refine(np.linalg.norm(c - 0.31, axis=1) < 0.35)
        if curved:
            mesh.transform = warp
        dofs = D(mesh, p)
        ac = hang(dofs) if adaptive else None
        out.append((dofs, MF.build(mesh, dofs, F(dim, p, scatter=scatter),
                                   coefficient=coefficient, constraints=ac,
                                   **kw)))
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def both(jop, top, x, method="vmult_raw"):
    yj = np.asarray(getattr(jop, method)(jnp.asarray(x)))
    yt = getattr(top, method)(torch.as_tensor(x)).numpy()
    return yj, yt


@pytest.mark.parametrize("dim,p,curved", [(2, 1, False), (2, 3, False),
                                          (3, 2, False), (2, 2, True)])
def test_mass_operator_parity(dim, p, curved):
    (dj, mfj), (dt, mft) = pair(dim, p, 3 if dim == 2 else 2, curved)
    x = RNG.standard_normal(dt.n_dofs)
    yj, yt = both(jg.mass_operator(mfj), tg.mass_operator(mft), x)
    assert rel(yt, yj) < 1e-12
    assert rel(yt, assemble_mass(dj) @ x) < 1e-12


@pytest.mark.parametrize("dim,p,coefficient,scatter", [
    (2, 2, None, "incidence"), (2, 3, coef, "incidence"),
    (3, 2, None, "colored"), (2, 2, coef, "structured")])
def test_helmholtz_operator_parity(dim, p, coefficient, scatter):
    """alpha M + beta K with a pointwise coefficient on K (ctx.coef_q), on
    the incidence and colored scatters and on a structured-scheme
    MatrixFree (the functor tier gathers on any cell-loop scheme)."""
    (dj, mfj), (dt, mft) = pair(dim, p, 3 if dim == 2 else 2,
                                coefficient=coefficient, scatter=scatter)
    alpha, beta = 0.7, 2.5
    x = RNG.standard_normal(dt.n_dofs)
    yj, yt = both(jg.helmholtz_operator(mfj, alpha, beta),
                  tg.helmholtz_operator(mft, alpha, beta), x)
    assert rel(yt, yj) < 1e-12
    ref = (alpha * (assemble_mass(dj) @ x)
           + beta * (assemble_laplace(dj, coefficient=coefficient) @ x))
    assert rel(yt, ref) < 1e-12


def test_custom_quad_functor_advection_like():
    """A custom functor submit_gradient(e * value) (a non-symmetric form
    B[i,j] = int grad(phi_i) . e phi_j) against tpufem and a dense
    per-cell oracle."""
    (dj, mfj), (dt, mft) = pair(2, 2, 3)
    e = np.array([1.0, 0.5])

    def qop_j(vals, grads, ctx):
        return None, jnp.stack([e[0] * vals, e[1] * vals], axis=1)

    def qop_t(vals, grads, ctx):
        return None, torch.stack([e[0] * vals, e[1] * vals], dim=1)

    x = RNG.standard_normal(dt.n_dofs)
    yj, yt = both(jg.GenericOperator(mfj, qop_j, needs_gradients=False),
                  tg.GenericOperator(mft, qop_t, needs_gradients=False), x)
    assert rel(yt, yj) < 1e-12
    quad = Quadrature.gauss(3)
    met = compute_metric(dj.mesh, quad).to_general()
    G = cell_basis_gradients(2, 2, quad)
    V = cell_basis_values(2, 2, quad)
    Gp = np.einsum("cqba,qjb->cqja", met.inv_jac, G)
    Be = np.einsum("cqja,a,qk,cq->cjk", Gp, e, V, met.jxw)
    ref = np.zeros(dj.n_dofs)
    np.add.at(ref, dj.cell_dofs.ravel(),
              np.einsum("cjk,ck->cj", Be, x[dj.cell_dofs]).ravel())
    assert rel(yt, ref) < 1e-12


@pytest.mark.parametrize("dim,p,adaptive", [(2, 2, 0), (2, 2, 1),
                                            (3, 2, 1)])
def test_generic_constrained_apply(dim, p, adaptive):
    """vmult = m C^T A C (m x) + (1 - m) x on Dirichlet and hanging-node
    meshes: tpufem's apply to 1e-12, the identity on constrained rows."""
    (dj, mfj), (dt, mft) = pair(dim, p, 2, adaptive=adaptive)
    x = RNG.standard_normal(dt.n_dofs)
    yj, yt = both(jg.helmholtz_operator(mfj, 1.0, 0.3),
                  tg.helmholtz_operator(mft, 1.0, 0.3), x, "vmult")
    assert rel(yt, yj) < 1e-12
    con = mft.interior_mask.numpy() == 0.0
    assert np.array_equal(yt[con], x[con])


@pytest.mark.parametrize("dim,p", [(2, 1), (2, 3), (3, 2)])
def test_convection_diffusion_parity(dim, p):
    (dj, mfj), (dt, mft) = pair(dim, p, 3 if dim == 2 else 2)
    vel = velocity_2d if dim == 2 else velocity_3d
    nu = 0.7
    x = RNG.standard_normal(dt.n_dofs)
    yj, yt = both(jg.convection_diffusion_operator(mfj, vel, nu=nu),
                  tg.convection_diffusion_operator(mft, vel, nu=nu), x)
    assert rel(yt, yj) < 1e-12
    ref = nu * (assemble_laplace(dj) @ x) + assemble_convection(dj, vel) @ x
    assert rel(yt, ref) < 1e-12


def test_generic_refuses_the_separable_scheme():
    mesh = Mesh.hyper_cube(2, 2)
    mf = MatrixFree.build(mesh, DoFHandler(mesh, 2),
                          FemConfig(2, 2, scatter="separable"), "cpu")
    with pytest.raises(ValueError, match="cell-loop"):
        tg.mass_operator(mf)


def quasilinear_j(vals, grads, ctx):
    return None, (1.0 + vals**2)[:, None, :] * grads


def quasilinear_t(vals, grads, ctx):
    return None, (1.0 + vals**2)[:, None, :] * grads


def test_nonlinear_residual_and_jacobian():
    """NonlinearOperator's residual m C^T (R(C u) - b) and its Jacobian
    (torch.func.linearize against jax.linearize) at a random u, on a
    hanging-node mesh (C and C^T inside the traced chain)."""
    (dj, mfj), (dt, mft) = pair(2, 2, 2, adaptive=1)
    n = dt.n_dofs
    u, b, v = (RNG.standard_normal(n) for _ in range(3))
    jop = jg.NonlinearOperator(mfj, quasilinear_j)
    top = tg.NonlinearOperator(mft, quasilinear_t)
    assert rel(top.residual(u, b).numpy(), np.asarray(jop.residual(u, b))) \
        < 1e-12
    a = (jop.device_args, jnp.asarray(b))
    _, jvp_j = jax.linearize(lambda w: jop.residual_with(a, w),
                             jnp.asarray(u))
    bt = torch.as_tensor(b)
    _, jvp_t = torch.func.linearize(lambda w: top.residual_with(bt, w),
                                    torch.as_tensor(u))
    Jv = jvp_t(torch.as_tensor(v)).numpy()
    assert rel(Jv, np.asarray(jvp_j(jnp.asarray(v)))) < 1e-12
    # the same derivative by central differences of the port's residual
    eps = 1e-6
    fd = (top.residual(u + eps * v, b) - top.residual(u - eps * v, b)
          ).numpy() / (2 * eps)
    assert rel(Jv, fd) < 1e-7

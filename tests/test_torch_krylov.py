"""Port parity for the nonsymmetric Krylov solvers (``solvers/gmres.py``,
``solvers/bicgstab.py``): the convection-diffusion solves and the dense
systems of tpufem's tests, with tpufem's iteration counts (equal) and
solutions (1e-10) in f64, the breakdown cases, and the oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from tpufem.fem.assemble import (
    assemble_convection,
    assemble_laplace,
    assemble_mass,
    assemble_rhs,
    integrate_difference,
)
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.generic import (
    convection_diffusion_operator as j_convdiff,
)
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.bicgstab import bicgstab_solve as j_bicgstab
from tpufem.solvers.cg import make_jacobi as j_jacobi
from tpufem.solvers.gmres import gmres_solve as j_gmres
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.generic import convection_diffusion_operator
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.bicgstab import bicgstab_solve
from tpufem_torch.solvers.cg import cg_solve, make_jacobi
from tpufem_torch.solvers.gmres import gmres_solve
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(37)


def velocity_2d(pts):
    return np.stack([1.0 + 0.3 * pts[:, 1], -0.5 * pts[:, 0]], axis=-1)


def convdiff(refine, nu, p=2):
    """tpufem's and the port's constrained convection-diffusion operators
    on the same 2D mesh, and the condensed homogeneous-Dirichlet RHS."""
    mj = JMesh.hyper_cube(2, refine)
    dj = JDoFHandler(mj, p)
    mfj = JMatrixFree.build(mj, dj, JFemConfig(2, p, scatter="incidence"))
    mt = Mesh.hyper_cube(2, refine)
    mft = MatrixFree.build(mt, DoFHandler(mt, p),
                           FemConfig(2, p, scatter="incidence"), "cpu")
    return (dj, j_convdiff(mfj, velocity_2d, nu=nu),
            convection_diffusion_operator(mft, velocity_2d, nu=nu))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def same(rj, rt, tol=1e-10):
    """Equal iteration counts and convergence flags, x to ``tol``."""
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    assert rel(rt.x.numpy(), rj.x) < tol


def condensed_oracle(dofs, nu, b):
    A = (nu * assemble_laplace(dofs)
         + assemble_convection(dofs, velocity_2d)).tocsr()
    interior = ~dofs.boundary_mask
    x = np.zeros(dofs.n_dofs)
    x[interior] = spla.spsolve(A[interior][:, interior].tocsc(), b[interior])
    return x


@pytest.mark.parametrize("solver,restart", [("gmres", 30), ("gmres", 8),
                                            ("bicgstab", None)])
def test_solves_convection_diffusion(solver, restart):
    """The Dirichlet convection-diffusion solve through the matrix-free
    operator: tpufem's iterations and x, and scipy's direct solve of the
    condensed system (a small restart runs several cycles)."""
    dofs, opj, opt = convdiff(3, 0.1)
    b = assemble_rhs(dofs, lambda pts: np.ones(len(pts)))
    bd = np.where(~dofs.boundary_mask, b, 0.0)
    if solver == "gmres":
        rj = j_gmres(opj.vmult, jnp.asarray(bd), rtol=1e-12, maxiter=2000,
                     restart=restart)
        rt = gmres_solve(opt.vmult, torch.as_tensor(bd), rtol=1e-12,
                         maxiter=2000, restart=restart)
    else:
        rj = j_bicgstab(opj.vmult, jnp.asarray(bd), rtol=1e-12, maxiter=2000)
        rt = bicgstab_solve(opt.vmult, torch.as_tensor(bd), rtol=1e-12,
                            maxiter=2000)
    same(rj, rt)
    assert rt.converged
    assert rel(rt.x.numpy(), condensed_oracle(dofs, 0.1, b)) < 1e-8


@pytest.mark.parametrize("solver", ["gmres", "bicgstab"])
def test_matches_cg_on_spd(solver):
    """On an SPD system (the mass matrix, Jacobi-preconditioned) the
    solver agrees with CG on the solution and with tpufem on its count;
    GMRES's right preconditioning reports the true residual."""
    dofs, _, _ = convdiff(3, 0.1)
    M = assemble_mass(dofs)
    b = RNG.standard_normal(dofs.n_dofs)
    Mj, Mt = jnp.asarray(M.toarray()), torch.as_tensor(M.toarray())
    diag = M.diagonal()
    j_solve, t_solve = ((j_gmres, gmres_solve) if solver == "gmres"
                        else (j_bicgstab, bicgstab_solve))
    rj = j_solve(lambda x: Mj @ x, jnp.asarray(b),
                 M_inv=j_jacobi(jnp.asarray(diag)), rtol=1e-12)
    rt = t_solve(lambda x: Mt @ x, torch.as_tensor(b),
                 M_inv=make_jacobi(torch.as_tensor(diag)), rtol=1e-12)
    same(rj, rt)
    r1 = cg_solve(lambda x: Mt @ x, torch.as_tensor(b),
                  M_inv=make_jacobi(torch.as_tensor(diag)), rtol=1e-12)
    assert r1.converged and rt.converged
    assert rel(rt.x.numpy(), r1.x.numpy()) < 1e-9
    if solver == "gmres":
        rn = np.linalg.norm(b - M @ rt.x.numpy())
        assert abs(rn - rt.residual) / max(rn, 1e-30) < 1e-3


def test_gmres_nonnormal_dense():
    """A strongly nonnormal dense system: GMRES(20) reaches the oracle in
    tpufem's count."""
    n = 60
    A0 = np.triu(RNG.standard_normal((n, n))) + 3.0 * np.eye(n)
    b = RNG.standard_normal(n)
    Aj, At = jnp.asarray(A0), torch.as_tensor(A0)
    rj = j_gmres(lambda x: Aj @ x, jnp.asarray(b), rtol=1e-10, maxiter=500,
                 restart=20)
    rt = gmres_solve(lambda x: At @ x, torch.as_tensor(b), rtol=1e-10,
                     maxiter=500, restart=20)
    same(rj, rt)
    x_ref = np.linalg.solve(A0, b)
    assert np.linalg.norm(rt.x.numpy() - x_ref) \
        < 1e-6 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("solver", [gmres_solve, bicgstab_solve])
def test_converged_initial_guess(solver):
    """x0 = the exact solution: zero iterations, converged."""
    A0 = np.eye(16) * 2.0
    x_ref = RNG.standard_normal(16)
    At = torch.as_tensor(A0)
    res = solver(lambda x: At @ x, torch.as_tensor(A0 @ x_ref),
                 x0=torch.as_tensor(x_ref), rtol=1e-8)
    assert res.converged and res.iterations == 0


@pytest.mark.parametrize("rhs", ["null", "consistent"])
def test_gmres_singular_operator(rhs):
    """A degenerate Arnoldi breakdown (b in the null space of a singular
    A: hj ~ hnext ~ 0 at the first step) rolls the step back and returns
    the last finite iterate, as tpufem does; with a consistent part the
    iterate solves it and the residual is the null component's norm."""
    n = 12
    d = np.ones(n)
    d[-1] = 0.0
    A0 = np.diag(d)
    b = np.zeros(n)
    b[-1] = 1.0
    if rhs == "consistent":
        b[0] = 1.0
    Aj, At = jnp.asarray(A0), torch.as_tensor(A0)
    rj = j_gmres(lambda x: Aj @ x, jnp.asarray(b), rtol=1e-10, maxiter=50)
    rt = gmres_solve(lambda x: At @ x, torch.as_tensor(b), rtol=1e-10,
                     maxiter=50)
    x = rt.x.numpy()
    assert np.all(np.isfinite(x)) and not rt.converged
    assert rt.iterations == int(rj.iterations)
    assert np.allclose(x, np.asarray(rj.x), rtol=1e-10, atol=1e-10)
    if rhs == "consistent":
        assert abs(x[0] - 1.0) < 1e-8
        assert abs(rt.residual - 1.0) < 1e-8


def test_convdiff_convergence_rate():
    """Manufactured u = sin(pi x) sin(pi y) with velocity b: BiCGStab's L2
    error converges at O(h^{p+1}), p = 2 (the port alone)."""
    import math

    p, nu = 2, 1.0

    def u_exact(pts):
        return np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])

    def f(pts):
        x, y = pts[:, 0], pts[:, 1]
        u = np.sin(np.pi * x) * np.sin(np.pi * y)
        ux = np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
        uy = np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
        bv = velocity_2d(pts)
        return nu * 2 * np.pi**2 * u + bv[:, 0] * ux + bv[:, 1] * uy

    errs = []
    for refine in (2, 3, 4):
        mesh = Mesh.hyper_cube(2, refine)
        dofs = DoFHandler(mesh, p)
        mf = MatrixFree.build(mesh, dofs, FemConfig(2, p,
                                                    scatter="incidence"),
                              "cpu")
        op = convection_diffusion_operator(mf, velocity_2d, nu=nu)
        b = assemble_rhs(dofs, f)
        bd = torch.as_tensor(np.where(~dofs.boundary_mask, b, 0.0))
        res = bicgstab_solve(op.vmult, bd, rtol=1e-12, maxiter=4000)
        assert res.converged
        errs.append(integrate_difference(dofs, res.x.numpy(), u_exact))
    rate = math.log2(errs[0] / errs[1]), math.log2(errs[1] / errs[2])
    assert min(rate) > p + 0.7, (errs, rate)

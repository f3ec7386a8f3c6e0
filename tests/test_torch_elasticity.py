"""Port parity for vector problems and elasticity (``operators/vector.py``,
``solvers/vector_multigrid.py``, ``operators/tensor_product.
SeparableElasticityOperator``, ``apps/elasticity.py``) against tpufem in
f64 on the CPU: applies and diagonals 1e-12, one V-cycle 1e-12, solutions
and L2 1e-10, CG iterations equal; the K4 path of the fast tier (its plain
version here) block by block and summed; and the refusals (2D kernel,
``fast`` with ``gmg``, ``shards``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps.elasticity import run_elasticity as j_run_elasticity
from tpufem.fem.assemble import assemble_elasticity
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.tensor_product import (
    SeparableElasticityOperator as JSeparable,
)
from tpufem.operators.vector import elasticity_operator as j_elasticity
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.vector_multigrid import VectorMultigrid as JVectorMG
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.apps import elasticity as tel
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.tensor_product import (
    SeparableElasticityOperator,
    elasticity_separable_blocks,
)
from tpufem_torch.operators.vector import elasticity_operator
from tpufem_torch.ops.kernel_terms import ResidentTerms
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers import chebyshev as t_cheb
from tpufem_torch.solvers.vector_multigrid import VectorMultigrid
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(31)
MU, LAM = 0.8, 1.7


def tpufem_start(n, seed, dtype, device):
    """tpufem's power-iteration start (``jax.random.normal``)."""
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float64)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(t_cheb, "power_start", tpufem_start)


def pair(dim, p, refine, scatter="incidence"):
    mj = JMesh.hyper_cube(dim, refine)
    dj = JDoFHandler(mj, p)
    mfj = JMatrixFree.build(mj, dj, JFemConfig(dim, p, scatter="incidence"))
    mt = Mesh.hyper_cube(dim, refine)
    mft = MatrixFree.build(mt, DoFHandler(mt, p),
                           FemConfig(dim, p, scatter=scatter), "cpu")
    return dj, mfj, mft


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dim,p,refine", [(2, 1, 3), (2, 3, 2), (3, 2, 2)])
def test_elasticity_operator_parity(dim, p, refine):
    """vmult_raw against tpufem and the assembled block oracle; vmult
    against tpufem (identity on constrained rows)."""
    dj, mfj, mft = pair(dim, p, refine)
    opj, opt = j_elasticity(mfj, MU, LAM), elasticity_operator(mft, MU, LAM)
    x = RNG.standard_normal((dim, dj.n_dofs))
    xt = torch.as_tensor(x)
    y = opt.vmult_raw(xt).numpy()
    assert rel(y, np.asarray(opj.vmult_raw(jnp.asarray(x)))) < 1e-12
    K = assemble_elasticity(dj, mu=MU, lam=LAM)
    assert rel(y.reshape(-1), K @ x.reshape(-1)) < 1e-12
    yc = opt.vmult(xt).numpy()
    assert rel(yc, np.asarray(opj.vmult(jnp.asarray(x)))) < 1e-12
    bd = dj.boundary_mask
    assert np.array_equal(yc[:, bd], x[:, bd])


def test_elasticity_diagonal():
    """The unit-basis diagonal against tpufem's and the oracle's."""
    dj, mfj, mft = pair(2, 2, 3)
    d = elasticity_operator(mft, MU, LAM).diagonal().numpy()
    assert rel(d, np.asarray(j_elasticity(mfj, MU, LAM).diagonal())) < 1e-12
    d_ref = assemble_elasticity(dj, mu=MU, lam=LAM).diagonal().copy()
    d_ref[np.concatenate([dj.boundary_mask] * 2)] = 1.0
    assert rel(d.reshape(-1), d_ref) < 1e-12


@pytest.mark.parametrize("dim,p,refine", [(2, 1, 3), (2, 3, 2), (3, 2, 2),
                                          (3, 4, 1)])
def test_separable_elasticity_parity(dim, p, refine):
    """The block tensor-product factorisation: the blocks bit for bit,
    vmult_raw, vmult and the diagonal against tpufem and the oracle (on
    the separable scheme's MatrixFree, as the app builds it)."""
    dj, mfj, mft = pair(dim, p, refine, scatter="separable")
    opj = JSeparable(mfj, mu=MU, lam=LAM)
    opt = SeparableElasticityOperator(mft, mu=MU, lam=LAM)
    for rj, rt in zip(opj.blocks, opt.blocks64):
        for bj, bt in zip(rj, rt):
            for tj, tt in zip(bj, bt):
                assert all(np.array_equal(a, b) for a, b in zip(tj, tt))
    x = RNG.standard_normal((dim, dj.n_dofs))
    xt = torch.as_tensor(x)
    y = opt.vmult_raw(xt).numpy()
    assert rel(y, np.asarray(opj.vmult_raw(jnp.asarray(x)))) < 1e-12
    K = assemble_elasticity(dj, mu=MU, lam=LAM)
    assert rel(y.reshape(-1), K @ x.reshape(-1)) < 1e-12
    assert rel(opt.vmult(xt), np.asarray(opj.vmult(jnp.asarray(x)))) < 1e-12
    assert rel(opt.diagonal(), np.asarray(opj.diagonal())) < 1e-12


def test_separable_elasticity_kernel_path():
    """use_pallas in 3D: nine K4 wrappers, built unmasked, their plain
    versions on the CPU; each block's wrapper against its plain terms
    apply, the summed apply against tpufem's apply and the generic vector
    operator.  (tpufem's tests hold its per-block ResidentTerms in
    interpret mode to its XLA apply; the port's heat tests hold K4 to
    tpufem's interpreted kernel.)"""
    from tpufem_torch.ops.separable import laplace_apply_separable_terms

    dj, mfj, mft = pair(3, 2, 2, scatter="separable")
    opk = SeparableElasticityOperator(mft, MU, LAM, use_pallas=True)
    assert len(opk.kernels) == 3 and all(
        isinstance(k, ResidentTerms) and not k.dirichlet
        and k.n_terms == (3 if c == a else 2)
        for c, row in enumerate(opk.kernels) for a, k in enumerate(row))
    x = RNG.standard_normal((3, dj.n_dofs))
    xt = torch.as_tensor(x)
    for c in range(3):
        for a in range(3):
            k = opk.kernels[c][a]
            yb = k.unpad(k.raw(k.pad(xt[a])))
            ref = laplace_apply_separable_terms(xt[a], 3, opk.npts,
                                                opk.blocks[c][a])
            assert rel(yb, ref) < 1e-12
    y = opk.vmult_raw(xt).numpy()
    opj = JSeparable(mfj, MU, LAM)
    assert rel(y, np.asarray(opj.vmult_raw(jnp.asarray(x)))) < 1e-12
    gen = elasticity_operator(pair(3, 2, 2)[2], MU, LAM)
    assert rel(y, gen.vmult_raw(xt)) < 1e-12
    assert rel(opk.vmult(xt), gen.vmult(xt)) < 1e-12


def test_separable_elasticity_refusals():
    """use_pallas in 2D raises (no 2D kernel; the reference takes its XLA
    path there without a word); the 2D blocks are two terms each."""
    mesh = Mesh.hyper_cube(2, 2)
    mf = MatrixFree.build(mesh, DoFHandler(mesh, 2),
                          FemConfig(2, 2, scatter="separable"), "cpu")
    with pytest.raises(ValueError, match="3D"):
        SeparableElasticityOperator(mf, MU, LAM, use_pallas=True)
    assert SeparableElasticityOperator(mf, MU, LAM).kernels is None
    blocks = elasticity_separable_blocks(2, 2, 3, 4, [0.25, 0.25], MU, LAM)
    assert [len(b) for row in blocks for b in row] == [2, 2, 2, 2]


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=3),
    dict(dim=2, degree=2, refine=3, precond="chebyshev", fast=True),
    dict(dim=3, degree=2, refine=2, fast=True),
    dict(dim=2, degree=2, refine=2, precond="gmg")],
    ids=["jacobi", "chebyshev-fast", "jacobi-fast-3d", "gmg"])
def test_run_elasticity_matches_tpufem(same_start, kw):
    """run_elasticity with tpufem's CG iterations, x and L2 to 1e-10: the
    generic tier with Jacobi, the fast tier with Chebyshev (both packages
    estimating lambda_max from tpufem's start vector) and Jacobi, and the
    vector GMG V-cycle."""
    oj, xj = j_run_elasticity(mu=MU, lam=LAM, **kw)
    ot, xt = tel.run_elasticity(mu=MU, lam=LAM, device="cpu", **kw)
    for key in ("n_dofs", "n_components", "n_cells", "precond",
                "iterations", "converged"):
        assert ot[key] == oj[key], key
    assert ot["converged"]
    assert rel(xt, np.asarray(xj)) < 1e-10
    assert ot["l2_error"] == pytest.approx(oj["l2_error"], rel=1e-10)


def test_vector_multigrid_matches_tpufem(same_start):
    """The hierarchy (coarse inverse) and one V-cycle and two
    (n_cycles = 2) against tpufem's preconditioner to 1e-12; the GMG-CG
    takes fewer iterations than Jacobi to the same solution (its count
    against tpufem's: test_run_elasticity_matches_tpufem[gmg])."""
    from tpufem_torch.apps.elasticity import fdot
    from tpufem_torch.solvers.cg import cg_solve, make_jacobi

    mgj = JVectorMG(2, 2, finest_refine=3, coarsest_refine=1, mu=MU,
                    lam=LAM)
    mgt = VectorMultigrid(2, 2, finest_refine=3, coarsest_refine=1, mu=MU,
                          lam=LAM, device="cpu")
    assert rel(mgt.coarse_inv, np.asarray(mgj.coarse_inv)) < 1e-12
    mask = mgt.fine.mask.numpy()
    b = np.stack([mask * RNG.standard_normal(mask.shape[0])
                  for _ in range(2)])
    for n_cycles in (1, 2):
        mgj.n_cycles = mgt.n_cycles = n_cycles
        yj = mgj.preconditioner_with(mgj.device_args, jnp.asarray(b))
        yt = mgt.preconditioner()(torch.as_tensor(b))
        assert rel(yt, np.asarray(yj)) < 1e-12
    mgt.n_cycles = 1
    fine = mgt.fine
    rg = cg_solve(fine.op.vmult, torch.as_tensor(b),
                  M_inv=mgt.preconditioner(), rtol=1e-10, maxiter=500,
                  dot=fdot)
    rj = cg_solve(fine.op.vmult, torch.as_tensor(b),
                  M_inv=make_jacobi(1.0 / fine.inv_diag), rtol=1e-10,
                  maxiter=2000, dot=fdot)
    assert rg.converged and rj.converged and rg.iterations < rj.iterations
    assert rel(rg.x, rj.x) <= 1e-8


def test_elasticity_refusals():
    with pytest.raises(ValueError, match="gmg"):
        tel.run_elasticity(dim=2, degree=1, refine=2, precond="gmg",
                           fast=True, device="cpu")
    # the port refuses the fast tier with shards (the reference builds it
    # and leaves it unused); shards alone runs (tests/
    # test_torch_parallel_apps.py)
    with pytest.raises(ValueError, match="fast"):
        tel.run_elasticity(dim=2, degree=1, refine=2, shards=2, fast=True,
                           device="cpu")
    with pytest.raises(ValueError, match="fast"):
        tel.run_elasticity(dim=3, degree=1, refine=1, use_pallas=True,
                           device="cpu")


@pytest.mark.parametrize("argv,precond", [
    (["--precond", "gmg"], "gmg"),
    (["--fast"], "jacobi (separable fast tier)")])
def test_elasticity_cli(capsys, argv, precond):
    import json

    tel.main(["--dim", "2", "--degree", "2", "--refine", "3", "--json",
              "--device", "cpu"] + argv)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["converged"] and rec["l2_error"] < 5e-4
    assert rec["n_components"] == 2 and rec["precond"] == precond
    if precond == "gmg":
        assert rec["iterations"] <= 15

"""Port parity for the general-mesh partitioner and its distributed
operator (``tpufem_torch.parallel.general``) against tpufem's under
``shard_map`` on the 8 virtual CPU devices of tests/conftest.py, in f64:
the host plans equal element by element (owned/ghost lists, ghost
sources, the pairwise exchange plan, local cells, incidence, constraint
rows, metric slices), the adaptive hanging-node vmult on both exchange
schemes ("a2a", "gather"), the functor operators (mass, Helmholtz, a
curved metric), the exchange traffic, the Jacobi- and Chebyshev-CG with
tpufem's counts and solutions to 1e-10, and ``cheb_params`` to 1e-12 (the
distributed Newton-Krylov: tests/test_torch_parallel_krylov.py and
tests/test_torch_parallel_multichip.py)."""

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
from tpufem_torch.operators.laplace import LaplaceOperator
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


PLAN_FIELDS = ("n_shards", "n_dofs", "P", "G", "NC", "dim", "metric_kind",
               "l2g", "own_counts", "cell_counts", "cell_dofs", "incidence",
               "interior", "owned_mask", "ghost_src", "pair_send",
               "pair_recv", "con_dofs", "con_masters", "con_weights",
               "inv_h", "det", "inv_jac", "jxw", "coef_q", "S", "D",
               "D_col", "w_q")


def adaptive(M, dim, refine, steps):
    mesh = M.hyper_cube(dim, refine)
    for _ in range(steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - 0.3, axis=1) < 0.4)
    return mesh


def pair(dim, p, refine, steps, coefficient=None, shell=False):
    """(port MatrixFree, tpufem MatrixFree) on the same mesh."""
    out = []
    for M, D, C, MF, cfg, dev in (
            (Mesh, DoFHandler, make_hanging_node_constraints, MatrixFree,
             FemConfig, ("cpu",)),
            (JMesh, JDoFHandler, j_mhnc, JMatrixFree, JFemConfig, ())):
        mesh = M.hyper_shell_2d(3) if shell else adaptive(M, dim, refine,
                                                          steps)
        dofs = D(mesh, p)
        ac = None if mesh.is_uniform else C(dofs)
        out.append(MF.build(mesh, dofs, cfg(dim, p, scatter="incidence"),
                            *dev, coefficient=coefficient, constraints=ac))
    return out


def host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("case", ["adaptive", "coefficient", "shell"])
def test_plans_equal_tpufem(case):
    coef = None
    if case == "coefficient":
        coef = lambda x: 1.0 + 0.5 * np.sin(3.0 * x[:, 0]) * x[:, 1]
    mf, jmf = pair(2, 2, 2, 1, coefficient=coef, shell=case == "shell")
    part = GeneralPartitioner.build(mf, 4)
    jpart = jg.GeneralPartitioner.build(jmf, 4)
    for name in PLAN_FIELDS:
        a, b = getattr(part, name), getattr(jpart, name)
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if np.issubdtype(b.dtype, np.floating):
            assert np.allclose(a, b, rtol=1e-14, atol=1e-15), name
        else:
            assert np.array_equal(a, b), name
    # every dof owned exactly once; ghosts consistent with owners
    owners = np.concatenate([part.l2g[s, : part.own_counts[s]]
                             for s in range(4)])
    assert np.array_equal(np.sort(owners), np.arange(mf.n_dofs))
    u = np.random.default_rng(0).standard_normal(mf.n_dofs)
    loc = part.to_local(u)
    assert np.array_equal(loc, jpart.to_local(u))
    assert np.array_equal(part.to_global(loc), u)


def j_vmult(jop, x):
    return jop.part.to_global(np.asarray(jop.vmult(jop.put_vector(x))))


@pytest.mark.parametrize("dim,p,refine,steps,n_shards,exchange", [
    (2, 2, 2, 1, 4, "a2a"), (2, 3, 2, 1, 8, "gather"),
    (3, 2, 1, 1, 8, "a2a")])
def test_vmult_matches_tpufem(dim, p, refine, steps, n_shards, exchange):
    mf, jmf = pair(dim, p, refine, steps)
    part = GeneralPartitioner.build(mf, n_shards)
    dop = GeneralDistributedOperator(part, exchange=exchange)
    jop = jg.GeneralDistributedOperator(
        jg.GeneralPartitioner.build(jmf, n_shards), exchange=exchange)
    x = np.random.default_rng(1).standard_normal(mf.n_dofs)
    y_loc = dop.vmult(dop.put_vector(x))
    y = part.to_global(y_loc)
    assert rel(y, j_vmult(jop, x)) < 1e-12
    assert rel(y, host(LaplaceOperator(mf).vmult(torch.as_tensor(x)))) \
        < 1e-12
    # consistency: ghost copies agree with owned values after the apply
    yl = dop.mesh.stack(y_loc)
    live = part.l2g >= 0
    assert np.allclose(yl[live], y[part.l2g[live]], rtol=0, atol=1e-12)


def test_exchange_schemes_and_traffic():
    """"a2a" and "gather" give the same apply; the default picks "a2a"
    and ``exchange_traffic`` is tpufem's."""
    mf, jmf = pair(2, 2, 3, 0)
    part = GeneralPartitioner.build(mf, 8)
    x = np.random.default_rng(6).standard_normal(mf.n_dofs)
    ys = {ex: part.to_global(GeneralDistributedOperator(
        part, exchange=ex).vmult(GeneralDistributedOperator(
            part, exchange=ex).put_vector(x))) for ex in ("a2a", "gather")}
    assert rel(ys["a2a"], ys["gather"]) < 1e-14
    dop = GeneralDistributedOperator(part)
    jop = jg.GeneralDistributedOperator(jg.GeneralPartitioner.build(jmf, 8))
    assert dop.exchange == "a2a"
    assert dop.exchange_traffic() == jop.exchange_traffic()
    with pytest.raises(ValueError, match="exchange"):
        GeneralDistributedOperator(part, exchange="ring")


def test_functor_operators_match_tpufem():
    """The distributed FEEvaluation contract: mass and Helmholtz functors
    on the adaptive mesh, Helmholtz on the curved shell (the general
    metric), against tpufem's distributed operators."""
    qops = [(lambda v, g, c: (v, None), dict(needs_gradients=False)),
            (lambda v, g, c: (v, 0.7 * g), {})]
    for shell in (False, True):
        mf, jmf = pair(2, 2, 2, 1, shell=shell)
        part = GeneralPartitioner.build(mf, 8)
        jpart = jg.GeneralPartitioner.build(jmf, 8)
        x = np.random.default_rng(7).standard_normal(mf.n_dofs)
        for qop, kw in qops[1:] if shell else qops:
            dop = GeneralDistributedOperator(part, quad_op=qop, **kw)
            jop = jg.GeneralDistributedOperator(jpart, quad_op=qop, **kw)
            y = part.to_global(dop.vmult(dop.put_vector(x)))
            assert rel(y, j_vmult(jop, x)) < 1e-12, (shell, kw)


def _cg_case():
    mf, jmf = pair(2, 2, 3, 1)
    diag = host(LaplaceOperator(mf).diagonal())
    b = host(mf.interior_mask) * np.random.default_rng(3).standard_normal(
        mf.n_dofs)
    return mf, jmf, diag, b


def test_adaptive_cg_matches_tpufem():
    mf, jmf, diag, b = _cg_case()
    dop = GeneralDistributedOperator(GeneralPartitioner.build(mf, 8))
    jop = jg.GeneralDistributedOperator(jg.GeneralPartitioner.build(jmf, 8))
    x, it, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=500)
    xj, itj, _ = jop.cg_solve(b, diag, rtol=1e-10, maxiter=500)
    assert it == itj and rel(x, xj) < 1e-10
    # the local form, from a given x0
    res = dop.cg_solve_local(dop.put_vector(b), dop.put_vector(diag),
                             x0_local=dop.put_vector(x), rtol=1e-10)
    assert res.iterations == 0


def test_chebyshev_cg_and_params_match_tpufem():
    """cheb_params draws tpufem's start (``np.random.default_rng(0)``):
    theta and delta to 1e-12; the Chebyshev-CG takes tpufem's count and
    fewer iterations than Jacobi."""
    mf, jmf, diag, b = _cg_case()
    dop = GeneralDistributedOperator(GeneralPartitioner.build(mf, 8))
    jop = jg.GeneralDistributedOperator(jg.GeneralPartitioner.build(jmf, 8))
    cp, jcp = dop.cheb_params(diag, degree=4), jop.cheb_params(diag,
                                                               degree=4)
    assert cp.theta == pytest.approx(float(jcp.theta), rel=1e-12)
    assert cp.delta == pytest.approx(float(jcp.delta), rel=1e-12)
    x, it, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=500,
                            precond="chebyshev")
    xj, itj, _ = jop.cg_solve(b, diag, rtol=1e-10, maxiter=500,
                              precond="chebyshev", cheb_params=jcp)
    assert it == itj and rel(x, xj) < 1e-10
    _, it_jac, _ = dop.cg_solve(b, diag, rtol=1e-10, maxiter=500)
    assert it < it_jac
    with pytest.raises(ValueError, match="precond"):
        dop.cg_solve(b, diag, precond="gmg")

"""The structured and dense tiers of tpufem_torch (the JAX ``auto``
default on uniform meshes) against tpufem on the CPU in f64: the tensor
contractions, the blocked and global quadrature-grid applies (Cartesian,
with a pointwise coefficient on a refined mesh, curved), dense against
structured, and default-tier solves (BASELINE configs 1-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops import structured as jst
from tpufem.ops import tensor_ops as jtops
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.utils.config import FemConfig as JConfig
from tpufem_torch.apps import poisson as tpoisson
from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops import structured as tst
from tpufem_torch.ops import tensor_ops as ttops
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401


def rel_err(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))


def _warp(x):
    y = x.copy()
    s = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    y[:, 0] = x[:, 0] + 0.08 * s
    y[:, 1] = x[:, 1] - 0.06 * s
    return y


MESHES = {
    "cube2": lambda M: M.hyper_cube(2, 3),
    "cube3": lambda M: M.hyper_cube(3, 2),
    "refined2": lambda M: M.hyper_cube(2, 2).refine(np.ones(16, dtype=bool)),
    "shell2": lambda M: M.hyper_shell_2d(2),
    "shell3": lambda M: M.hyper_shell_3d(1),
}


def _pair(kind, p, scatter, coefficient=None, warp=False):
    """(port operator, JAX operator) on the same mesh."""
    out = []
    for M, D, C, MF, Op, dev in (
            (Mesh, DoFHandler, FemConfig, MatrixFree, LaplaceOperator,
             ("cpu",)),
            (JMesh, JDoFHandler, JConfig, JMatrixFree, JLaplace, ())):
        mesh = MESHES[kind](M)
        if warp:
            mesh.transform = _warp
        dofs = D(mesh, p)
        mf = MF.build(mesh, dofs, C(mesh.dim, p, scatter=scatter), *dev,
                      coefficient=coefficient)
        out.append(Op(mf))
    return out


def _apply_both(ops, seed=0):
    top, jop = ops
    x = np.random.default_rng(seed).standard_normal(top.n_dofs)
    y_t = top.vmult_raw(torch.as_tensor(x)).numpy()
    y_j = np.asarray(jop.vmult_raw(jnp.asarray(x)))
    return x, y_t, y_j


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", range(1, 8))
def test_tensor_ops_match_tpufem(dim, p):
    """Every contraction of ``tensor_ops`` on a random cell batch, with
    collocation (nq1 = p+1) and over-integration (nq1 = p+2) shapes."""
    rng = np.random.default_rng(p + 10 * dim)
    for nq1 in (p + 1, p + 2):
        si = ShapeInfo(p, Quadrature.gauss(nq1))
        S, D = si.S, si.D
        t = lambda a: torch.as_tensor(a)
        n1, nc = p + 1, 3
        u = rng.standard_normal((nc, n1**dim))
        g = rng.standard_normal((nc, dim, nq1**dim))
        v = rng.standard_normal((nc, nq1**dim))
        pairs = [
            (ttops.eval_gradients_basis(t(u), t(S), t(D), dim),
             jtops.eval_gradients_basis(u, S, D, dim)),
            (ttops.integrate_gradients_basis(t(g), t(S), t(D), dim),
             jtops.integrate_gradients_basis(g, S, D, dim)),
            (ttops.eval_values(t(u), t(S), dim),
             jtops.eval_values(u, S, dim)),
            (ttops.integrate_values(t(v), t(S), dim),
             jtops.integrate_values(v, S, dim)),
        ]
        if si.D_col is not None:
            Dc = si.D_col
            vt, gt = ttops.eval_gradients_collocation(t(u), t(S), t(Dc), dim)
            vj, gj = jtops.eval_gradients_collocation(u, S, Dc, dim)
            pairs += [(vt, vj), (gt, gj),
                      (ttops.integrate_collocation(t(v), t(g), t(S), t(Dc),
                                                   dim),
                       jtops.integrate_collocation(v, g, S, Dc, dim)),
                      (ttops.integrate_collocation(None, t(g), t(S), t(Dc),
                                                   dim),
                       jtops.integrate_collocation(None, g, S, Dc, dim))]
        for a, b in pairs:
            assert a.shape == tuple(np.shape(b))
            assert rel_err(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("dim,p", [(2, p) for p in range(1, 8)]
                         + [(3, p) for p in range(1, 6)])
def test_vmult_parity_all_degrees(dim, p):
    """The structured apply (the default tier) against tpufem's and the
    port's separable apply on the cube."""
    kind = "cube2" if dim == 2 else "cube3"
    ops = _pair(kind, p, "auto")
    assert ops[0].mf.scheme == ops[1].mf.scheme == "structured"
    x, y_t, y_j = _apply_both(ops, p)
    assert rel_err(y_t, y_j) <= 1e-12
    mesh = MESHES[kind](Mesh)
    sep = LaplaceOperator(MatrixFree.build(
        mesh, DoFHandler(mesh, p), FemConfig(dim, p, scatter="separable"),
        "cpu"))
    assert rel_err(y_t, sep.vmult_raw(torch.as_tensor(x)).numpy()) <= 1e-12


@pytest.mark.parametrize("dim,p", [(2, 2), (2, 5), (2, 7), (3, 2), (3, 4)])
def test_dense_matches_structured(dim, p):
    kind = "cube2" if dim == 2 else "cube3"
    dense, jdense = _pair(kind, p, "dense")
    st, _ = _pair(kind, p, "structured")
    x, y_d, y_jd = _apply_both((dense, jdense), p)
    y_s = st.vmult_raw(torch.as_tensor(x)).numpy()
    assert rel_err(y_d, y_s) <= 1e-12 and rel_err(y_d, y_jd) <= 1e-12


def test_variable_coefficient_on_refined_uniform_mesh():
    """A refined mesh is not lexicographic: the coefficient's blocked
    field must be put in canonical cell order, or it is transposed."""
    coef = lambda x: 1.0 + 5.0 * x[:, 0]  # asymmetric on purpose
    ops = _pair("refined2", 2, "auto", coefficient=coef)
    assert ops[0].mf.scheme == "structured"
    assert ops[0].mf.mesh.is_uniform
    x, y_t, y_j = _apply_both(ops)
    K = assemble_laplace(ops[0].mf.dofs, coefficient=coef)
    assert rel_err(y_t, K @ x) <= 1e-10 and rel_err(y_t, y_j) <= 1e-12


@pytest.mark.parametrize("kind,p,coef,warp", [
    ("cube2", 3, False, True),
    ("shell2", 1, False, False),
    ("shell2", 3, True, False),
    ("shell3", 2, False, False),
])
def test_curved_mesh_general_metric_parity(kind, p, coef, warp):
    """The general-metric structured apply (global quadrature grid, the
    packed metric component-major) against tpufem's, the assembled
    operator and the port's incidence apply."""
    cf = (lambda x: 1.0 + np.sum(x**2, axis=1)) if coef else None
    ops = _pair(kind, p, "auto", coefficient=cf, warp=warp)
    assert ops[0].mf.scheme == "structured"
    assert ops[0].mf.metric_kind == "general"
    assert ops[0].mf.struct_gsym.shape[0] == (3 if "2" in kind else 6)
    x, y_t, y_j = _apply_both(ops, p)
    assert rel_err(y_t, y_j) <= 1e-12
    K = assemble_laplace(ops[0].mf.dofs, coefficient=cf)
    assert rel_err(y_t, K @ x) <= 1e-10
    inc, _ = _pair(kind, p, "incidence", coefficient=cf, warp=warp)
    assert rel_err(y_t, inc.vmult_raw(torch.as_tensor(x)).numpy()) <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_global_operators_match_tpufem(dim):
    """``laplace_apply_global_general`` and ``laplace_apply_global_diag``
    called directly on the same operators and metric as tpufem's (the
    port's packed metric component-major, tpufem's component-last)."""
    p, n = 2, 3
    si = ShapeInfo(p, Quadrature.gauss(p + 1))
    E, Gd = tst.global_interp_matrices(p, n, si.S, si.D_col)
    Ej, Gj = jst.global_interp_matrices(p, n, si.S, si.D_col)
    assert np.array_equal(E, Ej) and np.array_equal(Gd, Gj)
    rng = np.random.default_rng(dim)
    npts, nq = n * p + 1, n * (p + 1)
    u = rng.standard_normal(npts**dim)
    ncomp = dim * (dim + 1) // 2
    gsym = rng.random((nq,) * dim + (ncomp,)) + 0.5
    y_t = tst.laplace_apply_global_general(
        torch.as_tensor(u), dim, n, p, [torch.as_tensor(E)] * dim,
        [torch.as_tensor(Gd)] * dim,
        torch.as_tensor(np.moveaxis(gsym, -1, 0).copy())).numpy()
    y_j = jst.laplace_apply_global_general(jnp.asarray(u), dim, n, p,
                                           [E] * dim, [Gd] * dim,
                                           jnp.asarray(gsym))
    assert rel_err(y_t, y_j) <= 1e-12
    wb = rng.random((n, p + 1) * dim) + 0.5
    scale = np.array([1.0, 1.7, 0.6])[:dim]
    y_t = tst.laplace_apply_global_diag(
        torch.as_tensor(u), dim, n, p, [torch.as_tensor(E)] * dim,
        [torch.as_tensor(Gd)] * dim, torch.as_tensor(scale),
        torch.as_tensor(wb)).numpy()
    y_j = jst.laplace_apply_global_diag(jnp.asarray(u), dim, n, p, [E] * dim,
                                        [Gd] * dim, scale, jnp.asarray(wb))
    assert rel_err(y_t, y_j) <= 1e-12
    inv_jac = rng.standard_normal((4, 5, dim, dim))
    jxw = rng.random((4, 5))
    assert np.array_equal(tst.sym_metric_components(inv_jac, jxw),
                          jst.sym_metric_components(inv_jac, jxw))


@pytest.mark.parametrize("dim,ns", [(2, (3, 2)), (3, (2, 3, 1))])
def test_block_unblock_match_tpufem(dim, ns):
    """Blocking and its transpose, the overlap-add, on unequal axes."""
    p = 3
    u = np.random.default_rng(1).standard_normal(
        int(np.prod([n * p + 1 for n in ns])))
    bt = tst.block_all(torch.as_tensor(u), dim, ns, p)
    bj = np.asarray(jst.block_all(jnp.asarray(u), dim, ns, p))
    assert np.array_equal(bt.numpy(), bj)
    v = np.random.default_rng(2).standard_normal(bj.shape)
    assert np.array_equal(
        tst.unblock_all_add(torch.as_tensor(v), dim, ns, p).numpy(),
        np.asarray(jst.unblock_all_add(jnp.asarray(v), dim, ns, p)))


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=1, refine=4),  # BASELINE config 1
    dict(dim=3, degree=2, refine=2),  # BASELINE config 2
    dict(dim=2, degree=3, refine=2, mesh_kind="shell"),
    dict(dim=2, degree=2, refine=3,
         exact=lambda x: x[:, 0] ** 2 - x[:, 1] ** 2,
         rhs=lambda x: np.zeros(len(x))),
])
def test_default_tier_solve_matches_tpufem(kw):
    """solve_poisson() on its default tier (auto -> structured): equal
    iteration counts, L2 within 1e-10 of tpufem's."""
    rt = tpoisson.solve_poisson(**kw, device="cpu")
    rj = j_solve_poisson(**kw)
    assert rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * max(rj.l2_error, 1e-6)
    assert rel_err(rt.solution, rj.solution) <= 1e-10


def _rough(x):
    """A RHS far from an eigenvector, so the solve takes many iterations."""
    return (np.cos(7 * x[:, 0]) + x[:, -1] ** 3
            + np.sin(13 * x[:, 0] * x[:, -1]))


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=3, refine=4),
    dict(dim=3, degree=2, refine=3),
    dict(dim=3, degree=4, refine=2),
])
def test_f32_structured_solve_matches_tpufem(kw):
    """The f32 solve on the structured tier: equal iteration counts and x
    within the f32 class (1e-6) of tpufem's.  The RHS is rough: the sine
    of the default solution is almost an eigenvector of the Jacobi-scaled
    operator, so its f32 count measures rounding noise (the port 17,
    tpufem 25 at 3D Q4 refine 3, both tiers alike)."""
    rt = tpoisson.solve_poisson(**kw, scatter="structured", dtype="float32",
                                rhs=_rough, device="cpu")
    rj = j_solve_poisson(**kw, scatter="structured", dtype="float32",
                         rhs=_rough)
    assert rt.converged and rt.iterations == rj.iterations
    assert rel_err(rt.solution, rj.solution) <= 1e-6


def test_structured_refusals():
    mesh = Mesh.hyper_cube(2, 2)
    dofs = DoFHandler(mesh, 2)
    with pytest.raises(ValueError, match="nq1 == p\\+1"):
        MatrixFree.build(mesh, dofs, FemConfig(2, 2, n_q_1d=4,
                                               scatter="structured"), "cpu")
    with pytest.raises(ValueError, match="dense scheme"):
        MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="dense"), "cpu",
                         coefficient=lambda x: 1.0 + x[:, 0])
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, n_q_1d=4), "cpu")
    assert mf.scheme == "incidence" and mf.D_col is None
    # the uniform tiers never build the incidence map or the colors
    st = MatrixFree.build(mesh, dofs, FemConfig(2, 2), "cpu")
    LaplaceOperator(st).vmult(torch.ones(dofs.n_dofs, dtype=torch.float64))
    assert st.incidence is None and st.colors is None


def test_dense_with_cell_mask_matches_tpufem():
    """``laplace_apply_dense`` with an active-cell mask against tpufem's
    ``laplace_apply_dense_masked``."""
    from tpufem.ops import dense_local as jdl
    from tpufem_torch.ops import dense_local as tdl

    dim, p, ns = 3, 2, (2, 3, 2)
    A = tdl.build_dense_local_matrix(p, dim, p + 1, [1.0, 2.0, 0.5])
    Aj = jdl.build_dense_local_matrix(p, dim, p + 1, [1.0, 2.0, 0.5],
                                      np.float64)
    assert np.array_equal(A, Aj)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(int(np.prod([n * p + 1 for n in ns])))
    mask = (rng.random(int(np.prod(ns))) < 0.6).astype(np.float64)
    y_t = tdl.laplace_apply_dense(torch.as_tensor(u), dim, ns, p,
                                  torch.as_tensor(A),
                                  torch.as_tensor(mask)).numpy()
    y_j = jdl.laplace_apply_dense_masked(jnp.asarray(u), dim, ns, p,
                                         jnp.asarray(A), jnp.asarray(mask))
    assert rel_err(y_t, y_j) <= 1e-12

"""The gather tiers of tpufem_torch (incidence, colored) with hanging
nodes, the device diagonal, the adaptive solves and the AMR loop, against
tpufem on the CPU in f64 (BASELINE config 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps import poisson as jpoisson
from tpufem.fem.constraints import make_hanging_node_constraints as j_hanging
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops.diagonal import diagonal_device as j_diag_dev
from tpufem.ops.diagonal import diagonal_device_hanging as j_diag_hanging
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.utils.config import FemConfig as JConfig
from tpufem_torch.apps import poisson as tpoisson
from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.coloring import color_cells, verify_coloring
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.estimator import kelly_estimate
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.diagonal import diagonal_device, diagonal_device_hanging
from tpufem_torch.ops.matrix_free import MatrixFree, transpose_table
from tpufem_torch.utils.config import FemConfig


def rel_err(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))


def adaptive_mesh(M, dim, base, steps, center=0.31):
    mesh = M.hyper_cube(dim, base)
    for _ in range(steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - center, axis=1) < 0.35)
    return mesh


def _pair(dim, p, scatter, coefficient=None, steps=None):
    """(port operator, JAX operator) on the same adaptive mesh."""
    steps = (2 if dim == 2 else 1) if steps is None else steps
    mesh = adaptive_mesh(Mesh, dim, 2, steps)
    dofs = DoFHandler(mesh, p)
    ac = make_hanging_node_constraints(dofs)
    assert len(ac.lines) > 0
    top = LaplaceOperator(MatrixFree.build(
        mesh, dofs, FemConfig(dim, p, scatter=scatter), "cpu",
        coefficient=coefficient, constraints=ac))
    jmesh = adaptive_mesh(JMesh, dim, 2, steps)
    jdofs = JDoFHandler(jmesh, p)
    jop = JLaplace(JMatrixFree.build(
        jmesh, jdofs, JConfig(dim, p, scatter=scatter),
        coefficient=coefficient, constraints=j_hanging(jdofs)))
    return top, jop


_COEF = lambda x: 1.0 + 10.0 * np.sum(x**2, axis=1)  # noqa: E731


@pytest.mark.parametrize("scatter", ["incidence", "colored"])
@pytest.mark.parametrize("dim,p", [(2, 1), (2, 2), (2, 3), (2, 4),
                                   (3, 1), (3, 2), (3, 3), (3, 4)])
def test_constrained_vmult_parity(dim, p, scatter):
    """vmult (m C^T A C m + identity rows) against tpufem's, and the
    condensed assembled operator."""
    top, jop = _pair(dim, p, scatter)
    mf = top.mf
    assert mf.scheme == scatter and mf.has_hanging
    x = np.random.default_rng(p).standard_normal(mf.n_dofs)
    y_t = top.vmult(torch.as_tensor(x)).numpy()
    y_j = np.asarray(jop.vmult(jnp.asarray(x)))
    assert rel_err(y_t, y_j) <= 1e-12
    if dim == 2 or p <= 2:
        ac = mf.constraints_obj
        m = mf.interior_mask.numpy()
        K = assemble_laplace(mf.dofs)
        y_o = m * ac.distribute_transpose(K @ ac.distribute(m * x)) \
            + (1 - m) * x
        assert rel_err(y_t, y_o) <= 1e-12
    y_r = top.vmult_raw(torch.as_tensor(x)).numpy()
    assert rel_err(y_r, np.asarray(jop.vmult_raw(jnp.asarray(x)))) <= 1e-12


@pytest.mark.parametrize("dim,p", [(2, 3), (3, 2)])
def test_incidence_and_colored_agree_bitwise_run_to_run(dim, p):
    inc, _ = _pair(dim, p, "incidence")
    col, _ = _pair(dim, p, "colored")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(inc.n_dofs))
    y_i, y_c = inc.vmult(x), col.vmult(x)
    assert rel_err(y_i.numpy(), y_c.numpy()) <= 1e-12
    assert torch.equal(y_i, inc.vmult(x)) and torch.equal(y_c, col.vmult(x))


def test_transpose_table_sums_what_the_accumulating_scatter_sums():
    """distribute_transpose (the padded master table's gather-sum) and
    distribute against tpufem's ``.at[].add`` / ``.at[].set``, and the
    table against np.add.at on random entries with repeated columns."""
    top, jop = _pair(3, 2, "incidence")
    y = np.random.default_rng(3).standard_normal(top.n_dofs)
    assert rel_err(top.mf.distribute_transpose(torch.as_tensor(y)).numpy(),
                   jop.mf.distribute_transpose(jnp.asarray(y))) <= 1e-14
    for hom in (True, False):
        assert rel_err(
            top.mf.distribute(torch.as_tensor(y), homogeneous=hom).numpy(),
            jop.mf.distribute(jnp.asarray(y), homogeneous=hom)) <= 1e-15
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 50, 400)
    cols = rng.integers(0, 30, 400)
    vals = rng.standard_normal(400)
    x = rng.standard_normal(50)
    tc, tr, tv = transpose_table(rows, cols, vals, 50)
    ref = np.zeros(30)
    np.add.at(ref, cols, vals * x[rows])
    got = np.zeros(30)
    got[tc] = (tv * np.append(x, 0.0)[tr]).sum(1)
    assert np.allclose(got, ref, rtol=0, atol=1e-13)
    assert len(np.unique(tc)) == len(tc)


@pytest.mark.parametrize("dim,p,coef", [(2, 2, False), (2, 3, True),
                                        (3, 2, False), (3, 2, True)])
def test_diagonal_device_hanging(dim, p, coef):
    """diag(C^T A C) against tpufem's and the condensed assembled
    operator, with and without a variable coefficient."""
    cf = _COEF if coef else None
    top, jop = _pair(dim, p, "incidence", coefficient=cf)
    d_t = diagonal_device_hanging(top.mf).numpy()
    d_j = np.asarray(j_diag_hanging(jop.mf))
    assert rel_err(d_t, d_j) <= 1e-12
    mf = top.mf
    ac = mf.constraints_obj
    Kc = ac.condense_matrix(assemble_laplace(mf.dofs, coefficient=cf))
    mask = ~(mf.dofs.boundary_mask | ac.constrained_mask())
    dg = top.diagonal().numpy()
    assert rel_err(dg[mask], np.asarray(Kc.diagonal())[mask]) <= 1e-12
    assert np.all(dg[~mask] == 1.0)


def test_diagonal_device_unconstrained_matches_host():
    mesh = Mesh.hyper_cube(3, 2)
    dofs = DoFHandler(mesh, 3)
    mf = MatrixFree.build(mesh, dofs, FemConfig(3, 3, scatter="incidence"),
                          "cpu")
    d_host = LaplaceOperator(mf).diagonal().numpy()
    d_dev = diagonal_device(mf).numpy()
    mask = ~dofs.boundary_mask
    assert rel_err(d_dev[mask], d_host[mask]) <= 1e-12
    jmesh = JMesh.hyper_cube(3, 2)
    jmf = JMatrixFree.build(jmesh, JDoFHandler(jmesh, 3),
                            JConfig(3, 3, scatter="incidence"))
    assert rel_err(d_dev, j_diag_dev(jmf)) <= 1e-12


def test_coloring_valid_uniform_and_adaptive():
    mesh = Mesh.hyper_cube(2, 3)
    dofs = DoFHandler(mesh, 2)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="colored"),
                          "cpu")
    colors_u = [c.numpy() for c, _ in mf._ensure_colors()]
    verify_coloring(colors_u, dofs.cell_dofs)
    assert len(colors_u) == 4
    assert sum(len(c) for c in colors_u) == mesh.n_cells
    for dim in (2, 3):
        amesh = adaptive_mesh(Mesh, dim, 2, 2 if dim == 2 else 1)
        adofs = DoFHandler(amesh, 2)
        colors = color_cells(amesh, adofs.cell_dofs)
        verify_coloring(colors, adofs.cell_dofs)
        assert sum(len(c) for c in colors) == amesh.n_cells
    with pytest.raises(AssertionError, match="shared DoF"):
        verify_coloring([np.arange(mesh.n_cells)], dofs.cell_dofs)


def test_constrained_vmult_identity_on_boundary():
    """Identity rows on constrained (boundary and hanging) DoFs, and a
    symmetric constrained operator."""
    top, _ = _pair(2, 2, "incidence")
    mf = top.mf
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(mf.n_dofs))
    y = top.vmult(x)
    con = mf.interior_mask == 0
    assert torch.equal(y[con], x[con])
    a = torch.as_tensor(rng.standard_normal(mf.n_dofs))
    b = torch.as_tensor(rng.standard_normal(mf.n_dofs))
    assert np.isclose(float(top.vmult(a) @ b), float(a @ top.vmult(b)),
                      rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=2, adaptive_steps=2),
    dict(dim=2, degree=3, refine=1, adaptive_steps=1, scatter="colored"),
    dict(dim=3, degree=2, refine=1, adaptive_steps=1),
    dict(dim=2, degree=2, refine=2, adaptive_steps=1, coefficient=_COEF),
])
def test_adaptive_solve_matches_tpufem(kw):
    """f64 adaptive solves: equal iteration counts, L2 within 1e-10, and
    a solution continuous across the hanging faces."""
    rt = tpoisson.solve_poisson(**kw, device="cpu")
    rj = jpoisson.solve_poisson(**kw)
    assert rt.n_dofs == rj.n_dofs and rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error
    ac = make_hanging_node_constraints(rt.dofs)
    for d, ents in ac.lines.items():
        assert abs(rt.solution[d] - sum(w * rt.solution[m]
                                        for m, w in ents)) < 1e-12


def test_solve_poisson_on_a_given_mesh():
    mesh = adaptive_mesh(Mesh, 2, 2, 1)
    rt = tpoisson.solve_poisson(dim=2, degree=2, mesh=mesh, device="cpu")
    rj = jpoisson.solve_poisson(dim=2, degree=2,
                                mesh=adaptive_mesh(JMesh, 2, 2, 1))
    assert rt.n_cells == mesh.n_cells and rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=2, cycles=3),
    dict(dim=3, degree=1, refine=1, cycles=2),
    dict(dim=2, degree=2, refine=2, cycles=2, mesh_kind="shell"),
])
def test_solve_poisson_amr_matches_tpufem(kw):
    """The AMR loop: equal n_dofs and iterations per cycle, eta within
    1e-10 of tpufem's."""
    rt = tpoisson.solve_poisson_amr(**kw, device="cpu")
    rj = jpoisson.solve_poisson_amr(**kw)
    assert [r.n_dofs for r in rt] == [r.n_dofs for r in rj]
    assert [r.iterations for r in rt] == [r.iterations for r in rj]
    for a, b in zip(rt, rj):
        assert abs(a.eta - b.eta) <= 1e-10 * b.eta
    assert rt[-1].n_cells > rt[0].n_cells


def test_kelly_zero_on_linear():
    """A globally linear FE function has no gradient jumps, across the
    2:1 hanging faces included."""
    for dim, p in [(2, 3), (3, 2)]:
        mesh = adaptive_mesh(Mesh, dim, 2 if dim == 2 else 1,
                             2 if dim == 2 else 1)
        dofs = DoFHandler(mesh, p)
        ac = make_hanging_node_constraints(dofs)
        u = ac.distribute(dofs.dof_coords @ np.arange(1.0, dim + 1.0) + 0.5)
        assert kelly_estimate(dofs, u).max() < 1e-12


def test_cli_amr_json(capsys):
    tpoisson.main(["--dim", "2", "--degree", "1", "--refine", "2", "--amr",
                   "3", "--device", "cpu", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()[-3:]
    import json

    rt = tpoisson.solve_poisson_amr(dim=2, degree=1, refine=2, cycles=3,
                                    device="cpu")
    got = [json.loads(s) for s in lines]
    assert [g["cycle"] for g in got] == [0, 1, 2]
    assert [g["n_dofs"] for g in got] == [r.n_dofs for r in rt]
    assert [g["eta"] for g in got] == [r.eta for r in rt]

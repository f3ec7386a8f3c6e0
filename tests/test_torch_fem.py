"""The port's copy of the numpy host setup (``tpufem_torch.fem``,
``tpufem_torch.utils.config``) against the JAX package's on the same
inputs: every array bit-equal, every field and default the same."""

import dataclasses

import numpy as np
import pytest

from tpufem.fem import assemble as j_assemble
from tpufem.fem import dof_handler as j_dofs
from tpufem.fem import mapping as j_mapping
from tpufem.fem import mesh as j_mesh
from tpufem.fem import quadrature as j_quad
from tpufem.fem import shapes as j_shapes
from tpufem.utils import config as j_config
from tpufem_torch.fem import assemble as t_assemble
from tpufem_torch.fem import dof_handler as t_dofs
from tpufem_torch.fem import mapping as t_mapping
from tpufem_torch.fem import mesh as t_mesh
from tpufem_torch.fem import quadrature as t_quad
from tpufem_torch.fem import shapes as t_shapes
from tpufem_torch.utils import config as t_config

MESHES = {
    "cube2d": lambda M, r: M.hyper_cube(2, r),
    "cube3d": lambda M, r: M.hyper_cube(3, r),
    "shell2d": lambda M, r: M.hyper_shell_2d(r),
    "shell3d": lambda M, r: M.hyper_shell_3d(r),
}


def _same(a, b):
    assert type(a) is type(b) or (a is None) == (b is None)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("refine", [1, 2])
def test_mesh_equal(kind, refine):
    mj = MESHES[kind](j_mesh.Mesh, refine)
    mt = MESHES[kind](t_mesh.Mesh, refine)
    for name in ("dim", "n_cells", "U", "is_uniform"):
        _same(getattr(mj, name), getattr(mt, name))
    for name in ("origins", "sizes", "lower", "upper"):
        _same(getattr(mj, name), getattr(mt, name))
    _same(mj.cell_vertices_logical(), mt.cell_vertices_logical())
    _same(mj.cell_vertices(), mt.cell_vertices())


@pytest.mark.parametrize("p", range(1, 8))
@pytest.mark.parametrize("dim,refine", [(2, 1), (2, 2), (3, 1)])
def test_dofs_equal(p, dim, refine):
    dj = j_dofs.DoFHandler(j_mesh.Mesh.hyper_cube(dim, refine), p)
    dt = t_dofs.DoFHandler(t_mesh.Mesh.hyper_cube(dim, refine), p)
    assert dj.n_dofs == dt.n_dofs
    for name in ("cell_dofs", "dof_coords", "boundary_mask"):
        _same(getattr(dj, name), getattr(dt, name))
    _same(j_shapes.support_points_1d(p), t_shapes.support_points_1d(p))


@pytest.mark.parametrize("kind", ["shell2d", "shell3d"])
def test_dofs_equal_on_shells(kind):
    dj = j_dofs.DoFHandler(MESHES[kind](j_mesh.Mesh, 1), 3)
    dt = t_dofs.DoFHandler(MESHES[kind](t_mesh.Mesh, 1), 3)
    for name in ("cell_dofs", "dof_coords", "boundary_mask"):
        _same(getattr(dj, name), getattr(dt, name))


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_quadrature_and_shapes_equal(n):
    for fn in ("gauss_legendre", "gauss_lobatto"):
        if fn == "gauss_lobatto" and n < 2:
            continue
        for a, b in zip(getattr(j_quad, fn)(n), getattr(t_quad, fn)(n)):
            _same(a, b)
    qj, qt = j_quad.Quadrature.gauss(n), t_quad.Quadrature.gauss(n)
    for dim in (1, 2, 3):
        _same(qj.tensor_points(dim), qt.tensor_points(dim))
        _same(qj.tensor_weights(dim), qt.tensor_weights(dim))
    for p in range(1, 8):
        sj = j_shapes.ShapeInfo(p, qj)
        st = t_shapes.ShapeInfo(p, qt)
        for name in ("S", "D", "D_col", "nodes"):
            _same(getattr(sj, name), getattr(st, name))


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_compute_metric_equal(kind):
    mj, mt = MESHES[kind](j_mesh.Mesh, 1), MESHES[kind](t_mesh.Mesh, 1)
    qj, qt = j_quad.Quadrature.gauss(3), t_quad.Quadrature.gauss(3)
    a = j_mapping.compute_metric(mj, qj, need_points=True)
    b = t_mapping.compute_metric(mt, qt, need_points=True)
    for f in dataclasses.fields(a):
        _same(getattr(a, f.name), getattr(b, f.name))
    a, b = a.to_general(), b.to_general()
    for f in dataclasses.fields(a):
        _same(getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("kind,p", [("cube2d", 2), ("cube3d", 3),
                                    ("shell2d", 4), ("shell3d", 2)])
def test_assembly_and_errors_equal(kind, p):
    dj = j_dofs.DoFHandler(MESHES[kind](j_mesh.Mesh, 1), p)
    dt = t_dofs.DoFHandler(MESHES[kind](t_mesh.Mesh, 1), p)
    f = lambda x: np.prod(np.sin(np.pi * x), axis=1) + x[:, 0] ** 2
    _same(j_assemble.assemble_rhs(dj, f), t_assemble.assemble_rhs(dt, f))
    u_h = np.random.default_rng(p).standard_normal(dj.n_dofs)
    grad = lambda x: np.cos(x)
    for norm in ("l2", "h1_semi", "h1"):
        _same(j_assemble.integrate_difference(dj, u_h, f, norm=norm,
                                              grad_exact=grad),
              t_assemble.integrate_difference(dt, u_h, f, norm=norm,
                                              grad_exact=grad))
    _same(j_assemble.integrate_errors(dj, u_h, f, grad),
          t_assemble.integrate_errors(dt, u_h, f, grad))
    dim = dj.mesh.dim
    _same(j_assemble.cell_basis_gradients(p, dim, j_quad.Quadrature.gauss(4)),
          t_assemble.cell_basis_gradients(p, dim, t_quad.Quadrature.gauss(4)))


def test_fem_config_equal():
    fj = dataclasses.fields(j_config.FemConfig)
    ft = dataclasses.fields(t_config.FemConfig)
    assert [(f.name, f.type, f.default) for f in fj] == \
        [(f.name, f.type, f.default) for f in ft]
    a = j_config.FemConfig(dim=3, degree=4, scatter="separable")
    b = t_config.FemConfig(dim=3, degree=4, scatter="separable")
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(ValueError):
        t_config.FemConfig(degree=13)

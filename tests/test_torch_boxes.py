"""Port parity for the adaptive box tier (``tpufem_torch.ops.boxes``,
``box_interface``, ``box_pairs``) against tpufem in f64 on the CPU.

Mirrors tests/test_boxes.py: the same meshes and seeded inputs go through
both packages; the host tables are bit-equal, the applies agree to 1e-12
relative (and with the assembled oracle), the box CG solves take equal
iteration counts.  No kernel stands behind this tier: the port runs plain
PyTorch ops on any device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.assemble import assemble_laplace as j_assemble_laplace
from tpufem.fem.constraints import make_hanging_node_constraints as j_mhnc
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops import box_interface as j_bi
from tpufem.ops import box_pairs as j_bp
from tpufem.ops import boxes as j_boxes
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.assemble import assemble_laplace, assemble_rhs
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops import box_interface as t_bi
from tpufem_torch.ops import box_pairs as t_bp
from tpufem_torch.ops import boxes as t_boxes
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.utils.config import FemConfig
from torch_threads import one_torch_thread  # noqa: F401

COEF = lambda x: 1.0 + 10.0 * np.sum(x**2, axis=1)  # test_boxes.py's


def adaptive(M, dim, base, steps, center=0.31):
    """test_boxes.py's adaptive mesh, in package M."""
    mesh = M.hyper_cube(dim, base)
    for _ in range(steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - center, axis=1) < 0.35)
    return mesh


def curved_adaptive(M, dim, r):
    """test_boxes.py's adaptively refined shell wedge."""
    mesh = (M.hyper_shell_2d(r) if dim == 2 else M.hyper_shell_3d(r))
    flags = np.zeros(mesh.n_cells, bool)
    flags[: mesh.n_cells // 3] = True
    return mesh.refine(flags)


def pair(make, p, coefficient=None, dtype="float64", **kw):
    """The same mesh through both packages: (tpufem op, port op, port
    dofs, port constraints)."""
    out = []
    for M, D, mk, B, dev in ((JMesh, JDoFHandler, j_mhnc,
                              j_boxes.BoxLaplaceOperator, None),
                             (Mesh, DoFHandler, make_hanging_node_constraints,
                              BoxLaplaceOperator, "cpu")):
        mesh = make(M)
        dofs = D(mesh, p)
        ac = None if mesh.is_uniform else mk(dofs)
        extra = {} if dev is None else {"device": dev}
        out.append((B(mesh, dofs, constraints=ac, coefficient=coefficient,
                      dtype=dtype, **kw, **extra), dofs, ac))
    (oj, _, _), (ot, dofs, ac) = out
    return oj, ot, dofs, ac


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def applies_agree(oj, ot, x, names=("vmult_raw", "vmult"), tol=1e-12):
    """Each apply of the port against tpufem's on the same global x."""
    for name in names:
        yj = oj.from_patch(getattr(oj, name)(oj.to_patch(x)))
        yt = ot.from_patch(getattr(ot, name)(ot.to_patch(x)))
        assert rel(yt, yj) <= tol, name
    return yt


def oracle_vmult(dofs, ac, x, coefficient=None):
    """The condensed assembled operator m C^T K C (m x) + (1-m) x."""
    K = assemble_laplace(dofs, coefficient=coefficient)
    m_g = ~(dofs.boundary_mask | ac.constrained_mask())
    y = ac.distribute_transpose(np.asarray(K @ ac.distribute(m_g * x)))
    return m_g * y + (~m_g) * x


# ---- host tables, bit-equal ---------------------------------------------

def _boxes_equal(bj, bt):
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        for f in ("size", "nb", "lattice_shape", "offset"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("lo", "cells", "gid", "active"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("dim,p,base,steps", [(3, 2, 1, 2), (2, 3, 2, 2),
                                              (2, 2, 3, 3)])
def test_boxes_cover_every_cell_once(dim, p, base, steps):
    """test_boxes.py's cover check on the port, and build_boxes /
    _local_lattice bit-equal to tpufem's."""
    mj, mt = adaptive(JMesh, dim, base, steps), adaptive(Mesh, dim, base,
                                                         steps)
    dofs = DoFHandler(mt, p)
    boxes = t_boxes.build_boxes(mt, dofs)
    seen = np.concatenate([b.cells for b in boxes])
    assert sorted(seen.tolist()) == list(range(mt.n_cells))
    for b in boxes:
        assert int(b.active.sum()) == len(b.cells)
    _boxes_equal(j_boxes.build_boxes(mj, JDoFHandler(mj, p)), boxes)
    assert np.array_equal(j_boxes._local_lattice(p, dim),
                          t_boxes._local_lattice(p, dim))
    for a, b in zip(j_boxes._copies_by_gid(j_boxes.build_boxes(
            mj, JDoFHandler(mj, p))), t_boxes._copies_by_gid(boxes)):
        assert np.array_equal(a, b)


def _rects_equal(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert (a.bf, a.bc, a.fslice, a.cslice) == (b.bf, b.bc, b.fslice,
                                                    b.cslice)
        assert len(a.F) == len(b.F)
        assert all(np.array_equal(x, y) for x, y in zip(a.F, b.F))
        assert np.array_equal(a.mask, b.mask)
        assert np.array_equal(a.rows, b.rows)


@pytest.mark.parametrize("dim,p,base,steps", [(2, 2, 2, 2), (3, 2, 1, 2),
                                              (2, 2, 3, 3), (3, 1, 2, 2)])
def test_interface_and_pair_tables_equal(dim, p, base, steps):
    """build_interface_rects (maximal and bounding), build_pair_plans with
    its S and E, and uncovered_multi_rows bit-equal to tpufem's."""
    tabs = []
    for M, D, mk, bx, bi, bp in (
            (JMesh, JDoFHandler, j_mhnc, j_boxes, j_bi, j_bp),
            (Mesh, DoFHandler, make_hanging_node_constraints, t_boxes, t_bi,
             t_bp)):
        mesh = adaptive(M, dim, base, steps)
        dofs = D(mesh, p)
        ac = mk(dofs)
        boxes = bx.build_boxes(mesh, dofs)
        rects, left = bi.build_interface_rects(boxes, ac, p, dim)
        brects, bleft = bi.build_interface_rects(boxes, ac, p, dim,
                                                 merge="bounding")
        plans, dropped = bp.build_pair_plans(boxes, rects, p, dim)
        gids, live, starts, ends = bx._copies_by_gid(boxes)
        fb = bp.uncovered_multi_rows(boxes, plans, gids, live, starts, ends)
        tabs.append((rects, left, brects, bleft, plans, dropped, fb))
    (rj, lj, brj, blj, pj, dj, fj), (rt, lt, brt, blt, pt, dt, ft) = tabs
    assert len(rt) > 0 and len(pt) > 0
    _rects_equal(rj, rt)
    _rects_equal(brj, brt)
    _rects_equal(dj, dt)
    assert np.array_equal(lj, lt) and np.array_equal(blj, blt)
    assert np.array_equal(fj, ft) and fj.dtype == ft.dtype
    assert len(pj) == len(pt)
    for a, b in zip(pj, pt):
        assert isinstance(b, t_bp.PairPlan)
        for f in ("bc", "bf", "src_sl", "dst_sl", "sub_f", "sub_c"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("h", "alive", "msh", "E"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for f in ("P", "S"):
            assert all(np.array_equal(x, y) for x, y in
                       zip(getattr(a, f), getattr(b, f))), f


def test_max_rectangles_equal():
    rng = np.random.default_rng(4)
    for shape in [(17,), (1,), (6, 9), (11, 4), (1, 7)]:
        for density in (0.3, 0.7, 1.0):
            cov = rng.random(shape) < density
            rj = j_bi._max_rectangles(cov)
            assert t_bi._max_rectangles(cov) == rj
            grid = np.zeros(shape, int)
            for r in rj:
                grid[tuple(slice(a, b) for a, b in r)] += 1
            assert np.array_equal(grid, cov.astype(int))


@pytest.mark.parametrize("kw", [{}, {"structured_interfaces": "rects"},
                                {"structured_interfaces": False}],
                         ids=["pairs", "rects", "fallback"])
def test_patch_roundtrip_and_owner_dot(kw):
    """test_boxes.py's round trip and owner-weighted dot, with w_owner,
    interior_mask, the owner map and to_patch bit-equal to tpufem's."""
    oj, ot, dofs, ac = pair(lambda M: adaptive(M, 2, 2, 2), 3, **kw)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(dofs.n_dofs)
    v = rng.standard_normal(dofs.n_dofs)
    up, vp = ot.to_patch(u), ot.to_patch(v)
    assert np.array_equal(ot.from_patch(up), u)
    assert np.isclose(float(ot.dot(up, vp)), float(u @ v), atol=1e-10)
    assert np.array_equal(up.numpy(), np.asarray(oj.to_patch(u)))
    assert ot.n_patch == oj.n_patch and ot.n_rect_rows == oj.n_rect_rows
    assert np.array_equal(ot._owner, oj._owner)
    for name in ("w_owner", "interior_mask"):
        assert np.array_equal(getattr(ot, name).numpy(),
                              np.asarray(getattr(oj, name))), name
    assert ot._single_compress == oj._single_compress
    assert ot._has_fallback == oj._has_fallback


# ---- the apply -----------------------------------------------------------

@pytest.mark.parametrize("dim,p", [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2)])
def test_box_vmult_raw_parity(dim, p):
    """Raw apply == tpufem's and the assembled K on conforming inputs."""
    oj, ot, dofs, ac = pair(
        lambda M: adaptive(M, dim, 2, 2 if dim == 2 else 1), p)
    x = np.random.default_rng(11).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x, ("vmult_raw",))
    y_o = np.asarray(assemble_laplace(dofs) @ x)
    assert rel(y, y_o) < 1e-12


@pytest.mark.parametrize("dim,p", [(2, 1), (2, 2), (2, 4), (3, 1), (3, 2)])
def test_box_constrained_vmult_parity(dim, p):
    oj, ot, dofs, ac = pair(
        lambda M: adaptive(M, dim, 2, 2 if dim == 2 else 1), p)
    assert len(ac.lines) > 0
    x = np.random.default_rng(12).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    assert rel(y, oracle_vmult(dofs, ac, x)) < 1e-12


@pytest.mark.parametrize("dim,p,kw", [
    (2, 2, {"cell_scheme": "dense"}),
    (3, 2, {"cell_scheme": "dense"}),
    (2, 3, {"cell_scheme": "structured", "coefficient": COEF}),
    (3, 2, {"cell_scheme": "structured", "coefficient": COEF}),
    (2, 2, {"cell_scheme": "dense", "coefficient": COEF}),
    (2, 3, {"structured_interfaces": "rects"}),
    (3, 2, {"structured_interfaces": "rects"}),
    (2, 2, {"structured_interfaces": False}),
    (3, 1, {"structured_interfaces": False}),
], ids=["dense-2d", "dense-3d", "structured-2d", "structured-3d",
        "dense-coef", "rects-2d", "rects-3d", "fallback-2d", "fallback-3d"])
def test_box_schemes_parity(dim, p, kw):
    """Every cell_scheme (dense with a coefficient takes structured, as in
    tpufem) and every C/C^T path (pairs, rects, the index fallback)."""
    oj, ot, dofs, ac = pair(
        lambda M: adaptive(M, dim, 2, 2 if dim == 2 else 1), p, **kw)
    assert ot._cell_scheme == oj._cell_scheme
    assert len(ot._pair_meta) == len(oj._pair_meta)
    assert len(ot._rect_groups) == len(oj._rect_groups)
    x = np.random.default_rng(13).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    assert rel(y, oracle_vmult(dofs, ac, x, kw.get("coefficient"))) < 1e-12


def test_structured_scheme_without_coefficient():
    """tpufem's structured box scheme multiplies by the coefficient block
    unconditionally and raises without a coefficient (ROADMAP.md queue 3,
    observations); the port reads none as 1 and equals the default
    scheme."""
    make = lambda M: adaptive(M, 2, 2, 2)
    with pytest.raises(TypeError):
        mj = make(JMesh)
        dj = JDoFHandler(mj, 2)
        j_boxes.BoxLaplaceOperator(mj, dj, constraints=j_mhnc(dj),
                                   dtype="float64", cell_scheme="structured")
    mt = make(Mesh)
    dofs = DoFHandler(mt, 2)
    ac = make_hanging_node_constraints(dofs)
    ops = [BoxLaplaceOperator(mt, dofs, constraints=ac, dtype="float64",
                              cell_scheme=s, device="cpu")
           for s in ("structured", "global")]
    x = ops[0].to_patch(np.random.default_rng(3).standard_normal(
        dofs.n_dofs))
    assert rel(ops[0].vmult(x), ops[1].vmult(x)) < 1e-12


def test_box_vmult_variable_coefficient():
    oj, ot, dofs, ac = pair(lambda M: adaptive(M, 2, 2, 2), 2,
                            coefficient=COEF)
    x = np.random.default_rng(14).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    assert rel(y, oracle_vmult(dofs, ac, x, COEF)) < 1e-12


@pytest.mark.parametrize("dim,p", [(2, 2), (3, 2)])
def test_box_bf16_tier_parity(dim, p):
    """bf16 patch storage stays in the bf16 class against the port's f64
    apply, and against tpufem's bf16 apply; the recast operator likewise,
    the f32 source untouched."""
    make = lambda M: adaptive(M, dim, 2, 2 if dim == 2 else 1)
    oj16, ot16, dofs, ac = pair(make, p, dtype="bfloat16")
    ot = BoxLaplaceOperator(make(Mesh), dofs, constraints=ac,
                            dtype="float64", device="cpu")
    x = np.random.default_rng(15).standard_normal(dofs.n_dofs)
    y_ref = ot.from_patch(ot.vmult(ot.to_patch(x)))
    y16 = ot16.from_patch(ot16.vmult(ot16.to_patch(x)))
    yj16 = oj16.from_patch(oj16.vmult(oj16.to_patch(x).astype(jnp.bfloat16)))
    assert ot16.vmult(ot16.to_patch(x)).dtype == torch.bfloat16
    for y in (y16, yj16):
        assert np.isfinite(rel(y, y_ref)) and rel(y, y_ref) < 5e-3
    assert rel(y16, yj16) < 5e-3
    op32 = BoxLaplaceOperator(make(Mesh), dofs, constraints=ac,
                              dtype="float32", device="cpu")
    op16r = op32.recast("bfloat16")
    assert op16r.dt == torch.bfloat16 and op32.dt == torch.float32
    assert op32.w_owner.dtype == torch.float32
    yr = op16r.from_patch(op16r.vmult(op16r.to_patch(x)))
    assert rel(yr, y_ref) < 5e-3


def test_box_uniform_mesh_degenerates_to_structured():
    """On a uniform mesh the tier is one full box — parity still holds."""
    oj, ot, dofs, ac = pair(lambda M: M.hyper_cube(2, 3), 2)
    assert len(ot.boxes) == 1 and not ot.has_hanging
    x = np.random.default_rng(16).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    assert rel(ot.from_patch(ot.vmult_raw(ot.to_patch(x))),
               np.asarray(assemble_laplace(dofs) @ x)) < 1e-12
    assert np.array_equal(ot.diagonal().numpy(), np.asarray(oj.diagonal()))
    del y


@pytest.mark.parametrize("dim,p,r", [(2, 1, 3), (2, 3, 3), (3, 2, 2)])
def test_box_curved_adaptive_vmult_parity(dim, p, r):
    """Curved adaptive meshes take the global-general cell loop."""
    oj, ot, dofs, ac = pair(lambda M: curved_adaptive(M, dim, r), p)
    assert ot._cell_scheme == oj._cell_scheme == "global-general"
    x = np.random.default_rng(17).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    ref = np.asarray(assemble_laplace(dofs) @ x)
    assert rel(ot.from_patch(ot.vmult_raw(ot.to_patch(x))), ref) < 1e-10
    assert rel(y, oracle_vmult(dofs, ac, x)) < 1e-10


@pytest.mark.parametrize("dim,p,steps,base", [(2, 2, 3, 3), (3, 1, 2, 2)])
def test_box_deep_level_chain_parity(dim, p, steps, base):
    """3-4 size groups: the sweep-compress chain spans >= 2 pairs."""
    oj, ot, dofs, ac = pair(lambda M: adaptive(M, dim, base, steps), p)
    assert len(ot._pair_meta) >= 2
    x = np.random.default_rng(18).standard_normal(dofs.n_dofs)
    y = applies_agree(oj, ot, x)
    assert rel(y, oracle_vmult(dofs, ac, x)) < 1e-12


def test_applies_leave_their_input_and_repeat_bitwise():
    """Every apply leaves the caller's tensor as it was and gives the same
    bits twice; distribute / distribute_transpose / compress as well."""
    for kw in ({}, {"structured_interfaces": "rects"},
               {"structured_interfaces": False}):
        _, ot, dofs, _ = pair(lambda M: adaptive(M, 3, 2, 1), 2, **kw)
        x = ot.to_patch(np.random.default_rng(19).standard_normal(
            dofs.n_dofs))
        keep = x.clone()
        for fn in (ot.vmult, ot.vmult_raw, ot.compress, ot.distribute,
                   ot.distribute_transpose):
            y = fn(x)
            assert torch.equal(x, keep)
            assert torch.equal(y, fn(x))


def test_diagonal_matches_tpufem():
    oj, ot, dofs, ac = pair(lambda M: adaptive(M, 3, 2, 1), 2,
                            coefficient=COEF)
    dj, dt = np.asarray(oj.diagonal()), ot.diagonal().numpy()
    assert np.abs(dt - dj).max() <= 1e-12 * np.abs(dj).max()


# ---- box CG ---------------------------------------------------------------

def test_box_cg_solve_matches_incidence_path():
    """The patch-space Jacobi-CG of a Poisson RHS takes the incidence
    solve's iterations; Jacobi and Chebyshev box CG equal tpufem's
    (iterations, x to 1e-10) with tpufem's power-iteration start."""
    from tpufem.apps.poisson import default_solution
    from tpufem_torch.apps.poisson import dirichlet_setup

    oj, ot, dofs, ac = pair(lambda M: adaptive(M, 2, 2, 2), 2)
    mf = MatrixFree.build(dofs.mesh, dofs, FemConfig(2, 2), "cpu",
                          constraints=ac)
    iop = LaplaceOperator(mf)
    b = assemble_rhs(dofs, default_solution(2)[1])
    b_con, x0 = dirichlet_setup(iop, b, np.zeros(dofs.n_dofs))
    res_i = cg_solve(iop.vmult, b_con, M_inv=lambda r: r / iop.diagonal(),
                     x0=x0, rtol=1e-12)
    x_i = mf.distribute(res_i.x).numpy()
    bp = ot.to_patch(b_con.numpy())
    diag = ot.diagonal()
    res_b = ot.cg_solve(bp, diag, x0=ot.to_patch(x0.numpy()), rtol=1e-12)
    assert res_b.converged and res_b.iterations == res_i.iterations
    assert rel(ot.from_patch(ot.distribute(res_b.x)), x_i) < 1e-9


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev"])
def test_box_cg_matches_tpufem(precond, same_start):
    oj, ot, dofs, ac = pair(lambda M: adaptive(M, 2, 2, 2), 3)
    rng = np.random.default_rng(20)
    m = ot.interior_mask.numpy()
    b = m * ot.to_patch(rng.standard_normal(dofs.n_dofs)).numpy()
    rj = oj.cg_solve(jnp.asarray(b), oj.diagonal(), rtol=1e-10,
                     precond=precond)
    rt = ot.cg_solve(torch.tensor(b), ot.diagonal(), rtol=1e-10,
                     precond=precond)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert rel(rt.x, rj.x) <= 1e-10
    if precond == "chebyshev":
        assert rt.iterations < 60


def test_box_curved_adaptive_solve_converges():
    """u = x^2 - y^2 on adaptively refined shell wedges: the L2 error of
    the box-tier solve decays under refinement (rate > 1.8)."""
    from tpufem_torch.apps.poisson import dirichlet_setup
    from tpufem_torch.fem.assemble import integrate_difference

    exact = lambda x: x[:, 0] ** 2 - x[:, 1] ** 2
    errs = []
    for r in (2, 3, 4):
        mesh = curved_adaptive(Mesh, 2, r)
        dofs = DoFHandler(mesh, 2)
        ac = make_hanging_node_constraints(dofs)
        op = BoxLaplaceOperator(mesh, dofs, constraints=ac, dtype="float64",
                                device="cpu")
        iop = LaplaceOperator(MatrixFree.build(mesh, dofs, FemConfig(2, 2),
                                               "cpu", constraints=ac))
        b = assemble_rhs(dofs, lambda x: np.zeros(len(x)))
        g = np.zeros(dofs.n_dofs)
        bm = dofs.boundary_mask
        g[bm] = exact(dofs.dof_coords[bm])
        b_con, x0 = dirichlet_setup(iop, b, g)
        res = op.cg_solve(op.to_patch(b_con.numpy()), op.diagonal(),
                          x0=op.to_patch(x0.numpy()), rtol=1e-12)
        x = op.from_patch(op.distribute(res.x))
        errs.append(integrate_difference(dofs, x, exact))
    rate = np.log2(errs[-2] / errs[-1])
    assert rate > 1.8, (errs, rate)


# ---- MatrixFree.build(scatter="boxes") ------------------------------------

def test_matrix_free_boxes_scheme_as_tpufem():
    """Both packages build a MatrixFree with scheme 'boxes'; neither's
    LaplaceOperator applies it (TypeError); its diagonal and its
    gather/scatter are the incidence tier's."""
    mj, mt = adaptive(JMesh, 2, 2, 2), adaptive(Mesh, 2, 2, 2)
    dj, dt = JDoFHandler(mj, 2), DoFHandler(mt, 2)
    mfj = JMatrixFree.build(mj, dj, JFemConfig(dim=2, degree=2,
                                               scatter="boxes"),
                            constraints=j_mhnc(dj))
    ac = make_hanging_node_constraints(dt)
    mft = MatrixFree.build(mt, dt, FemConfig(dim=2, degree=2,
                                             scatter="boxes"), "cpu",
                           constraints=ac)
    inc = MatrixFree.build(mt, dt, FemConfig(dim=2, degree=2,
                                             scatter="incidence"), "cpu",
                           constraints=ac)
    assert mfj.scheme == mft.scheme == "boxes"
    x = np.random.default_rng(21).standard_normal(dt.n_dofs)
    opj, opt = JLaplace(mfj), LaplaceOperator(mft)
    for f in (opj.vmult, opj.vmult_raw):
        with pytest.raises(TypeError):
            f(jnp.asarray(x))
    for f in (opt.vmult, opt.vmult_raw):
        with pytest.raises(TypeError, match="BoxLaplaceOperator"):
            f(torch.tensor(x))
    dgj, dgt = np.asarray(opj.diagonal()), opt.diagonal().numpy()
    assert np.abs(dgt - dgj).max() <= 1e-12 * np.abs(dgj).max()
    assert np.array_equal(dgt, LaplaceOperator(inc).diagonal().numpy())
    xt = torch.tensor(x)
    loc = mft.gather(xt)
    assert np.array_equal(loc.numpy(), np.asarray(mfj.gather(jnp.asarray(x))))
    assert torch.equal(mft.scatter(loc), inc.scatter(inc.gather(xt)))
    assert rel(mft.scatter(loc), mfj.scatter(jnp.asarray(loc.numpy()))) \
        <= 1e-15


@pytest.fixture
def same_start(monkeypatch):
    """The port's Chebyshev power iteration starts from tpufem's draw."""
    import jax

    from tpufem_torch.solvers import chebyshev

    def draw(n, seed, dtype, device):
        v = jax.random.normal(jax.random.PRNGKey(seed), (n,),
                              dtype=jnp.float64)
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    monkeypatch.setattr(chebyshev, "power_start", draw)


def test_oracle_uses_the_reference_assembly():
    """The oracle of these tests (the port's assemble_laplace) is tpufem's
    matrix on the same mesh."""
    mj, mt = adaptive(JMesh, 2, 2, 2), adaptive(Mesh, 2, 2, 2)
    Kj = j_assemble_laplace(JDoFHandler(mj, 2)).toarray()
    Kt = assemble_laplace(DoFHandler(mt, 2)).toarray()
    assert np.array_equal(Kj, Kt)

"""Port parity for the adaptive box-tier multigrid
(``tpufem_torch.solvers.box_multigrid``) and ``solve_poisson(scatter=
"boxes")`` against tpufem in f64 on the CPU.

Mirrors tests/test_box_multigrid.py.  The host pieces (``coarsen_floor``,
``embed_1d``, ``_build_rules``) are bit-equal; the GMG-CG and the app's
box solves take tpufem's iteration counts with tpufem's power-iteration
start in the port's seam (``chebyshev.power_start``).  The reference's
JIT compiles dominate the time here, so the cross-package solves run at
its smallest parametrisations and the property checks (nested
prolongation, the adjoint, mesh independence, the bf16 cycle's bounds) on
the port alone, with the reference's own bounds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem.fem.constraints import make_hanging_node_constraints as j_mhnc
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops import boxes as j_boxes
from tpufem.solvers import box_multigrid as j_bmg
from tpufem_torch.apps import poisson as tpoisson
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops import boxes as t_boxes
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.solvers import box_multigrid as t_bmg
from tpufem_torch.solvers import chebyshev as t_cheb
from tpufem_torch.solvers.box_multigrid import BoxMultigrid

_JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32,
        torch.bfloat16: jnp.bfloat16}


def tpufem_start(n, seed, dtype, device):
    """tpufem's power-iteration start (``jax.random.normal`` in the
    operator's dtype)."""
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=_JNP[dtype])
    return torch.tensor(np.asarray(v.astype(jnp.float64)), dtype=dtype,
                        device=device)


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(t_cheb, "power_start", tpufem_start)


def adaptive(M, dim, base, steps, center=0.31):
    """test_box_multigrid.py's adaptive mesh, in package M."""
    mesh = M.hyper_cube(dim, base)
    for _ in range(steps):
        c = mesh.cell_vertices().mean(axis=1)
        mesh = mesh.refine(np.linalg.norm(c - center, axis=1) < 0.35)
    return mesh


def shell_adaptive(M):
    mesh = M.hyper_shell_2d(3)
    flags = np.zeros(mesh.n_cells, bool)
    flags[: mesh.n_cells // 3] = True
    return mesh.refine(flags)


def setup(mesh, p, coefficient=None):
    dofs = DoFHandler(mesh, p)
    ac = make_hanging_node_constraints(dofs)
    gop = BoxLaplaceOperator(mesh, dofs, constraints=ac,
                             coefficient=coefficient, dtype="float64",
                             device="cpu")
    mg = BoxMultigrid(mesh, dofs, constraints=ac, coefficient=coefficient,
                      dtype="float64", fine_op=gop, device="cpu")
    return dofs, gop, mg


def canonical_rhs(gop, mg, seed=0):
    """Interior, non-hanging, copy-consistent random patch RHS."""
    rng = np.random.default_rng(seed)
    mask = gop.interior_mask.numpy() * mg.fine.nh_mask
    return torch.tensor(mask * gop.to_patch(
        rng.standard_normal(gop.n_dofs)).numpy())


def rel_owned(gop, a, b):
    own = gop.w_owner.numpy() > 0
    a, b = np.asarray(a, np.float64)[own], np.asarray(b, np.float64)[own]
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def compare(gop, jac, res, iter_bound):
    assert res.converged
    assert res.iterations <= iter_bound
    assert rel_owned(gop, res.x, jac.x) < 1e-8


# ---- host pieces, bit-equal ------------------------------------------------

@pytest.mark.parametrize("dim,base,steps", [(2, 2, 2), (3, 1, 2), (2, 3, 3)])
def test_hierarchy_host_pieces_equal(dim, base, steps):
    """coarsen_floor at every floor, the levels' boxes, embed_1d and the
    transfer rules of each adjacent pair: bit-equal to tpufem's."""
    p = 2
    mj, mt = adaptive(JMesh, dim, base, steps), adaptive(Mesh, dim, base,
                                                         steps)
    smin, smax = int(mt.sizes.min()), int(mt.sizes.max())
    floors = []
    f = smax * 2
    while f >= smin:
        floors.append(f)
        f //= 2
    levels = []
    for fl in floors:
        cj, ct = j_bmg.coarsen_floor(mj, fl), t_bmg.coarsen_floor(mt, fl)
        assert np.array_equal(cj.origins, ct.origins)
        assert np.array_equal(cj.sizes, ct.sizes)
        bj = j_boxes.build_boxes(cj, JDoFHandler(cj, p))
        bt = t_boxes.build_boxes(ct, DoFHandler(ct, p))
        assert [b.offset for b in bj] == [b.offset for b in bt]
        levels.append((bj, bt))
    for l in range(1, len(levels)):
        rj = j_bmg._build_rules(levels[l - 1][0], levels[l][0],
                                floors[l - 1], p, dim)
        rt = t_bmg._build_rules(levels[l - 1][1], levels[l][1],
                                floors[l - 1], p, dim)
        assert len(rj) == len(rt) > 0
        for a, b in zip(rj, rt):
            assert {k: a[k] for k in ("kind", "bf", "bc", "sl")} == \
                {k: b[k] for k in ("kind", "bf", "bc", "sl")}
            assert (a["P"] is None) == (b["P"] is None)
            if a["P"] is not None:
                assert all(np.array_equal(x, y)
                           for x, y in zip(a["P"], b["P"]))
    for args in [(2, 0, 4, 0, 2), (3, 3, 5, 1, 3), (4, 6, 1, 3, 1)]:
        assert np.array_equal(j_bmg.embed_1d(*args), t_bmg.embed_1d(*args))


# ---- GMG-CG ----------------------------------------------------------------

@pytest.mark.parametrize("dim,p,base,steps", [
    (2, 2, 2, 2), (3, 2, 1, 2), (2, 4, 2, 1),
])
def test_box_gmg_cg_matches_jacobi(dim, p, base, steps, same_start):
    """test_box_multigrid.py's check on the port: fewer iterations than
    the box Jacobi-CG, at most 12, x within 1e-8 of Jacobi's.  At the
    reference's smallest case (2D Q4) also against tpufem's GMG-CG and
    Jacobi-CG: equal iterations, x to 1e-10."""
    mesh = adaptive(Mesh, dim, base, steps)
    dofs, gop, mg = setup(mesh, p)
    b = canonical_rhs(gop, mg)
    jac = gop.cg_solve(b, gop.diagonal(), rtol=1e-10)
    res = mg.cg_solve(b, rtol=1e-10)
    assert res.iterations < jac.iterations
    compare(gop, jac, res, iter_bound=12)
    if (dim, p) != (2, 4):
        return
    mj = adaptive(JMesh, dim, base, steps)
    dj = JDoFHandler(mj, p)
    acj = j_mhnc(dj)
    opj = j_boxes.BoxLaplaceOperator(mj, dj, constraints=acj,
                                     dtype="float64")
    mgj = j_bmg.BoxMultigrid(mj, dj, constraints=acj, dtype="float64",
                             fine_op=opj)
    assert len(mgj.levels) == len(mg.levels)
    assert np.array_equal(mgj.fine.nh_mask, mg.fine.nh_mask)
    bj = jnp.asarray(b.numpy())
    resj = mgj.cg_solve(bj, rtol=1e-10)
    jacj = opj.cg_solve(bj, opj.diagonal(), rtol=1e-10)
    assert res.iterations == int(resj.iterations)
    assert jac.iterations == int(jacj.iterations)
    assert rel_owned(gop, res.x, resj.x) <= 1e-10
    for lt, lj in zip(mg.levels, mgj.levels):
        for a, b_ in ((lt.cheb.theta, lj.cheb.theta),
                      (lt.cheb.delta, lj.cheb.delta)):
            assert abs(a - float(b_)) <= 1e-12 * abs(float(b_))


def test_box_gmg_mixed_precision_bf16_cycle():
    """f32 outer CG + bf16 V-cycle hierarchy (``solve_op=``), with the
    reference's own bounds: converged, at most 3 iterations above the f32
    cycle, x within 1e-4 of it, true f32 residual below 1e-5; the recast
    hierarchy within 2 iterations of the native bf16 build, the originals
    untouched."""
    mesh = adaptive(Mesh, 3, 2, 1)
    dofs = DoFHandler(mesh, 2)
    ac = make_hanging_node_constraints(dofs)
    op = BoxLaplaceOperator(mesh, dofs, constraints=ac, dtype="float32",
                            device="cpu")
    mg = BoxMultigrid(mesh, dofs, constraints=ac, dtype="float32",
                      fine_op=op, fine_diag=op.diagonal(), device="cpu")
    mg16 = BoxMultigrid(mesh, dofs, constraints=ac, dtype="bfloat16",
                        solve_op=op, device="cpu")
    b = canonical_rhs(op, mg).to(torch.float32)
    r32 = mg.cg_solve(b, rtol=1e-6)
    r16 = mg16.cg_solve(b, rtol=1e-6)
    assert r16.converged and r16.x.dtype == torch.float32
    assert r16.iterations <= r32.iterations + 3
    x32, x16 = r32.x.double(), r16.x.double()
    assert float((x16 - x32).norm() / x32.norm()) < 1e-4
    rr = b - op.vmult(r16.x)
    assert float(rr.norm()) / float(b.norm()) < 1e-5

    mgr = mg.recast("bfloat16")
    assert mgr.solve_op is op  # defaults to the f32 fine operator
    for lvl in mgr.levels:
        assert lvl.op.dt == torch.bfloat16
        assert lvl.inv_diag.dtype == torch.bfloat16
        assert lvl.cheb.theta == float(torch.tensor(lvl.cheb.theta).to(
            torch.bfloat16))
    rc = mgr.cg_solve(b, rtol=1e-6)
    assert rc.converged
    assert abs(rc.iterations - r16.iterations) <= 2
    assert float((rc.x.double() - x32).norm() / x32.norm()) < 1e-4
    assert mg.levels[-1].op.dt == torch.float32
    assert mg.levels[-1].op.S.dtype == torch.float32


def test_box_operator_recast_parity():
    """recast(bf16) equals a native bf16 build to bf16 resolution; the f32
    source stays f32."""
    mesh = adaptive(Mesh, 2, 2, 2)
    dofs = DoFHandler(mesh, 3)
    ac = make_hanging_node_constraints(dofs)
    op32 = BoxLaplaceOperator(mesh, dofs, constraints=ac, dtype="float32",
                              device="cpu")
    op16n = BoxLaplaceOperator(mesh, dofs, constraints=ac,
                               dtype="bfloat16", device="cpu")
    op16r = op32.recast("bfloat16")
    assert op16r.dt == torch.bfloat16 and op16r.n_patch == op32.n_patch
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(op32.n_patch)).to(torch.bfloat16)
    yn, yr = op16n.vmult(x).double(), op16r.vmult(x).double()
    assert float((yr - yn).abs().max()) < 2e-2 * float(yn.abs().max())
    y32 = op32.vmult(torch.tensor(rng.standard_normal(op32.n_patch),
                                  dtype=torch.float32))
    assert y32.dtype == torch.float32


def test_box_gmg_variable_coefficient():
    coef = lambda x: 1.0 + 10.0 * np.exp(
        -np.sum((x - 0.4) ** 2, axis=1) * 8)
    dofs, gop, mg = setup(adaptive(Mesh, 3, 1, 2), 3, coefficient=coef)
    b = canonical_rhs(gop, mg, seed=1)
    compare(gop, gop.cg_solve(b, gop.diagonal(), rtol=1e-10),
            mg.cg_solve(b, rtol=1e-10), iter_bound=12)


def test_box_gmg_curved_adaptive():
    """Curved x adaptive: shell wedge with hanging nodes, per-level
    general metric."""
    dofs, gop, mg = setup(shell_adaptive(Mesh), 2)
    assert gop._cell_scheme == "global-general"
    b = canonical_rhs(gop, mg, seed=2)
    compare(gop, gop.cg_solve(b, gop.diagonal(), rtol=1e-10),
            mg.cg_solve(b, rtol=1e-10), iter_bound=12)


def test_box_gmg_iteration_mesh_independence():
    """Iteration counts stay O(1) as the mesh deepens."""
    iters = []
    for base in (2, 3, 4):
        dofs, gop, mg = setup(adaptive(Mesh, 2, base, 2), 2)
        res = mg.cg_solve(canonical_rhs(gop, mg, seed=3), rtol=1e-10)
        assert res.converged
        iters.append(res.iterations)
    assert max(iters) <= 12
    assert max(iters) - min(iters) <= 3


def test_box_gmg_prolongation_nested_exact():
    """Prolongation reproduces coarse FE-space fields exactly at live fine
    nodes (a degree-p polynomial at each level's DoF coordinates)."""
    p = 3
    dofs, gop, mg = setup(adaptive(Mesh, 2, 2, 2), p)
    assert len(mg.levels) >= 3
    f = lambda x: (1.0 + x[:, 0]) ** p + 2.0 * x[:, 1] ** p - x[:, 0]
    for l in range(1, len(mg.levels)):
        lc, lf = mg.levels[l - 1], mg.levels[l]
        uc = lc.op.distribute(lc.op.to_patch(f(lc.dofs.dof_coords)))
        uf = mg.prolongate(l, uc).numpy()
        uf_ref = lf.op.to_patch(f(lf.dofs.dof_coords)).numpy()
        assert rel_owned(lf.op, uf, uf_ref) < 1e-12, f"level {l}"


def test_box_gmg_restriction_is_adjoint():
    """<P c, f>_fine == <c, R f>_coarse with owner-weighted dots."""
    dofs, gop, mg = setup(adaptive(Mesh, 2, 2, 2), 2)
    l = len(mg.levels) - 1
    lc, lf = mg.levels[l - 1], mg.levels[l]
    rng = np.random.default_rng(5)
    c = lc.op.to_patch(rng.standard_normal(lc.dofs.n_dofs)) * torch.tensor(
        lc.nh_mask) * lc.op.interior_mask
    fv = lf.op.to_patch(rng.standard_normal(lf.dofs.n_dofs)) * torch.tensor(
        lf.nh_mask) * lf.op.interior_mask
    keep = fv.clone()
    Pc = mg.prolongate(l, lc.op.distribute(c))
    Rf = mg.restrict(l, fv)
    assert torch.equal(fv, keep)
    lhs = float(lf.op.dot(Pc, fv))
    rhs = float(lc.op.dot(c, Rf))
    assert abs(lhs - rhs) / max(abs(lhs), 1e-30) < 1e-12


def test_vcycle_repeats_bitwise():
    dofs, gop, mg = setup(adaptive(Mesh, 3, 1, 2), 2)
    b = canonical_rhs(gop, mg)
    keep = b.clone()
    z = mg.vcycle(b)
    assert torch.equal(b, keep) and torch.equal(z, mg.preconditioner(b))


# ---- solve_poisson(scatter="boxes") and the CLI -----------------------------

_J_RESULTS: dict = {}


def j_result(**kw):
    """tpufem's solve_poisson, once per argument set."""
    key = json.dumps(kw, sort_keys=True)
    if key not in _J_RESULTS:
        _J_RESULTS[key] = j_solve_poisson(**kw)
    return _J_RESULTS[key]


@pytest.mark.parametrize("kw", [
    dict(dim=3, degree=2, refine=1, adaptive_steps=1, precond="jacobi"),
    dict(dim=3, degree=2, refine=1, adaptive_steps=1, precond="chebyshev"),
    dict(dim=3, degree=2, refine=1, adaptive_steps=1, precond="gmg"),
    dict(dim=3, degree=2, refine=1, adaptive_steps=1, precond="gmg-bf16",
         dtype="float32"),
    dict(dim=2, degree=2, refine=2, adaptive_steps=2, precond="gmg"),
], ids=["3d-jacobi", "3d-chebyshev", "3d-gmg", "3d-gmg-bf16-f32", "2d-gmg"])
def test_box_poisson_app_matches_tpufem(kw, same_start):
    """The box tier through solve_poisson: tpufem's iterations, L2 to
    1e-10 (f32 with the bf16 cycle: 1e-5, its solve's class)."""
    kw = dict(dict(dtype="float64"), **kw)
    rt = tpoisson.solve_poisson(**kw, scatter="boxes", device="cpu")
    rj = j_result(**kw, scatter="boxes")
    assert rt.converged and rt.n_dofs == rj.n_dofs
    assert rt.iterations == rj.iterations
    tol = 1e-10 if kw["dtype"] == "float64" else 1e-5
    assert abs(rt.l2_error - rj.l2_error) <= tol * rj.l2_error


def test_box_gmg_poisson_app():
    """test_box_multigrid.py's app check on the port: the same L2 as the
    Jacobi solve, far fewer iterations."""
    kw = dict(dim=2, degree=3, refine=3, scatter="boxes", adaptive_steps=2,
              dtype="float64", device="cpu")
    rj = tpoisson.solve_poisson(**kw)
    rg = tpoisson.solve_poisson(**kw, precond="gmg")
    assert rg.iterations <= 12 and rg.iterations < rj.iterations
    assert abs(rg.l2_error - rj.l2_error) / rj.l2_error < 1e-6


def test_box_cli_matches_tpufem(capsys, same_start):
    tpoisson.main(["--dim", "2", "--degree", "2", "--refine", "2",
                   "--adaptive-steps", "2", "--scatter", "boxes",
                   "--precond", "gmg", "--device", "cpu", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = j_result(dim=2, degree=2, refine=2, adaptive_steps=2,
                  precond="gmg", dtype="float64", scatter="boxes")
    assert line["n_dofs"] == rj.n_dofs and line["iterations"] == rj.iterations
    assert abs(line["l2_error"] - rj.l2_error) <= 1e-10 * rj.l2_error


def test_box_app_refusals():
    """shards still raises NotImplementedError naming its item, after the
    reference's scatter check; use_pallas refuses the box tier as it
    refuses every cell-loop tier."""
    with pytest.raises(ValueError, match="scatter auto/boxes"):
        tpoisson.solve_poisson(shards=2, scatter="incidence", device="cpu")
    with pytest.raises(NotImplementedError, match="distributed"):
        tpoisson.solve_poisson(shards=2, scatter="boxes", device="cpu")
    with pytest.raises(ValueError, match="separable"):
        tpoisson.solve_poisson(dim=2, degree=1, refine=2, scatter="boxes",
                               use_pallas=True, device="cpu")


def test_box_amr_passes_scatter_through():
    rs = tpoisson.solve_poisson_amr(dim=2, degree=2, refine=2, cycles=2,
                                    scatter="boxes", precond="gmg",
                                    device="cpu")
    assert rs[-1].n_cells > rs[0].n_cells
    assert all(r.converged and r.iterations <= 12 for r in rs)

"""Port parity for the distributed box tier
(``tpufem_torch.parallel.boxes``) against tpufem's under ``shard_map`` on
the 8 virtual CPU devices of tests/conftest.py, in f64.  Mirrors
tests/test_distributed_boxes.py: the host plan equal element by element
(cuts, slabs, on-cut flags, local sizes, owner weights, interior masks,
the cut-plane groups and weights, plane tops, the cell-loop operands and
the localized pair transfers), the roundtrip and the owner weights,
1-axis and 2-axis vmults (constant and variable coefficient, curved
adaptive) against tpufem's distributed and the port's single-device
apply, empty slabs, the cut refusal, and the Jacobi- and Chebyshev-CG
with tpufem's counts (Chebyshev through the ``power_start`` seam, so
both packages estimate the same lambda_max).  Every apply is bitwise
equal across two calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.constraints import make_hanging_node_constraints as j_mhnc
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops.boxes import BoxLaplaceOperator as JBox
from tpufem.parallel.boxes import DistributedBoxLaplace as JDist
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.parallel.boxes import DistributedBoxLaplace
from tpufem_torch.solvers import chebyshev as t_cheb


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAM_KEYS = ("w_owner", "interior_mask", "plane_top", "cut_seg", "cut_wm",
              "cut_wr", "cut_ws", "cut_idx")


def tpufem_start(n, seed, dtype, device):
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float64)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(t_cheb, "power_start", tpufem_start)


def adaptive(M, dim, base, steps, center=0.31):
    mesh = M.hyper_cube(dim, base)
    for _ in range(steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - center, axis=1) < 0.35)
    return mesh


def curve(mesh):
    d = mesh.dim
    perm = [1, 0] if d == 2 else [1, 2, 0]
    amp = 0.06 if d == 2 else 0.05
    mesh.transform = lambda x: x + amp * np.sin(np.pi * x[:, perm])
    return mesh


def ops(dim, p, steps=2, base=2, coefficient=None, curved=False):
    """(port operator, tpufem operator, port DoFHandler) on one mesh."""
    out = []
    for M, D, C, B, kw in (
            (Mesh, DoFHandler, make_hanging_node_constraints,
             BoxLaplaceOperator, dict(device="cpu")),
            (JMesh, JDoFHandler, j_mhnc, JBox, {})):
        mesh = adaptive(M, dim, base, steps)
        if curved:
            curve(mesh)
        dofs = D(mesh, p)
        out.append(B(mesh, dofs, constraints=C(dofs),
                     coefficient=coefficient, dtype="float64", **kw))
        out.append(dofs)
    gop, dofs, jgop, _ = out
    return gop, jgop, dofs


def host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def vmult_pair(gop, jgop, dofs, shards, seed=5):
    """(port distributed, tpufem distributed, port single-device) vmult of
    one random patch vector, as global patch vectors; the port's
    distributed apply twice, bitwise."""
    dop = DistributedBoxLaplace(gop, shards=shards)
    jdop = JDist(jgop, shards=shards)
    x = gop.to_patch(np.random.default_rng(seed).standard_normal(
        dofs.n_dofs))
    xl = dop.put_vector(x)
    y1, y2 = dop.vmult(xl), dop.vmult(xl)
    assert all(torch.equal(a, b) for a, b in zip(y1.parts, y2.parts))
    yj = jdop.from_local(np.asarray(jdop.vmult(jdop.put_vector(host(x)))))
    return dop, dop.from_local(y1), yj, host(gop.vmult(x))


def assert_plans_equal(dop, jdop):
    assert np.array_equal(dop.cuts_units, jdop.cuts_units)
    if dop.sy > 1:
        assert np.array_equal(dop.cuts_y, jdop.cuts_y)
    for a, b in zip(dop._slab + dop._slab_y, jdop._slab + jdop._slab_y):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    for name in ("_bot_cut", "_top_cut", "_bot_cut_y", "_top_cut_y"):
        assert np.array_equal(getattr(dop, name), getattr(jdop, name)), name
    assert dop.NL == jdop.NL
    assert [b.lattice_shape for b in dop.lboxes] == [
        b.lattice_shape for b in jdop.lboxes]
    keys = PARAM_KEYS + (("plane_top_y",) + tuple(k + "_y" for k in
                                                  PARAM_KEYS[3:])
                         if dop.sy > 1 else ())
    for k in keys:
        a, b = np.asarray(dop.params[k]), np.asarray(jdop.params[k])
        assert a.shape == b.shape and np.array_equal(a, b), k
    # the cell-loop operands and the localized pair transfers
    flat = lambda t: jax.tree.leaves(jax.tree.map(np.asarray, t))
    for key in ("box_EG", "pair_P", "pair_S", "pair_h", "pair_E",
                "pair_alive", "pair_msh"):
        if key not in jdop.params:
            assert key not in dop.params
            continue
        la, lb = flat(dop.params[key]), flat(jdop.params[key])
        assert len(la) == len(lb), key
        for a, b in zip(la, lb):
            assert np.allclose(a, np.asarray(b), rtol=1e-15, atol=0), key
    if dop.gop._cell_scheme == "global":
        for (sa, wa), (sb, wb) in zip(dop.params["box_args"],
                                      jdop.params["box_args"]):
            assert np.array_equal(sa, np.asarray(sb))
            assert np.array_equal(wa, np.asarray(wb))
    else:  # the port keeps the packed metric component-major
        for (ga, _), (gb, _) in zip(dop.params["box_args"],
                                    jdop.params["box_args"]):
            assert np.array_equal(np.moveaxis(ga, 1, -1), np.asarray(gb))


@pytest.mark.parametrize("dim,p,shards", [
    (2, 3, (4, 1)), (2, 2, (8, 1)), (3, 1, (4, 1)), (3, 2, (2, 4))])
def test_plans_and_vmult_match_tpufem(dim, p, shards):
    gop, jgop, dofs = ops(dim, p)
    dop, y, yj, y1 = vmult_pair(gop, jgop, dofs, shards)
    assert_plans_equal(dop, JDist(jgop, shards=shards))
    assert rel(y, yj) < 1e-12 and rel(y, y1) < 1e-12


@pytest.mark.parametrize("dim,shards", [(2, (4, 1)), (3, (2, 2))])
def test_variable_coefficient_vmult(dim, shards):
    coef = lambda x: 1.0 + 0.5 * np.cos(x[:, 0]) * np.sin(
        x[:, 1] + (x[:, 2] if x.shape[1] > 2 else 0.0))
    gop, jgop, dofs = ops(dim, 2, coefficient=coef)
    dop, y, yj, y1 = vmult_pair(gop, jgop, dofs, shards)
    assert_plans_equal(dop, JDist(jgop, shards=shards))
    assert rel(y, yj) < 1e-12 and rel(y, y1) < 1e-12


@pytest.mark.parametrize("dim,shards", [(2, (4, 1)), (3, (2, 2))])
def test_curved_adaptive_vmult(dim, shards):
    """transform x refinement: the global-general cell scheme, its packed
    metric sliced along the sharded axes."""
    gop, jgop, dofs = ops(dim, 2, steps=1, curved=True)
    assert gop._cell_scheme == "global-general"
    dop, y, yj, y1 = vmult_pair(gop, jgop, dofs, shards)
    assert_plans_equal(dop, JDist(jgop, shards=shards))
    assert rel(y, yj) < 1e-12 and rel(y, y1) < 1e-12


def test_roundtrip_and_owner_weights():
    for dim, shards in ((2, (4, 1)), (3, (2, 2))):
        gop, jgop, dofs = ops(dim, 2)
        dop = DistributedBoxLaplace(gop, shards=shards)
        u = host(gop.to_patch(np.random.default_rng(1).standard_normal(
            dofs.n_dofs)))
        loc = dop.to_local(u)
        assert np.array_equal(loc, JDist(jgop, shards=shards).to_local(u))
        assert np.array_equal(dop.from_local(loc), u)
        assert np.array_equal(dop.from_local(dop.put_vector(u)), u)
        ones = dop.to_local(host(gop.to_patch(np.ones(dofs.n_dofs))))
        w = dop.params["w_owner"]
        assert int(round(float((w * ones).sum()))) == dofs.n_dofs


def test_empty_slabs_are_harmless():
    """More shards than coarse z-slots: some shards get no cells."""
    gop, jgop, dofs = ops(2, 1, steps=1)
    dop, y, yj, y1 = vmult_pair(gop, jgop, dofs, (8, 1))
    assert all((r == 0).any() for _, r, _ in dop._slab)
    assert rel(y, yj) < 1e-12 and rel(y, y1) < 1e-12


def test_refusals(monkeypatch):
    """The cut refusal (every interior plane strands a 2:1 fill), the
    2-axis grid in 2D and the non-global cell schemes, as tpufem."""
    gop, _, _ = ops(3, 2, steps=1, base=2)
    monkeypatch.setattr(DistributedBoxLaplace, "_cut_ok",
                        lambda self, ax, c: False)
    with pytest.raises(NotImplementedError, match="cut plane"):
        DistributedBoxLaplace(gop, shards=(2, 1))
    monkeypatch.undo()
    g2, _, _ = ops(2, 1, steps=1)
    with pytest.raises(NotImplementedError, match="dim=3"):
        DistributedBoxLaplace(g2, shards=(2, 2))
    mesh = adaptive(Mesh, 2, 2, 1)
    dofs = DoFHandler(mesh, 1)
    dense = BoxLaplaceOperator(mesh, dofs,
                               constraints=make_hanging_node_constraints(
                                   dofs), dtype="float64",
                               cell_scheme="dense", device="cpu")
    with pytest.raises(NotImplementedError, match="global cell schemes"):
        DistributedBoxLaplace(dense, 2)


@pytest.mark.parametrize("dim,shards,precond", [
    (2, (4, 1), "jacobi"), (3, (2, 2), "chebyshev")])
def test_cg_matches_tpufem(dim, shards, precond, same_start):
    gop, jgop, dofs = ops(dim, 2)
    mask = host(gop.interior_mask)
    b = mask * host(gop.to_patch(np.random.default_rng(5).standard_normal(
        dofs.n_dofs)))
    diag = gop.diagonal()
    single = gop.cg_solve(torch.as_tensor(b), diag, rtol=1e-10,
                          precond=precond)
    dop = DistributedBoxLaplace(gop, shards=shards)
    res = dop.cg_solve(dop.put_vector(b), dop.diagonal_local(diag),
                       rtol=1e-10, precond=precond)
    jdop = JDist(jgop, shards=shards)
    rj = jdop.cg_solve(jdop.put_vector(b), jnp.asarray(
        jdop.diagonal_local()), rtol=1e-10, precond=precond)
    assert res.converged and res.iterations == int(rj.iterations)
    assert res.iterations == single.iterations
    x = dop.from_local(res.x)
    assert rel(x, jdop.from_local(np.asarray(rj.x))) < 1e-10
    assert rel(x, host(single.x)) < 1e-10
    if precond == "chebyshev":
        jac = dop.cg_solve(dop.put_vector(b), dop.diagonal_local(),
                           rtol=1e-10)
        assert res.iterations < jac.iterations

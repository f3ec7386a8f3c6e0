"""Port parity for the slab partitioners and the distributed structured
solves (``tpufem_torch.parallel.{partitioner,distributed,multigrid}``)
against tpufem's, run under ``shard_map`` on the 8 virtual CPU devices of
tests/conftest.py, in f64.  Mirrors tests/test_parallel.py: the local
layouts bit-equal, 1-axis and 2-axis vmults, the owned-plane dots, the
Jacobi-CG and GMG-CG with tpufem's iteration counts and solutions to
1e-10, the variable coefficient against the assembled oracle, and both
exchange branches (``use_ppermute``) equal.  The GMG levels' Chebyshev
estimates take tpufem's power-iteration start (the ``power_start``
seam)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.parallel import distributed as jd
from tpufem.parallel import multigrid as jmg
from tpufem.parallel.partitioner import Partitioner as JPartitioner
from tpufem.parallel.partitioner import Partitioner2D as JPartitioner2D
from tpufem.solvers.multigrid import GeometricMultigrid as JGMG
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.parallel.distributed import (
    distributed_cg_solve,
    distributed_cg_solve_2d,
    make_local_laplace,
    make_local_laplace_2d,
)
from tpufem_torch.parallel.mesh import Sharded
from tpufem_torch.parallel.multigrid import distributed_gmg_cg_solve
from tpufem_torch.parallel.partitioner import Partitioner, Partitioner2D
from tpufem_torch.solvers import chebyshev as t_cheb
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.multigrid import GeometricMultigrid
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


def tpufem_start(n, seed, dtype, device):
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float64)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(t_cheb, "power_start", tpufem_start)


def build(dim, p, refine, coefficient=None):
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, p)
    mf = MatrixFree.build(mesh, dofs, FemConfig(dim, p), "cpu",
                          coefficient=coefficient)
    return dofs, mf


def j_build(dim, p, refine, coefficient=None):
    mesh = JMesh.hyper_cube(dim, refine)
    dofs = JDoFHandler(mesh, p)
    return JMatrixFree.build(mesh, dofs, JFemConfig(dim, p),
                             coefficient=coefficient)


def host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_partitioner_layout_as_tpufem():
    rng = np.random.default_rng(0)
    part, jpart = Partitioner(2, 8, 2, 4), JPartitioner(2, 8, 2, 4)
    u = rng.standard_normal(part.npts**2)
    loc = part.to_local(u)
    assert loc.shape == (4, 5, 17) and part.local_shape == jpart.local_shape
    assert np.array_equal(loc, jpart.to_local(u))
    for k in range(3):
        assert np.array_equal(loc[k, -1], loc[k + 1, 0])
    assert np.array_equal(part.to_global(loc), u)
    p2, j2 = Partitioner2D(3, 4, 2, 2, 2), JPartitioner2D(3, 4, 2, 2, 2)
    u3 = rng.standard_normal(p2.npts**3)
    assert np.array_equal(p2.to_local(u3), j2.to_local(u3))
    assert np.array_equal(p2.to_global(p2.to_local(u3)), u3)
    with pytest.raises(ValueError, match="divisible"):
        Partitioner(2, 6, 1, 4)


@pytest.mark.parametrize("dim,p,refine,n_shards", [
    (2, 2, 3, 4), (2, 3, 3, 8), (3, 2, 2, 4),
])
def test_distributed_vmult_matches_tpufem(dim, p, refine, n_shards):
    dofs, mf = build(dim, p, refine)
    jmf = j_build(dim, p, refine)
    part = Partitioner(dim=dim, n=1 << refine, p=p, n_shards=n_shards)
    x = np.random.default_rng(5).standard_normal(dofs.n_dofs)
    y_ref = np.asarray(JLaplace(jmf).vmult_raw(jnp.asarray(x)))
    mesh = part.device_mesh(device="cpu")
    vl = make_local_laplace(part, mf.S, mf.D_col, mf.struct_scale,
                            mf.struct_w, mesh)
    y = part.to_global(vl(mesh.put(part.to_local(x))))
    assert rel(y, y_ref) < 1e-13


def test_distributed_vmult_2d_mesh_and_dot():
    """Two-axis (2 x 4) decomposition of a 3D problem: the vmult against
    tpufem's and the owned-region dot against numpy's."""
    dim, p, refine = 3, 2, 3
    dofs, mf = build(dim, p, refine)
    part = Partitioner2D(dim=dim, n=1 << refine, p=p, shards_z=2,
                         shards_y=4)
    mesh = part.device_mesh(device="cpu")
    rng = np.random.default_rng(13)
    x = rng.standard_normal(dofs.n_dofs)
    y_ref = np.asarray(JLaplace(j_build(dim, p, refine)).vmult_raw(
        jnp.asarray(x)))
    put = lambda g: mesh.put(part.to_local(g).reshape(
        (-1,) + part.local_shape))
    vl = make_local_laplace_2d(part, mf.S, mf.D_col, mf.struct_scale,
                               mf.struct_w, mesh)
    assert rel(part.to_global(vl(put(x))), y_ref) < 1e-13
    b = rng.standard_normal(dofs.n_dofs)
    d = part.dot(put(x), put(b), mesh)
    assert np.isclose(float(d), float(np.dot(x, b)), rtol=1e-12)
    assert all(torch.equal(t, d.parts[0]) for t in d.parts)


def test_distributed_dot_deterministic_and_correct():
    part = Partitioner(dim=2, n=8, p=1, n_shards=4)
    mesh = part.device_mesh(device="cpu")
    rng = np.random.default_rng(2)
    a = rng.standard_normal(part.npts**2)
    b = rng.standard_normal(part.npts**2)
    al, bl = mesh.put(part.to_local(a)), mesh.put(part.to_local(b))
    v1, v2 = part.dot(al, bl, mesh), part.dot(al, bl, mesh)
    assert float(v1) == float(v2)
    assert np.isclose(float(v1), float(np.dot(a, b)), rtol=1e-12)


def _single(dim, p, refine, seed, coefficient=None):
    dofs, mf = build(dim, p, refine, coefficient)
    op = LaplaceOperator(mf)
    diag = host(op.diagonal())
    mask = host(mf.interior_mask)
    b = mask * np.random.default_rng(seed).standard_normal(dofs.n_dofs)
    return dofs, mf, diag, mask, b


@pytest.mark.parametrize("use_ppermute", [None, False],
                         ids=["ppermute", "gather_rig"])
def test_distributed_cg_matches_tpufem(use_ppermute):
    dim, p, refine, n_shards = 2, 2, 4, 8
    dofs, mf, diag, mask, b = _single(dim, p, refine, 11)
    jmf = j_build(dim, p, refine)
    jpart = JPartitioner(dim=dim, n=1 << refine, p=p, n_shards=n_shards)
    xj, itj, _ = jd.distributed_cg_solve(
        jpart, jmf.S, jmf.D_col, jmf.struct_scale, jmf.struct_w, mask,
        diag, b, rtol=1e-10)
    part = Partitioner(dim=dim, n=1 << refine, p=p, n_shards=n_shards,
                       use_ppermute=use_ppermute)
    x, it, resid = distributed_cg_solve(
        part, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask, diag, b,
        rtol=1e-10)
    assert it == itj
    assert rel(x, xj) < 1e-10
    single = cg_solve(LaplaceOperator(mf).vmult, torch.as_tensor(b),
                      M_inv=lambda r: r / torch.as_tensor(diag), rtol=1e-10)
    assert it == single.iterations


def test_distributed_cg_2d_mesh_matches_tpufem():
    dim, p, refine = 3, 1, 3
    dofs, mf, diag, mask, b = _single(dim, p, refine, 17)
    jmf = j_build(dim, p, refine)
    jpart = JPartitioner2D(dim=dim, n=1 << refine, p=p, shards_z=2,
                           shards_y=4)
    xj, itj, _ = jd.distributed_cg_solve_2d(
        jpart, jmf.S, jmf.D_col, jmf.struct_scale, jmf.struct_w, mask,
        diag, b, rtol=1e-10)
    part = Partitioner2D(dim=dim, n=1 << refine, p=p, shards_z=2,
                         shards_y=4)
    x, it, _ = distributed_cg_solve_2d(
        part, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask, diag, b,
        rtol=1e-10)
    assert it == itj and rel(x, xj) < 1e-10


@pytest.mark.parametrize("dim,refine", [(2, 4), (3, 3)])
def test_distributed_gmg_cg_matches_tpufem(dim, refine, same_start):
    """Every level slab-sharded: tpufem's distributed GMG-CG count and
    solution, and the port's single-device GMG-CG count."""
    p, n_shards = 2, 4
    gmg = GeometricMultigrid(dim, p, refine, coarsest_refine=2,
                             device="cpu")
    jgmg = JGMG(dim, p, refine, coarsest_refine=2)
    mask = host(gmg.fine.mask)
    b = mask * np.random.default_rng(23).standard_normal(
        gmg.fine.mf.n_dofs)
    xj, itj, _ = jmg.distributed_gmg_cg_solve(jgmg, n_shards, b,
                                              rtol=1e-10)
    x, it, resid = distributed_gmg_cg_solve(gmg, n_shards, b, rtol=1e-10)
    assert it == itj and rel(x, xj) < 1e-10
    assert resid <= 1e-10 * np.linalg.norm(b) * 1.001
    single = cg_solve(gmg.fine.op.vmult, torch.as_tensor(b),
                      M_inv=gmg.preconditioner(), rtol=1e-10)
    assert it == single.iterations and rel(x, host(single.x)) < 1e-10


def test_distributed_variable_coefficient_cg_matches_oracle():
    """Sharded struct_w: tpufem's count and solution, and the assembled
    variable-coefficient operator's direct solve."""
    dim, p, refine, n_shards = 2, 2, 4, 8
    coef = lambda x: 1.0 + 5.0 * np.sum(x**2, axis=1)
    dofs, mf, diag, mask, b = _single(dim, p, refine, 31, coef)
    assert mf.struct_w.shape[0] > 1  # really sharded
    jmf = j_build(dim, p, refine, coef)
    jpart = JPartitioner(dim=dim, n=1 << refine, p=p, n_shards=n_shards)
    xj, itj, _ = jd.distributed_cg_solve(
        jpart, jmf.S, jmf.D_col, jmf.struct_scale, jmf.struct_w, mask,
        diag, b, rtol=1e-10)
    part = Partitioner(dim=dim, n=1 << refine, p=p, n_shards=n_shards)
    x, it, _ = distributed_cg_solve(
        part, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask, diag, b,
        rtol=1e-10)
    assert it == itj and rel(x, xj) < 1e-10
    K = assemble_laplace(dofs, coefficient=coef).toarray()
    Kc = mask[:, None] * K * mask[None, :] + np.diag(1.0 - mask)
    assert rel(x, np.linalg.solve(Kc, b)) < 1e-8


def test_ppermute_branch_matches_gather_rig():
    """Both exchange branches (the single-neighbour ppermute and the
    all_gather + select rig) give the same compress, as tpufem's, bit for
    bit."""
    part = Partitioner(dim=2, n=8, p=2, n_shards=4, use_ppermute=True)
    rig = Partitioner(dim=2, n=8, p=2, n_shards=4, use_ppermute=False)
    mesh = part.device_mesh(device="cpu")
    x = np.random.default_rng(11).standard_normal(
        (4, part.local_npts_z, part.npts))
    y_pp = mesh.stack(part.compress_add(mesh.put(x), mesh))
    y_ag = mesh.stack(rig.compress_add(mesh.put(x), mesh))
    assert np.array_equal(y_pp, y_ag)
    jp = JPartitioner(dim=2, n=8, p=2, n_shards=4)
    from jax.sharding import PartitionSpec as P

    f = jax.jit(jax.shard_map(lambda y: jp.compress_add(y[0])[None],
                              mesh=jp.device_mesh(), in_specs=P("shard"),
                              out_specs=P("shard")))
    assert np.array_equal(y_pp, np.asarray(f(jnp.asarray(x))))
    assert Partitioner(2, 8, 1, 2).use_ppermute is None
    assert isinstance(mesh.put(x), Sharded)

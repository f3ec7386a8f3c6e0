"""Port parity: host builders, the plain separable apply and the K2 wrapper
of tpufem_torch against tpufem (f64, CPU; Pallas in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.assemble import assemble_laplace
from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.ops import pallas_separable as jps
from tpufem.ops import separable as jsep
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops import separable as tsep

# a distinct cell width per axis: an axis swap or a transposed operator in
# the port shows as a mismatch (identical axes would hide it)
H_AXES = (1.0 / 4, 1.0 / 3, 1.0 / 5)


@pytest.mark.parametrize("p,n", [(1, 4), (2, 3), (4, 2), (7, 2)])
def test_host_copies_equal(p, n):
    K_t, M_t = tsep.global_1d_matrices(p, n, p + 1)
    K_j, M_j = jsep.global_1d_matrices(p, n, p + 1)
    assert np.array_equal(K_t, K_j) and np.array_equal(M_t, M_j)
    for dtype in (np.float64, np.float32):
        ops_t = tsep.build_separable_operators(p, 3, p + 1, n,
                                               np.asarray(H_AXES), dtype)
        ops_j = jsep.build_separable_operators(p, 3, p + 1, n,
                                               np.asarray(H_AXES), dtype)
        for a_t, a_j in zip(ops_t[0] + ops_t[1], ops_j[0] + ops_j[1]):
            assert a_t.dtype == a_j.dtype and np.array_equal(a_t, a_j)
    npts = n * p + 1
    for b, nt in [(npts, 1), (8, -(-npts // 8)), (3, -(-npts // 3) + 1)]:
        assert np.array_equal(tks.exact_bands(K_t, p, b, nt),
                              jps._exact_bands(K_j, p, b, nt))


def _operators(dim, p, n):
    K1u, M1u = jsep.global_1d_matrices(p, n, p + 1)
    Ks = [K1u / H_AXES[a] for a in range(dim)]
    Ms = [M1u * H_AXES[a] for a in range(dim)]
    return Ks, Ms


@pytest.mark.parametrize("dim,p,n", [(2, 1, 8), (2, 2, 6), (2, 3, 4),
                                     (3, 1, 6), (3, 2, 4), (3, 4, 2)])
def test_plain_matches_tpufem(dim, p, n):
    npts = n * p + 1
    Ks, Ms = _operators(dim, p, n)
    u = np.random.default_rng(0).standard_normal(npts**dim)
    y_t = tsep.laplace_apply_separable(
        torch.as_tensor(u), dim, npts, [torch.as_tensor(K) for K in Ks],
        [torch.as_tensor(M) for M in Ms]).numpy()
    y_j = np.asarray(jsep.laplace_apply_separable(
        jnp.asarray(u), dim, npts, [jnp.asarray(K) for K in Ks],
        [jnp.asarray(M) for M in Ms]))
    pk = jps.PallasSeparable(dim, npts, p, Ks, Ms, "float64", interpret=True)
    y_p = np.asarray(pk(jnp.asarray(u)))
    nrm = np.linalg.norm(y_j)
    assert np.linalg.norm(y_t - y_j) / nrm < 1e-13
    assert np.linalg.norm(y_t - y_p) / nrm < 1e-13
    # the K2 wrapper on a CPU tensor is the plain version, and counts no
    # kernel launch
    before = tks.KernelSeparable.launches
    kt = tks.KernelSeparable(dim, npts, p, Ks, Ms, torch.float64, "cpu")
    assert np.array_equal(kt(torch.as_tensor(u)).numpy(), y_t)
    assert tks.KernelSeparable.launches == before


@pytest.mark.parametrize("dim,p,r", [(2, 2, 3), (3, 2, 2)])
def test_plain_matches_assembled_oracle(dim, p, r):
    """Against the assembled matrix on a box with a distinct extent per
    axis (independent of either separable implementation)."""
    n = 1 << r
    npts = n * p + 1
    mesh = Mesh.hyper_cube(dim, r, upper=[n * H_AXES[a] for a in range(dim)])
    dofs = DoFHandler(mesh, p)
    K = assemble_laplace(dofs)
    Ks, Ms = _operators(dim, p, n)
    x = np.random.default_rng(1).standard_normal(dofs.n_dofs)
    y = tsep.laplace_apply_separable(
        torch.as_tensor(x), dim, npts, [torch.as_tensor(K1) for K1 in Ks],
        [torch.as_tensor(M1) for M1 in Ms]).numpy()
    assert np.linalg.norm(y - K @ x) / np.linalg.norm(K @ x) < 1e-12


def test_kernel_tables_are_exact_bands():
    """Kernel tables: row g, tap o holds M[g, g+o-p] (non-symmetric, so a
    transposed table would differ), then the row sum."""
    rng = np.random.default_rng(2)
    p, npts = 3, 11
    i, j = np.indices((npts, npts))
    M = np.where(np.abs(i - j) <= p, rng.standard_normal((npts, npts)), 0.0)
    tabs = tks.band_tables([M], p)
    assert tabs.flags.c_contiguous  # the kernel reads row-major tables
    W = tabs[0]
    assert W.shape == (npts, 2 * p + 2)
    for g in range(npts):
        for o in range(2 * p + 1):
            jj = g + o - p
            assert W[g, o] == (M[g, jj] if 0 <= jj < npts else 0.0)
    # last column: the row's tap sum, for the kernel's difference form
    assert np.allclose(W[:, -1], M.sum(axis=1), rtol=0, atol=1e-13)


def test_kernel_refuses_what_it_cannot_run():
    Ks, Ms = _operators(3, 2, 2)
    with pytest.raises(ValueError, match="p = 1..8"):
        tks.KernelSeparable(3, 19, 9, Ks, Ms, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no kernel instance"):
        tks.KernelSeparable(3, 5, 2, Ks, Ms, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="bf16s"):
        tks.ResidentSeparable(5, 2, Ks, Ms, torch.float64, mode="bf16s")
    if not torch.cuda.is_available():
        # no silent CPU fallback: a CUDA instance needs its built kernel
        with pytest.raises(RuntimeError, match="CUDA"):
            tks.KernelSeparable(3, 5, 2, Ks, Ms, torch.float32, "cuda")

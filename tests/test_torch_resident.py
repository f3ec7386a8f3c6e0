"""Port parity: the K1 wrapper (ResidentSeparable) and resident_jacobi_cg
of tpufem_torch against tpufem (f64, CPU; Pallas in interpret mode)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops import pallas_separable as jps
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.ops.separable import global_1d_matrices
from tpufem.solvers.resident import resident_jacobi_cg as j_resident_cg
from tpufem.utils.config import FemConfig
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.resident import resident_jacobi_cg
from torch_threads import one_torch_thread  # noqa: F401

H_AXES = (1.0 / 4, 1.0 / 3, 1.0 / 5)


def _operators(p, n):
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    return ([K1u / H_AXES[a] for a in range(3)],
            [M1u * H_AXES[a] for a in range(3)])


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dirichlet", [False, True])
def test_resident_matches_tpufem(p, dirichlet):
    n = 4
    npts = n * p + 1
    Ks, Ms = _operators(p, n)
    u = np.random.default_rng(5).standard_normal(npts**3)
    jk = jps.ResidentSeparable(npts, p, Ks, Ms, "float64", interpret=True,
                               dirichlet=dirichlet)
    y_j = np.asarray(jk.unpad(jk.raw(jk.pad(jnp.asarray(u)))))
    before = tks.ResidentSeparable.launches
    tk = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float64,
                               dirichlet=dirichlet, device="cpu")
    y_t = tk.unpad(tk.raw(tk.pad(torch.as_tensor(u)))).numpy()
    assert tks.ResidentSeparable.launches == before  # plain, not a launch
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-12
    # chaining stays in the resident layout
    y2_j = np.asarray(jk.unpad(jk.raw(jk.raw(jk.pad(jnp.asarray(u))))))
    y2_t = tk.unpad(tk.raw(tk.raw(tk.pad(torch.as_tensor(u))))).numpy()
    assert np.linalg.norm(y2_t - y2_j) / np.linalg.norm(y2_j) < 1e-12


def test_resident_bf16_storage_mode():
    """bf16s: bf16 storage, f32 arithmetic; against the f64 plain apply of
    the same (bf16-quantised) input, within the 4e-3 class."""
    p, n = 2, 4
    npts = n * p + 1
    Ks, Ms = _operators(p, n)
    tk = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float32, mode="bf16s",
                               dirichlet=True, device="cpu")
    assert tk.dt == torch.bfloat16 and tk.compute_dt == torch.float32
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(npts**3))
    gp = tk.pad(u)
    y = tk.raw(gp)
    assert y.dtype == torch.bfloat16 and y.shape == (npts, npts, 32)
    ref = tks.ResidentSeparable(npts, p, Ks, Ms, torch.float64,
                                dirichlet=True, device="cpu")
    y_ref = ref(tk.unpad(gp).to(torch.float64))
    err = (tk.unpad(y).to(torch.float64) - y_ref).abs().max() \
        / y_ref.abs().max()
    assert err <= 4e-3


@pytest.mark.parametrize("pallas_dirichlet", [None, False])
def test_resident_cg_matches_tpufem(pallas_dirichlet):
    """Resident Jacobi-CG on a seeded masked random RHS: the port's
    iteration count equals tpufem's, solutions agree to 1e-10."""
    mesh = Mesh.hyper_cube(3, 3)
    dofs = DoFHandler(mesh, 2)
    cfg = FemConfig(3, 2, scatter="separable", use_pallas=True,
                    pallas_dirichlet=pallas_dirichlet)
    jmf = JMatrixFree.build(mesh, dofs, cfg)
    tmf = MatrixFree.build(mesh, dofs, cfg, "cpu")
    assert tmf.resident.dirichlet == jmf.resident.dirichlet
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    mask = np.asarray(jmf.interior_mask)
    b = mask * np.random.default_rng(3).standard_normal(dofs.n_dofs)
    rj = j_resident_cg(jop, jnp.asarray(b), diag=jop.diagonal(), rtol=1e-8,
                       maxiter=400)
    rt = resident_jacobi_cg(top, torch.as_tensor(b), diag=top.diagonal(),
                            rtol=1e-8, maxiter=400)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)


def test_resident_cg_bf16s_through_matrix_free():
    """pallas_mode="bf16s" reaches the resident kernel through
    MatrixFree.build (as the on-card smoke drives it); the solve returns the
    residual recomputed with its own operator, not the recurrence's, and x
    stays within the bf16-storage operator class of the f32 solution."""
    from tpufem_torch.apps.poisson import poisson_operator

    op16 = poisson_operator(3, 2, 3, "float32", True, "cpu",
                            pallas_mode="bf16s")
    op32 = poisson_operator(3, 2, 3, "float32", True, "cpu")
    assert op16.mf.resident.mode == "bf16s"
    assert op16.mf.resident.dt == torch.bfloat16
    mask = op32.mf.interior_mask.numpy().astype(np.float64)
    b = torch.tensor(mask * np.random.default_rng(4).standard_normal(
        op32.mf.n_dofs), dtype=torch.float32)
    r16 = resident_jacobi_cg(op16, b, diag=op16.diagonal(), rtol=1e-5)
    r32 = resident_jacobi_cg(op32, b, diag=op32.diagonal(), rtol=1e-5)
    assert r32.converged and r16.x.dtype == torch.float32
    assert torch.isfinite(r16.x).all()
    rk = op16.mf.resident
    Ax = rk.unpad(rk.raw(rk.pad(r16.x))).to(torch.float32)
    true_res = float((b - Ax).norm())
    assert abs(r16.residual - true_res) <= 1e-3 * true_res
    rel = float((r16.x - r32.x).norm() / r32.x.norm())
    assert rel <= 1e-2, rel  # bf16 storage: a 4e-3-class operator


def test_resident_2d_not_ported():
    """A 2D operator without use_pallas carries no resident kernel, and the
    resident solver refuses it rather than run something else; with
    use_pallas, K3 (ResidentTerms2D) attaches as in tpufem (its solve is
    held to tpufem's in tests/test_torch_terms.py)."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms2D

    mesh = Mesh.hyper_cube(2, 2)
    dofs = DoFHandler(mesh, 2)
    b = torch.zeros(dofs.n_dofs, dtype=torch.float64)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="separable"),
                          "cpu")
    assert mf.resident is None and mf.kernel is None
    with pytest.raises(ValueError, match="no resident kernel"):
        resident_jacobi_cg(LaplaceOperator(mf), b)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="separable",
                                                use_pallas=True), "cpu")
    assert isinstance(mf.resident, ResidentTerms2D) and mf.kernel is not None


# ---------------------------------------------------------------------
# the ring's resident layout and the masked tables (K1)
# ---------------------------------------------------------------------
def test_resident_layout_round_trip_and_zero_pad():
    """The resident layout (npts, npts, X), X the smallest multiple of the
    ring's 64-byte chunk that is >= npts (272, 288, 264 at npts = 257 in
    f32, bf16, f64): unpad(pad(u)) == u in each storage, the pad zero, and
    the pad stays zero in every vector a CPU resident CG hands its apply."""
    assert [tks.resident_x(257, dt) for dt in (
        torch.float32, torch.bfloat16, torch.float64)] == [272, 288, 264]
    p, n = 2, 4
    npts = n * p + 1
    Ks, Ms = _operators(p, n)
    u = torch.as_tensor(np.random.default_rng(8).standard_normal(npts**3))
    for dtype, mode, X in ((torch.float32, "f32", 16),
                           (torch.float32, "bf16s", 32),
                           (torch.float64, "f32", 16)):
        tk = tks.ResidentSeparable(npts, p, Ks, Ms, dtype, mode=mode,
                                   device="cpu")
        gp = tk.pad(u)
        assert gp.shape == (npts, npts, X) and tk.X == X
        assert not gp[..., npts:].any()
        assert torch.equal(tk.unpad(gp), u.to(tk.dt))
        assert torch.equal(tk.unpad(tk.pad_any(u)), u)
    mesh = Mesh.hyper_cube(3, 3)
    dofs = DoFHandler(mesh, 2)
    tmf = MatrixFree.build(mesh, dofs, FemConfig(3, 2, scatter="separable",
                                                 use_pallas=True), "cpu")
    rk = tmf.resident
    seen = []

    def raw(gp, _raw=rk.raw):
        seen.append(bool(gp[..., rk.npts:].any()))
        y = _raw(gp)
        seen.append(bool(y[..., rk.npts:].any()))
        return y

    rk.raw = raw
    top = LaplaceOperator(tmf)
    b = tmf.interior_mask * torch.as_tensor(
        np.random.default_rng(9).standard_normal(dofs.n_dofs))
    r = resident_jacobi_cg(top, b, diag=top.diagonal(), rtol=1e-8,
                           maxiter=400)
    assert r.converged and len(seen) > 10 and not any(seen)
    assert r.x.shape == (dofs.n_dofs,)


class MaskedTables:
    """The operator the ring kernels run with the fused mask, in plain
    PyTorch on the CPU: the sum of products of the masked 1D matrices
    D X D (kernel_separable.masked), plus (1 - m) x, on the wrapper's
    resident layout (2D or 3D, by the terms' length)."""

    def __init__(self, rk, terms):
        self.rk, self.dirichlet = rk, True
        self.compute_dt, self.dt = rk.compute_dt, rk.dt
        self.npts, self.dim = rk.npts, len(terms[0])
        self.mterms = [[torch.as_tensor(tks.masked(np.asarray(X)),
                                        dtype=rk.compute_dt) for X in t]
                       for t in terms]
        self.m = tks.separable_interior_mask(rk.npts, rk.compute_dt, "cpu",
                                             self.dim)

    def pad_any(self, u):
        return self.rk.pad_any(u)

    def unpad(self, gp):
        return self.rk.unpad(gp)

    def raw(self, gp):
        from tpufem_torch.ops.separable import laplace_apply_separable_terms

        x = self.unpad(gp).to(self.compute_dt)
        y = laplace_apply_separable_terms(x, self.dim, self.npts,
                                          self.mterms) \
            + (1.0 - self.m) * x
        return self.rk.pad_any(y.to(self.dt))


def laplace_terms(Ks, Ms):
    """K1's operator as three terms, x first: Kz My Mx + Mz Ky Mx +
    Mz My Kx."""
    return [[Ms[0], Ms[1], Ks[2]], [Ms[0], Ks[1], Ms[2]],
            [Ks[0], Ms[1], Ms[2]]]


def test_masked_tables_match_tpufem_mask_algebra():
    """The masked-table operator the K1 kernel runs with the fused mask
    equals tpufem's m·A(m·x) + (1-m)·x in f64 to 1e-10, and a resident CG
    through it takes tpufem's iterations to the same x."""
    mesh = Mesh.hyper_cube(3, 3)
    dofs = DoFHandler(mesh, 2)
    cfg = FemConfig(3, 2, scatter="separable", use_pallas=True)
    jmf = JMatrixFree.build(mesh, dofs, cfg)
    tmf = MatrixFree.build(mesh, dofs, cfg, "cpu")
    assert tmf.resident.dirichlet
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    mt = MaskedTables(tmf.resident, laplace_terms(
        [K.numpy() for K in tmf.Ks], [M.numpy() for M in tmf.Ms]))
    x = np.random.default_rng(10).standard_normal(dofs.n_dofs)
    y_j = np.asarray(jop.vmult(jnp.asarray(x)))
    y_t = mt.unpad(mt.raw(mt.pad_any(torch.as_tensor(x)))).numpy()
    assert np.linalg.norm(y_t - y_j) <= 1e-10 * np.linalg.norm(y_j)
    mask = np.asarray(jmf.interior_mask)
    b = mask * np.random.default_rng(11).standard_normal(dofs.n_dofs)
    rj = j_resident_cg(jop, jnp.asarray(b), diag=jop.diagonal(), rtol=1e-8,
                       maxiter=400)
    rt = resident_jacobi_cg(SimpleNamespace(mf=tmf, resident=mt),
                            torch.as_tensor(b), diag=top.diagonal(),
                            rtol=1e-8, maxiter=400)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)

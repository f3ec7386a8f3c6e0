"""Port parity: tpufem_torch cg_solve against tpufem cg_solve on an
assembled SPD system, plus its stall and NaN exits."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

from tpufem.fem.assemble import assemble_laplace
from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.solvers.cg import cg_solve as j_cg_solve
from tpufem.solvers.cg import make_jacobi as j_make_jacobi
from tpufem_torch.solvers.cg import cg_solve, make_jacobi
from torch_threads import one_torch_thread  # noqa: F401


def _system(dim=2, p=2, r=3, seed=4):
    """Dirichlet-constrained assembled Laplace matrix (identity rows on
    the boundary) and a seeded masked RHS."""
    dofs = DoFHandler(Mesh.hyper_cube(dim, r), p)
    mask = (~dofs.boundary_mask).astype(np.float64)
    P = sp.diags(mask)
    K = (P @ assemble_laplace(dofs) @ P + sp.diags(1.0 - mask)).tocsr()
    b = mask * np.random.default_rng(seed).standard_normal(dofs.n_dofs)
    return K, b


def test_cg_matches_tpufem_f64():
    K, b = _system()
    Kd = torch.as_tensor(K.toarray())
    Kj = jnp.asarray(K.toarray())
    diag = K.diagonal()
    rt = cg_solve(lambda v: Kd @ v, torch.as_tensor(b),
                  M_inv=make_jacobi(torch.as_tensor(diag)), rtol=1e-12)
    rj = j_cg_solve(lambda v: Kj @ v, jnp.asarray(b),
                    M_inv=j_make_jacobi(jnp.asarray(diag)), rtol=1e-12)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)
    assert abs(rt.residual - float(rj.residual)) <= 1e-10 * np.linalg.norm(b)


def test_cg_f32_stall_returns_best_iterate():
    """A residual that stops improving ends the loop stall_iters after its
    last new minimum (not at maxiter), and the best iterate comes back
    with its residual; with track_best=False the final iterate instead.
    A skew-symmetric perturbation of the SPD matrix keeps p·Ap > 0 but
    breaks CG's orthogonality, so the residual plateaus."""
    K, b = _system(r=4)
    n = len(b)
    R = np.random.default_rng(0).standard_normal((n, n)) / np.sqrt(n)
    Kd = torch.as_tensor(K.toarray(), dtype=torch.float32)
    S = torch.as_tensor(0.1 * (R - R.T), dtype=torch.float32)
    A = lambda v: Kd @ v + S @ v
    bt = torch.as_tensor(b, dtype=torch.float32)
    M = make_jacobi(Kd.diagonal())
    best, final = (cg_solve(A, bt, M_inv=M, rtol=1e-6, maxiter=5000,
                            stall_iters=60, track_best=track)
                   for track in (True, False))
    assert not best.converged and best.iterations < 2000
    assert final.iterations == best.iterations
    assert final.residual > best.residual
    r_true = float((bt - A(best.x)).norm())
    assert abs(r_true - best.residual) <= 1e-2 * best.residual
    # f32 default: stall detection (max(100, maxiter // 10)) with tracking
    default = cg_solve(A, bt, M_inv=M, rtol=1e-6, maxiter=600)
    assert default.iterations < 600 and not default.converged
    assert default.residual <= best.residual


def test_cg_nan_exit():
    """A non-finite residual ends the loop; the best iterate (x0) and its
    residual come back, not converged."""
    K, b = _system()
    Kd = torch.as_tensor(K.toarray())
    calls = []

    def A(v):
        calls.append(1)
        y = Kd @ v
        return y * float("nan") if len(calls) > 1 else y

    res = cg_solve(A, torch.as_tensor(b), rtol=1e-12, track_best=True)
    assert res.iterations == 1 and not res.converged
    assert torch.equal(res.x, torch.zeros(len(b), dtype=torch.float64))
    assert abs(res.residual - np.linalg.norm(b)) <= 1e-12 * np.linalg.norm(b)

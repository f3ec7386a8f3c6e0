"""Elasticity app: the vector-valued matrix-free solve (deal.II step-8).

Port of ``tpufem/apps/elasticity.py``.  Solves -div sigma(u) = f,
sigma = 2 mu eps(u) + lam tr(eps(u)) I, on the unit hyper_cube with zero
Dirichlet data and the manufactured solution u_c = prod_a sin(pi x_a)
for every component c; reports the combined L2 error and the solver's
statistics.

Tiers: the generic vector operator (``operators.vector``, the incidence
cell loop), or ``--fast``, the exact block tensor-product factorisation
(``operators.tensor_product.SeparableElasticityOperator``), whose nine
blocks run K4 in 3D on a CUDA device (``use_pallas``; the CLI asks for it
with ``--fast`` on the card in 3D).  Preconditioners: jacobi | chebyshev | gmg
(the vector V-cycle, ``solvers.vector_multigrid``).  ``--fast`` with
``gmg`` raises (the V-cycle's levels are the generic operator; the
reference ignores ``--fast`` there without a word).  ``--shards N``
distributes the generic vector operator over an in-process shard mesh
(``parallel.vector``); ``--fast`` with ``--shards`` raises likewise (the
reference builds the fast tier and leaves it unused).

Run:  python -m tpufem_torch.apps.elasticity --dim 3 --degree 4 \\
          --refine 4 --fast --dtype float32 --rtol 1e-6
      python -m tpufem_torch.apps.elasticity --dim 2 --degree 2 \\
          --refine 4 --precond gmg --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_rhs, integrate_difference
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.tensor_product import SeparableElasticityOperator
from tpufem_torch.operators.vector import elasticity_operator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.cg import cg_solve, make_jacobi
from tpufem_torch.solvers.chebyshev import (
    chebyshev_smooth,
    make_chebyshev_params,
)
from tpufem_torch.solvers.vector_multigrid import VectorMultigrid
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import synchronize


def manufactured(dim, mu, lam):
    """u_c = g = prod_a sin(pi x_a); f_c = -(mu lap g
    + (mu + lam) sum_a d_c d_a g)."""

    def u_exact(pts):
        return np.prod(np.sin(np.pi * pts), axis=1)

    def f_component(c, pts):
        s = np.sin(np.pi * pts)
        co = np.cos(np.pi * pts)
        g = np.prod(s, axis=1)
        lap = -dim * np.pi**2 * g
        dcd = np.zeros(len(pts))
        for a in range(dim):
            if a == c:
                dcd += -np.pi**2 * g
            else:
                cols = s.copy()
                cols[:, a] = co[:, a]
                cols[:, c] = co[:, c]
                dcd += np.pi**2 * np.prod(cols, axis=1)
        return -(mu * lap + (mu + lam) * dcd)

    return u_exact, f_component


def fdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot of two (C, n) fields."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def run_elasticity(dim=2, degree=2, refine=4, precond="jacobi", mu=1.0,
                   lam=1.0, rtol=1e-10, dtype="float64", shards=0,
                   fast=False, use_pallas=False,
                   device: torch.device | str = "cuda"):
    """Returns (metrics dict, x (C, n_dofs) numpy).  ``use_pallas`` with
    ``fast``: the blocks through K4 (3D; 2D raises).  ``shards``: the
    generic vector tier distributed over that many shards
    (``parallel.vector``), Jacobi- or Chebyshev-preconditioned (with
    "gmg" Jacobi, as in the JAX package); ``fast`` with shards raises
    ``ValueError``, where the JAX package builds the fast tier and leaves
    it unused."""
    dt = torch_dtype(dtype)
    device = resolve_device(device)
    if fast and shards:
        raise ValueError("--fast is the single-device separable block "
                         "tier; --shards distributes the generic vector "
                         "operator: use one or the other")
    if fast and precond == "gmg":
        raise ValueError("--fast is the separable block tier; the vector "
                         "V-cycle (--precond gmg) runs on the generic "
                         "vector operator: use one or the other")
    if use_pallas and not fast:
        raise ValueError("use_pallas attaches K4 to the --fast tier only")
    u_exact, f_component = manufactured(dim, mu, lam)

    t0 = time.perf_counter()
    mg = None
    if precond == "gmg":
        mg = VectorMultigrid(dim, degree, finest_refine=refine,
                             coarsest_refine=min(1, refine), dtype=dtype,
                             mu=mu, lam=lam, device=device)
        mf = mg.fine.mf
        dofs = mf.dofs
        op = mg.fine.op
    else:
        mesh = Mesh.hyper_cube(dim, refine)
        dofs = DoFHandler(mesh, degree)
        # the fast tier reads no cell table: its MatrixFree is the
        # separable scheme's (the reference builds incidence for both)
        mf = MatrixFree.build(
            mesh, dofs, FemConfig(dim, degree, dtype=dtype,
                                  scatter="separable" if fast
                                  else "incidence"), device)
        if fast:
            op = SeparableElasticityOperator(mf, mu=mu, lam=lam,
                                             use_pallas=use_pallas)
        else:
            op = elasticity_operator(mf, mu=mu, lam=lam)

    mask = mf.interior_mask.cpu().to(torch.float64).numpy()
    b = np.stack([mask * assemble_rhs(dofs, lambda p, c=c: f_component(c, p))
                  for c in range(dim)])
    diag = op.diagonal()
    bj = torch.as_tensor(b, dtype=dt, device=device)
    if precond == "gmg":
        M_inv = mg.preconditioner()
    elif precond == "chebyshev":
        cheb = make_chebyshev_params(
            lambda xf: op.vmult(xf.reshape(dim, -1)).reshape(-1),
            diag.reshape(-1), dim * dofs.n_dofs)
        inv_diag = 1.0 / diag

        def M_inv(r):
            return chebyshev_smooth(op.vmult, inv_diag, cheb, r)
    elif precond == "jacobi":
        M_inv = make_jacobi(diag)
    else:
        raise ValueError(f"unknown precond {precond!r}")
    synchronize(device)
    setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    if shards:
        from tpufem_torch.parallel.general import GeneralPartitioner
        from tpufem_torch.parallel.vector import (
            distributed_elasticity_operator,
        )

        part = GeneralPartitioner.build(mf, shards)
        dop = distributed_elasticity_operator(part, mu=mu, lam=lam)
        pr = "chebyshev" if precond == "chebyshev" else "jacobi"
        x, iterations, residual = dop.cg_solve(
            b, diag.cpu().to(torch.float64).numpy(), rtol=rtol,
            maxiter=10000, precond=pr)
        res = SimpleNamespace(
            iterations=iterations, residual=residual,
            converged=residual <= rtol * float(np.linalg.norm(b)))
        tier = f"distributed-{pr} ({shards} shards)"
    else:
        res = cg_solve(op.vmult, bj, M_inv=M_inv, rtol=rtol, maxiter=10000,
                       dot=fdot)
        x = res.x.cpu().numpy()
        tier = precond + (" (separable fast tier)" if fast else "")
    solve = time.perf_counter() - t0

    err2 = sum(integrate_difference(dofs, x[c].astype(np.float64),
                                    u_exact) ** 2 for c in range(dim))
    return {
        "n_dofs": dofs.n_dofs,
        "n_components": dim,
        "n_cells": dofs.mesh.n_cells,
        "precond": tier,
        "iterations": res.iterations,
        "residual": res.residual,
        "converged": res.converged,
        "setup_s": setup,
        "solve_s": solve,
        "l2_error": float(np.sqrt(err2)),
    }, x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "chebyshev", "gmg"])
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--shards", type=int, default=0,
                    help="distributed solve over an in-process shard mesh "
                         "(the generic vector tier on the general "
                         "partitioner)")
    ap.add_argument("--fast", action="store_true",
                    help="separable block tier (uniform grids; K4 for each "
                         "block in 3D on a CUDA device)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    out, _ = run_elasticity(
        dim=args.dim, degree=args.degree, refine=args.refine,
        precond=args.precond, mu=args.mu, lam=args.lam, rtol=args.rtol,
        dtype=args.dtype, shards=args.shards, fast=args.fast,
        # the reference's rule: the kernels with --fast off the CPU
        use_pallas=args.fast and device.type == "cuda" and args.dim == 3,
        device=device)
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>14}: {v}")
    return None  # console-script exit code


if __name__ == "__main__":
    main()

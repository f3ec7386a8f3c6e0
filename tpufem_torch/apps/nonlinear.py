"""Nonlinear Poisson app: Newton-Krylov on quadrature-point functors.

Port of ``tpufem/apps/nonlinear.py``, the deal.II step-15 analogue:
stationary nonlinear problems solved by matrix-free Newton whose Jacobian
is ``torch.func.linearize`` through the residual (``solvers/newton.py``),
on the incidence cell loop (``operators.generic.NonlinearOperator``).

Problems:
  quasilinear       -div((1 + u^2) grad u) = f, manufactured
                    u = prod sin(pi x_a); reports the L2 error.
  minimal-surface   -div(grad u / sqrt(1 + |grad u|^2)) = 0 with boundary
                    data g = sin(2 pi x0) (the step-15 problem).

Run:  python -m tpufem_torch.apps.nonlinear --dim 3 --degree 2 \\
          --refine 5 --dtype float32 --precond jacobi
      python -m tpufem_torch.apps.nonlinear --problem minimal-surface \\
          --linear gmres --device cpu
``--adaptive-steps`` refines toward a ball; the hanging-node meshes take
the same residual through C/C^T.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_rhs, integrate_difference
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.generic import NonlinearOperator
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import synchronize


def quasilinear_problem(dim):
    """u = prod sin(pi x_a); f = -(1+u^2) lap u - 2 u |grad u|^2."""

    def u_exact(pts):
        return np.prod(np.sin(np.pi * pts), axis=1)

    def f(pts):
        s = np.sin(np.pi * pts)
        c = np.cos(np.pi * pts)
        u = np.prod(s, axis=1)
        lap = -dim * np.pi**2 * u
        grad2 = np.zeros(len(pts))
        for a in range(dim):
            cols = s.copy()
            cols[:, a] = c[:, a]
            grad2 += np.prod(cols, axis=1) ** 2
        grad2 *= np.pi**2
        return -(1.0 + u**2) * lap - 2.0 * u * grad2

    def qop(vals, grads, ctx):
        return None, (1.0 + vals**2)[:, None, :] * grads

    return u_exact, f, qop, True


def minimal_surface_problem(dim):
    def qop(vals, grads, ctx):
        g2 = torch.sum(grads * grads, dim=1)
        return None, grads / torch.sqrt(1.0 + g2)[:, None, :]

    return None, None, qop, False


def run_nonlinear(dim=2, degree=2, refine=4, problem="quasilinear",
                  linear="cg", rtol=1e-10, adaptive_steps=0,
                  dtype="float64", precond="none",
                  device: torch.device | str = "cuda"):
    """Returns (metrics dict, x as numpy)."""
    dt = torch_dtype(dtype)
    device = resolve_device(device)
    build = (quasilinear_problem if problem == "quasilinear"
             else minimal_surface_problem)
    u_exact, f, qop, needs_values = build(dim)

    t0 = time.perf_counter()
    mesh = Mesh.hyper_cube(dim, refine)
    for _ in range(adaptive_steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - 0.31, axis=1) < 0.35)
    dofs = DoFHandler(mesh, degree)
    ac = make_hanging_node_constraints(dofs) if adaptive_steps else None
    mf = MatrixFree.build(
        mesh, dofs, FemConfig(dim, degree, scatter="incidence", dtype=dtype),
        device, constraints=ac)
    op = NonlinearOperator(mf, qop, needs_values=needs_values)

    if problem == "quasilinear":
        b = torch.as_tensor(assemble_rhs(dofs, f), dtype=dt, device=device)
        u0 = None
    else:
        b = torch.zeros(dofs.n_dofs, dtype=dt, device=device)
        g = np.sin(2 * np.pi * dofs.dof_coords[:, 0])
        u0 = torch.as_tensor(np.where(dofs.boundary_mask, g, 0.0), dtype=dt,
                             device=device)
    jacobi_diag = None
    if precond == "jacobi":
        # a fixed Jacobi preconditioner from the linear Laplace diagonal:
        # spectrally equivalent for these coefficient-bounded forms
        jacobi_diag = LaplaceOperator(mf).diagonal()
    elif precond != "none":
        raise ValueError(f"unknown precond {precond!r}")
    synchronize(device)
    setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = op.solve(b, u0=u0, rtol=rtol, linear=linear,
                   jacobi_diag=jacobi_diag)
    synchronize(device)
    solve = time.perf_counter() - t0

    x = res.x.cpu().numpy()
    out = {
        "n_dofs": dofs.n_dofs,
        "n_cells": mesh.n_cells,
        "problem": problem,
        "linear": linear,
        "precond": precond,
        "newton_iterations": res.iterations,
        "linear_iterations": res.linear_iterations,
        "residual": res.residual,
        "converged": res.converged,
        "setup_s": setup,
        "solve_s": solve,
    }
    if u_exact is not None:
        out["l2_error"] = float(integrate_difference(
            dofs, x.astype(np.float64), u_exact))
    return out, x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--problem", default="quasilinear",
                    choices=["quasilinear", "minimal-surface"])
    ap.add_argument("--linear", default="cg",
                    choices=["cg", "gmres", "bicgstab"])
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--adaptive-steps", type=int, default=0)
    ap.add_argument("--precond", default="none", choices=["none", "jacobi"])
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    out, _ = run_nonlinear(
        dim=args.dim, degree=args.degree, refine=args.refine,
        problem=args.problem, linear=args.linear,
        rtol=args.rtol, adaptive_steps=args.adaptive_steps, dtype=args.dtype,
        precond=args.precond, device="cpu" if args.cpu else args.device)
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>18}: {v}")
    return None  # console-script exit code


if __name__ == "__main__":
    main()

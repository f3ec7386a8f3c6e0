"""End-to-end Poisson solver application (the reference's ``poisson.cu``).

Port of ``tpufem/apps/poisson.py`` for the uniform hyper_cube and the
curved hyper_shell (``--mesh shell``) on the separable tier: mesh -> Q_p
DoFs -> MatrixFree -> host RHS -> Jacobi-CG on the device -> L2 error
against the manufactured solution.  With ``--pallas`` every operator apply
runs a hand-written CUDA kernel: K2 on the cube, K4 (3D) or K3 (2D) on
the shell.

Run:  tpufem-torch-poisson --dim 3 --degree 4 --refine 5 --pallas \
          --dtype float32 [--mesh shell]
      (python -m tpufem_torch.apps.poisson ...; --device cpu runs the
      plain PyTorch version on the CPU)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import (
    assemble_rhs,
    integrate_difference,
    integrate_errors,
)
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, not_ported, resolve_device
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.timer import Timer


def default_solution(dim: int):
    """Manufactured solution u = prod sin(pi x_a); f = dim pi^2 u."""
    u = lambda x: np.prod(np.sin(np.pi * x), axis=1)
    f = lambda x: dim * np.pi**2 * np.prod(np.sin(np.pi * x), axis=1)
    return u, f


def default_gradient(dim: int):
    """grad of the default manufactured solution, for H1 error output."""

    def g(x):
        out = np.empty_like(x)
        for a in range(dim):
            cols = [np.sin(np.pi * x[:, b]) for b in range(dim)]
            cols[a] = np.cos(np.pi * x[:, a])
            out[:, a] = np.pi * np.prod(cols, axis=0)
        return out

    return g


def dirichlet_setup(op: LaplaceOperator, b: np.ndarray,
                    boundary_values: np.ndarray):
    """Turn an unconstrained RHS into the constrained system's RHS + x0:
      x0 = g on the boundary;  b' = mask * (b - A_raw x0) + (1-mask) x0.
    CG on the constrained operator then keeps constrained values exact."""
    mask = op.mf.interior_mask
    g = torch.as_tensor(boundary_values, dtype=mask.dtype, device=mask.device)
    x0 = (1.0 - mask) * g
    b_dev = torch.as_tensor(b, dtype=mask.dtype, device=mask.device)
    b_con = mask * (b_dev - op.vmult_raw(x0)) + (1.0 - mask) * x0
    return b_con, x0


@dataclasses.dataclass
class PoissonResult:
    n_dofs: int
    n_cells: int
    iterations: int
    l2_error: float
    residual: float
    setup_time: float
    solve_time: float
    solution: np.ndarray
    converged: bool
    dofs: object = None  # DoFHandler (for output writers)
    h1_error: float | None = None  # H1 seminorm, with --h1


def poisson_mesh(dim: int, refine: int, mesh_kind: str = "cube") -> Mesh:
    """The domain of ``solve_poisson``: the unit hyper_cube, or the
    hyper_shell wedge (``Mesh.hyper_shell_2d/3d``, the reference's
    GridGenerator::hyper_shell analogue), refined ``refine`` times."""
    if mesh_kind == "shell":
        return (Mesh.hyper_shell_2d(refine) if dim == 2
                else Mesh.hyper_shell_3d(refine))
    if mesh_kind == "cube":
        return Mesh.hyper_cube(dim, refine)
    raise ValueError(f"mesh_kind must be 'cube' or 'shell', got "
                     f"{mesh_kind!r}")


def poisson_operator(dim: int, degree: int, refine: int, dtype: str,
                     use_pallas: bool, device: torch.device | str,
                     scatter: str = "separable",
                     coefficient: Optional[Callable] = None,
                     pallas_mode: str = "f32",
                     mesh_kind: str = "cube",
                     coefficient_axes: Optional[list] = None
                     ) -> LaplaceOperator:
    """The Laplace operator of ``solve_poisson``: Q_degree on
    ``poisson_mesh(dim, refine, mesh_kind)``, with the kernels attached
    under ``use_pallas`` (the resident kernel in ``pallas_mode``).
    ``coefficient_axes`` is forwarded to ``MatrixFree.build`` (a separable
    variable coefficient, the operator of the K4 terms tier)."""
    mesh = poisson_mesh(dim, refine, mesh_kind)
    dofs = DoFHandler(mesh, degree)
    cfg = FemConfig(dim=dim, degree=degree, scatter=scatter, dtype=dtype,
                    use_pallas=use_pallas, pallas_mode=pallas_mode)
    return LaplaceOperator(MatrixFree.build(
        mesh, dofs, cfg, device, coefficient=coefficient,
        coefficient_axes=coefficient_axes))


def solve_poisson(
    dim: int = 2,
    degree: int = 1,
    refine: int = 3,
    scatter: str = "separable",
    dtype: str = "float64",
    coefficient: Optional[Callable] = None,
    adaptive_steps: int = 0,
    rtol: float | None = None,
    exact=None,
    rhs=None,
    use_pallas: bool = False,
    warm: bool = False,
    shards=None,
    precond: str = "jacobi",
    h1: bool = False,
    mesh_kind: str = "cube",
    device: torch.device | str = "cuda",
) -> PoissonResult:
    """Jacobi-CG Poisson solve on the uniform hyper_cube or hyper_shell
    (``mesh_kind``), separable tier.  On the shell the default
    manufactured solution gives inhomogeneous Dirichlet data.

    Arguments keep the JAX package's names; the ones this slice has not
    ported raise NotImplementedError naming their ROADMAP.md item.
    """
    device = resolve_device(device)
    if shards is not None:
        raise not_ported("--shards", "distributed")
    if precond != "jacobi":
        raise not_ported(f"--precond {precond}", "GMG plus resident_gmg_cg")
    if adaptive_steps:
        raise not_ported("--adaptive-steps",
                         "incidence, colored and dense with hanging nodes")
    if h1 and exact is not None:
        raise ValueError("--h1 supports the default manufactured "
                         "solution only (no gradient for a custom exact)")
    if rtol is None:
        # f32 CG cannot reach f64-grade residuals; pick a reachable default
        rtol = 1e-10 if dtype == "float64" else 1e-6
    timer = Timer(device)
    with timer.section("setup"):
        op = poisson_operator(dim, degree, refine, dtype, use_pallas,
                              device, scatter, coefficient,
                              mesh_kind=mesh_kind)
        mesh, dofs = op.mf.mesh, op.mf.dofs
        diag = op.diagonal()
        u_exact, f = default_solution(dim)
        if exact is not None:
            u_exact = exact
        if rhs is not None:
            f = rhs
        b = assemble_rhs(dofs, f)
        g = np.zeros(dofs.n_dofs)
        bv = dofs.boundary_mask
        if np.any(bv):
            g[bv] = u_exact(dofs.dof_coords[bv])
        b_con, x0 = dirichlet_setup(op, b, g)

    inv_diag = 1.0 / diag
    solve = lambda: cg_solve(op.vmult, b_con, M_inv=lambda r: inv_diag * r,
                             x0=x0, rtol=rtol)
    if warm:
        solve()  # first run pays the one-time costs; time the second
    with timer.section("solve"):
        res = solve()
        x = res.x.cpu().numpy()
    if not res.converged:
        import sys

        print(f"WARNING: CG did not converge in {res.iterations} iterations "
              f"(residual {res.residual:.3e}); best iterate returned",
              file=sys.stderr)

    h1_err = None
    if h1:
        err, h1_err = integrate_errors(dofs, x.astype(np.float64), u_exact,
                                       default_gradient(dim))
    else:
        err = integrate_difference(dofs, x.astype(np.float64), u_exact)
    return PoissonResult(
        n_dofs=dofs.n_dofs, n_cells=mesh.n_cells, iterations=res.iterations,
        l2_error=err, residual=res.residual,
        setup_time=timer.totals["setup"], solve_time=timer.totals["solve"],
        solution=x, converged=res.converged,
        dofs=dofs, h1_error=h1_err)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--refine", type=int, default=3)
    ap.add_argument("--mesh", default="cube", choices=["cube", "shell"],
                    help="domain: the unit hyper_cube or the curved "
                         "hyper_shell wedge")
    ap.add_argument("--scatter", default="separable",
                    choices=["auto", "incidence", "colored", "structured",
                             "dense", "separable", "boxes"],
                    help="apply tier (only 'separable' is ported)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--adaptive-steps", type=int, default=0)
    ap.add_argument("--amr", type=int, default=0, metavar="CYCLES",
                    help="solve->estimate->mark->refine loop (not ported)")
    ap.add_argument("--amr-fraction", type=float, default=0.3)
    ap.add_argument("--shards", default=None,
                    help="distributed solve (not ported)")
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "chebyshev", "gmg", "gmg-bf16"])
    ap.add_argument("--pallas", action="store_true",
                    help="apply the operator with the hand-written CUDA "
                         "kernel (the JAX package's Pallas flag)")
    ap.add_argument("--h1", action="store_true",
                    help="also report the H1 seminorm error")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON metrics line")
    ap.add_argument("--vtu", metavar="PATH",
                    help="write the solution as a VTU file")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    ap.add_argument("--warm", action="store_true",
                    help="run the solve twice and time the second")
    args = ap.parse_args(argv)
    if args.amr:
        raise not_ported("--amr", "incidence, colored and dense with "
                         "hanging nodes")
    r = solve_poisson(
        dim=args.dim, degree=args.degree, refine=args.refine,
        scatter=args.scatter, dtype=args.dtype,
        adaptive_steps=args.adaptive_steps, use_pallas=args.pallas,
        warm=args.warm, shards=args.shards, precond=args.precond,
        h1=args.h1, mesh_kind=args.mesh,
        device="cpu" if args.cpu else args.device,
    )
    if args.vtu:
        from tpufem_torch.utils.output import write_vtu

        write_vtu(args.vtu, r.dofs, {"u": r.solution})
    if args.json:
        line = {"n_dofs": r.n_dofs, "n_cells": r.n_cells,
                "iterations": r.iterations, "l2_error": r.l2_error,
                "setup_time": r.setup_time, "solve_time": r.solve_time}
        if r.h1_error is not None:
            line["h1_error"] = r.h1_error
        print(json.dumps(line))
    else:
        print(f"cells:      {r.n_cells}")
        print(f"dofs:       {r.n_dofs}")
        print(f"setup:      {r.setup_time:.3f} s")
        print(f"solve:      {r.solve_time:.3f} s   ({r.iterations} CG iters)")
        print(f"L2 error:   {r.l2_error:.6e}")
        if r.h1_error is not None:
            print(f"H1 error:   {r.h1_error:.6e}")
    return None  # console-script exit code


if __name__ == "__main__":
    main()

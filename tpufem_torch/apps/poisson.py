"""End-to-end Poisson solver application (the reference's ``poisson.cu``).

Port of ``tpufem/apps/poisson.py``: mesh -> Q_p DoFs -> hanging-node
constraints (adaptive meshes) -> MatrixFree -> host RHS -> CG (Jacobi or
Chebyshev, ``--precond``) on the device -> L2 error against the
manufactured solution, on the hyper_cube, the curved hyper_shell
(``--mesh shell``), a refined mesh (``--adaptive-steps``) or a caller's
mesh (``solve_poisson(mesh=...)``), and the solve -> estimate -> mark ->
refine loop (``--amr``).  The tier
defaults to ``auto`` (structured on uniform meshes, incidence otherwise);
with ``--pallas`` it is the separable tier, and every operator apply runs
a hand-written CUDA kernel: K2 on the cube, K4 (3D) or K3 (2D) on the
shell.  The other tiers run no kernel and refuse ``--pallas``.
``--scatter boxes`` runs the CG on the adaptive box tier's patchwork
vector, where ``--precond gmg`` (or ``gmg-bf16``) preconditions it with
the adaptive geometric multigrid V-cycle.

Run:  tpufem-torch-poisson --dim 3 --degree 4 --refine 5 --dtype float32 \
          [--mesh shell] [--pallas]
      tpufem-torch-poisson --dim 2 --degree 2 --refine 2 --amr 4
      tpufem-torch-poisson --dim 3 --degree 2 --refine 2 \
          --adaptive-steps 2 --scatter boxes --precond gmg
      (python -m tpufem_torch.apps.poisson ...; --device cpu runs on the
      CPU)
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
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.estimator import kelly_estimate, mark_fixed_fraction
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, not_ported, resolve_device
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.chebyshev import (
    chebyshev_smooth,
    make_chebyshev_params,
)
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
      x0 = g on the boundary (hanging DoFs interpolated from it);
      b' = mask * C^T (b - A_raw x0) + (1-mask) x0.
    CG on the constrained operator then keeps constrained values exact."""
    mf = op.mf
    mask = mf.interior_mask
    g = torch.as_tensor(boundary_values, dtype=mask.dtype, device=mask.device)
    x0 = mf.distribute((1.0 - mask) * g)
    b_dev = torch.as_tensor(b, dtype=mask.dtype, device=mask.device)
    b1 = mf.distribute_transpose(b_dev - op.vmult_raw(x0))
    b_con = mask * b1 + (1.0 - mask) * x0
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
    eta: float | None = None  # global Kelly estimate (AMR loop)


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


def refine_toward_ball(mesh: Mesh, steps: int, center: float,
                       radius: float) -> Mesh:
    """``mesh`` refined ``steps`` times: each round refines the cells whose
    centre lies within ``radius`` of the point (center, ..., center) in
    coordinates scaled to the unit box."""
    for _ in range(steps):
        centers = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
        mesh = mesh.refine(np.linalg.norm(centers - center, axis=1) < radius)
    return mesh


def adaptive_mesh(dim: int, refine: int, steps: int, center: float = 0.31,
                  radius: float = 0.35) -> Mesh:
    """Uniform base + ``steps`` rounds of refinement toward a ball: the
    JAX package's adaptive benchmark mesh (``tpufem/apps/bmop.py``)."""
    return refine_toward_ball(Mesh.hyper_cube(dim, refine), steps, center,
                              radius)


def poisson_operator(dim: int, degree: int, refine: int, dtype: str,
                     use_pallas: bool, device: torch.device | str,
                     scatter: str = "separable",
                     coefficient: Optional[Callable] = None,
                     pallas_mode: str = "f32",
                     mesh_kind: str = "cube",
                     coefficient_axes: Optional[list] = None,
                     mesh: Mesh | None = None) -> LaplaceOperator:
    """The Laplace operator of ``solve_poisson``: Q_degree on ``mesh``, or
    on ``poisson_mesh(dim, refine, mesh_kind)``, with hanging-node
    constraints where the mesh is not uniform and the kernels attached
    under ``use_pallas`` (the resident kernel in ``pallas_mode``).
    ``coefficient_axes`` is forwarded to ``MatrixFree.build`` (a separable
    variable coefficient, the operator of the K4 terms tier)."""
    if mesh is None:
        mesh = poisson_mesh(dim, refine, mesh_kind)
    dofs = DoFHandler(mesh, degree)
    constraints = (None if mesh.is_uniform
                   else make_hanging_node_constraints(dofs))
    cfg = FemConfig(dim=dim, degree=degree, scatter=scatter, dtype=dtype,
                    use_pallas=use_pallas, pallas_mode=pallas_mode)
    return LaplaceOperator(MatrixFree.build(
        mesh, dofs, cfg, device, coefficient=coefficient,
        constraints=constraints, coefficient_axes=coefficient_axes))


def solve_poisson(
    dim: int = 2,
    degree: int = 1,
    refine: int = 3,
    scatter: str = "auto",
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
    mesh: Mesh | None = None,
    device: torch.device | str = "cuda",
) -> PoissonResult:
    """CG Poisson solve on ``poisson_mesh(dim, refine, mesh_kind)``
    refined ``adaptive_steps`` times toward the ball of radius 0.3 about
    the centre, or on ``mesh`` (``refine``/``mesh_kind`` then ignored).
    A non-uniform mesh gets hanging-node constraints.  On the shell the
    default manufactured solution gives inhomogeneous Dirichlet data.
    ``scatter="boxes"`` runs the whole solve on the box tier's patchwork
    vector (``_solve_poisson_boxes``).  ``precond``: "jacobi", or
    "chebyshev" (a Chebyshev polynomial of the Jacobi-scaled operator);
    "gmg" (the adaptive global-coarsening V-cycle) and "gmg-bf16" (the
    same V-cycle in bf16 under the CG's dtype) belong to the box tier.

    Arguments keep the JAX package's names, resolved in its order;
    ``shards`` is not ported yet and raises NotImplementedError naming
    its ROADMAP.md item.
    """
    device = resolve_device(device)
    if h1 and exact is not None:
        raise ValueError("--h1 supports the default manufactured "
                         "solution only (no gradient for a custom exact)")
    if shards is not None and scatter not in ("auto", "boxes"):
        raise ValueError("--shards runs the distributed box tier; use "
                         "scatter auto/boxes")
    if shards is not None:
        raise not_ported("--shards", "distributed")
    if rtol is None:
        # f32 CG cannot reach f64-grade residuals; pick a reachable default
        rtol = 1e-10 if dtype == "float64" else 1e-6
    timer = Timer(device)
    with timer.section("setup"):
        if mesh is None:
            mesh = poisson_mesh(dim, refine, mesh_kind)
        mesh = refine_toward_ball(mesh, adaptive_steps, 0.5, 0.3)
    if scatter == "boxes":
        if use_pallas:
            raise ValueError("use_pallas attaches kernels only in the "
                             "separable scheme, not scatter='boxes'")
        return _solve_poisson_boxes(mesh, degree, coefficient, dtype, rtol,
                                    exact, rhs, warm, precond, h1, device,
                                    timer)
    if precond in ("gmg", "gmg-bf16"):
        raise ValueError(
            "--precond gmg pairs with the box tier (--scatter boxes / "
            "adaptive meshes) or the poisson_mg app for uniform meshes")
    with timer.section("setup"):
        op = poisson_operator(dim, degree, refine, dtype, use_pallas, device,
                              scatter, coefficient, mesh=mesh)
        dofs = op.mf.dofs
        diag = op.diagonal()
        u_exact, b, g = _manufactured_rhs(dofs, exact, rhs)
        b_con, x0 = dirichlet_setup(op, b, g)

    inv_diag = 1.0 / diag
    M_inv = lambda r: inv_diag * r
    if precond == "chebyshev":
        # one Chebyshev polynomial of D^-1 A as the preconditioner (the
        # reference's PreconditionChebyshev)
        cp = make_chebyshev_params(op.vmult, diag, dofs.n_dofs)
        M_inv = lambda r: chebyshev_smooth(op.vmult, inv_diag, cp, r)
    solve = lambda: cg_solve(op.vmult, b_con, M_inv=M_inv, x0=x0, rtol=rtol)
    if warm:
        solve()  # first run pays the one-time costs; time the second
    with timer.section("solve"):
        res = solve()
        x = op.mf.distribute(res.x).cpu().numpy()
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


def _manufactured_rhs(dofs, exact, rhs):
    """The exact solution, the assembled RHS and the Dirichlet values of
    a solve: the default manufactured solution unless given."""
    u_exact, f = default_solution(dofs.mesh.dim)
    if exact is not None:
        u_exact = exact
    if rhs is not None:
        f = rhs
    b = assemble_rhs(dofs, f)
    g = np.zeros(dofs.n_dofs)
    bv = dofs.boundary_mask
    if np.any(bv):
        g[bv] = u_exact(dofs.dof_coords[bv])
    return u_exact, b, g


def _solve_poisson_boxes(mesh, degree, coefficient, dtype, rtol, exact,
                         rhs, warm, precond, h1, device, timer):
    """Poisson solve on the box tier: the whole CG runs on the patchwork
    vector (``ops.boxes``), with the Dirichlet setup in patch space.
    ``precond`` "gmg" preconditions it with the adaptive V-cycle
    (``solvers.box_multigrid``) on the solve's operator and diagonal;
    "gmg-bf16" builds that hierarchy in bf16 under the solve's operator
    (its finest defects in the solve's dtype)."""
    from tpufem_torch.ops.boxes import BoxLaplaceOperator
    from tpufem_torch.solvers.box_multigrid import BoxMultigrid

    with timer.section("setup"):
        dofs = DoFHandler(mesh, degree)
        constraints = (None if mesh.is_uniform
                       else make_hanging_node_constraints(dofs))
        op = BoxLaplaceOperator(mesh, dofs, constraints=constraints,
                                coefficient=coefficient, dtype=dtype,
                                device=device)
        u_exact, b, g = _manufactured_rhs(dofs, exact, rhs)
        # dirichlet_setup's algebra, in patch space
        m = op.interior_mask
        x0 = op.distribute((1.0 - m) * op.to_patch(g), homogeneous=False)
        b1 = op.distribute_transpose(op.to_patch(b) - op.vmult_raw(x0))
        b_con = m * b1 + (1.0 - m) * x0
        diag = op.diagonal()
        mg = None
        if precond == "gmg-bf16":
            mg = BoxMultigrid(mesh, dofs, constraints=constraints,
                              coefficient=coefficient, dtype="bfloat16",
                              solve_op=op, device=device)
        elif precond == "gmg":
            mg = BoxMultigrid(mesh, dofs, constraints=constraints,
                              coefficient=coefficient, dtype=dtype,
                              fine_op=op, fine_diag=diag, device=device)
    if mg is not None:
        solve = lambda: mg.cg_solve(b_con, x0=x0, rtol=rtol)
    else:
        solve = lambda: op.cg_solve(b_con, diag, x0=x0, rtol=rtol,
                                    precond=precond)
    if warm:
        solve()  # first run pays the one-time costs; time the second
    with timer.section("solve"):
        res = solve()
        x = op.from_patch(op.distribute(res.x, homogeneous=False))
    if not res.converged:
        import sys

        print(f"WARNING: CG did not converge in {res.iterations} iterations "
              f"(residual {res.residual:.3e})", file=sys.stderr)
    h1_err = None
    if h1:
        err, h1_err = integrate_errors(dofs, x, u_exact,
                                       default_gradient(mesh.dim))
    else:
        err = integrate_difference(dofs, x, u_exact)
    return PoissonResult(
        n_dofs=dofs.n_dofs, n_cells=mesh.n_cells, iterations=res.iterations,
        l2_error=err, residual=res.residual,
        setup_time=timer.totals["setup"], solve_time=timer.totals["solve"],
        solution=x, converged=res.converged, dofs=dofs, h1_error=h1_err)


def solve_poisson_amr(dim: int = 2, degree: int = 1, refine: int = 2,
                      cycles: int = 5, fraction: float = 0.3,
                      mesh_kind: str = "cube", exact=None, rhs=None,
                      **kwargs) -> list[PoissonResult]:
    """Solve -> estimate -> mark -> refine loop (deal.II step-6): runs
    ``cycles`` solves on ``poisson_mesh(dim, refine, mesh_kind)``,
    refining the top ``fraction`` of cells by Kelly indicator between
    them.  Returns one PoissonResult per cycle with ``eta`` the global
    estimate sqrt(sum eta_K^2).  kwargs pass through to solve_poisson
    (scatter, dtype, device, ...)."""
    mesh = poisson_mesh(dim, refine, mesh_kind)
    results = []
    for cycle in range(cycles):
        r = solve_poisson(dim=dim, degree=degree, mesh=mesh, exact=exact,
                          rhs=rhs, **kwargs)
        eta = kelly_estimate(r.dofs, r.solution.astype(np.float64))
        r.eta = float(np.sqrt((eta**2).sum()))
        results.append(r)
        if cycle < cycles - 1:
            mesh = mesh.refine(mark_fixed_fraction(eta, fraction))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--refine", type=int, default=3)
    ap.add_argument("--mesh", default="cube", choices=["cube", "shell"],
                    help="domain: the unit hyper_cube or the curved "
                         "hyper_shell wedge")
    ap.add_argument("--scatter", default="auto",
                    choices=["auto", "incidence", "colored", "structured",
                             "dense", "separable", "boxes"],
                    help="apply tier ('boxes': the adaptive box tier, "
                         "whose CG runs on the patchwork vector)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--adaptive-steps", type=int, default=0)
    ap.add_argument("--amr", type=int, default=0, metavar="CYCLES",
                    help="solve->estimate->mark->refine loop: run CYCLES "
                         "solves, refining by Kelly indicator between them")
    ap.add_argument("--amr-fraction", type=float, default=0.3,
                    help="fraction of cells refined per AMR cycle")
    ap.add_argument("--shards", default=None,
                    help="distributed solve (not ported)")
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "chebyshev", "gmg", "gmg-bf16"],
                    help="CG preconditioner (gmg = the adaptive global-"
                         "coarsening V-cycle, gmg-bf16 = the same V-cycle "
                         "in bf16 under the CG's dtype: both with "
                         "--scatter boxes)")
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
    device = "cpu" if args.cpu else args.device
    if args.amr:
        rs = solve_poisson_amr(
            dim=args.dim, degree=args.degree, refine=args.refine,
            cycles=args.amr, fraction=args.amr_fraction,
            mesh_kind=args.mesh, scatter=args.scatter, dtype=args.dtype,
            use_pallas=args.pallas, shards=args.shards,
            precond=args.precond, h1=args.h1, device=device)
        if args.json:
            for c, r in enumerate(rs):
                line = {"cycle": c, "n_cells": r.n_cells,
                        "n_dofs": r.n_dofs, "iterations": r.iterations,
                        "l2_error": r.l2_error, "eta": r.eta,
                        "solve_time": r.solve_time}
                if r.h1_error is not None:
                    line["h1_error"] = r.h1_error
                print(json.dumps(line))
        else:
            print(f"{'cycle':>5} {'cells':>9} {'dofs':>10} {'iters':>6} "
                  f"{'L2 error':>12} {'eta':>12}")
            for c, r in enumerate(rs):
                print(f"{c:>5} {r.n_cells:>9} {r.n_dofs:>10} "
                      f"{r.iterations:>6} {r.l2_error:>12.4e} "
                      f"{r.eta:>12.4e}")
        if args.vtu:
            from tpufem_torch.utils.output import write_vtu

            write_vtu(args.vtu, rs[-1].dofs, {"u": rs[-1].solution})
        return None
    r = solve_poisson(
        dim=args.dim, degree=args.degree, refine=args.refine,
        scatter=args.scatter, dtype=args.dtype,
        adaptive_steps=args.adaptive_steps, use_pallas=args.pallas,
        warm=args.warm, shards=args.shards, precond=args.precond,
        h1=args.h1, mesh_kind=args.mesh, device=device,
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

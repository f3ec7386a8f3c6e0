"""Poisson solver with geometric-multigrid-preconditioned CG.

Port of ``tpufem/apps/poisson_mg.py``, the reference's ``poisson_mg.cu``
(SURVEY.md §3.5): CG preconditioned by a V-cycle with Chebyshev smoothing
on every level and sum-factorised level transfer — BASELINE config 5
(a variable coefficient and the Chebyshev-smoothed GMG V-cycle CG).  The
levels run the default tier (``auto``: structured on the hyper_cube);
``GeometricMultigrid(use_pallas=True)`` with ``resident_gmg_cg`` is the
kernels' path.

Run:  tpufem-torch-poisson-mg --dim 2 --degree 2 --refine 5
      (python -m tpufem_torch.apps.poisson_mg ...; --device cpu runs on
      the CPU)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpufem_torch.apps.poisson import default_solution, dirichlet_setup
from tpufem_torch.fem.assemble import assemble_rhs, integrate_difference
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.multigrid import GeometricMultigrid
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import Timer


def solve_poisson_mg(
    dim: int = 2,
    degree: int = 2,
    refine: int = 5,
    coarsest: int = 1,
    dtype: str = "float64",
    smoother_degree: int = 4,
    coefficient=None,
    rtol: float | None = None,
    warm: bool = False,
    precond_dtype: str | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """GMG-preconditioned CG on the hyper_cube.

    precond_dtype: run the whole V-cycle hierarchy in a lower precision
    (e.g. "bfloat16") while the outer CG and its operator stay in
    ``dtype``; the preconditioner's precision moves the iteration count,
    not the attainable accuracy.  ``warm``: solve twice and time the
    second.
    """
    device = resolve_device(device)
    torch_dtype(dtype)  # raises on an unknown name
    if rtol is None:
        rtol = 1e-10 if dtype == "float64" else 1e-6
    timer = Timer(device)
    with timer.section("setup"):
        gmg = GeometricMultigrid(
            dim=dim, degree=degree, finest_refine=refine,
            coarsest_refine=coarsest, dtype=precond_dtype or dtype,
            smoother_degree=smoother_degree, coefficient=coefficient,
            device=device)
        if precond_dtype is not None and precond_dtype != dtype:
            # the outer operator runs in the solve dtype, on the fine
            # level's host data
            mf = MatrixFree.build(gmg.fine.mf.mesh, gmg.fine.mf.dofs,
                                  FemConfig(dim=dim, degree=degree,
                                            dtype=dtype),
                                  device, coefficient=coefficient)
            op = LaplaceOperator(mf)
            solve_dt, pre_dt = torch_dtype(dtype), torch_dtype(precond_dtype)
            vcycle = gmg.preconditioner()
            precond = lambda r: vcycle(r.to(pre_dt)).to(solve_dt)
        else:
            op = gmg.fine.op
            precond = gmg.preconditioner()
        dofs = op.mf.dofs
        u_exact, f = default_solution(dim)
        b = assemble_rhs(dofs, f)
        g = np.zeros(dofs.n_dofs)
        bv = dofs.boundary_mask
        g[bv] = u_exact(dofs.dof_coords[bv])
        b_con, x0 = dirichlet_setup(op, b, g)

    solve = lambda: cg_solve(op.vmult, b_con, M_inv=precond, x0=x0,
                             rtol=rtol)
    if warm:
        solve()  # first run pays the one-time costs; time the second
    with timer.section("solve"):
        res = solve()
        x = res.x.cpu().numpy()
    if not res.converged:
        print(f"WARNING: GMG-CG did not converge in {res.iterations} "
              f"iterations (residual {res.residual:.3e})", file=sys.stderr)
    err = integrate_difference(dofs, x.astype(np.float64), u_exact)
    return {
        "n_dofs": dofs.n_dofs,
        "iterations": res.iterations,
        "residual": res.residual,
        "l2_error": err,
        "setup_time": timer.totals["setup"],
        "solve_time": timer.totals["solve"],
        "solution": x,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refine", type=int, default=5)
    ap.add_argument("--coarsest", type=int, default=1)
    ap.add_argument("--smoother-degree", type=int, default=4)
    ap.add_argument("--variable-coefficient", action="store_true")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--precond-dtype", default=None,
                    choices=["float64", "float32", "bfloat16"],
                    help="run the V-cycle in this dtype (e.g. bfloat16) "
                         "while the outer CG stays in --dtype")
    ap.add_argument("--warm", action="store_true",
                    help="time the second solve (steady state)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    coef = None
    if args.variable_coefficient:
        coef = lambda x: 1.0 + np.sum(x**2, axis=1)
    r = solve_poisson_mg(
        dim=args.dim, degree=args.degree, refine=args.refine,
        coarsest=args.coarsest, smoother_degree=args.smoother_degree,
        coefficient=coef, dtype=args.dtype, warm=args.warm,
        precond_dtype=args.precond_dtype, device=args.device,
    )
    print(f"dofs:       {r['n_dofs']}")
    print(f"setup:      {r['setup_time']:.3f} s")
    print(f"solve:      {r['solve_time']:.3f} s   "
          f"({r['iterations']} CG iters)")
    print(f"L2 error:   {r['l2_error']:.6e}")
    return None  # console-script exit code


if __name__ == "__main__":
    main()

"""Time-dependent heat equation with checkpoint and resume.

Port of ``tpufem/apps/heat.py``: implicit-Euler stepping of u_t = Δu on
the unit hyper_cube with zero Dirichlet data and u0 = prod sin(pi x_a),
each step solving (M + dt K) u^{n+1} = M u^n with CG, with periodic
checkpoints and an exact resume (SURVEY.md §5).

Two tiers:
- the generic-functor tier (``operators.generic``: ``mass_operator``,
  ``helmholtz_operator`` on the incidence cell loop) with plain CG;
- ``--resident``, the tensor-product tier (``operators.tensor_product``):
  M and M + dt K factor exactly on the uniform grid, so each step's mass
  apply and Helmholtz Jacobi-CG (``solvers.resident.resident_jacobi_cg``)
  run on K4 in 3D (K3 in 2D), the hand-written CUDA kernel of the terms
  plan.  Its MatrixFree is the separable scheme's (no cell tables, no
  kernel of its own); the operators attach the kernels;
- ``--shards N``, the generic tier distributed over an in-process shard
  mesh (``parallel.general``: the mass and Helmholtz functors on the
  general partitioner, unpreconditioned CG); the state stays sharded
  across steps, and checkpoints are written in global numbering.

Run:  tpufem-torch-heat --dim 3 --degree 4 --refine 6 --dt 1e-4 \\
          --steps 5 --dtype float32 --resident
      tpufem-torch-heat --dim 2 --degree 2 --refine 4 --steps 20 \\
          --checkpoint-every 10 --checkpoint ck.npz --device cpu
      (resume: ... --resume ck.npz; python -m tpufem_torch.apps.heat)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpufem_torch.fem.assemble import integrate_difference
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.generic import helmholtz_operator, mass_operator
from tpufem_torch.operators.tensor_product import (
    helmholtz_tensor_operator,
    mass_tensor_operator,
)
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.output import load_checkpoint, save_checkpoint
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import synchronize


def run_heat(dim=2, degree=2, refine=4, dt=1e-3, steps=20, dtype="float64",
             checkpoint=None, checkpoint_every=0, resume=None, rtol=None,
             shards=None, resident=False,
             device: torch.device | str = "cuda"):
    """``resident``: the tensor-product tier, every step's mass apply and
    Helmholtz Jacobi-CG through K4 (3D) or K3 (2D) on a CUDA device, their
    plain versions on the CPU.  ``shards``: the generic tier distributed
    over that many shards (``parallel.general``); it excludes
    ``resident``, as in the JAX package.

    Returns a dict: n_dofs, steps, t_end, l2_error, u (numpy), and the
    run's setup_s, solve_s and the CG iterations of each step."""
    cdt = torch_dtype(dtype)
    device = resolve_device(device)
    if rtol is None:
        rtol = 1e-10 if dtype == "float64" else 1e-6
    if resident and shards:
        raise ValueError("--resident is a single-device fast path; "
                         "combine with --shards is not supported")
    t0 = time.perf_counter()
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, degree)
    # the reference builds an incidence MatrixFree for both tiers; the
    # tensor-product tier reads none of its cell tables, so the resident
    # run takes the separable scheme, whose setup is the 1D operators
    cfg = FemConfig(dim=dim, degree=degree, dtype=dtype,
                    scatter="separable" if resident else "incidence")
    mf = MatrixFree.build(mesh, dofs, cfg, device)
    mask = mf.interior_mask
    if resident:
        A = helmholtz_tensor_operator(mf, alpha=1.0, beta=dt,
                                      use_pallas=True)
        M = mass_tensor_operator(mf, use_pallas=True)
        diag = A.diagonal()
    else:
        M = mass_operator(mf)
        A = helmholtz_operator(mf, alpha=1.0, beta=dt)  # M + dt K

    # exact solution of u_t = Δu with u0 = prod sin(pi x): decay rate
    # lam = dim * pi^2, zero Dirichlet
    u0_fn = lambda x: np.prod(np.sin(np.pi * x), axis=1)
    lam = dim * np.pi**2

    # run metadata saved with every checkpoint; resuming with another
    # config (even one with the same n_dofs) is an error
    meta = dict(dim=dim, degree=degree, refine=refine, dt=dt, dtype=dtype)
    start = 0
    if resume:
        if not os.path.exists(resume):
            raise FileNotFoundError(f"--resume checkpoint not found: {resume}")
        z = load_checkpoint(resume)
        for k, v in meta.items():
            if k in z and str(z[k]) != str(v):
                raise ValueError(
                    f"checkpoint {resume} was written with {k}={z[k]}, "
                    f"resuming with {k}={v}")
        u = torch.as_tensor(z["u"], dtype=cdt, device=device)
        start = int(z["step"])
    else:
        # nodal interpolation of u0
        u = torch.as_tensor(mask.cpu().to(torch.float64).numpy()
                            * u0_fn(dofs.dof_coords), dtype=cdt,
                            device=device)
    synchronize(device)
    setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    iterations = []
    if shards:
        u = _step_distributed(mf, dt, u, start, steps, int(shards), rtol,
                              iterations, checkpoint, checkpoint_every,
                              meta)
    else:
        for n in range(start, steps):
            if resident:
                # u is masked, so the constrained mass apply equals
                # mask * M u
                rhs = M.vmult(u)
                res = resident_jacobi_cg(A, rhs, diag=diag, rtol=rtol, x0=u)
            else:
                rhs = mask * M.vmult_raw(u)
                res = cg_solve(A.vmult, rhs, x0=u, rtol=rtol)
            if not res.converged:
                print(f"WARNING: step {n}: CG did not converge (residual "
                      f"{res.residual:.3e})", file=sys.stderr)
            iterations.append(res.iterations)
            u = mask * res.x
            if (checkpoint and checkpoint_every
                    and (n + 1) % checkpoint_every == 0):
                save_checkpoint(checkpoint, u=u.cpu().numpy(),
                                step=np.int64(n + 1), **meta)
    synchronize(device)
    solve = time.perf_counter() - t0
    t_end = steps * dt
    exact = lambda x: np.exp(-lam * t_end) * u0_fn(x)
    u_host = u.cpu().numpy()
    err = integrate_difference(dofs, u_host.astype(np.float64), exact)
    return {"n_dofs": dofs.n_dofs, "steps": steps, "t_end": t_end,
            "l2_error": err, "u": u_host, "setup_s": setup,
            "solve_s": solve, "iterations": iterations}


def _step_distributed(mf, dt, u, start, steps, shards, rtol, iterations,
                      checkpoint, checkpoint_every, meta) -> torch.Tensor:
    """Steps ``start..steps`` on the general partitioner over ``shards``
    shards: each step's RHS the distributed mass apply, its solve the
    distributed unpreconditioned CG from the previous state; the state
    stays sharded, checkpoints go out in global numbering.  Appends each
    step's iterations; returns the final u (global, on mf's device)."""
    from tpufem_torch.parallel.general import (
        GeneralDistributedOperator,
        GeneralPartitioner,
    )

    part = GeneralPartitioner.build(mf, shards)
    A_d = GeneralDistributedOperator(
        part, quad_op=lambda vals, grads, ctx: (vals, dt * grads))
    M_d = GeneralDistributedOperator(
        part, quad_op=lambda vals, grads, ctx: (vals, None),
        needs_gradients=False, device_mesh=A_d.mesh)
    d_l = A_d.put_vector(np.ones(mf.n_dofs))  # unpreconditioned
    u_l = A_d.put_vector(u.cpu().to(torch.float64).numpy())
    for n in range(start, steps):
        # u is masked, so the constrained apply's identity part is 0 and
        # this equals mask * M.vmult_raw(u)
        rhs_l = M_d.vmult(u_l)
        res = A_d.cg_solve_local(rhs_l, d_l, x0_local=u_l, rtol=rtol)
        if not res.converged:
            print(f"WARNING: step {n}: distributed CG did not converge "
                  f"(residual {res.residual:.3e})", file=sys.stderr)
        iterations.append(res.iterations)
        u_l = res.x
        if checkpoint and checkpoint_every and (n + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint, u=part.to_global(u_l),
                            step=np.int64(n + 1), **meta)
    return torch.as_tensor(part.to_global(u_l), dtype=u.dtype,
                           device=u.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--shards", type=int, default=None,
                    help="distributed stepping over an in-process shard "
                         "mesh (the generic tier on the general "
                         "partitioner)")
    ap.add_argument("--resident", action="store_true",
                    help="tensor-product tier: every step's mass apply and "
                         "Helmholtz CG through the terms kernel (K4 in 3D, "
                         "K3 in 2D)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    r = run_heat(
        dim=args.dim, degree=args.degree, refine=args.refine, dt=args.dt,
        steps=args.steps, dtype=args.dtype, checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        shards=args.shards, resident=args.resident,
        device="cpu" if args.cpu else args.device)
    print(f"dofs: {r['n_dofs']}  steps: {r['steps']}  t_end: {r['t_end']}")
    print(f"L2 error vs analytic decay: {r['l2_error']:.6e}")
    print(f"setup: {r['setup_s']:.3f} s  solve: {r['solve_s']:.3f} s  "
          f"CG iterations: {r['iterations']}")
    return None  # console-script exit code


if __name__ == "__main__":
    main()

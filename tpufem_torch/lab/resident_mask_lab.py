"""Card A/B: the flat against the fused Dirichlet mask in the resident
Jacobi-CG.

Port of ``scripts/resident_mask_lab.py``.  The resident CG's operator is
y = m·A(m·x) + (1-m)·x.  The flat variant applies the two masks around
the kernel, elementwise passes over the whole resident layout each
apply; ``MatrixFree.build(..., pallas_dirichlet=True)`` gives K1 the
masked 1D tables instead (D M D), and the kernel stores a boundary
point's input (``ops/kernel_separable.py::ResidentSeparable``).  Both
variants solve the same ``rng(42)`` right-hand side with
``resident_jacobi_cg``, once warm and once timed (the device synchronised
before and after), and the lab prints one JSON line per variant and a
verdict line with the reference's keys (``speedup``,
``same_iterations``, ``recommend_fused``: a speedup above 1.02 at equal
iterations).

``mode="bf16"`` (the reference's default) runs K1's f32 instance in this
port: the kernel has no matmul to split into bf16x3 (ROADMAP queue 3, a
known divergence); each line names the instance that ran.  A
configuration without a resident kernel raises, as the reference's
``SystemExit`` does.

Run:  python -m tpufem_torch.lab.resident_mask_lab [--refine 6]
      [--mode bf16] [--rtol 1e-5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.timer import synchronize


def run(refine: int = 6, mode: str = "bf16", rtol: float = 1e-5,
        dtype: str = "float32", device: torch.device | str = "cuda",
        log=print) -> dict:
    """Both variants at 3D Q4 ``refine``; returns {"flat": record,
    "fused": record, "verdict": record, "x": {variant: flat solution}}."""
    device = resolve_device(device)
    dim, p = 3, 4
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, p)
    rng = np.random.default_rng(42)
    b_host = rng.standard_normal(dofs.n_dofs)  # ONE rhs for both variants
    out: dict = {"x": {}}
    diag = None  # the same for both variants: computed once
    for fused in (False, True):
        mf = MatrixFree.build(
            mesh, dofs,
            FemConfig(dim=dim, degree=p, dtype=dtype, scatter="separable",
                      use_pallas=True, pallas_mode=mode,
                      pallas_dirichlet=fused), device)
        rk = mf.resident
        if rk is None or rk.dirichlet != fused:
            raise ValueError(f"no resident kernel with dirichlet={fused} "
                             f"for this configuration")
        op = LaplaceOperator(mf)
        if diag is None:
            diag = op.diagonal()
        mask = mf.interior_mask.to("cpu", torch.float64).numpy()
        b = torch.as_tensor(mask * b_host, dtype=rk.compute_dt,
                            device=device)
        resident_jacobi_cg(op, b, diag=diag, rtol=rtol)  # warm
        synchronize(device)
        t0 = time.perf_counter()
        res = resident_jacobi_cg(op, b, diag=diag, rtol=rtol)
        synchronize(device)
        dt = time.perf_counter() - t0
        key = "fused" if fused else "flat"
        out[key] = {"s": dt, "iterations": res.iterations,
                    "ms_per_iteration": 1e3 * dt / max(res.iterations, 1),
                    "residual": res.residual,
                    "converged": bool(res.converged),
                    "x_sum": float(res.x.abs().sum())}
        out["x"][key] = res.x
        log(json.dumps({"check": f"resident_jacobi_cg_{key}_mask",
                        "mode": mode,
                        "instance": "bf16s" if rk.dt != rk.compute_dt
                        else "f32",
                        "dtype": dtype, "n_dofs": dofs.n_dofs,
                        **out[key]}))
        del mf, op, res, rk
    speedup = out["flat"]["s"] / out["fused"]["s"]
    same_iters = out["flat"]["iterations"] == out["fused"]["iterations"]
    out["verdict"] = {"check": "fused_mask_verdict",
                      "speedup": round(speedup, 3),
                      "same_iterations": same_iters,
                      "recommend_fused": bool(speedup > 1.02
                                              and same_iters)}
    log(json.dumps(out["verdict"]))
    return out


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--mode", default="bf16",
                    choices=["f32", "bf16", "bf16s"])
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    run(args.refine, args.mode, args.rtol,
        device=args.device)


if __name__ == "__main__":
    cli()

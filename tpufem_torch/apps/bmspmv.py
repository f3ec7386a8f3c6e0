"""Assembled-SpMV benchmark: the baseline matrix-free is compared against.

Port of ``tpufem/apps/bmspmv.py`` (the reference's ``bmspmv.cu``,
SURVEY.md §2): assemble the sparse matrix, time N repeated SpMVs per
(degree, refinement), report s/apply and DoF/s — the protocol ``bmop``
uses for the matrix-free path (BASELINE config 3: "matrix-free wins for
p >= 2, growing with p").

The baseline is the padded-ELL SpMV of ``tpufem_torch.ops.sparse`` (one
gather and one row sum, plain PyTorch).  A CSR cross-check (the ELL apply
against scipy's ``K @ v``) runs once per configuration, so the benchmark
doubles as the assembled-operator oracle the reference uses it for
(SURVEY.md §4.3).  The time is the reference's: ``reps`` calls on the same
input after two warm calls, CUDA events around them on the card.

Run:  tpufem-torch-bmspmv --dim 3 --degrees 1 2 3 4 --refine 4
      (python -m tpufem_torch.apps.bmspmv ...; --cpu or --device cpu runs
      on the CPU)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.ops.sparse import EllMatrix
from tpufem_torch.utils.metrics import emit
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import time_fn


def bench_spmv(dim, p, refine, dtype, reps, check=True,
               device: torch.device | str = "cuda"):
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, p)
    K = assemble_laplace(dofs)
    A = EllMatrix.from_csr(K, dt, device)
    x = torch.ones(dofs.n_dofs, dtype=dt, device=device)
    rec = {
        "bench": "bmspmv",
        "dim": dim, "degree": p, "refine": refine,
        "n_dofs": dofs.n_dofs, "nnz": int(K.nnz),
        "row_width": int(A.indices.shape[1]),
        "bytes_per_dof": round(8.0 * K.nnz / dofs.n_dofs, 1),
        "dtype": dtype,
    }
    if check:  # assembled-oracle cross-check (SURVEY.md §4.3)
        rng = np.random.default_rng(0)
        v = rng.standard_normal(dofs.n_dofs)
        ref = K @ v
        got = A.matvec(torch.as_tensor(v, dtype=dt, device=device)).to(
            "cpu", torch.float64).numpy()
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        tol = 1e-12 if dt.itemsize >= 8 else 2e-5
        if rel > tol:
            raise AssertionError(
                f"ELL SpMV vs scipy CSR rel err {rel:.2e} > {tol}"
            )
        rec["csr_cross_check_rel_err"] = float(rel)
    dt_s = time_fn(lambda _: A.matvec(x), x, reps=reps)
    rec["s_per_apply"] = dt_s
    rec["gdofs_per_s"] = dofs.n_dofs / dt_s / 1e9
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degrees", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the scipy-CSR cross-check")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    for p in args.degrees:
        emit(bench_spmv(args.dim, p, args.refine, args.dtype, args.reps,
                        check=not args.no_check, device=device))


if __name__ == "__main__":
    main()

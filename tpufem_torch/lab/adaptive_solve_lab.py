"""Card lab: where the adaptive box GMG solve's seconds go.

Port of ``scripts/adaptive_solve_lab.py``, a module-level script there,
a ``main(refine, steps, device)`` here.  It splits the adaptive solve
benchmark (``bmop.bench_adaptive_solve``: the box Jacobi-CG, the GMG-CG
and the bf16-cycle GMG-CG on the JAX bench's b: seed 7, interior and
non-hanging entries, rtol 1e-5) into its stages:

  cuda_warmup          one synchronised read of a small tensor (the
                       reference's ``d2h_warmup`` of its TPU, here the
                       CUDA context's first use)
  build_adaptive_op    host setup: mesh, DoFs, constraints, box operator
  diagonal             the box operator's diagonal
  mg_f32_build         the GMG hierarchy (level operators, Chebyshev
                       power iterations, coarse dense inverse, transfers)
  jacobi_warm, _timed  the box Jacobi-CG, first call, then timed
  gmg_warm, _timed     the GMG-CG likewise
  mg_bf16_recast       the bf16 hierarchy (``BoxMultigrid.recast``)
  gmg16_warm, _timed   the bf16-cycle GMG-CG (f32 outer CG)

The reference's "compile_warm" is the first call here: the port is eager
and compiles nothing.  The sequence is bmop's own (its ``stage`` hook);
this lab adds the clock: each stage synchronises the device before it
reads the clock, and prints one line.  Given a prebuilt operator, and
optionally its diagonal and hierarchy, the lab times only the stages
left to run, in the operator's dtype.

Run:  python -m tpufem_torch.lab.adaptive_solve_lab [refine] [steps]
      [--device cpu]    (default refine 4, 2 steps: 3,302,995 DoFs)
"""

from __future__ import annotations

import argparse
import time

import torch

from tpufem_torch.apps import bmop
from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.utils.timer import synchronize

RTOL = 1e-5
DEGREE = 4


def main(refine: int = 4, steps: int = 2,
         device: torch.device | str = "cuda", prebuilt=None,
         log=print) -> dict:
    """The stages at 3D Q4 f32 on ``adaptive_mesh(3, refine, steps)``, or
    on ``prebuilt`` (``bmop.bench_adaptive_solve``'s); returns {"stages":
    {name: seconds}, "iterations": {"jacobi", "gmg", "gmg16"}, "n_dofs",
    "n_hanging", "levels"} ("gmg16" only in f32)."""
    device = resolve_device(device)
    dtype = ("float32" if prebuilt is None
             else str(prebuilt[3].dt).removeprefix("torch."))
    log(f"device={device} refine={refine} steps={steps} dtype={dtype}"
        + (" (prebuilt)" if prebuilt is not None else ""))
    stages: dict = {}

    def stage(name, fn):
        synchronize(device)
        t0 = time.perf_counter()
        r = fn()
        synchronize(device)
        stages[name] = time.perf_counter() - t0
        log(f"  {name:<28s} {stages[name]:10.3f} s")
        return r

    stage("cuda_warmup", lambda: torch.zeros(8, device=device).cpu())
    rec = bmop.bench_adaptive_solve(3, DEGREE, refine, steps, dtype,
                                    rtol=RTOL, prebuilt=prebuilt,
                                    bf16_cycle=True, device=device,
                                    stage=stage)
    iters = {tag: rec[f"{name}_iterations"] for name, tag in (
        ("jacobi", "jacobi"), ("gmg", "gmg"), ("gmg_bf16cycle", "gmg16"))
        if f"{name}_iterations" in rec}
    log(f"    n_dofs={rec['n_dofs']} n_hanging={rec['n_hanging']} "
        f"levels={rec['levels']} iterations={iters}")
    return {"stages": stages, "iterations": iters, "n_dofs": rec["n_dofs"],
            "n_hanging": rec["n_hanging"], "levels": rec["levels"]}


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("refine", type=int, nargs="?", default=4)
    ap.add_argument("steps", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    main(args.refine, args.steps, device=args.device)


if __name__ == "__main__":
    cli()

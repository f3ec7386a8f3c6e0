"""Where the time of the flagship resident solve goes, on a CUDA device.

Two measurements at 3D Q4 on the hyper_cube refined ``--refine`` times
(refine 6: 16,974,593 DoFs), f32, fused Dirichlet mask:

1. K1 tile sweep: ms per apply (CUDA events, chains of 30) for each output
   tile (TZ, TY, TX) of ``TILES``, in f32 and bf16s storage, three chains
   each;
2. a ``torch.profiler`` trace of ``--iters`` resident Jacobi-CG
   iterations: device time per kernel group (K1 apply, cuBLAS dots,
   elementwise BLAS-1), the unprofiled wall time of the same iterations,
   and the device's busy share (device time over unprofiled wall time).

Run from the repository root:  python -m tpufem_torch.apps.resident_probe
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from tpufem_torch.apps.poisson import hyper_cube_operator
from tpufem_torch.ops.kernel_separable import ResidentSeparable
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.timer import time_fn

# (TZ, TY, TX); every one needs at most 215 KB of shared memory at p = 4
# in f32, within the H100's 227 KB per block
TILES = ((8, 8, 32), (4, 8, 32), (8, 4, 32), (4, 4, 32), (8, 8, 16),
         (4, 16, 32), (8, 16, 32), (16, 8, 32), (16, 16, 32))


def kernel_group(name: str) -> str:
    if "separable_apply" in name:
        return "K1 apply"
    if "dot" in name or "gemv" in name or "reduce" in name.lower():
        return "dots / reductions"
    return "elementwise BLAS-1"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    op = hyper_cube_operator(3, 4, args.refine, "float32", True, dev)
    mf = op.mf
    Ks = [k.cpu().numpy() for k in mf.Ks]
    Ms = [m.cpu().numpy() for m in mf.Ms]
    x = torch.tensor(np.random.default_rng(0).standard_normal(mf.n_dofs),
                     dtype=torch.float32, device=dev)
    print(f"K1 tile sweep, {mf.n_dofs} DoFs, default tile "
          f"{mf.resident.tile}", flush=True)
    for tile in TILES:
        for mode in ("f32", "bf16s"):
            rk = ResidentSeparable(mf.npts, 4, Ks, Ms, torch.float32,
                                   mode=mode, dirichlet=True, device=dev,
                                   tile=tile)
            xp = rk.pad(x)
            ms = [1e3 * time_fn(rk.raw, xp, reps=30) for _ in range(3)]
            print(f"  tile {tile} {mode}: ms per apply "
                  + " ".join(f"{m:.4f}" for m in ms)
                  + f"  ({mf.n_dofs / min(ms) / 1e6:.2f} GDoF/s)", flush=True)

    diag = op.diagonal()
    mask = mf.interior_mask.cpu().numpy().astype(np.float64)
    b = torch.tensor(mask * np.random.default_rng(7).standard_normal(
        mf.n_dofs), dtype=torch.float32, device=dev)
    solve = lambda: resident_jacobi_cg(op, b, diag=diag, rtol=1e-5,
                                       maxiter=args.iters, track_best=False)
    solve()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.device_time_total > 0:
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + e.device_time_total / 1e3
            kernels.append((e.device_time_total / 1e3, e.count, e.key))
    busy = sum(groups.values())
    it = r.iterations
    print(f"resident Jacobi-CG, {it} iterations: unprofiled wall "
          f"{wall:.4f} s ({1e3 * wall / it:.4f} ms/iteration); device time "
          f"{busy:.3f} ms ({busy / it:.4f} ms/iteration), busy share "
          f"{busy / (1e3 * wall):.3f}", flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.3f} ms, {t / it:.4f} ms/iteration, "
              f"{100 * t / busy:.1f}% of device time", flush=True)
    for t, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {t:9.3f} ms x{n:5d}  {key[:100]}", flush=True)


if __name__ == "__main__":
    main()

"""Where the time of the flagship resident solves goes, on a CUDA device.

At 3D Q4 on the hyper_cube refined ``--refine`` times (refine 6:
16,974,593 DoFs), with the fused Dirichlet mask, for K1 (the Laplace) and
K4 (the separable coefficient's three terms, ``COEF_AXES``):

1. the ring's sub-tile sweep: ms per apply (CUDA events, chains of 30,
   three chains each) at each sub-tile (TZ, TY) of ``SWEEP_TILES``, in f32
   and bf16s storage, beside the ring's two ablations at the same sub-tile
   and storage: ``copy`` (the loads and stores alone) and ``bands`` (the
   z and y stages too, no x band).  copy, bands - copy and apply - bands
   split an apply into the tile mover, the z/y bands and the x band;
2. a ``torch.profiler`` trace of ``--iters`` resident Jacobi-CG
   iterations through each kernel: device time per kernel group (the ring
   apply, cuBLAS dots, elementwise BLAS-1), the unprofiled wall time of the
   same iterations, and the device's busy share (device time over
   unprofiled wall time);
3. the host's cost of one apply: wall time per ``raw`` call of each
   kernel at refine 2 (17^3 DoFs), where the kernel is shorter than its
   launch (the wrapper's checks, ctypes, the tensor maps, the launch).

Run from the repository root:  python -m tpufem_torch.apps.resident_probe
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from tpufem_torch.apps.poisson import poisson_operator
from tpufem_torch.ops.kernel_separable import RING_TILES, ResidentSeparable
from tpufem_torch.ops.kernel_terms import ResidentTerms
from tpufem_torch.ops.separable import cartesian_coef_terms
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.timer import time_fn

SWEEP_TILES = RING_TILES[:4]  # (8, 8), (4, 16), (4, 8), (8, 16)
# the separable coefficient of tests/test_pallas.py:708-712
COEF_AXES = [lambda x: 1.0 + 0.5 * np.sin(2.1 * np.pi * x),
             lambda y: 1.3 + y * y,
             lambda z: np.exp(0.5 * z)]


def kernel_group(name: str) -> str:
    if "resident_ring" in name:
        return "ring apply"
    if "dot" in name or "gemv" in name or "reduce" in name.lower():
        return "dots / reductions"
    return "elementwise BLAS-1"


def sweep(name: str, make, x: torch.Tensor, n_dofs: int) -> None:
    """ms per apply of ``make(mode, tile)`` at each sub-tile and storage,
    the apply beside its copy and bands ablations."""
    for tile in SWEEP_TILES:
        for storage in ("f32", "bf16s"):
            ms = {}
            for mode in ("copy", "bands", storage):  # ablations: f32
                rk = make(mode, tile)
                xp = rk.pad(x)
                ms[mode] = min(1e3 * time_fn(rk.raw, xp, reps=30)
                               for _ in range(3))
            t, c, b = ms[storage], ms["copy"], ms["bands"]
            print(f"  {name} sub-tile {tile} {storage}: {t:.4f} ms per apply "
                  f"({n_dofs / t / 1e6:.2f} GDoF/s; group "
                  f"{getattr(rk, 'group', None)}); copy {c:.4f}, bands "
                  f"{b:.4f} (f32 ablations): mover {c:.4f} + z/y bands "
                  f"{b - c:.4f} + x band {t - b:.4f}", flush=True)


def profile(name: str, op, b: torch.Tensor, diag, iters: int) -> None:
    solve = lambda: resident_jacobi_cg(op, b, diag=diag, rtol=1e-5,
                                       maxiter=iters, track_best=False)
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
    print(f"{name} resident Jacobi-CG, {it} iterations: unprofiled wall "
          f"{wall:.4f} s ({1e3 * wall / it:.4f} ms/iteration); device time "
          f"{busy:.3f} ms ({busy / it:.4f} ms/iteration), busy share "
          f"{busy / (1e3 * wall):.3f}", flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.3f} ms, {t / it:.4f} ms/iteration, "
              f"{100 * t / busy:.1f}% of device time", flush=True)
    for t, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"    {t:9.3f} ms x{n:5d}  {key[:100]}", flush=True)


def host_us(name: str, rk, n: int = 2000) -> None:
    """Wall microseconds per ``rk.raw`` call, into one output, over ``n``
    calls after a warm-up: the host's cost of an apply where the kernel
    is shorter than its launch."""
    x = rk.pad(torch.ones(rk.npts**3, device=rk.device))
    y = torch.empty_like(x)
    for _ in range(50):
        rk.raw(x, out=y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rk.raw(x, out=y)
    torch.cuda.synchronize()
    us = 1e6 * (time.perf_counter() - t0) / n
    print(f"{name} host cost per apply at {rk.npts}^3 DoFs: {us:.2f} us "
          f"({n} calls)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--no-sweep", action="store_true",
                    help="the profiles only")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    op1 = poisson_operator(3, 4, args.refine, "float32", True, dev)
    op4 = poisson_operator(3, 4, args.refine, "float32", True, dev,
                           coefficient_axes=COEF_AXES)
    mf1, mf4 = op1.mf, op4.mf
    n_dofs = mf1.n_dofs
    x = torch.tensor(np.random.default_rng(0).standard_normal(n_dofs),
                     dtype=torch.float32, device=dev)
    if not args.no_sweep:
        Ks = [k.cpu().numpy() for k in mf1.Ks]
        Ms = [m.cpu().numpy() for m in mf1.Ms]
        terms = cartesian_coef_terms(4, 3, 5, 2**args.refine, [0.0] * 3,
                                     [1.0] * 3, COEF_AXES, np.float64)
        print(f"ring sub-tile sweep, {n_dofs} DoFs, p = 4; default K1 "
              f"{mf1.resident.tile}, K4 {mf4.resident.tile} (group "
              f"{mf4.resident.group})", flush=True)
        sweep("K1", lambda mode, tile: ResidentSeparable(
            mf1.npts, 4, Ks, Ms, torch.float32, mode=mode,
            dirichlet=mode not in ("copy", "bands"), device=dev, tile=tile),
            x, n_dofs)
        sweep("K4", lambda mode, tile: ResidentTerms(
            mf4.npts, 4, terms, torch.float32, mode=mode,
            dirichlet=mode not in ("copy", "bands"), device=dev, tile=tile),
            x, n_dofs)

    for name, op in (("K1", op1), ("K4", op4)):
        mask = op.mf.interior_mask.cpu().numpy().astype(np.float64)
        b = torch.tensor(mask * np.random.default_rng(7).standard_normal(
            n_dofs), dtype=torch.float32, device=dev)
        profile(name, op, b, op.diagonal(), args.iters)
    host_us("K1", poisson_operator(3, 4, 2, "float32", True,
                                   dev).mf.resident)
    host_us("K4", poisson_operator(3, 4, 2, "float32", True, dev,
                                   coefficient_axes=COEF_AXES).mf.resident)


if __name__ == "__main__":
    main()

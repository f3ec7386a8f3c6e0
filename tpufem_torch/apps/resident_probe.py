"""Where the time of the resident solves goes, on a CUDA device.

``--dim 3`` (the default): at 3D Q4 on the hyper_cube refined
``--refine`` times (refine 6: 16,974,593 DoFs), with the fused Dirichlet
mask, for K1 (the Laplace) and K4 (the separable coefficient's three
terms, ``COEF_AXES``):

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

``--dim 2``: K3 (the 2D Laplace's two terms) at 2D Q4 refine 8 and 10
(1,050,625 and 16,785,409 DoFs): the sweep of the 2D sub-tiles (1, TY) of
``RING_TILES_2D`` with the fused mask, each beside its copy and bands
ablations (mover, y bands, x band; the segment chooser's count at each),
then the profile of the 2D resident CG at both sizes (its apply group takes
the tile routine of earlier trees too), then the host's cost of one apply
at refine 2.  ``--no-sweep`` skips the sweeps.

``--applies``: K2 and K3 alone at their main-path shapes (f32, Q4
hyper_cube operators), one JSON line each: ms per apply, the mean of a
chain of 30 (CUDA events), three chains (``ms``), and the kernels' own
device time per apply over a chain of 30 under ``torch.profiler``
(``device_ms``: where a kernel is shorter than the host's cost of a
launch, the chain measures the host).  K3 at 2D refine 10 (16,785,409
DoFs) and 8, with the fused mask where the tree's K3 takes one; K3's
operator as the 2D resident CG applies it at refine 8 (``K3 operator``:
m·A(m·x) + (1-m)·x, the mask in the kernel or, in a tree whose K3 takes
none, the elementwise launches around it); K2 at 3D refine 5 (the
``solve_poisson`` main path) and 6, and at 2D refine 10: its tile routine,
then K2 as it launches there, the z-march (a tree before the march: its
tile routine alone).

Run from the repository root:  python -m tpufem_torch.apps.resident_probe
(or, to hold another tree against this one on the same card, in turns A B
B A in one call, ``PYTHONPATH=<tree> python
tpufem_torch/apps/resident_probe.py --dim 2 --no-sweep`` or ``--applies``)
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import numpy as np
import torch

from tpufem_torch.apps.poisson import poisson_operator
from tpufem_torch.ops import kernel_separable
from tpufem_torch.ops.kernel_separable import (
    RING_TILES,
    KernelSeparable,
    ResidentSeparable,
)
from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
from tpufem_torch.ops.separable import (
    cartesian_coef_terms,
    global_1d_matrices,
)
from tpufem_torch.solvers.resident import resident_jacobi_cg
from tpufem_torch.utils.build import CSRC
from tpufem_torch.utils.timer import time_fn

SWEEP_TILES = RING_TILES[:4]  # (8, 8), (4, 16), (4, 8), (8, 16)
# the separable coefficient of tests/test_pallas.py:708-712
COEF_AXES = [lambda x: 1.0 + 0.5 * np.sin(2.1 * np.pi * x),
             lambda y: 1.3 + y * y,
             lambda z: np.exp(0.5 * z)]


def device_ms(fn, x, reps: int = 30) -> float:
    """The device time of the CUDA kernels a chain of ``reps`` applies
    launches, per apply (``torch.profiler``); one more chain where the
    profiler saw no kernel (it sometimes records none)."""
    fn(x)
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            y = x
            for _ in range(reps):
                y = fn(y)
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total > 0:
            break
    return total / 1e3 / reps


def kernel_group(name: str) -> str:
    if any(k in name for k in ("resident_ring", "terms_apply",
                               "separable_apply")):
        return "apply"
    if "dot" in name or "gemv" in name or "reduce" in name.lower():
        return "dots / reductions"
    return "elementwise BLAS-1"


def sweep(name: str, make, x: torch.Tensor, n_dofs: int,
          tiles=SWEEP_TILES) -> None:
    """ms per apply of ``make(mode, tile)`` at each sub-tile and storage,
    the apply beside its copy and bands ablations."""
    for tile in tiles:
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
                  f"{getattr(rk, 'group', None)}, segments "
                  f"{getattr(rk, 'segments', None)}); copy {c:.4f}, bands "
                  f"{b:.4f} (f32 ablations): mover {c:.4f} + y bands "
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
    dim = 2 if isinstance(rk, ResidentTerms2D) else 3
    x = rk.pad(torch.ones(rk.npts**dim, device=rk.device))
    y = torch.empty_like(x)
    # into one output where the tree's wrapper takes one
    kw = {"out": y} if "out" in inspect.signature(rk.raw).parameters else {}
    for _ in range(50):
        rk.raw(x, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rk.raw(x, **kw)
    torch.cuda.synchronize()
    us = 1e6 * (time.perf_counter() - t0) / n
    print(f"{name} host cost per apply at {rk.npts}^{dim} DoFs: {us:.2f} us "
          f"({n} calls)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=3, choices=(2, 3))
    ap.add_argument("--refine", type=int, default=6,
                    help="3D refinement (2D: refine 8 and 10)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--no-sweep", action="store_true",
                    help="the profiles only")
    ap.add_argument("--applies", action="store_true",
                    help="K2 and K3 alone at their main-path shapes")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.applies:
        return applies(dev, smi)
    if args.dim == 2:
        return main_2d(args, dev)

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


def main_2d(args, dev) -> None:
    """K3's 2D sub-tile sweep, then the 2D resident CG's profile at refine
    8 and 10 and the host's cost of one apply at refine 2."""
    ops = {r: poisson_operator(2, 4, r, "float32", True, dev) for r in (8, 10)}
    fused = "dirichlet" in inspect.signature(ResidentTerms2D).parameters
    for r, op in ops.items():
        mf = op.mf
        rk = mf.resident
        x = torch.tensor(np.random.default_rng(r).standard_normal(mf.n_dofs),
                         dtype=torch.float32, device=dev)
        print(f"2D Q4 refine {r}: {mf.n_dofs} DoFs, K3 tile {rk.tile}, "
              f"segments {getattr(rk, 'segments', None)}, fused mask "
              f"{rk.dirichlet}", flush=True)
        if not args.no_sweep and fused:
            K = [k.cpu().numpy() for k in mf.Ks]
            M = [m.cpu().numpy() for m in mf.Ms]
            terms = [[K[0], M[1]], [M[0], K[1]]]
            sweep(f"K3 refine {r}", lambda mode, tile: ResidentTerms2D(
                mf.npts, 4, terms, torch.float32, mode=mode,
                dirichlet=mode not in ("copy", "bands"), device=dev,
                tile=tile), x, mf.n_dofs, kernel_separable.RING_TILES_2D)
        mask = mf.interior_mask.cpu().numpy().astype(np.float64)
        b = torch.tensor(mask * np.random.default_rng(7).standard_normal(
            mf.n_dofs), dtype=torch.float32, device=dev)
        profile(f"K3 refine {r}", op, b, op.diagonal(), args.iters)
    host_us("K3", poisson_operator(2, 4, 2, "float32", True,
                                   dev).mf.resident)



def applies(dev, smi: str) -> None:
    """K2 and K3 at their main-path shapes (``--applies``)."""
    fused = "dirichlet" in inspect.signature(ResidentTerms2D).parameters

    def line(kernel, shape, k, fn, x):
        ms = [1e3 * time_fn(fn, x, reps=30) for _ in range(3)]
        print(json.dumps({
            "tree": str(CSRC.parents[1]), "kernel": kernel, "shape": shape,
            "ms": ms, "device_ms": device_ms(fn, x), "tile": k.tile,
            "segments": getattr(k, "segments", getattr(k, "nseg", None)),
            "fused_mask": fused and kernel.startswith("K3"), "device": smi}),
            flush=True)

    for refine in (10, 8):
        n, npts = 2**refine, 4 * 2**refine + 1
        K, M = global_1d_matrices(4, n, 5)
        kw = {"dirichlet": True} if fused else {}
        k3 = ResidentTerms2D(npts, 4, [[K * n, M / n], [M / n, K * n]],
                             torch.float32, device=dev, **kw)
        x = k3.pad(torch.tensor(np.random.default_rng(refine)
                                .standard_normal(npts**2),
                                dtype=torch.float32, device=dev))
        line("K3", f"2D refine {refine}", k3, k3.raw, x)
    mf = poisson_operator(2, 4, 8, "float32", True, dev).mf
    rk = mf.resident
    if fused:
        A = rk.raw
    else:  # resident_jacobi_cg's mask algebra around the kernel
        m = rk.pad_any(mf.interior_mask)
        A = lambda gp: m * rk.raw(m * gp) + (1.0 - m) * gp
    x = rk.pad_any(torch.tensor(np.random.default_rng(8).standard_normal(
        mf.n_dofs), dtype=torch.float32, device=dev))
    line("K3 operator", "2D refine 8", rk, A, x)
    for dim, refine in ((3, 5), (3, 6), (2, 10)):
        n, npts = 2**refine, 4 * 2**refine + 1
        K, M = global_1d_matrices(4, n, 5)
        k2 = KernelSeparable(dim, npts, 4, [K * n] * dim, [M / n] * dim,
                             torch.float32, dev)
        x = torch.tensor(np.random.default_rng(dim + refine)
                         .standard_normal(npts**dim), dtype=torch.float32,
                         device=dev)
        if hasattr(k2, "with_routine"):  # the tile routine beside K2
            tile = k2.with_routine("tile")
            line("K2 tile routine", f"{dim}D refine {refine}", tile,
                 tile.launch, x)
        line("K2", f"{dim}D refine {refine}", k2, k2, x)


if __name__ == "__main__":
    main()

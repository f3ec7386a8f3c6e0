"""Sweep the compile-time constants of the redesigned L2 lab routines.

The all-band tile mover (``csrc/lab_zyfirst.cuh``: vcopy, vband, v16, on the
ring of ``csrc/band_ring.cuh``) and the dense x stage's ring
(``csrc/lab_separable.cuh``: vx and the x-first kernels) fix their ring
depth, and vx its x blocks a block, as constants, not run-time arguments.  This script builds copies of the two libraries with one constant
changed each (``VARIANTS``; p = 4 only, so a copy builds in ~10 s), into
``build/tpufem_torch/sweep/``, and times the kernels that run them at the
lab's flagship (3D Q4 refine 6, 16,974,593 DoFs, f32) beside the committed
constants, each held to its plain version first.  Two more copies are
ablations of the x ring, timed only (their output is wrong by design): its
loads and barriers without the products, and its products on whatever the
first chunks left in shared memory, without the loads; their sum against the
whole says how far the two overlap.  v3's ring (``csrc/lab_separable_ring.cuh``)
runs at each depth of its u ring (a run-time argument) beside the chooser's,
and in three copies timed only: its band x with the table rows held where
the committed kernel does not hold them (shared memory, and registers in
bf16x3), its loads, band x and stores without the y and z products, and its
products with the band x replaced by a copy of each output's centre tap.
vxy's ring (the same file) runs beside v3's, in a copy whose launch bound
holds one block an SM (255 registers a thread, where the committed two
blocks an SM hold it to 128 and ptxas serialises its wgmmas), and in a copy
timed only without its y products and stores: its x stage, with ax and gx
stored into the y operand, alone.  v2's ring (the same file) runs at z
segments of 1, 2, 3, 4 and all 17 tiles a block (a run-time argument;
3xTF32 also 5, 6 and 8) beside its chooser's, in a copy whose launch bound
asks for two blocks an SM (128 registers; its shared memory holds one block
an SM either way), in copies timed only without its z products (its x and
y stages, with t1 and t2 stored, and the stores) and without its y and z
products (its x stage, with ax and gx stored, and the stores), and with its
ring of 5 and 6 stages in place of 4.  Both dense x rings run in a copy
whose second warpgroup multiplies a copy of a pass's third 64-row tile at
LP = 24, as vxy's ring did before v2's.  v12's ring
(``csrc/lab_separable_band.cu`` on the same header) runs at z segments of 1,
2, 3, 4 and all 17 tiles (3xTF32 also 5, 6 and 8) beside its chooser's, in
a copy whose z window lies in shared memory where the committed one holds
it in registers, in a copy whose eight band rows a pass are unrolled (the
committed loop takes one row at a time), in a copy whose launch bound asks
for two blocks an SM (128 registers), and in copies timed only without its
band z (t1 + t2 of each row stored in its place) and without either band
(its x stage, with ax and gx stored, alone); each copy's ptxas registers
and spills of v12's instances first.

    python -m tpufem_torch.lab.ring_sweep [--reps 20] [--only l2_nxb1 ...]

It runs on a CUDA device and raises without one; a copy that does not build,
or an edit whose text the sources no longer hold, raises.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time

import numpy as np
import torch

from tpufem_torch.lab import separable_lab
from tpufem_torch.lab.separable_lab import LabKernel
from tpufem_torch.ops.separable import global_1d_matrices
from tpufem_torch.utils import build
from tpufem_torch.utils.timer import time_fn

SWEEP_DIR = build.BUILD_DIR / "sweep"
# the libraries a copy rebuilds, by name: their launchers, cut to p = 4
LIBRARIES = {"lab_zyfirst": "lab_zyfirst.cu",
             "lab_separable": "lab_separable.cu",
             "lab_separable_ring": "lab_separable_ring.cu",
             "lab_separable_band": "lab_separable_band.cu"}
# name -> (library, {file: [(text, replacement), ...]}, timed only)
VARIANTS = {
    "committed": (None, {}, False),
    # the ring's depth, in the skeleton the all-band routine shares with K1
    # and K4 (only the lab library is rebuilt from the copy)
    "zy_stages2": ("lab_zyfirst", {"band_ring.cuh": [
        ("kRingStages = 3;", "kRingStages = 2;")]}, False),
    "zy_stages4": ("lab_zyfirst", {"band_ring.cuh": [
        ("kRingStages = 3;", "kRingStages = 4;")]}, False),
    "l2_stages5": ("lab_separable", {"lab_separable.cuh": [
        ("kL2Stages = 4;", "kL2Stages = 5;")]}, False),
    # vx with one x block a block, as the full variants run the ring
    "l2_nxb1": ("lab_separable", {"lab_separable.cuh": [
        ("(kL2XBand | kL2XJobs)) ? 2 : 1;",
         "(kL2XBand | kL2XJobs)) ? 1 : 1;")]}, False),
    "l2_loads_only": ("lab_separable", {"lab_separable.cuh": [
        ("              hop_wgmma<BF>(d[j * MAXT + i],\n"
         "                            part == 0 ? small[i][ks] : big[i][ks],\n"
         "                            B + (j * NP + (part == 1)) * rg.b_part,"
         " ks,\n                            kbytes);",
         "              (void)d;")]}, True),
    "l2_products_only": ("lab_separable", {"lab_separable.cuh": [
        ("      load(kc + S - 2);     // the slot chunk kc - 2 was multiplied "
         "from\n", "      lab_cp_commit();\n")]}, True),
    "bx_rows_other": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("kRowsInRegs = XP != kXBF16x3;", "kRowsInRegs = XP == kXBF16x3;")
    ]}, True),
    "bxy_one_block": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("__global__ void __launch_bounds__(kBxyThreads, 2)",
         "__global__ void __launch_bounds__(kBxyThreads, 1)")]}, False),
    "bxy_no_y": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("        each_wg([&](int wg) {\n"
         "          BxWgmma<P, XP>::y_products(",
         "        auto no_y = ([&](int wg) {\n          BxWgmma<P, XP>::"
         "y_products(")
    ]}, True),
    "bxyz_stages5": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("kBxyzStages = 4;", "kBxyzStages = 5;")]}, False),
    "bxyz_stages6": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("kBxyzStages = 4;", "kBxyzStages = 6;")]}, False),
    # vxy's and v2's x stage with both warpgroups on one code at LP = 24:
    # the second multiplies a copy of the third tile, not stored
    "bxy_tile_repeat": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("      if constexpr (NMT % NWG == 0) {\n        each_wg(f);",
         "      if constexpr (true) {\n        each_wg(f);"),
        ("    static_assert(NMT % NWG == 0, \"a run-time warpgroup: equal "
         "shares\");\n    return NMT / NWG;",
         "    return (NMT + NWG - 1) / NWG;"),
        ("                         A + (bxy_wg(wg) + i * NWG) * kHopM * KC, "
         "a_at, ks,",
         "                         A + (bxy_wg(wg) + i * NWG < NMT ? "
         "bxy_wg(wg) + i * NWG : NMT - 1) * kHopM * KC, a_at, ks,")]}, False),
    "bxyz_two_blocks": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("kBxyzBlocks = 1;", "kBxyzBlocks = 2;")]}, False),
    "bxyz_no_z": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("          each_wg([&](int wg) { zw.z_issue(T1, T2, Bz, j, wg, w, "
         "lane); });", "          (void)Bz;")]}, True),
    "bxyz_x_only": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("          each_wg([&](int wg) { zw.z_issue(T1, T2, Bz, j, wg, w, "
         "lane); });", "          (void)Bz;"),
        ("            each_wg([&](int wg) { zw.y(AX, GX, B, T1, T2, wg, w, "
         "lane); });", "            (void)0;")]}, True),
    "bx_no_products": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("      each_wg([&](int wg) { x.y(AX, GX, B, T1, T2, wg, warp % 4, "
         "lane); });", "      (void)0;"),
        ("        x.z_issue(T1, T2, B + ybytes, j, wg, warp % 4, lane);",
         "        (void)wg;")]}, True),
    "bx_no_band": ("lab_separable_ring", {"lab_separable_ring.cuh": [
        ("        band2<P>(wa, wb, U + (zr * LP + yl) * BXW + xo + PH - P, 1, "
         "am, ak);", "        am = ak = U[(zr * LP + yl) * BXW + xo + PH];")
    ]}, True),
    # v12's z window in a shared ring of 2p + 1 rows at every degree
    "bzb_window_shared": ("lab_separable_band", {"lab_separable_ring.cuh": [
        ("bzb_regs(int p, int xp) {\n  return xp != kXF64 && p <= 6;",
         "bzb_regs(int p, int xp) {\n  return false;")]}, False),
    # v12's eight band rows a pass unrolled, beside the x stage's code
    "bzb_rows_unrolled": ("lab_separable_band", {"lab_separable_ring.cuh": [
        ("#pragma unroll 1\n      for (int zr = 0; zr < ZC; ++zr) "
         "band_row(j, zr, wmy, wky);",
         "#pragma unroll\n      for (int zr = 0; zr < ZC; ++zr) "
         "band_row(j, zr, wmy, wky);")]}, False),
    "bzb_two_blocks": ("lab_separable_band", {"lab_separable_ring.cuh": [
        ("kBxyzbBlocks = 1;", "kBxyzbBlocks = 2;")]}, False),
    "bzb_no_z": ("lab_separable_band", {"lab_separable_ring.cuh": [
        ("              v = band<P>(wkz, win[i][c][0], 1) +\n"
         "                  band<P>(wmz, win[i][c][1], 1);",
         "              v = t1 + t2;")]}, True),
    "bzb_x_only": ("lab_separable_band", {"lab_separable_ring.cuh": [
        ("const YRows& wmy, const YRows& wky) {\n",
         "const YRows& wmy, const YRows& wky) {\n    if (j >= 0) return;\n")
    ]}, True),
}
ZY_TIMED = ("vcopy", "vband", "v16")
BX_TIMED = ("highest", "high", "bf16x3")  # v3's and vxy's rings
L2_TIMED = (("vx", "highest"), ("vx", "high"), ("vx", "bf16x3"),
            ("v2", "highest"), ("v12", "highest"), ("vxy", "highest"))


def edited_sources(name: str):
    """{file: text} of the csrc copy of variant ``name``: its edits applied
    (each text must occur exactly once) and the launchers cut to p = 4."""
    out = build.edited_csrc(VARIANTS[name][1], name)
    for fname in LIBRARIES.values():
        out[fname] = re.sub(r" +TPUFEM_CASE\([1-35-8]\)\n", "", out[fname])
    return out


def build_variant(name: str) -> dict:
    """Build the lab libraries of variant ``name`` (all four for
    "committed", else the one it edits); returns {library name:
    KernelLibrary}."""
    lib_name = VARIANTS[name][0]
    names = [lib_name] if lib_name else list(LIBRARIES)
    d = SWEEP_DIR / name
    return build.build_copies({d: (edited_sources(name), names)})[d]


def time_variant(libs, variant, prec, u, K1, M1, reps, timed_only,
                 nu=None, routine=None, seg=None):
    """One line: the kernel of ``variant`` from ``libs`` at the flagship
    (v3's ring: with nu u slots, or its chooser's; v2's and v12's: a z
    segment of seg tiles, or its chooser's; routine: None, the variant's default), held to
    its plain version (unless an ablation), ms of two timings."""
    real = separable_lab.load_kernels
    separable_lab.load_kernels = lambda: libs
    try:
        k = LabKernel(variant, 257, 4, K1, M1, [1.0 / 64] * 3, prec=prec,
                      device="cuda", routine=routine, seg=seg)
    finally:
        separable_lab.load_kernels = real
    if nu is not None:  # the launcher sizes its shared memory from nu
        k.ring = (nu,)
        k.smem = k.lib.lib.tpufem_l2_ring_smem_bytes(4, k.xp, nu)
    gp = k.pad(u)
    err = float("nan")
    if not timed_only:
        y, ref = k.raw(gp).double(), k.plain(gp.to(torch.float64))
        err = float((y - ref).abs().max() / ref.abs().max())
        tol = {"vcopy": 0.0, "vband": 1e-6}.get(variant,
                                                separable_lab.TOL[k.xp])
        if not err <= tol:
            raise RuntimeError(f"{variant}: max rel err {err:.3e} > {tol}")
    ms = [1e3 * time_fn(lambda _: k.raw(gp), gp, reps=reps) for _ in range(2)]
    return (f"  {variant}-{prec} b={k.b}"
            + (f" {k.routine}" if k.routine else "")
            + (f" sub-tile={k.tile}" if k.tile else "")
            + (f" u slots={k.ring[0]}" if k.bx and k.ring else "")
            + (f" seg={k.seg} grid={k.grid}" if k.seg else "")
            + (f" window={k.window}" if k.window else "")
            + f" smem={k.smem} max rel err {err:.2e}  {ms[0]:.4f} "
            f"{ms[1]:.4f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the ring sweep runs on a CUDA device; "
                           "torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"ring sweep: 3D Q4 refine 6, 16,974,593 DoFs, f32, {smi}",
          flush=True)
    K1, M1 = global_1d_matrices(4, 64, 5)
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(257**3),
                        device="cuda")
    committed = build_variant("committed")
    for name in args.only:
        t0 = time.perf_counter()
        own = committed if name == "committed" else build_variant(name)
        libs = {**committed, **own}
        print(f"{name}: built {sorted(own)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        timed_only = VARIANTS[name][2]
        if "lab_zyfirst" in own:
            for v in ZY_TIMED:
                print(time_variant(libs, v, "highest", u, K1, M1, args.reps,
                                   timed_only), flush=True)
        if "lab_separable" in own:
            for v, prec in L2_TIMED:  # vxy, v12: their schedule on this
                # routine
                print(time_variant(libs, v, prec, u, K1, M1, args.reps,
                                   timed_only, routine="tile"
                                   if v in ("vxy", "v12") else None),
                      flush=True)
        if "lab_separable_ring" in own:
            for v in ("v3", "vxy", "v2"):
                for prec in BX_TIMED:
                    print(time_variant(libs, v, prec, u, K1, M1, args.reps,
                                       timed_only), flush=True)
            if name == "committed":  # each u ring that fits, 3xTF32
                count = own["lab_separable_ring"].lib.tpufem_l2_ring_smem_bytes
                for nu in range(1, separable_lab.RING_MAX_U + 1):
                    if count(4, separable_lab.X3TF32, nu) <= \
                            separable_lab.RING_BUDGET:
                        print(time_variant(libs, "v3", "highest", u, K1, M1,
                                           args.reps, False, nu), flush=True)
                for prec in BX_TIMED:  # v2's z segments
                    for seg in ((1, 2, 3, 4, 5, 6, 8, 17) if prec ==
                                "highest" else (1, 2, 3, 4, 17)):
                        print(time_variant(libs, "v2", prec, u, K1, M1,
                                           args.reps, False, seg=seg),
                              flush=True)
        if "lab_separable_band" in own:
            for line in build.ptxas_lines(
                    own["lab_separable_band"].compiler_log,
                    "l2_bxyzb_kernel"):
                print(f"  ptxas {line}", flush=True)
            for prec in BX_TIMED:
                print(time_variant(libs, "v12", prec, u, K1, M1, args.reps,
                                   timed_only), flush=True)
            if name == "committed":  # v12's z segments
                for prec in BX_TIMED:
                    for seg in ((1, 2, 3, 4, 5, 6, 8, 17) if prec ==
                                "highest" else (1, 2, 3, 4, 17)):
                        print(time_variant(libs, "v12", prec, u, K1, M1,
                                           args.reps, False, seg=seg),
                              flush=True)


if __name__ == "__main__":
    main()

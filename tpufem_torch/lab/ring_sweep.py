"""Sweep the compile-time constants of the two redesigned lab routines.

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
whole says how far the two overlap.

    python -m tpufem_torch.lab.ring_sweep [--reps 20] [--only l2_nxb1 ...]

It runs on a CUDA device and raises without one; a copy that does not build,
or an edit whose text the sources no longer hold, raises.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
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
}
ZY_TIMED = ("vcopy", "vband", "v16")
L2_TIMED = (("vx", "highest"), ("vx", "high"), ("vx", "bf16x3"),
            ("v2", "highest"), ("v12", "highest"), ("vxy", "highest"))


def edited_sources(name: str):
    """{file: text} of the csrc copy of variant ``name``: its edits applied
    (each text must occur exactly once) and the two launchers cut to p = 4."""
    _, edits, _ = VARIANTS[name]
    out = {}
    for path in build.CSRC.iterdir():
        text = path.read_text()
        for old, new in edits.get(path.name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {path.name} holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        if path.name in ("lab_zyfirst.cu", "lab_separable.cu"):
            text = re.sub(r" +TPUFEM_CASE\([1-35-8]\)\n", "", text)
        out[path.name] = text
    return out


def build_variant(name: str) -> dict:
    """Build the lab libraries of variant ``name`` (both for "committed",
    else the one it edits); returns {library name: KernelLibrary}."""
    lib_name = VARIANTS[name][0]
    d = SWEEP_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in edited_sources(name).items():
        (d / fname).write_text(text)
    names = [lib_name] if lib_name else ["lab_zyfirst", "lab_separable"]
    procs = {n: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{n}.so"),
         str(d / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}/{n}.cu failed:\n{log}")
        lib = ctypes.CDLL(str(d / f"{n}.so"))
        for entry, (argtypes, restype) in build._ENTRIES[n].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
        libs[n] = build.KernelLibrary(lib, d / f"{n}.so", 0.0, log)
    return libs


def time_variant(libs, variant, prec, u, K1, M1, reps, timed_only):
    """One line: the kernel of ``variant`` from ``libs`` at the flagship,
    held to its plain version (unless an ablation), ms of two timings."""
    real = separable_lab.load_kernels
    separable_lab.load_kernels = lambda: libs
    try:
        k = LabKernel(variant, 257, 4, K1, M1, [1.0 / 64] * 3, prec=prec,
                      device="cuda")
    finally:
        separable_lab.load_kernels = real
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
            + (f" sub-tile={k.tile}" if k.tile else "")
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
            for v, prec in L2_TIMED:
                print(time_variant(libs, v, prec, u, K1, M1, args.reps,
                                   timed_only), flush=True)


if __name__ == "__main__":
    main()

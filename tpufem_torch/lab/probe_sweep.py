"""P2's cluster chain taken apart (its products alone and its exchange
alone), and P1's wgmma tile at other widths and without its per-chunk sums.

The chain of ``csrc/toolchain_probe.cuh`` (``probe_cluster_kernel``) runs
each product's ``wgmma``s, then writes and sends its slice to every block of
its cluster and waits for theirs.  This script builds three copies of the
probe library into ``build/tpufem_torch/sweep/probe/``, side by side
(``utils.build.build_copies``): the committed sources, and two ablations with one part of the chain cut out (``VARIANTS``;
their output is wrong by design, so they are timed only): ``products``, no
slice written, sent or waited for; ``exchange``, every slice written, sent
and waited for, no ``wgmma``.  Four more copies change P1's wgmma tile:
``columns32`` and ``columns64``, a block 32 or 64 columns wide (the library
has 16); ``no_promotion``, its two accumulators carried over all of k, no
chunk's sums added on CUDA cores; ``one_accumulator``, that and the small
passes in the big*big pass's accumulator, as the earlier routine keeps
them.  It times P2's probe
(``toolchain_probe.probe_co_scheduling``, the JAX probe's inputs, CUDA
events) at (n_iter, m) = (256, 512) on the cluster chain in each arithmetic
that takes it, the copies in turns (committed, products, exchange,
committed; ``REPS`` chains a timing), and prints one JSON line per timing
after a header with the card's name and power limit (also into
``chiprun_out/probe_sweep.jsonl``); then P1 at n = 256 in each arithmetic
on the committed copy and P1's four in turns (``P1_ORDER``, then the same
reversed): its device time (``torch.profiler``), and each copy's error
against the f64 product and against the plain version in its arithmetic
at n = 256, 1040 and 2048 (``P1_SIZES``), beside the bound chip_smoke.py
holds the library to, one line each.

    python -m tpufem_torch.lab.probe_sweep

It runs on a CUDA device and raises without one; a copy that does not build,
or an edit whose text the sources no longer hold once, raises.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from tpufem_torch.lab import toolchain_probe
from tpufem_torch.utils import build

SWEEP_DIR = build.BUILD_DIR / "sweep" / "probe"
REPS = 10  # chains a timing, as toolchain_probe.main times them
# P1's accumulators carried over every chunk (no chunk starts them afresh,
# none is added into the totals before the last)
_P1_ONE_CHAIN = [
    ("hop_wgmma<BF>(acc, big[ks], op, ks, kbytes, ks > 0);",
     "hop_wgmma<BF>(acc, big[ks], op, ks, kbytes);"),
    ("    mm.keep();\n    mm.promote();\n    if (tid == 0",
     "    mm.keep();\n    if (tid == 0")]
# name -> edits of the sources {file: [(text, replacement), ...]}
VARIANTS = {
    "committed": {},
    # every product waits for w only (a completed phase) and sends nothing
    "products": {"toolchain_probe.cuh": [
        ("  if (it == 0) {\n    hop_mbar_wait(br.wb(), 0);",
         "  if (true) {\n    hop_mbar_wait(br.wb(), 0);"),
        ("  const int nb = (it + 1) % g.nbuf;\n",
         "  if (true) return;\n  const int nb = (it + 1) % g.nbuf;\n")]},
    # no batch of wgmmas: the accumulators stay zero
    "exchange": {"toolchain_probe.cuh": [
        ("    for (int b = 0; b < m / ncb; b += 2) {",
         "    for (int b = 0; b < 0; b += 2) {")]},
    # P1 a block 32 or 64 columns wide
    "columns32": {"toolchain_probe.cuh": [
        ("constexpr int kP1wColumns = 16;", "constexpr int kP1wColumns = 32;")]},
    "columns64": {"toolchain_probe.cuh": [
        ("constexpr int kP1wColumns = 16;", "constexpr int kP1wColumns = 64;")]},
    # P1's two accumulators over all of k
    "no_promotion": {"toolchain_probe.cuh": _P1_ONE_CHAIN + [
        ("hop_wgmma<BF>(acc_lo, small[ks], op, ks, kbytes, ks > 0);",
         "hop_wgmma<BF>(acc_lo, small[ks], op, ks, kbytes);")]},
    # P1's three passes in one accumulator over all of k
    "one_accumulator": {"toolchain_probe.cuh": _P1_ONE_CHAIN + [
        ("        hop_wgmma<BF>(acc_lo, small[ks], op, ks, kbytes, ks > 0);\n"
         "        hop_wgmma<BF>(acc_lo, big[ks], op + op_part, ks, kbytes);",
         "        hop_wgmma<BF>(acc, small[ks], op, ks, kbytes);\n"
         "        hop_wgmma<BF>(acc, big[ks], op + op_part, ks, kbytes);")]},
}
ORDER = ("committed", "products", "exchange", "committed")
P1_ORDER = ("committed", "columns32", "columns64", "no_promotion",
            "one_accumulator")
P1_SIZES = (256, 1040, 2048)


def build_variants() -> dict:
    """{name: KernelLibrary} of the probe library's copies, built side by
    side."""
    dirs = {name: SWEEP_DIR / name for name in VARIANTS}
    libs = build.build_copies({
        dirs[name]: (build.edited_csrc(edits, name), ["toolchain_probe"])
        for name, edits in VARIANTS.items()})
    return {name: libs[d]["toolchain_probe"] for name, d in dirs.items()}


def main() -> list[dict]:
    """Time the copies in turns in each arithmetic the cluster chain takes
    at m = 512, then P1's (``p1_turns``); returns the records it prints."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe sweep runs on a CUDA device; "
                           "torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"probe sweep: P2's cluster chain at (256, 512), P1 at n = 256, "
          f"{smi}", flush=True)
    libs = build_variants()
    out_dir = Path(__file__).resolve().parents[2] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    real = toolchain_probe.load_kernels
    records = []
    try:
        for arithmetic in toolchain_probe.ARITHMETICS:
            if toolchain_probe.chain_routine(arithmetic, 512) != "cluster":
                continue
            for name in ORDER:
                toolchain_probe.load_kernels = (
                    lambda name=name: {"toolchain_probe": libs[name]})
                rec = toolchain_probe.probe_co_scheduling(
                    arithmetic=arithmetic, reps=REPS,
                    routine="cluster")
                rec = {"variant": name, **{k: rec[k] for k in (
                    "arithmetic", "cluster", "nbuf", "sms",
                    "active_clusters", "t_mxu_ms", "t_vpu_ms", "t_both_ms",
                    "us_per_product")}}
                records.append(rec)
                print(json.dumps(rec), flush=True)
        records += p1_turns(libs)
    finally:
        toolchain_probe.load_kernels = real
    (out_dir / "probe_sweep.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    return records


def p1_turns(libs: dict) -> list[dict]:
    """P1 on seeded pairs, each arithmetic: the copies of ``P1_ORDER`` in
    turns (then reversed) at n = 256, device ms (a chain of 30 launches
    under ``torch.profiler``); then each copy's max |error| / max |c|
    against the f64 product and against the plain version in the
    arithmetic at each n of ``P1_SIZES``."""
    from tpufem_torch.apps.resident_probe import device_ms
    from tpufem_torch.lab.separable_lab import EMU_TOL, PRECS

    gen = torch.Generator().manual_seed(21)
    pairs = {n: tuple(torch.randn((n, n), generator=gen).cuda()
                      for _ in range(2)) for n in P1_SIZES}
    a, b = pairs[256]
    records = []

    def use(name):
        toolchain_probe.load_kernels = (
            lambda: {"toolchain_probe": libs[name]})

    for arithmetic in toolchain_probe.ARITHMETICS:
        for name in P1_ORDER + P1_ORDER[::-1]:
            use(name)
            rec = {"variant": name, "probe": "P1", "arithmetic": arithmetic,
                   "n": 256, "device_ms": device_ms(
                       lambda _, x=arithmetic: toolchain_probe.matmul(
                           a, b, x), a, 30)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    for n, (x, y) in pairs.items():
        ref = x.double() @ y.double()
        for arithmetic in toolchain_probe.ARITHMETICS:
            emu = toolchain_probe.matmul_plain(x, y, arithmetic)
            bound = min(EMU_TOL[PRECS[arithmetic]],
                        toolchain_probe.P1_PLAIN_TOL)
            for name in P1_ORDER:
                use(name)
                c = toolchain_probe.matmul(x, y, arithmetic)
                rec = {"variant": name, "probe": "P1 error",
                       "arithmetic": arithmetic, "n": n,
                       "rel_err": float((c.double() - ref).abs().max()
                                        / ref.abs().max()),
                       "off_plain": float((c - emu).abs().max()
                                          / ref.abs().max()),
                       "bound": bound}
                records.append(rec)
                print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()

"""P2's cluster chain taken apart: its products alone and its exchange alone.

The chain of ``csrc/toolchain_probe.cuh`` (``probe_cluster_kernel``) runs
each product's ``wgmma``s, then writes and sends its slice to every block of
its cluster and waits for theirs.  This script builds three copies of the
probe library into ``build/tpufem_torch/sweep/probe/``, side by side
(``utils.build.build_copies``): the committed sources, and two ablations with one part of the chain cut out (``VARIANTS``;
their output is wrong by design, so they are timed only): ``products``, no
slice written, sent or waited for; ``exchange``, every slice written, sent
and waited for, no ``wgmma``.  It times P2's probe
(``toolchain_probe.probe_co_scheduling``, the JAX probe's inputs, CUDA
events) at (n_iter, m) = (256, 512) on the cluster chain in each arithmetic
that takes it, the copies in turns (committed, products, exchange,
committed; ``REPS`` chains a timing), and prints one JSON line per timing
after a header with the card's name and power limit (also into
``chiprun_out/probe_sweep.jsonl``).

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
}
ORDER = ("committed", "products", "exchange", "committed")


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
    at m = 512; returns the records it prints."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe sweep runs on a CUDA device; "
                           "torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"probe sweep: P2's cluster chain at (256, 512), {smi}",
          flush=True)
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
    finally:
        toolchain_probe.load_kernels = real
    (out_dir / "probe_sweep.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    return records


if __name__ == "__main__":
    main()

"""Sweep the schedule of K2's z-march: its output tile and z-segments.

K2 (``ops/kernel_separable.py::KernelSeparable``) runs the z-march of
``csrc/separable_apply.cuh`` at the (TY, TX) tile and segment count that
``choose_march`` picks from a cost model.  This script times the march at
every tile the block holds (halo'd columns at least a quarter of
``tpufem_march_cols`` or all of the grid's, in 2D a sixteenth) and at a spread of segment counts, at the main path's
shapes (3D Q4 npts 17 to 257, 2D npts 33 to 4097; f32, the hyper_cube's
operators), beside the chooser's pick and the tile routine, each schedule
held bit for bit to the tile routine first (grids of at most
``DEVICE_TIMED`` points ranked by device time, the larger ones by chains of
applies).  One JSON line per schedule goes
to ``chiprun_out/march_sweep.jsonl``; the header line is the card's name and
power limit, then each shape's chooser pick, the fastest schedule and the
tile routine in turns with the pick.

    python -m tpufem_torch.lab.march_sweep [--reps 20] [--shapes 3:129 2:4097]

It also prints each march instance's registers and spills from the build's
ptxas log.  It runs on a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from tpufem_torch.apps.resident_probe import device_ms
from tpufem_torch.ops import kernel_separable as ks
from tpufem_torch.ops.separable import global_1d_matrices
from tpufem_torch.utils.build import load_kernels, ptxas_lines
from tpufem_torch.utils.timer import time_fn

SHAPES = ((3, 17), (3, 33), (3, 65), (3, 129), (3, 257), (2, 33), (2, 129),
          (2, 513), (2, 1025), (2, 4097))
OUT = Path(__file__).resolve().parents[2] / "chiprun_out"
# grids of at most this many points are ranked by the kernels' device time
# (torch.profiler; a chain of their applies measures the host's launches)
DEVICE_TIMED = 300_000


def candidates(band: ks._BandApply, cols: int, slots_of):
    """(tile, nseg) schedules of the sweep at band's shape."""
    npts, p, dim = band.npts, band.p, band.dim
    splits = sorted({t for t in (-(-npts // n) for n in range(1, npts + 1))
                     if 2 * (npts % t or t) >= t}, reverse=True)
    out = []
    for tx in splits:
        for ty in (splits if dim == 3 else (1,)):
            ly = ty + 2 * p if dim == 3 else 1
            whole = (npts + 2 * p) ** (dim - 1)  # halo'd columns of it all
            least = min(cols // 4, whole) // (4 if dim == 2 else 1)
            if not least <= ly * (tx + 2 * p) <= cols:
                continue
            slots = slots_of(ty, tx)
            if slots < 1:
                continue
            tiles = -(-npts // tx) * (-(-npts // ty) if dim == 3 else 1)
            for seg in splits:
                nseg = -(-npts // seg)
                waves = tiles * nseg / slots
                if 0.4 <= waves <= 4.5 or (nseg == 1 and waves > 4.5):
                    out.append(((ty, tx), nseg))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="dim:npts pairs (default: SHAPES)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("march_sweep times the z-march on a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    lib = load_kernels()["separable_apply"]
    for line in ptxas_lines(lib.compiler_log, "march") or [
            "no log: the library was built by an earlier process"]:
        print("ptxas", line, flush=True)
    shapes = SHAPES if args.shapes is None else [
        tuple(int(v) for v in s.split(":")) for s in args.shapes]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    OUT.mkdir(exist_ok=True)
    rows = open(OUT / "march_sweep.jsonl", "a")
    for dim, npts in shapes:
        n = (npts - 1) // 4
        K, M = global_1d_matrices(4, n, 5)
        k = ks.KernelSeparable(dim, npts, 4, [K * n] * dim, [M / n] * dim,
                               torch.float32, dev)
        band, tile = k.with_routine("march"), k.with_routine("tile")
        x = torch.tensor(np.random.default_rng(npts).standard_normal(
            npts**dim), dtype=torch.float32, device=dev)
        ref = tile.launch(x)
        cols = band.lib.lib.tpufem_march_cols(band.code, dim, band.p)
        bps = lambda ty, tx: band.lib.lib.tpufem_march_blocks_per_sm(
            band.code, dim, band.p, ty, tx)
        pick = (band.tile, band.nseg)
        results = []
        for sched in [pick] + candidates(band, cols,
                                         lambda ty, tx: n_sm * bps(ty, tx)):
            band.schedule("march", *sched)
            y = band.launch(x)
            if not torch.equal(y.view(torch.int32), ref.view(torch.int32)):
                raise RuntimeError(f"march at {sched} is not bitwise equal "
                                   f"to the tile routine at {dim}D npts "
                                   f"{npts}")
            ms = 1e3 * time_fn(band.launch, x, reps=args.reps)
            rec = {"dim": dim, "npts": npts, "tile": list(sched[0]),
                   "nseg": sched[1], "blocks_per_sm": bps(*sched[0]),
                   "ms": ms, "pick": sched == pick, "device": smi}
            if npts**dim <= DEVICE_TIMED:
                # 0: the profiler saw no kernel (the chain's ms stands)
                rec["device_ms"] = device_ms(band.launch, x, args.reps)
                ms = rec["device_ms"] or ms
            rows.write(json.dumps(rec) + "\n")
            results.append((ms, sched))
        band.schedule("march", *pick)
        best = min(results)
        timer = ((lambda f: device_ms(f, x, args.reps))
                 if npts**dim <= DEVICE_TIMED
                 else (lambda f: 1e3 * time_fn(f, x, reps=args.reps)))
        turns = [timer(f) for f in (tile.launch, band.launch, band.launch,
                                    tile.launch)]
        print(json.dumps({
            "dim": dim, "npts": npts, "pick": [list(pick[0]), pick[1]],
            "pick_ms": results[0][0], "best": [list(best[1][0]), best[1][1]],
            "best_ms": best[0], "schedules": len(results),
            "turns_tile_march_march_tile": turns, "device": smi}),
            flush=True)
    rows.close()


if __name__ == "__main__":
    main()

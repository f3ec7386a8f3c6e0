"""Sweep the design of the ring routines of the K1 lab's v17, v19 and v20.

``resident_lab.V17Kernel`` runs v17, v19 and v20 on the ring routines of
``csrc/lab_resident_ring.cuh`` (TMA-fed z/y bands, a ``wgmma`` x stage over
x chunks; v19 warp-specialised and persistent; v20 v19's roles with the
x stage windowed) at the sub-tile, ring depths and persistent grid that
``resident_lab.choose_ring`` (v20: ``choose_window``) picks.  This script
times, at the flagship (3D Q4 refine 6, 16,974,593 DoFs), on the card:

1. the sub-tiles of ``RING_TILES`` at p = 4 in each precision (3xTF32,
   1xTF32, bf16x3, f64), v17, v19 and v20;
2. v17's and v19's ring depths (u slots, B stages), v19's qq stages, v20's
   u slots and qq window stages (``WINDOW_DEPTHS``), and the persistent
   grid, in 3xTF32 and in the ablations, each output held bit for bit to
   the chooser's first.

It prints the card's name and power limit and the ring instances'
registers and spills from the build's ptxas log; one JSON line per timing
goes to ``chiprun_out/lab_ring_sweep.jsonl``.  The checks of every mode
against the plain version and the timings in turns with the tile routine
are ``chip_smoke.py``'s phases 5 and 6.

    python -m tpufem_torch.lab.lab_ring_sweep

It runs on a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from tpufem_torch.lab import resident_lab as rl
from tpufem_torch.ops.separable import global_1d_matrices
from tpufem_torch.utils.build import load_kernels, ptxas_lines
from tpufem_torch.utils.timer import time_fn

OUT = Path(__file__).resolve().parents[2] / "chiprun_out"
REPS = 20  # raw applies a timing
P, N = 4, 64  # the flagship: npts = N P + 1 = 257


def kernel(kern, mode, **kw):
    """A V17Kernel at the flagship on the card; mode "f32h" is 1xTF32,
    "f64" the exact x stage in float64."""
    K1, M1 = global_1d_matrices(P, N, P + 1)
    return rl.V17Kernel(N * P + 1, P, K1, M1, [1.0 / N] * 3,
                        mode={"f64": "f32", "f32h": "f32"}.get(mode, mode),
                        prec="high" if mode == "f32h" else "highest",
                        kern_name=kern, device="cuda",
                        dtype=torch.float64 if mode == "f64"
                        else torch.float32, **kw)


def ms(k, gp) -> float:
    """ms per raw apply of k on gp (CUDA events over REPS applies)."""
    return 1e3 * time_fn(lambda _: k.raw(gp), gp, reps=REPS)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the lab runs on a CUDA device; torch.cuda is not "
                           "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log = load_kernels()["lab_resident"].compiler_log
    for line in ptxas_lines(log, "lab_ring") + ptxas_lines(
            log, "lab_window") or [
            "no log: the library was built by an earlier process"]:
        print("ptxas", line, flush=True)
    OUT.mkdir(exist_ok=True)
    u = torch.tensor(np.random.default_rng(17).standard_normal(
        (N * P + 1)**3), device="cuda")
    with open(OUT / "lab_ring_sweep.jsonl", "w") as out:

        def record(rec):
            rec["device"] = smi
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)

        for mode in ("f32", "f32h", "bf16", "f64"):
            for kern in rl.RING_KERNELS:
                for tile in rl.RING_TILES:
                    try:
                        k = kernel(kern, mode, tile=tile)
                    except ValueError as e:  # no ring of it fits
                        print(f"{kern} {mode} {tile}: {e}", flush=True)
                        continue
                    record({"what": "tile", "kern": kern, "mode": mode,
                            "tile": tile, "ring": k.ring, "grid": k.grid,
                            "smem": k.smem, "ms": ms(k, k.pad(u.to(k.dt))),
                            "design_ms": k.design_bound()[0]})
        # the chooser's rings and grid overridden (the launcher sizes its
        # shared memory from them)
        for kern, mode in (("v17", "f32"), ("v17", "mm"), ("v19", "f32"),
                           ("v19", "mm"), ("v19", "copy"), ("v19", "bands"),
                           ("v20", "f32"), ("v20", "mm"), ("v20", "copy"),
                           ("v20", "bands")):
            k = kernel(kern, mode)
            gp = k.pad(u.to(k.dt))
            y0 = k.raw(gp)
            grids = [k.grid] if kern == "v17" else \
                [132, 264, 528, (-(-(N * P + 1) // 8))**2]
            depths = ([(nu, rl.WIN_B, nq) for nu, nq in rl.WINDOW_DEPTHS]
                      if kern == "v20" else
                      [(nu, nb, nq) for nu, nb in rl.RING_DEPTHS
                       for nq in ((1,) if kern == "v17" else (1, 2))])
            for ring in depths:
                for grid in grids:
                    k.ring = ring + k.ring[3:]
                    k.grid = grid
                    if not torch.equal(k.raw(gp), y0):
                        raise RuntimeError(f"{kern} {mode} rings {k.ring} "
                                           f"grid {grid}: not the chooser's "
                                           "output")
                    record({"what": "rings", "kern": kern, "mode": mode,
                            "ring": k.ring, "grid": grid, "ms": ms(k, gp)})


if __name__ == "__main__":
    main()

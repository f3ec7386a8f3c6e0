"""Batch-run bmop over (degree, refine) and print a markdown table.

Port of ``scripts/run_sweep.py`` (the reference repo's batch-run helpers,
SURVEY.md §2: run over (p, refinement), extract timings).  Each cell is
one ``python -m tpufem_torch.apps.bmop`` subprocess, so every cell pays
its own start-up and kernel loads; results stream to stdout as they land,
the raw records go to a JSONL file, and the table prints at the end.  A
cell that fails, times out or prints no JSON line is recorded with its
``error`` and shows as ERR in the table.

Run:  python -m tpufem_torch.apps.run_sweep --dim 3 --degrees 1 2 3 4
      --refines 3 4        (on the card; --device cpu for the CPU)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from tpufem_torch.ops.matrix_free import resolve_device

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "chiprun_out" / "sweep.jsonl"


def run_cell(dim, p, refine, dtype, reps, device, timeout):
    cmd = [sys.executable, "-m", "tpufem_torch.apps.bmop", "--dim",
           str(dim), "--degrees", str(p), "--refine", str(refine),
           "--dtype", dtype, "--reps", str(reps), "--device", device]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"error": "timeout", "wall_s": timeout}
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        return {"error": r.stderr.strip()[-200:], "wall_s": round(wall, 1)}
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        rec["wall_s"] = round(wall, 1)
        return rec
    return {"error": "no JSON line", "wall_s": round(wall, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degrees", type=int, nargs="+",
                    default=[1, 2, 3, 4])
    ap.add_argument("--refines", type=int, nargs="+", default=[4])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=int, default=900,
                    help="per-cell subprocess cap (s)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda",
                    help="torch device of every cell; 'cuda' raises when "
                         "CUDA is absent")
    args = ap.parse_args(argv)
    device = args.device
    resolve_device(device)

    cells = {}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for refine in args.refines:
            for p in args.degrees:
                rec = run_cell(args.dim, p, refine, args.dtype, args.reps,
                               device, args.timeout)
                rec.update(degree=p, refine=refine, dim=args.dim)
                cells[(refine, p)] = rec
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(json.dumps(rec), flush=True)

    print(f"\n## bmop sweep — {args.dim}D, {args.dtype} (GDoF/s)\n")
    hdr = "| refine | " + " | ".join(f"p={p}" for p in args.degrees) + " |"
    print(hdr)
    print("|" + "---|" * (len(args.degrees) + 1))
    for refine in args.refines:
        row = [f"| {refine} "]
        for p in args.degrees:
            rec = cells[(refine, p)]
            v = rec.get("gdofs_per_s")
            row.append(f"| {v:.3f} " if v is not None
                       else "| ERR ")
        print("".join(row) + "|")
    print(f"\nraw records: {args.out}")
    return cells


if __name__ == "__main__":
    main()

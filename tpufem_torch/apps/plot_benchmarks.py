"""Tabulate and plot bmop JSONL results.

Port of ``scripts/plot_benchmarks.py``.  Reads the ``bench == "bmop"``
records of a JSONL file (``tpufem_torch.apps.run_sweep``'s, or bmop's
own lines), prints a GDoF/s table a degree, and draws a PNG beside the
JSONL file where matplotlib is installed; where it is not (the card's
machine has none), it prints one line saying so.

Run:  python -m tpufem_torch.apps.plot_benchmarks bench_results.jsonl
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def read_rows(path) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("bench") == "bmop":
                rows.append(rec)
    return rows


def plot(rows: list[dict], png: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ps = [r["degree"] for r in rows]
    gd = [r["gdofs_per_s"] for r in rows]
    fig, ax = plt.subplots()
    ax.plot(ps, gd, "o-", label="matrix-free")
    if any("spmv_gdofs_per_s" in r for r in rows):
        ax.plot(ps, [r.get("spmv_gdofs_per_s", float("nan"))
                     for r in rows], "s--", label="assembled SpMV")
    ax.set_xlabel("polynomial degree p")
    ax.set_ylabel("GDoF/s")
    ax.legend()
    fig.savefig(png, dpi=120)
    plt.close(fig)


def main(path: str = "bench_results.jsonl") -> list[dict]:
    rows = read_rows(path)
    if not rows:
        print("no bmop records found")
        return rows
    print(f"{'dim':>3} {'p':>2} {'ndofs':>10} {'scheme':>10} "
          f"{'GDoF/s':>8} {'SpMV GDoF/s':>11} {'speedup':>7}")
    for r in sorted(rows, key=lambda r: (r["dim"], r["degree"])):
        print(
            f"{r['dim']:>3} {r['degree']:>2} {r['n_dofs']:>10} "
            f"{r['scheme']:>10} {r['gdofs_per_s']:>8.3f} "
            f"{r.get('spmv_gdofs_per_s', float('nan')):>11.3f} "
            f"{r.get('mf_speedup_vs_spmv', float('nan')):>7.2f}"
        )
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plot drawn")
        return rows
    png = Path(path).with_suffix(".png")
    plot(rows, png)
    print(f"wrote {png}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "bench_results.jsonl")

"""Machine-diff a chip_checks artifact against the committed golden.

Port of ``scripts/check_chip_goldens.py``, with its comparison rules:

    python -m tpufem_torch.apps.chip_checks --out chiprun_out/chip_checks.json
    python -m tpufem_torch.apps.check_chip_goldens chiprun_out/chip_checks.json

Exit 0 iff every golden check matches:
  - iteration counts EQUAL the golden exactly (the bitwise-stability
    record: counts must not drift run to run, nor from one change of the
    code to the next, for the same program on the same card);
  - bitwise_identical_solutions is true wherever the golden says so;
  - rel_err <= the golden's rel_err_max bound;
  - the artifact's platform is the golden's;
  - a check missing from the artifact, or one whose pass is false, fails.
Nonzero exit and a per-field diff on any regression.

The default golden is the H100's (``tpufem_torch/goldens/
chip_checks_h100.json``, platform "gpu"); ``tests/goldens/
chip_checks_golden.json`` is the JAX package's TPU record.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

GOLDEN = Path(__file__).resolve().parents[1] / "goldens" / \
    "chip_checks_h100.json"
ARTIFACT = Path(__file__).resolve().parents[2] / "chiprun_out" / \
    "chip_checks.json"


def failures(golden: dict, got: dict) -> list[str]:
    """The per-field diff of artifact ``got`` against ``golden``."""
    out = []
    if got.get("platform") != golden.get("platform"):
        out.append(
            f"platform: artifact ran on {got.get('platform')!r}, golden "
            f"is for {golden.get('platform')!r} — chip goldens must be "
            "diffed against a chip run")

    by_check = {r.get("check"): r for r in got.get("records", [])}
    for g in golden["records"]:
        name = g["check"]
        r = by_check.get(name)
        if r is None:
            out.append(f"{name}: missing from artifact")
            continue
        if not r.get("pass", False):
            out.append(f"{name}: pass={r.get('pass')}")
        for key in g:
            # any *iterations field is an exact-match count record
            # (iterations, newton_iterations, linear_iterations, ...)
            if key.endswith("iterations"):
                if r.get(key) != g[key]:
                    out.append(
                        f"{name}: {key} {r.get(key)} != golden "
                        f"{g[key]}")
        if g.get("bitwise_identical_solutions"):
            if not r.get("bitwise_identical_solutions"):
                out.append(f"{name}: solutions not bitwise identical")
        if "rel_err_max" in g:
            rel = r.get("rel_err")
            if rel is None or rel > g["rel_err_max"]:
                out.append(
                    f"{name}: rel_err {rel} > golden bound "
                    f"{g['rel_err_max']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("artifact", nargs="?", default=str(ARTIFACT))
    ap.add_argument("--golden", default=str(GOLDEN))
    args = ap.parse_args(argv)

    with open(args.golden) as f:
        golden = json.load(f)
    with open(args.artifact) as f:
        got = json.load(f)

    bad = failures(golden, got)
    if bad:
        print("chip golden REGRESSION:")
        for f_ in bad:
            print(f"  - {f_}")
        return 1
    print(f"chip goldens OK: {len(golden['records'])} checks match "
          f"{args.artifact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

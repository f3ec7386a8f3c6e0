"""Card A/B: the precision ladder of the adaptive box tier.

Port of ``scripts/adaptive_prec_lab.py``.  The reference measured what a
TPU's one-pass bf16 product does to the box tier's constrained apply
(the per-box cell loop's matmuls, then the pair and rect transfers).  On
an H100 TF32 is that silent one-pass product (ROADMAP, "Precision"), so
the ladder maps as follows:

  f32          the baseline: the port's true f32 (the reference's
               ``high``, its production tier);
  cells-tf32   the cell stage's products in TF32, the pair and rect
               transfers in f32, so that the exact identity rows of the
               compress sweeps stay faithful (the reference's
               ``cells-def``);
  all-tf32     every product of the apply in TF32 (``all-def``);
  bf16-patch   the operator in bfloat16: patch vectors, tables and
               products (``BoxLaplaceOperator.recast("bfloat16")``, the
               same device tensors a bfloat16 build casts from the host
               data).

Like the reference, which patches ``structured._AXIS_MM_PRECISION_F32``
and ``BoxLaplaceOperator._pair_apply``, the lab gets its variants by
patching inside the lab only: it turns TF32 on around the apply
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.set_float32_matmul_precision``), and for ``cells-tf32`` gives
``BoxLaplaceOperator._pair_apply``, ``_rect_interp_b`` and
``_rect_interp_t_b`` wrappers that turn it off around their products.
Every patch and both settings are restored in a ``finally``;
``utils/precision.py`` and ``ops/boxes.py`` gain no knob.  On the CPU
TF32 does not exist, so the two TF32 variants compute f32 there.

Each variant reports the chained rate (``bmop.chain_seconds``: 30
applies, the 1e-7 rescale) and its single apply's relative error against
``f32``.  A variant that raises goes into the result's ``failed`` map
with its exception's type and text, as ``bmop`` records ``tier_errors``.

Run:  python -m tpufem_torch.lab.adaptive_prec_lab [refine] [steps]
      [--device cpu]    (default refine 4, 2 steps: 3,302,995 DoFs)
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from tpufem_torch.apps.bmop import build_adaptive_op, chain_seconds
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.utils.timer import synchronize

N_CHAIN = 30
VARIANTS = ("f32", "cells-tf32", "all-tf32", "bf16-patch")
# the box tier's transfer products, kept in f32 by ``cells-tf32``
TRANSFERS = ("_pair_apply", "_rect_interp_b", "_rect_interp_t_b")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off inside the block; both settings restored."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high" if on else "highest")
        torch.backends.cuda.matmul.allow_tf32 = on
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def _in_f32(fn):
    def wrapped(*args, **kw):
        with tf32(False):
            return fn(*args, **kw)
    return staticmethod(wrapped)


@contextlib.contextmanager
def transfers_in_f32():
    """``BoxLaplaceOperator``'s transfer products in f32 inside the
    block, whatever the TF32 setting around them; restored after."""
    saved = {name: BoxLaplaceOperator.__dict__[name] for name in TRANSFERS}
    try:
        for name, sm in saved.items():
            setattr(BoxLaplaceOperator, name, _in_f32(sm.__func__))
        yield
    finally:
        for name, sm in saved.items():
            setattr(BoxLaplaceOperator, name, sm)


def variant(tag: str):
    """The context a variant's applies run in."""
    if tag in ("f32", "bf16-patch"):
        return contextlib.nullcontext()
    if tag == "all-tf32":
        return tf32(True)
    if tag == "cells-tf32":
        stack = contextlib.ExitStack()
        stack.enter_context(tf32(True))
        stack.enter_context(transfers_in_f32())
        return stack
    raise ValueError(f"unknown variant {tag!r}; expected one of {VARIANTS}")


def one_apply(op, x) -> np.ndarray:
    """One constrained apply, the patch vector in f64 on the host."""
    return op.vmult(x).to("cpu", torch.float64).numpy()


def main(refine: int = 4, steps: int = 2,
         device: torch.device | str = "cuda", prebuilt=None,
         log=print) -> dict:
    """The ladder on ``adaptive_mesh(3, refine, steps)`` at Q4, or on
    ``prebuilt``: (mesh, dofs, constraints), or ``build_adaptive_op``'s
    (mesh, dofs, constraints, f32 operator), whose device is used.
    Returns {"n_dofs", "n_hanging", "gdofs", "ms", "rel_err", "failed",
    "y"} (rates, ms an apply, errors against ``f32`` and the single
    applies' patch vectors, each by variant)."""
    t0 = time.perf_counter()
    if prebuilt is None:
        prebuilt = build_adaptive_op(3, 4, refine, steps, "float32", device)
    mesh, dofs, ac = prebuilt[:3]
    op = prebuilt[3] if len(prebuilt) > 3 else None
    if op is None:
        op = BoxLaplaceOperator(mesh, dofs, constraints=ac,
                                dtype="float32",
                                device=resolve_device(device))
    device = op.device
    log(f"setup {time.perf_counter() - t0:.1f} s  n_dofs={dofs.n_dofs} "
        f"n_hanging={len(ac.lines)} device={device}")
    out: dict = {"n_dofs": dofs.n_dofs, "n_hanging": len(ac.lines),
                 "gdofs": {}, "ms": {}, "rel_err": {}, "failed": {},
                 "y": {}}
    x32 = op.to_patch(np.ones(dofs.n_dofs))
    for tag in VARIANTS:
        tb = time.perf_counter()
        try:
            vop = op.recast("bfloat16") if tag == "bf16-patch" else op
            x = x32.to(vop.dt)
            with variant(tag):
                dt = chain_seconds(vop.vmult, x, N_CHAIN,
                                   f"{tag} box apply")
                y = one_apply(vop, x)
            synchronize(device)
        except Exception as e:  # recorded, not dropped
            out["failed"][tag] = f"{type(e).__name__}: {e}"
            log(f"{tag:12s} FAILED: {out['failed'][tag]}")
            continue
        ref = out["y"].get("f32")
        if tag == "f32":
            err = 0.0
        elif ref is None:  # no baseline to hold it to
            err = None
        else:
            err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
        out["gdofs"][tag] = dofs.n_dofs / dt / 1e9
        out["ms"][tag] = 1e3 * dt
        out["rel_err"][tag] = err
        out["y"][tag] = y
        log(f"{tag:12s} {out['gdofs'][tag]:.4f} GDoF/s  ({1e3 * dt:.4f} "
            f"ms)  rel_err={'n/a' if err is None else f'{err:.3e}'}  "
            f"{time.perf_counter() - tb:.1f} s")
    log(str({k: round(v, 4) for k, v in out["gdofs"].items()}))
    return out


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("refine", type=int, nargs="?", default=4)
    ap.add_argument("steps", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    res = main(args.refine, args.steps,
               device=args.device)
    if res["failed"]:
        raise SystemExit(f"variants failed: {res['failed']}")


if __name__ == "__main__":
    cli()

"""Where the time of a sharded box apply goes, with every shard on one card.

On the adaptive mesh ``adaptive_mesh(3, --refine, --steps)`` at
``--degree`` (the defaults: the JAX bench's adaptive flagship, 3D Q4,
3,302,995 DoFs) in f32, for each shard grid 2x2 and 4x1, one JSON line
with the ms a call (the mean of ``REPS`` calls, CUDA events on the card,
the host clock on the CPU) of

- ``local``: the shards' partial applies alone (``raw_local``, every
  shard, no exchange);
- ``reconcile``: the cut-plane reconciliation alone (both axes), on a
  fixed partial field, less the copy that keeps that field fixed;
- ``vmult``: the whole sharded apply;

and on the card ``device_ms``, the device time of one vmult (the kernels
``torch.profiler`` sees over ``REPS`` vmults, summed over the cards the
shards sit on), and ``busy``, that time over ``vmult``.  A last line gives
the same for the single-device apply of the same operator.

Run from the repository root:  python -m tpufem_torch.apps.distributed_probe
(``--cpu`` and small sizes to try it without a card).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpufem_torch.apps.bmop import build_adaptive_op
from tpufem_torch.parallel.boxes import DistributedBoxLaplace
from tpufem_torch.parallel.mesh import Sharded
from tpufem_torch.utils.timer import synchronize

REPS = 10


def _mean_ms(fn, devices, reps):
    """ms a call of ``fn``, the mean of ``reps`` calls after one warm call:
    CUDA events on the first card after waiting for every card, the host
    clock on the CPU."""
    fn()
    for d in devices:
        synchronize(d)
    if devices[0].type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(devices[0]))
    for _ in range(reps):
        fn()
    for d in devices[1:]:
        synchronize(d)
    end.record(torch.cuda.current_stream(devices[0]))
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, devices, reps):
    """Device ms a call of ``fn``: the CUDA kernels ``torch.profiler`` sees
    over ``reps`` calls, summed, over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        for d in devices:
            synchronize(d)
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(e.device_type).endswith("CUDA")) / 1e3 / reps


def apply_split(dop: DistributedBoxLaplace, x: Sharded) -> dict:
    """The split of ``dop.vmult(x)`` described in the module docstring."""
    devices = list(dict.fromkeys(a.device for a in x.parts))
    y0 = Sharded(lo.raw_local(p) for lo, p in zip(dop.locals, x.parts))

    def reconcile():
        y = Sharded(a.clone() for a in y0.parts)
        y = dop._reconcile_axis(y, 0)
        return dop._reconcile_axis(y, 1) if dop.sy > 1 else y

    out = {
        "local": _mean_ms(lambda: [lo.raw_local(p) for lo, p in
                                   zip(dop.locals, x.parts)], devices, REPS),
        "reconcile": _mean_ms(reconcile, devices, REPS) - _mean_ms(
            lambda: [a.clone() for a in y0.parts], devices, REPS),
        "vmult": _mean_ms(lambda: dop.vmult(x), devices, REPS)}
    if devices[0].type == "cuda":
        out["device_ms"] = _device_ms(lambda: dop.vmult(x), devices, REPS)
        out["busy"] = out["device_ms"] / out["vmult"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    mesh, dofs, _, op = build_adaptive_op(3, args.degree, args.refine,
                                          args.steps, "float32", device)
    xp = op.to_patch(np.ones(dofs.n_dofs))
    head = {"bench": "distributed-apply-split", "degree": args.degree,
            "refine": args.refine, "adaptive_steps": args.steps,
            "n_dofs": dofs.n_dofs, "dtype": "float32", "reps": REPS}
    if op.device.type == "cuda":
        head["device"] = torch.cuda.get_device_name(op.device)
    for grid in ((2, 2), (4, 1)):
        dop = DistributedBoxLaplace(op, shards=grid)
        rec = apply_split(dop, dop.put_vector(xp))
        print(json.dumps(dict(head, shards=f"{dop.sz}x{dop.sy}", **rec)),
              flush=True)
        del dop
    devices = [op.device]
    rec = {"vmult": _mean_ms(lambda: op.vmult(xp), devices, REPS)}
    if op.device.type == "cuda":
        rec["device_ms"] = _device_ms(lambda: op.vmult(xp), devices, REPS)
        rec["busy"] = rec["device_ms"] / rec["vmult"]
    print(json.dumps(dict(head, shards="single", **rec)), flush=True)


if __name__ == "__main__":
    main()

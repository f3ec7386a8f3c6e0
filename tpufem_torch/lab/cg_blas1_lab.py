"""Card lab: where do the resident CG's non-apply milliseconds go?

Port of ``scripts/cg_blas1_lab.py``.  The resident Jacobi-CG through K1
spends about half of its device time outside the apply, in the BLAS-1
around it (PERF.md §5).  This lab times, on vectors of the resident
layout (``ResidentSeparable``'s ``(npts, npts, X)`` at 3D Q4 refine 6,
X = ``kernel_separable.resident_x``):

  1. one axpy pass, x <- x + a p (``torch.add``: read 2N, write N);
  2. the two dots the port's solvers take: ``solvers.cg._default_dot``
     (flat vectors) and ``solvers.resident._dot3`` (the resident layout).
     The JAX lab's HIGHEST / DEFAULT dot pair has no separate form here:
     an f32 ``torch.dot`` has no reduced-pass mode, so one dot of each
     solver is timed;
  3. the production ``cg_solve`` with A a one-pass near-identity
     (v -> 1.0000001 v) and a Jacobi ``M_inv``, ``track_best`` True and
     False;
  4. the hand-fused body: the same recurrence with in-place torch ops
     (``addcmul_`` for the updates, one ``torch.dot`` per dot, no host
     read), no new kernel.

Each step is a Python loop of ``iters`` steps, timed by
``utils.timer.time_fn`` (CUDA events, synchronised before and after; on
the CPU ``time.perf_counter``).  Each line reports ``ms_per_iter``, the
effective GB/s at the assumed pass count over one vector, and the byte
bound of those passes (``timer.roofline_ms``).

Run:  python -m tpufem_torch.lab.cg_blas1_lab [--shape NZ NY NX]
      [--iters 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpufem_torch.ops.kernel_separable import resident_x
from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.solvers.cg import _default_dot, cg_solve
from tpufem_torch.solvers.resident import _dot3
from tpufem_torch.utils.timer import roofline_ms, time_fn

# the stand-in apply, v -> A_SCALE v: one read and one write pass
A_SCALE = 1.0000001
# passes over one vector an iteration, counted from the operations: the
# hand-fused body's apply 2, dot(p, v) 2, x and r addcmul_ 3 + 3, z = idiag
# r 3, dot(r, z) 2, p addcmul 3
FUSED_PASSES = 2 + 2 + 3 + 3 + 3 + 2 + 3
# cg.py's body: the apply 2, dot(p, v) 2, x and r each a scale and an add
# 5 + 5, the ||r|| dot 2, z 3, dot(r, z) 2, p a scale and an add 5
CG_PASSES = 2 + 2 + 5 + 5 + 2 + 3 + 2 + 5


def resident_shape(refine: int = 6, p: int = 4,
                   storage: torch.dtype = torch.float32) -> tuple:
    """The resident layout ``ResidentSeparable`` keeps at 3D Q_p
    ``refine``: (npts, npts, X), X the ring's padded row length."""
    npts = (1 << refine) * p + 1
    return (npts, npts, resident_x(npts, storage))


def emit(log, **kw) -> dict:
    log(json.dumps(kw))
    return kw


def _line(log, name, dt, passes, nbytes, **extra) -> dict:
    bound, by = roofline_ms(passes * nbytes, {})
    return emit(log, check=name, ms_per_iter=1e3 * dt,
                eff_gbps_at_assumed_passes=passes * nbytes / dt / 1e9,
                assumed_passes=passes, bound_ms_per_iter=bound,
                bound_by=by, **extra)


def fused_cg(b, idiag, iters):
    """``iters`` steps of Jacobi-CG on A = ``A_SCALE`` I from x = 0, the
    hand-fused body: in-place updates, one ``torch.dot`` a dot, no host
    read.  Returns (x, r, p, rz)."""
    dot = lambda a, c: torch.dot(a.reshape(-1), c.reshape(-1))
    x = torch.zeros_like(b)
    r = b.clone()
    z = idiag * r
    p = z.clone()
    v = torch.empty_like(b)
    rz = dot(r, z)
    for _ in range(iters):
        torch.mul(p, A_SCALE, out=v)  # the stand-in apply
        alpha = rz / dot(p, v)
        x.addcmul_(p, alpha)
        r.addcmul_(v, alpha, value=-1.0)
        torch.mul(idiag, r, out=z)
        rz_new = dot(r, z)
        beta = rz_new / rz
        torch.addcmul(z, p, beta, out=p)
        rz = rz_new
    return x, r, p, rz


def main(shape=None, iters: int = 40, device: torch.device | str = "cuda",
         log=print) -> list[dict]:
    """Time each step at ``shape`` (default ``resident_shape()``) on
    ``device``; returns the records (also printed, one JSON line each)."""
    device = resolve_device(device)
    shape = tuple(resident_shape() if shape is None else shape)
    rng = np.random.default_rng(0)
    n = int(np.prod(shape))
    nbytes = 4 * n
    recs = [emit(log, check="config", shape=list(shape), elements=n,
                 mbytes_per_vector=nbytes / 1e6,
                 device=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"))]

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    x = dev(rng.standard_normal(shape))
    p = dev(rng.standard_normal(shape))
    idiag = dev(1.0 + 0.1 * rng.standard_normal(shape) ** 2)

    # 1. axpy: x <- x + a p, one kernel
    dt = time_fn(lambda v: torch.add(v, p, alpha=0.5), x, reps=iters,
                 warmup=1)
    recs.append(_line(log, "axpy_pass", dt, 3, nbytes))

    # 2. the solvers' dots
    xf, pf = x.reshape(-1), p.reshape(-1)
    dt = time_fn(lambda _: _default_dot(xf, pf), xf, reps=iters, warmup=1)
    recs.append(_line(log, "dot_cg_default", dt, 2, nbytes))
    dt = time_fn(lambda _: _dot3(x, p), x, reps=iters, warmup=1)
    recs.append(_line(log, "dot_resident_dot3", dt, 2, nbytes))

    # 3. the production cg_solve body, A = one-pass near-identity
    for track_best, name in ((True, "cg_body_track_best"),
                             (False, "cg_body_no_track")):
        ran = []

        def solve(_):
            res = cg_solve(lambda v: v * A_SCALE, p,
                           M_inv=lambda r: idiag * r, rtol=1e-30,
                           maxiter=iters, track_best=track_best, dot=_dot3)
            ran.append(res.iterations)
            return res.x

        dt = time_fn(solve, p, reps=1, warmup=1) / max(ran[-1], 1)
        recs.append(_line(log, name, dt, CG_PASSES, nbytes,
                          iters=ran[-1],
                          note="production cg_solve, A = 1-pass "
                               "near-identity, one host read an iteration"))

    # 4. the hand-fused body
    dt = time_fn(lambda _: fused_cg(p, idiag, iters)[0], p, reps=1,
                 warmup=1) / iters
    recs.append(_line(log, "hand_fused_body", dt, FUSED_PASSES, nbytes,
                      iters=iters,
                      note="in-place torch ops, no host read"))
    return recs


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="vector shape (default: the resident layout of "
                         "3D Q4 refine 6)")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    main(args.shape, args.iters, device=args.device)


if __name__ == "__main__":
    cli()

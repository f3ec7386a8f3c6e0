"""Kernel lab: time the K1 and K2 kernel variants on the card.

Counterpart of ``scripts/kernel_lab.py::main``.  Every variant computes the
3D Laplace apply y = (Kz(x)My(x)Mx + Mz(x)Ky(x)Mx + Mz(x)My(x)Kx) u on the
lab's flagship problem (3D Q4, refine 6, 16,974,593 DoFs, f32) and is held
against the plain version in f64 before it is timed.  Variants:

    v0                    K2, ``KernelSeparable`` (flat vectors)
    v5                    K1, ``ResidentSeparable.raw`` on its layout
    v5-copy               K1's routine with its copy ablation (timing only)
    v4                    the plain banded version (torch.roll taps; a
                          plain tier, not a kernel)
    v17 v18 v19 v20       the L1 kernels (``resident_lab.V17Kernel``, on
                          the ring routines; v18 on v17's); a
                          suffix picks the x stage or an ablation:
                          -bf (bf16x3), -h (1xTF32), -f64 (f64 storage),
                          -copy, -bands, -mm (timing only)
    v2 v3 v6 v8 v9 v12    the L2a kernels, x first (``separable_lab.
    vx vxy                LabKernel``): v2/v6 dense x, y, z; v8 the same
                          with transposed staging; v9 v2 in bf16x3 (the
                          four on v2's ring, one instruction stream); v3
                          band x; v12 band y/z (on its ring: v2's x stage,
                          a z window); vx, vxy the x and x+y
                          ablations (their own functions).  A suffix
                          picks every dense stage's arithmetic, as JAX's:
                          -highest (3xTF32, the default), -high (1xTF32),
                          -default (one bf16 product)
    v13 v14 v15 v16       the L2b kernels, z/y first (the same ``LabKernel``):
    vcopy vband           band z, band y, then x as two tensor-core products
                          (v13, on L1's ring routine; v14 with the next
                          load in flight), one K-stacked product (v15, on
                          L1's persistent ring; same suffixes) or a band
                          (v16); vcopy, vband the all-band schedule's loads
                          and stores, and its band stages, alone (their own
                          functions; v16's routine: TMA boxes, an mbarrier
                          ring, sub-tile (8, 8))

Per variant it prints the time per apply (CUDA events), GDoF/s, the
relative error against the f64 plain version on the lab's random input
and on a smooth one (a sine product), each as the variant stores it,
then for the layout variants the raw apply's rate, timed in turns with
its plain version, with its bound (and an L1/L2 kernel's design bound),
then for a K1/L1 variant the error of two chained applies (an ablation:
its error against its own plain version), for an L2 variant its max
relative error (out of its precision's class, vcopy off its input at all,
vband beyond 1e-6: it raises); the last line is ``best:``, the fastest
variant that was held against the operator's plain version.  An L2
kernel's output layout is not its input's, so it has no chain check.  It
runs on a CUDA device and raises without one; a failing variant raises.

    python -m tpufem_torch.lab.kernel_lab [--refine 6] [--p 4]
        [--reps 50] [--variants v0 v5 v17 v2-high ...]
        [--tiles auto 2x16 24 ...]   (TZxTY: an L1 tile or an L2b
                                      sub-tile; an integer: the L2 tile b)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpufem_torch.lab import separable_lab
from tpufem_torch.lab.resident_lab import V17Kernel, operator_bound
from tpufem_torch.ops.kernel_separable import (
    KernelSeparable,
    ResidentSeparable,
)
from tpufem_torch.ops.separable import (
    global_1d_matrices,
    laplace_apply_separable,
)
from tpufem_torch.utils.timer import time_fn

DEFAULT_VARIANTS = ("v0", "v5", "v5-copy", "v4", "v17", "v17-h", "v17-bf",
                    "v18", "v19", "v20", "v17-copy", "v17-bands", "v17-mm",
                    "v2-highest", "v2-high", "v3-highest", "v3-high", "v15",
                    "v16")
TIMING_ONLY = ("copy", "bands", "mm")


def band_table_full(M1: np.ndarray, p: int) -> np.ndarray:
    """(2p+1, npts) taps W[o, i] = M1[i, i+o-p], zero outside the matrix
    (``kernel_lab.py::_band_table_full``)."""
    npts = M1.shape[0]
    W = np.zeros((2 * p + 1, npts))
    for o in range(2 * p + 1):
        i = np.arange(max(0, p - o), min(npts, npts + p - o))
        W[o, i] = M1[i, i + o - p]
    return W


def make_banded_apply(npts, p, K1, M1, h, dtype, device):
    """The plain banded version (``kernel_lab.py::make_banded_apply``):
    every 1D operator as 2p+1 shifted multiply-adds; the tables' zeros at
    the boundaries cancel the wraparound of ``torch.roll``."""
    tab = lambda M: torch.tensor(band_table_full(M, p), dtype=dtype,
                                 device=device)
    Wm = [tab(M1 * h[a]) for a in range(3)]
    Wk = [tab(K1 / h[a]) for a in range(3)]

    def axis(t, W, a):
        pos = 2 - a
        shape = [1, 1, 1]
        shape[pos] = npts
        out = None
        for o in range(2 * p + 1):
            tap = W[o].reshape(shape) * torch.roll(t, p - o, dims=pos)
            out = tap if out is None else out + tap
        return out

    def apply(u):
        t = u.reshape((npts,) * 3)
        ax, gx = axis(t, Wm[0], 0), axis(t, Wk[0], 0)
        by, cy, dy = axis(ax, Wm[1], 1), axis(ax, Wk[1], 1), axis(gx, Wm[1], 1)
        return (axis(by, Wk[2], 2) + axis(cy + dy, Wm[2], 2)).reshape(-1)

    return apply


def lab_variant(v, npts, p, K1, M1, h, tile):
    """The V17Kernel of lab variant name ``v`` (v17..v20 plus suffixes)."""
    suffix = v[4:] if len(v) > 3 else ""
    mode = ("bf16" if suffix == "bf" else suffix if suffix in TIMING_ONLY
            else "f32")
    return V17Kernel(npts, p, K1, M1, h, mode=mode,
                     prec="high" if suffix == "h" else "highest",
                     kern_name=v[:3],
                     dtype=torch.float64 if suffix == "f64" else torch.float32,
                     device="cuda", tile=tile)


def l2_variant(v):
    """(variant, prec) of an L2 lab name (``v2``, ``v3-high``, ``v15``,
    ...), split on '-' as ``kernel_lab.py:1734``; None for another name."""
    var, prec = (v.split("-") + ["highest"])[:2]
    return (var, prec) if var in separable_lab.VARIANTS else None


# L2 variants that compute their own function, not the operator (timing
# only in the JAX lab): the class each is held to against its own plain
# version; the others are held to their precision's class
L2_OWN_TOL = {"vcopy": 0.0, "vband": 1e-6}


def run_l2(v, npts, p, K1, M1, h, b, tile, inputs, reps):
    """Hold an L2 kernel against its plain version in f64 on each of
    ``inputs`` ({"random", "smooth"}: flat f64 vectors on the card), then
    time it: the flat apply, and the raw apply in turns with its plain
    version.  Returns (flat record, raw record); raises when the max
    relative error on the random input is out of the precision's class
    (vcopy: not 0; vband: beyond 1e-6)."""
    var, prec = l2_variant(v)
    dev = next(iter(inputs.values())).device
    k = separable_lab.LabKernel(var, npts, p, K1, M1, h, b=b, prec=prec,
                                device=dev, tile=tile)
    errs = {}
    for which, u in inputs.items():
        gp = k.pad(u.to(torch.float32))
        y = k.raw(gp).to(torch.float64)
        r = k.plain(gp.to(torch.float64))
        errs[which] = (float((k.unpad(y) - k.unpad(r)).norm()
                             / k.unpad(r).norm()),
                       float((y - r).abs().max() / r.abs().max()))
    tol = L2_OWN_TOL.get(var, separable_lab.TOL[k.xp])
    if not errs["random"][1] <= tol:
        raise RuntimeError(f"{v}: max rel err {errs['random'][1]:.3e} > "
                           f"{tol} against its plain version")
    x = inputs["random"].to(torch.float32)
    dt = _per_apply(k, x, reps)
    dtr, dtp = _turns(k.raw, k.plain, k.pad(x), reps)
    bound, by = k.bound()
    # vcopy and vband are not the operator: no part in ``best:``
    nan = float("nan")
    err, errs_ = ((nan, nan) if var in L2_OWN_TOL
                  else (errs["random"][0], errs["smooth"][0]))
    flat = {"ms": dt * 1e3, "gdofs": npts**3 / dt / 1e9,
            "rel_err": err, "rel_err_smooth": errs_}
    raw = {"ms": dtr * 1e3, "plain_ms": dtp * 1e3, "gdofs": npts**3 / dtr
           / 1e9, "rel_err": err,
           "max_rel_err": errs["random"][1], "bound_ms": bound,
           "bound_by": by, "design_ms": k.design_bound()[0], "b": k.b,
           "tile": k.tile}
    return flat, raw


def _per_apply(fn, x, reps):
    """Seconds per call of fn on the same x (CUDA events)."""
    return time_fn(lambda _: fn(x), x, reps=reps)


def _turns(kernel, plain, x, reps):
    """(kernel, plain) seconds per call on the same x, timed in turns:
    plain, kernel, kernel, plain."""
    a, b, c, d = (_per_apply(f, x, reps) for f in (plain, kernel, kernel,
                                                    plain))
    return (b + c) / 2, (a + d) / 2


def main(argv=None) -> dict:
    """Run the lab; returns {name: record} per variant and tile, and for a
    resident variant {name}-raw: the raw apply on the layout timed in turns
    with its plain version (ms, plain_ms), the bound of the function it
    computes (bound_ms, bound_by) and, for an L1 kernel, the bound of what
    its design does (design_ms)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT_VARIANTS))
    ap.add_argument("--tiles", nargs="+", default=["auto"],
                    help="L1 output tiles and L2b sub-tiles TZxTY, L2 tiles "
                    "b (an integer); auto: each tile chooser's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel lab runs on a CUDA device; "
                           "torch.cuda is not available")
    dev = torch.device("cuda")
    p, n = args.p, 1 << args.refine
    npts = n * p + 1
    ndofs = npts**3
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n] * 3)
    Ks = [K1 / h[a] for a in range(3)]
    Ms = [M1 * h[a] for a in range(3)]
    K64 = [torch.tensor(K, device=dev) for K in Ks]
    M64 = [torch.tensor(M, device=dev) for M in Ms]
    ref = lambda u: laplace_apply_separable(u.to(torch.float64), 3, npts,
                                            K64, M64)
    x = torch.tensor(np.random.default_rng(3).standard_normal(ndofs),
                     dtype=torch.float32, device=dev)
    g = torch.sin(torch.pi * torch.linspace(0, 1, npts, dtype=torch.float64,
                                            device=dev))
    xs = (g[:, None, None] * g[None, :, None] * g[None, None, :]).reshape(-1)
    # references of the inputs as each variant stores them, so an error
    # is the variant's arithmetic, not the rounding of its input
    refs = {(which, dt): ref(u.to(dt)) for which, u in (("random", x),
                                                        ("smooth", xs))
            for dt in (torch.float32, torch.float64)}
    print(f"kernel lab: 3D Q{p} refine {args.refine}, {ndofs} DoFs, "
          f"{torch.cuda.get_device_name(dev)}", flush=True)

    def rel_err(y, which, dt):
        r = refs[which, dt]
        return float((y.to(torch.float64) - r).norm() / r.norm())

    results = {}
    for tile_arg in args.tiles:
        # TZxTY: L1 and L2b (its sub-tile); an integer: L2 only (b)
        l1_tile = "x" in tile_arg
        tile = None if tile_arg == "auto" else tuple(
            int(s) for s in tile_arg.split("x"))
        for v in args.variants:
            name = f"{v}-{tile_arg}"
            if l2_variant(v):
                zy = l2_variant(v)[0] in separable_lab.ZYFIRST
                if l1_tile and not zy:
                    continue
                flat, raw = run_l2(
                    v, npts, p, K1, M1, h,
                    None if l1_tile else tile and tile[0],
                    tile if l1_tile else None,
                    {"random": x.to(torch.float64), "smooth": xs}, args.reps)
                results[name], results[name + "-raw"] = flat, raw
                print(f"{name:18s}  {flat['ms']:8.4f} ms  "
                      f"{flat['gdofs']:7.2f} GDoF/s  rel_err "
                      f"{flat['rel_err']:.2e}  smooth "
                      f"{flat['rel_err_smooth']:.2e}", flush=True)
                print(f"{name:18s}  {raw['ms']:8.4f} ms  {raw['gdofs']:7.2f} "
                      f"GDoF/s  [raw, b={raw['b']}"
                      + (f", sub-tile {raw['tile']}" if raw["tile"] else "")
                      + f"; plain "
                      f"{raw['plain_ms']:.4f} ms; bound {raw['bound_ms']:.4f}"
                      f" ms ({raw['bound_by']}), design "
                      f"{raw['design_ms']:.4f} ms; max rel err "
                      f"{raw['max_rel_err']:.2e}]", flush=True)
                continue
            if tile_arg != "auto" and not l1_tile and v[:3] in (
                    "v17", "v18", "v19", "v20"):
                continue
            k = layout = None
            if v == "v0":
                k = KernelSeparable(3, npts, p, Ks, Ms, torch.float32, dev)
            elif v == "v4":
                k = make_banded_apply(npts, p, K1, M1, h, torch.float32, dev)
            elif v in ("v5", "v5-copy"):
                layout = ResidentSeparable(npts, p, Ks, Ms, torch.float32,
                                           mode=v[3:] or "f32", device=dev)
                k = lambda u, rk=layout: rk.unpad(rk.raw(rk.pad(u)))
            elif v[:3] in ("v17", "v18", "v19", "v20"):
                layout = k = lab_variant(v, npts, p, K1, M1, h, tile)
            else:
                raise ValueError(f"unknown variant {v!r}")
            timing_only = v.endswith(TIMING_ONLY)
            dt_in = torch.float64 if v.endswith("f64") else torch.float32
            xin = x.to(dt_in)
            err = errs = float("nan")
            if not timing_only:
                err = rel_err(k(xin), "random", dt_in)
                errs = rel_err(k(xs.to(dt_in)), "smooth", dt_in)
            dt = _per_apply(k, xin, args.reps)
            results[name] = {"ms": dt * 1e3, "gdofs": ndofs / dt / 1e9,
                             "rel_err": err, "rel_err_smooth": errs}
            print(f"{name:18s}  {dt * 1e3:8.4f} ms  {ndofs / dt / 1e9:7.2f} "
                  f"GDoF/s  rel_err {err:.2e}  smooth {errs:.2e}", flush=True)
            if layout is None:
                continue
            # the solver-resident rate: layout in, layout out
            gp = layout.pad(xin)
            cerr = aerr = float("nan")
            if timing_only:  # an ablation computes its own function
                # (copy exactly; bands and mm against the f32 plain
                # version, which has its own f32 rounding)
                yp = layout.plain(gp).to(torch.float64)
                aerr = float((layout.raw(gp).to(torch.float64) - yp).abs()
                             .max() / yp.abs().max())
                if not aerr <= (0.0 if v.endswith("copy") else 1e-5):
                    raise RuntimeError(f"{name}: the ablation is off its "
                                       f"plain version by {aerr:.3e}")
            else:  # chainable: halo/padding zeros intact
                y2 = layout.unpad(layout.raw(layout.raw(gp) * 1e-9))
                y2_ref = ref(refs["random", dt_in] * 1e-9)
                cerr = float((y2.to(torch.float64) - y2_ref).norm()
                             / y2_ref.norm())
            dtr, dtp = _turns(layout.raw, layout.plain, gp, args.reps)
            rec = {"ms": dtr * 1e3, "plain_ms": dtp * 1e3,
                   "gdofs": ndofs / dtr / 1e9, "rel_err": err,
                   "chain_err": cerr, "ablation_err": aerr}
            bands = {"v5": 7, "v5-copy": 0}
            rec["bound_ms"], rec["bound_by"] = (
                layout.bound() if layout is k
                else operator_bound(npts, p, bands[v]))
            if layout is k:
                rec["design_ms"] = layout.design_bound()[0]
            results[name + "-raw"] = rec
            print(f"{name:18s}  {dtr * 1e3:8.4f} ms  {ndofs / dtr / 1e9:7.2f} "
                  f"GDoF/s  [raw resident; plain {dtp * 1e3:.4f} ms; bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                  + (f", design {rec['design_ms']:.4f} ms" if layout is k
                     else "") + (f"; vs its plain version {aerr:.2e}]"
                                 if timing_only
                                 else f"; chain rel_err {cerr:.2e}]"),
                  flush=True)
    checked = [k_ for k_, r in results.items() if r["rel_err"] == r["rel_err"]]
    best = max(checked, key=lambda k_: results[k_]["gdofs"])
    print(f"\nbest: {best} @ {results[best]['gdofs']:.2f} GDoF/s", flush=True)
    return results


if __name__ == "__main__":
    main()

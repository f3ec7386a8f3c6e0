"""The two toolchain probes on the card: host side and wrappers.

Counterpart of ``scripts/toolchain_probe.py``, which asks two questions of
the toolchain under a kernel author's hands; the CUDA kernels and their
design note are in ``tpufem_torch/csrc/toolchain_probe.cuh``.

1. ``probe_high_precision`` (P1): does a three-pass bf16 product (JAX's
   ``Precision.HIGH``) exist inside a kernel, and how exact is it?  Here:
   a hand-written product of (n, n) f32 in bf16x3, and beside it the other
   arithmetics the labs use (3xTF32, 1xTF32, one bf16 product), each
   against the f64 product.  The ``wgmma`` routine (the default) gives a
   block one 64-row tile by ``P1_COLUMNS`` (16) columns on ``wgmma`` (64
   blocks at n = 256), its A stripe and B columns arriving by TMA in
   chunks of 64 k, all of them in flight at once where they fit a block's
   shared memory; A is split in registers as it loads, B by the block's
   threads into wgmma's K-major operand, and each chunk's sums are added
   into f32 totals on CUDA cores.  The ``earlier`` routine is the first
   port's WMMA kernel, a warp a 16 x 16 tile, kept for the timings in
   turns.
2. ``probe_co_scheduling`` (P2): do the matrix unit and the vector unit run
   at the same time in one kernel?  A chain of ``n_iter`` products ``acc <-
   acc @ w`` (tensor cores), a chain of ``fpp * n_iter`` multiply-adds ``v
   <- v * c1 + c2`` on an independent buffer (CUDA cores), and both in one
   kernel, in separate warpgroups of a block; ``overlap = (t_mxu + t_vpu -
   t_both) / min(t_mxu, t_vpu)``.  The cluster chain (the default) gives a
   cluster of C blocks a 64-row stripe with w held in shared memory, split
   by columns over the blocks, and the products on wgmma: m / 64 clusters,
   64 SMs at m = 512 in one bf16 pass (C = 8); 128 blocks in 1xTF32 and
   bf16x3 (C = 16), of which an H100 holds 7 clusters at once (112 SMs,
   two waves).  On an NVIDIA H100 80GB HBM3 at 700 W its products alone ran
   at (256, 512) in 10.4 ms on the earlier routine (a 16-row stripe a
   block, 32 SMs, w from L2 at every k step); PERF.md has the cluster
   chain's times.

``matmul`` and ``chain`` launch the kernels on a CUDA tensor (or raise) and
run their plain PyTorch versions on a CPU tensor; launches are counted in
``launches``.

    python -m tpufem_torch.lab.toolchain_probe

prints a header line (date, the card's name and power limit, versions) and
one JSON line per probe; it runs on a CUDA device and raises without one.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time

import torch

from tpufem_torch.lab.resident_lab import _b_layout, _operand_parts
from tpufem_torch.lab.separable_lab import (
    PRECS,
    X1TF32,
    X3TF32,
    XBF16,
    XBF16X3,
    _split_bf16,
    _split_product,
)
from tpufem_torch.utils.build import load_kernels
from tpufem_torch.utils.timer import roofline_ms, time_fn

# the f32 arithmetics of a probe product, by the labs' names
ARITHMETICS = tuple(PRECS)  # highest, high, bf16x3, default
MODES = {"mma": 0, "fma": 1, "both": 2}
# the multiply-add stream's constants (scripts/toolchain_probe.py:84)
C1, C2 = 1.000001, 1e-7
# P1's classes: max |error| / max |c| against the f64 product on a random
# (256, 256) pair.  3xTF32 and bf16x3 sit above the labs' classes
# (``separable_lab.TOL``): a dense product sums 256 terms of one sign mix
# in the tensor cores' f32 accumulators, which truncate
P1_TOL = {"highest": 1e-5, "high": 4e-3, "bf16x3": 5e-5, "default": 3e-2}
# the wgmma routine against the plain version in its own arithmetic: max |c
# - plain| / max |c| within the smaller of this and the labs' EMU_TOL (2e-6
# in 3xTF32).  EMU_TOL's one-pass classes (4e-3, 3e-2) would let a wrong
# operand type or a dropped or mis-split small pass through; each of those
# lands above 1e-4
P1_PLAIN_TOL = 1e-5
launches = {"P1": 0, "P2 mma": 0, "P2 fma": 0, "P2 both": 0}
# P1's routines: "wgmma" (probe_wgmma_kernel, a block a 64-row tile by
# ``P1_COLUMNS`` columns) and "earlier" (probe_matmul_kernel, a warp a 16 x
# 16 WMMA tile); both take every n that is a multiple of 16
P1_ROUTINES = ("wgmma", "earlier")
# a wgmma block's columns (kP1wColumns in csrc/toolchain_probe.cuh): at n =
# 256, 64 blocks, each a chain of 16 k steps of m64n16 (lab/probe_sweep.py
# times copies at 32 and 64 columns in turns with it)
P1_COLUMNS = 16
# P2's routines: the cluster chain ("cluster", probe_cluster_kernel) and its
# earlier routine ("earlier", probe_chain_kernel, a 16-row stripe a block).
# The cluster chain takes m = 64 2^j whose plan fits a block's 227 KB by the
# routine's own count (``cluster_plan``): m <= 512, and in 3xTF32 m <= 256
# (at m = 512 w's two TF32 parts and the f32 stripe take 256 KB a block at
# C = 16); every other (arithmetic, m) runs the earlier routine
CHAIN_ROUTINES = ("cluster", "earlier")
CLUSTER_MS = (64, 128, 256, 512)
CLUSTER_MAX_M = {"highest": 256, "high": 512, "bf16x3": 512, "default": 512}
CLUSTER_SIZES = (2, 4, 8, 16)  # blocks of a cluster, tried in order
SMEM_LIMIT = 227 * 1024  # of shared memory a block may use on an H100
ROWS = 64  # of a cluster's stripe (one wgmma M)


def _check(t: torch.Tensor, m: int, what: str) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (m, m) or \
            not t.is_contiguous():
        raise ValueError(f"{what}: a contiguous float32 ({m}, {m}) tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _cuda_inputs(tensors, what):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{what}: every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 arithmetic: str | None = None) -> torch.Tensor:
    """The plain PyTorch version of ``matmul``: ``a @ b`` in the operands'
    dtype, or (``arithmetic`` named) in that arithmetic, the operands split
    as the kernel splits them and the part products summed in f64
    (``separable_lab._split_product``), rounded to f32."""
    if arithmetic is None:
        return a @ b
    return _split_product(a, b, PRECS[arithmetic], "ik,kj->ij").to(
        torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, arithmetic: str = "bf16x3",
           routine: str = "wgmma") -> torch.Tensor:
    """P1: ``a @ b`` for (n, n) f32, n a multiple of 16, in ``arithmetic``
    by the ``routine`` of ``P1_ROUTINES``: "wgmma" (a and b 16-byte
    aligned, as its tensor maps ask) or "earlier".  On CPU tensors the
    plain version (exact f32), whichever routine is named."""
    if arithmetic not in PRECS:
        raise ValueError(f"arithmetic must be one of {ARITHMETICS}, got "
                         f"{arithmetic!r}")
    if routine not in P1_ROUTINES:
        raise ValueError(f"routine must be one of {P1_ROUTINES}, got "
                         f"{routine!r}")
    n = a.shape[0]
    _check(a, n, "a")
    _check(b, n, "b")
    if n % 16:
        raise ValueError(f"matmul: n must be a multiple of 16, got {n}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    dev = _cuda_inputs((a, b), "matmul")
    if routine == "wgmma" and (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("matmul: the wgmma routine's tensor maps take "
                         "16-byte aligned a and b")
    lib = load_kernels()["toolchain_probe"]
    c = torch.empty_like(a)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if routine == "wgmma":
            rc = lib.lib.tpufem_probe_matmul_wgmma(
                PRECS[arithmetic], n, a.data_ptr(), b.data_ptr(),
                c.data_ptr(), stream)
        else:
            rc = lib.lib.tpufem_probe_matmul(
                PRECS[arithmetic], n, a.data_ptr(), b.data_ptr(),
                c.data_ptr(), stream)
    lib.check(rc, f"P1 {routine} {arithmetic} launch")
    launches["P1"] += 1
    return c


def p1_plan(arithmetic: str, n: int) -> dict:
    """On the card: the wgmma routine's grid at n (blocks, one an SM), the
    ring's stages (every chunk of 64 k where they fit) and a block's shared
    memory."""
    lib = load_kernels()["toolchain_probe"].lib
    xp = PRECS[arithmetic]
    columns = lib.tpufem_probe_wgmma_columns()
    return {"columns": columns,
            "blocks": -(-n // columns) * -(-n // ROWS),
            "stages": lib.tpufem_probe_wgmma_stages(xp, n),
            "chunks": -(-n // 64),
            "smem": lib.tpufem_probe_wgmma_smem(xp, n)}


def p1_design_bound(n: int, arithmetic: str) -> float:
    """ms: the least time of the wgmma routine's design at n, one block's
    work in turn: its bytes (its A stripe and B columns read, its tile
    written) at the card's memory rate (L2's, higher, is not published;
    the term is 0.04 us at n = 256), then its chain of dependent ``wgmma``s
    (every k step and pass of the arithmetic, 64 x ``P1_COLUMNS`` each) at
    one SM's share (1/132) of the card's tensor-core peak."""
    xp = PRECS[arithmetic]
    passes = 3 if xp in (X3TF32, XBF16X3) else 1
    mma = "tf32" if xp in (X3TF32, X1TF32) else "bf16"
    nbytes = 4 * (ROWS * n + n * P1_COLUMNS + ROWS * P1_COLUMNS)
    k = 64 * -(-n // 64)  # k of the ring's chunks, zeros past n
    return (roofline_ms(nbytes, {})[0]
            + roofline_ms(0, {mma: 132 * passes * 2.0 * ROWS * P1_COLUMNS
                              * k})[0])


def chain_plain(mode: str, a, w, v, n_iter: int, fpp: int = 4,
                arithmetic: str | None = None):
    """The plain PyTorch version of ``chain``: (o, vo) by a loop of
    ``torch.matmul`` and a loop of multiply-adds in the tensors' dtype
    (f64 tensors: the exact reference).  ``arithmetic`` named (f32
    tensors): each product in that arithmetic, operands split as the
    kernel splits them, part products summed in f64, rounded to f32."""
    o, vo = a, v
    if mode in ("mma", "both"):
        for _ in range(n_iter):
            o = (o @ w if arithmetic is None else
                 _split_product(o, w, PRECS[arithmetic], "ik,kj->ij").to(
                     a.dtype))
    if mode in ("fma", "both"):
        for _ in range(n_iter * fpp):
            vo = vo * C1 + C2
    return o.clone() if o is a else o, vo.clone() if vo is v else vo


def w_operand(w: torch.Tensor, arithmetic: str, cluster: int | None = None):
    """(tensor, lo offset): w as a chain kernel reads it.  The earlier
    routine (cluster None): f32, or in the bf16 arithmetics its bf16 hi part
    stacked on its lo part (lo offset: w.numel()).  The cluster chain
    (cluster C): each block's m / C columns, split with the kernel's
    rounding (``resident_lab._operand_parts``: 3xTF32 big and small, 1xTF32
    one rounding, bf16x3 hi and lo, one bf16 pass hi) and laid out as
    wgmma's K-major B operand over K = m (``_b_layout``), (C, parts, m / C
    columns by m) flat; lo offset 0, each block's parts following one
    another in its slice."""
    xp = PRECS[arithmetic]
    if cluster is None:
        if xp in (XBF16X3, XBF16):
            return torch.stack(_split_bf16(w)).contiguous(), w.numel()
        return w, 0
    m = w.shape[0]
    parts = _operand_parts(w, xp)
    b = torch.stack(parts).reshape(len(parts), m, cluster, m // cluster)
    return _b_layout(b.permute(2, 0, 3, 1).contiguous(),
                     xp).reshape(-1).contiguous(), 0


def chain_routine(arithmetic: str, m: int) -> str:
    """The routine P2 runs unless one is asked for: the cluster chain at m
    in ``CLUSTER_MS`` up to ``CLUSTER_MAX_M[arithmetic]``, else the earlier
    routine (the table above ``CHAIN_ROUTINES``)."""
    return ("cluster" if m in CLUSTER_MS and m <= CLUSTER_MAX_M[arithmetic]
            else "earlier")


def cluster_plan(arithmetic: str, m: int, count, active=None):
    """(C, nbuf) of the cluster chain at m, or None where it has none: the
    smallest C of ``CLUSTER_SIZES`` whose block fits ``SMEM_LIMIT`` by the
    routine's own count ``count(xp, m, C, nbuf)`` (-1: a geometry it is not
    built for), with two stripe buffers where they fit, else one.  With
    ``active(C, nbuf)`` (the clusters the card holds at once), the first
    such plan whose m / 64 clusters all run in one wave, else the first."""
    xp = PRECS[arithmetic]
    fits = []
    for C in CLUSTER_SIZES:
        for nbuf in (2, 1):
            if 0 < count(xp, m, C, nbuf) <= SMEM_LIMIT:
                fits.append((C, nbuf))
                break
    if active is not None:
        for plan in fits:
            if active(*plan) >= m // ROWS:
                return plan
    return fits[0] if fits else None


def cluster_waves(m: int, C: int, active: int) -> tuple[int, int]:
    """(SMs at once, waves) of the cluster chain's m / 64 clusters of C
    blocks on a card that holds ``active`` of them at once (at m = 512 in
    clusters of 16 an H100 holds 7 of the 8: 112 SMs, two waves)."""
    if active < 1:
        raise ValueError(f"the card holds no cluster of {C} blocks at m={m}")
    stripes = m // ROWS
    at_once = min(stripes, active)
    return at_once * C, -(-stripes // at_once)


@functools.cache
def chain_plan(arithmetic: str, m: int, routine: str, device_index: int):
    """On the card: P2's plan, a dict of the routine, its cluster size C and
    stripe buffers (None on the earlier routine), the blocks of its grid
    (one an SM), the SMs they take at once and the waves they run in
    (``cluster_waves``), the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters of the ``both`` kernel) and the shared
    memory of a block."""
    if routine == "earlier":  # probe_chain_smem's count: two f32 stripes
        # of 16 rows and a 16 x 16 f32 tile for each of the 8 product warps
        return {"routine": routine, "cluster": None, "nbuf": None,
                "blocks": m // 16, "sms": m // 16, "waves": 1,
                "active_clusters": None,
                "smem": 2 * 16 * m * 4 + 8 * 256 * 4}
    lib = load_kernels()["toolchain_probe"].lib
    xp = PRECS[arithmetic]
    with torch.cuda.device(device_index):
        active = functools.partial(lib.tpufem_probe_cluster_active,
                                   MODES["both"], xp, m)
        plan = cluster_plan(arithmetic, m, lib.tpufem_probe_cluster_smem,
                            active)
        if plan is None:
            raise ValueError(f"the cluster chain takes no plan at m={m} in "
                             f"{arithmetic}")
        C, nbuf = plan
        n_active = active(C, nbuf)
        sms, waves = cluster_waves(m, C, n_active)
        return {"routine": routine, "cluster": C, "nbuf": nbuf,
                "blocks": m // ROWS * C, "sms": sms, "waves": waves,
                "active_clusters": n_active,
                "smem": lib.tpufem_probe_cluster_smem(xp, m, C, nbuf)}


def design_bound(n_iter: int, m: int, fpp: int, arithmetic: str,
                 blocks: int, waves: int = 1) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the chain's products
    and multiply-adds could take spread evenly over a grid of ``blocks``
    blocks, one an SM (each at its peak share of the card's 132), that runs
    in ``waves`` waves: every pass of the arithmetic on tensor cores, the
    multiply-adds on CUDA cores, a, w, v read and o, vo written once."""
    xp, share = PRECS[arithmetic], 132 * waves / blocks
    passes = 3 if xp in (X3TF32, XBF16X3) else 1
    mma = "tf32" if xp in (X3TF32, X1TF32) else "bf16"
    return roofline_ms(5 * 4 * m * m, {
        mma: share * passes * 2.0 * n_iter * m**3,
        "fp32": share * 2.0 * fpp * n_iter * m * m})


def chain(mode: str, a, w, v, n_iter: int, fpp: int = 4,
          arithmetic: str = "default", w_op=None, routine: str | None = None):
    """P2: (o, vo) of one kernel.  ``mode`` "mma": o = a @ w^n_iter, vo =
    v; "fma": vo = v after fpp * n_iter steps v <- v * C1 + C2, o = a;
    "both": both streams.  a, w, v: (m, m) f32, m a multiple of 16.
    routine: "cluster" or "earlier" (None: ``chain_routine``'s).  w_op:
    ``w_operand(w, arithmetic, C)`` made ahead for the routine's plan
    (``chain_plan``; C None on the earlier routine), a timing loop's.  On
    CPU tensors the plain version (exact f32)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if arithmetic not in PRECS:
        raise ValueError(f"arithmetic must be one of {ARITHMETICS}, got "
                         f"{arithmetic!r}")
    if routine is not None and routine not in CHAIN_ROUTINES:
        raise ValueError(f"routine must be one of {CHAIN_ROUTINES}, got "
                         f"{routine!r}")
    m = a.shape[0]
    for t, what in ((a, "a"), (w, "w"), (v, "v")):
        _check(t, m, what)
    if m < 16 or m % 16 or n_iter < 1 or fpp < 0:
        raise ValueError(f"m a multiple of 16, n_iter >= 1, fpp >= 0; got "
                         f"m={m}, n_iter={n_iter}, fpp={fpp}")
    if all(t.device.type == "cpu" for t in (a, w, v)):
        return chain_plain(mode, a, w, v, n_iter, fpp)
    dev = _cuda_inputs((a, w, v), "chain")
    lib = load_kernels()["toolchain_probe"]
    plan = chain_plan(arithmetic, m, routine or chain_routine(arithmetic, m),
                      dev.index)
    C = plan["cluster"]
    w_op, w_lo = w_operand(w, arithmetic, C) if w_op is None else w_op
    o, vo = torch.empty_like(a), torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if C is None:
            rc = lib.lib.tpufem_probe_chain(
                MODES[mode], PRECS[arithmetic], m, n_iter, fpp, C1, C2,
                a.data_ptr(), w_op.data_ptr(), w_lo, v.data_ptr(),
                o.data_ptr(), vo.data_ptr(), stream)
        else:
            rc = lib.lib.tpufem_probe_cluster_chain(
                MODES[mode], PRECS[arithmetic], m, C, plan["nbuf"], n_iter,
                fpp, C1, C2, a.data_ptr(), w_op.data_ptr(), v.data_ptr(),
                o.data_ptr(), vo.data_ptr(), stream)
    lib.check(rc, f"P2 {plan['routine']} {mode} {arithmetic} launch")
    launches[f"P2 {mode}"] += 1
    return o, vo


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the toolchain probes run on a CUDA device; "
                           "torch.cuda is not available")
    return device


def probe_high_precision(n: int = 256, device="cuda") -> dict:
    """P1: the product (its default routine) in bf16x3 (the counterpart of
    Precision.HIGH) and in the labs' other arithmetics, on a seeded random
    (n, n) pair
    against the f64 product (max |error| / max |c|, each within its class
    ``P1_TOL``, else it raises) and on the JAX probe's all-ones input, which
    must give n exactly."""
    device = _device(device)
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn((n, n), generator=gen).to(device) for _ in range(2))
    ref = a.double() @ b.double()
    ones = torch.ones((n, n), device=device)
    errs = {}
    for arithmetic in ARITHMETICS:
        c = matmul(a, b, arithmetic)
        errs[arithmetic] = float((c.double() - ref).abs().max()
                                 / ref.abs().max())
        if not torch.equal(matmul(ones, ones, arithmetic),
                           torch.full_like(ones, float(n))):
            raise RuntimeError(f"{arithmetic}: ones @ ones is not {n}")
        if not errs[arithmetic] <= P1_TOL[arithmetic]:
            raise RuntimeError(f"{arithmetic}: max rel err "
                               f"{errs[arithmetic]:.3e} out of its class "
                               f"{P1_TOL[arithmetic]}")
    return {"probe": "mma_precision_high", "supported": True, "n": n,
            "max_rel_err": errs,
            "note": "bf16x3 (Precision.HIGH's arithmetic) by hand-written "
                    "wgmma; errors against the f64 product"}


def probe_co_scheduling(n_iter: int = 256, m: int = 512, fpp: int = 4,
                        arithmetic: str = "default", reps: int = 10,
                        device="cuda", routine: str | None = None) -> dict:
    """P2: times (CUDA events) of the product chain alone, the multiply-add
    chain alone and both in one kernel, on the JAX probe's inputs (a =
    1e-3, w = 0.999 I, v = 1); JAX's keys, then the routine's plan
    (``chain_plan``: its cluster size, its grid's blocks, the SMs they take
    at once and their waves, the clusters the card holds at once, a block's
    shared memory), the microseconds a product takes (t_mxu / n_iter) and
    its design bound on that grid."""
    device = _device(device)
    a = torch.full((m, m), 1e-3, device=device)
    w = torch.eye(m, device=device) * 0.999
    v = torch.ones((m, m), device=device)
    routine = routine or chain_routine(arithmetic, m)
    plan = chain_plan(arithmetic, m, routine, device.index
                      if device.index is not None
                      else torch.cuda.current_device())
    w_op = w_operand(w, arithmetic, plan["cluster"])
    t = {mode: time_fn(lambda _, mode=mode: chain(
        mode, a, w, v, n_iter, fpp, arithmetic, w_op, routine)[0], a,
        reps=reps) for mode in ("mma", "fma", "both")}
    overlap = (t["mma"] + t["fma"] - t["both"]) / max(
        min(t["mma"], t["fma"]), 1e-9)
    design = design_bound(n_iter, m, fpp, arithmetic, plan["blocks"],
                          plan["waves"])
    return {"probe": "vpu_mxu_co_scheduling", "n_iter": n_iter, "m": m,
            "fma_per_product": fpp, "arithmetic": arithmetic,
            "t_mxu_ms": t["mma"] * 1e3, "t_vpu_ms": t["fma"] * 1e3,
            "t_both_ms": t["both"] * 1e3, "overlap_fraction": overlap,
            "co_scheduled": bool(overlap > 0.5), **plan,
            "us_per_product": t["mma"] * 1e6 / n_iter,
            "design_bound_ms": design[0], "design_bound_by": design[1],
            "note": "overlap ~1 = full co-schedule; ~0 = serial units; "
                    "the design bound on the grid's blocks and waves"}


def main() -> list[dict]:
    """Both probes on the card, one JSON line each after the header.  P2's
    record carries a second point under "balanced": the probe once more
    with the multiply-adds per product raised until the two streams alone
    take about the same time (JAX's ratio, 4, leaves the multiply-add
    stream a small fraction of the products on this card)."""
    device = _device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"date": time.strftime("%Y-%m-%d"), "platform": "gpu",
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    high = probe_high_precision(device=device)
    print(json.dumps(high), flush=True)
    co = probe_co_scheduling(device=device)
    ratio = co["t_mxu_ms"] / max(co["t_vpu_ms"], 1e-9)
    balanced = probe_co_scheduling(fpp=max(4, int(round(4 * ratio))),
                                   device=device)
    co["balanced"] = {key: balanced[key] for key in (
        "fma_per_product", "t_mxu_ms", "t_vpu_ms", "t_both_ms",
        "overlap_fraction", "co_scheduled")}
    print(json.dumps(co), flush=True)
    return [high, co]


if __name__ == "__main__":
    main()

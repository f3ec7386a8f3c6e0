#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpufem_torch``).

Run from the repository root on a machine with one CUDA GPU (H100):

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  1 header      the card's name and power limit (nvidia-smi), versions
  2 build       the CUDA kernels, from the sources in the checkout
  3 kernels     each kernel against its plain PyTorch version on the card
                (f64 <= 1e-12, f32 <= 1e-6, bf16s <= 4e-3 max relative
                error vs the plain version in f64, on the same inputs)
  4 main path   solve_poisson 3D Q4 refine 5 f32 through K2 (2,146,689
                DoFs), then the 16,974,593-DoF resident Jacobi-CG through
                K1, twice (bitwise-equal x); the kernel launch counts of
                these runs are the ones reported.  Then the resident solve
                once more with pallas_mode="bf16s", its K1 count apart
  4b parity     f64 solves (3D Q4 refine 3; 2D Q4 refine 5, rough RHS),
                kernel vs plain: equal iterations, L2 equal to 1e-10
  6 throughput  GDoF/s over a chain of 30 applies (CUDA events), 17M DoFs
Then one JSON line with each kernel's record, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = {"f64": 1e-12, "f32": 1e-6, "bf16s": 4e-3}
STORAGE = {"f64": torch.float64, "f32": torch.float32,
           "bf16s": torch.bfloat16}
N_CHAIN = 30
SOLVE_RTOL = 1e-5


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def random_banded(rng, npts, p):
    """A non-symmetric banded matrix (bandwidth p)."""
    i, j = np.indices((npts, npts))
    return np.where(np.abs(i - j) <= p, rng.standard_normal((npts, npts)),
                    0.0)


def laplace_axes(p, n, dim):
    """Per-axis assembled 1D Laplace operators with a distinct h per axis."""
    from tpufem_torch.ops.separable import global_1d_matrices

    K1u, M1u = global_1d_matrices(p, n, p + 1)
    h = [1.0 / n, 1.3 / n, 0.7 / n][:dim]
    return [K1u / h[a] for a in range(dim)], [M1u * h[a] for a in range(dim)]


def flagship_axes(p, n, dim):
    """The hyper_cube's operators: the same h on every axis."""
    from tpufem_torch.ops.separable import global_1d_matrices

    K1u, M1u = global_1d_matrices(p, n, p + 1)
    return [K1u * n] * dim, [M1u / n] * dim


def plain_f64(dim, npts, Ks, Ms, u64, dirichlet):
    """The plain PyTorch version in f64 on the card."""
    from tpufem_torch.ops.separable import laplace_apply_separable

    dev = u64.device
    K = [torch.tensor(k, dtype=torch.float64, device=dev) for k in Ks]
    M = [torch.tensor(m, dtype=torch.float64, device=dev) for m in Ms]
    A = lambda v: laplace_apply_separable(v, dim, npts, K, M)
    if not dirichlet:
        return A(u64)
    m1 = torch.ones(npts, dtype=torch.float64, device=dev)
    m1[0] = m1[-1] = 0.0
    m = m1
    for _ in range(dim - 1):
        m = torch.outer(m1, m.reshape(-1))
    m = m.reshape(-1)
    return m * A(m * u64) + (1.0 - m) * u64


def check_kernel(kind, dim, p, npts, mode, dirichlet, Ks, Ms, rng):
    """Launch one kernel instance on a seeded input; return (max relative
    error, max abs error) against the plain f64 version on the same
    (storage-rounded) input.  Raises when out of tolerance."""
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )

    dev = torch.device("cuda")
    u = torch.tensor(rng.standard_normal(npts**dim), device=dev)
    if kind == "K2":
        k = KernelSeparable(dim, npts, p, Ks, Ms, STORAGE[mode], dev)
        before = KernelSeparable.launches
        x = u.to(STORAGE[mode])
        y = k(x)
        rose = KernelSeparable.launches == before + 1
    else:
        k = ResidentSeparable(npts, p, Ks, Ms,
                              torch.float64 if mode == "f64" else
                              torch.float32, mode=mode if mode == "bf16s"
                              else "f32", dirichlet=dirichlet, device=dev)
        before = ResidentSeparable.launches
        x = k.pad(u)
        y = k.unpad(k.raw(x))
        rose = ResidentSeparable.launches == before + 1
    torch.cuda.synchronize()
    ref = plain_f64(dim, npts, Ks, Ms, x.reshape(-1).to(torch.float64),
                    dirichlet)
    abs_err = float((y.to(torch.float64) - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    tag = (f"{kind} dim={dim} p={p} npts={npts} {mode} "
           f"dirichlet={int(dirichlet)} tile={k.tile}")
    if not rose:
        raise RuntimeError(f"{tag}: launch counter did not rise")
    if not rel <= TOL[mode]:
        raise RuntimeError(f"{tag}: max rel err {rel:.3e} > {TOL[mode]}")
    return tag, rel, abs_err


def true_rel_residual(mf, b, x):
    """||b - A x|| / ||b|| with the constrained operator applied by the
    plain version in f64 on the card."""
    from tpufem_torch.ops.separable import laplace_apply_separable

    K = [k.to(torch.float64) for k in mf.Ks]
    M = [m.to(torch.float64) for m in mf.Ms]
    m = mf.interior_mask.to(torch.float64)
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    Ax = m * laplace_apply_separable(m * x64, 3, mf.npts, K, M) \
        + (1.0 - m) * x64
    return float((b64 - Ax).norm() / b64.norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import tpufem_torch  # noqa: F401  (fails outside a checkout)
    from tpufem_torch.apps.poisson import solve_poisson
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )
    from tpufem_torch.utils.build import load_kernels
    from tpufem_torch.utils.timer import time_fn

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1 header -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    say("1 header", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    # ---- 2 build ------------------------------------------------------
    lib = load_kernels()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       lib.compiler_log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                         lib.compiler_log)]
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_ptxas.log").write_text(lib.compiler_log)
    say("2 build", f"{lib.path.name} built in {lib.build_seconds:.1f} s; "
        f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
        f"spill stores max {max(spills, default=0)} bytes")

    # ---- 3 kernel vs plain on the card --------------------------------
    rng = np.random.default_rng(2024)
    worst = {}
    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        npts = n * p + 1
        for dim in (2, 3):
            nonsym = ([random_banded(rng, npts, p) for _ in range(dim)],
                      [random_banded(rng, npts, p) for _ in range(dim)])
            lap = laplace_axes(p, n, dim)
            for mode, mats in (("f64", nonsym), ("f32", lap),
                               ("f32", nonsym)):
                tag, rel, _ = check_kernel("K2", dim, p, npts, mode, False,
                                           *mats, rng)
                worst[mode] = max(worst.get(mode, 0.0), rel)
                say("3 kernels", f"{tag} max rel err {rel:.3e}")
        nonsym = ([random_banded(rng, npts, p) for _ in range(3)],
                  [random_banded(rng, npts, p) for _ in range(3)])
        lap = laplace_axes(p, n, 3)
        for mode, mats in (("f64", nonsym), ("f32", lap), ("bf16s", nonsym),
                           ("bf16s", lap)):
            for dirichlet in (False, True):
                tag, rel, _ = check_kernel("K1", 3, p, npts, mode,
                                           dirichlet, *mats, rng)
                worst[mode] = max(worst.get(mode, 0.0), rel)
                say("3 kernels", f"{tag} max rel err {rel:.3e}")
    # the main path's shapes: K2 at 3D Q4 refine 5, K1 at refine 6
    abs_err = {}
    for name, kind_k, n, modes in (("K2", "K2", 32, ("f32", "f64")),
                                   ("K1", "K1", 64, ("f32", "bf16s"))):
        npts = 4 * n + 1
        for mode in modes:
            tag, rel, aerr = check_kernel(kind_k, 3, 4, npts, mode,
                                          kind_k == "K1",
                                          *flagship_axes(4, n, 3), rng)
            worst[mode] = max(worst.get(mode, 0.0), rel)
            if mode == "f32":
                abs_err[name] = aerr
            say("3 kernels", f"{tag} max rel err {rel:.3e} "
                f"max abs err {aerr:.3e}")
    say("3 kernels", "all within tolerance; worst max rel err "
        + ", ".join(f"{m} {worst[m]:.3e} (tol {TOL[m]})" for m in TOL))

    # ---- 4 main path: counts reset here, read at the end of phase 4 ----
    KernelSeparable.launches = 0
    ResidentSeparable.launches = 0
    r5 = solve_poisson(dim=3, degree=4, refine=5, scatter="separable",
                       use_pallas=True, dtype="float32", device="cuda")
    k2_solve = KernelSeparable.launches
    say("4 main path", f"solve_poisson 3D Q4 refine 5 f32 K2: dofs "
        f"{r5.n_dofs} iterations {r5.iterations} converged {r5.converged} "
        f"L2 {r5.l2_error:.4e} setup {r5.setup_time:.2f} s solve "
        f"{r5.solve_time:.3f} s K2 launches {k2_solve}")
    if not (r5.converged and r5.l2_error <= 1e-6
            and k2_solve >= r5.iterations):
        raise RuntimeError("refine-5 f32 solve_poisson failed its checks")

    from tpufem_torch.apps.poisson import hyper_cube_operator
    from tpufem_torch.solvers.resident import resident_jacobi_cg

    def flagship_operator(pallas_mode):
        t0 = time.perf_counter()
        op = hyper_cube_operator(3, 4, 6, "float32", True, dev,
                                 pallas_mode=pallas_mode)
        diag = op.diagonal()
        torch.cuda.synchronize()
        say("4 main path", f"refine-6 {pallas_mode} host setup "
            f"{time.perf_counter() - t0:.1f} s, {op.mf.n_dofs} DoFs, K1 tile "
            f"{op.mf.resident.tile} fused mask {op.mf.resident.dirichlet}")
        return op, diag

    op, diag = flagship_operator("f32")
    mf = op.mf
    mask = mf.interior_mask.cpu().numpy().astype(np.float64)
    b = torch.tensor(mask * np.random.default_rng(7).standard_normal(
        mf.n_dofs), dtype=torch.float32, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = resident_jacobi_cg(op, b, diag=diag, rtol=SOLVE_RTOL,
                                 track_best=False)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, res))
    (t1, ra), (t2, rb) = runs
    rel_a = true_rel_residual(mf, b, ra.x)
    say("4 main path", f"3d_q4_jacobi_cg_solve_resident f32: {t1:.3f} s / "
        f"{t2:.3f} s, iterations {ra.iterations} / {rb.iterations}, "
        f"converged {ra.converged}, true rel residual {rel_a:.3e}")
    if not (ra.converged and rb.converged
            and ra.iterations == rb.iterations and torch.equal(ra.x, rb.x)):
        raise RuntimeError("resident f32 solve: not converged or not "
                           "bitwise reproducible")
    say("4 main path", "two resident solves: equal iterations, bitwise-"
        "equal x")
    # the counts the kernels line reports: solve_poisson (K2) and the two
    # f32 resident solves (K1), read before anything else launches
    launches = {"K2": KernelSeparable.launches,
                "K1": ResidentSeparable.launches}
    say("4 main path", f"kernel launches of solve_poisson and the f32 "
        f"resident solves: {launches}")
    if not (launches["K2"] >= r5.iterations
            and launches["K1"] >= ra.iterations + rb.iterations):
        raise RuntimeError(f"a kernel of the main path did not run: "
                           f"{launches}")

    # bf16s: the same entry point with FemConfig(pallas_mode="bf16s"),
    # counted on its own
    op16, diag16 = flagship_operator("bf16s")
    rk16 = op16.mf.resident
    ResidentSeparable.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r16 = resident_jacobi_cg(op16, b, diag=diag16, rtol=SOLVE_RTOL,
                             track_best=False)
    torch.cuda.synchronize()
    t16 = time.perf_counter() - t0
    k1_bf16s = ResidentSeparable.launches
    rel16 = true_rel_residual(mf, b, r16.x)
    say("4 main path", f"3d_q4_jacobi_cg_solve_resident bf16s: {t16:.3f} s,"
        f" iterations {r16.iterations}, true rel residual (f64 operator) "
        f"{rel16:.3e}, K1 bf16s launches {k1_bf16s}")
    if not (np.isfinite(rel16) and k1_bf16s >= r16.iterations):
        raise RuntimeError("bf16s resident solve: non-finite x or the bf16s "
                           "kernel did not run")

    # ---- 4b f64 kernel-vs-plain solve parity (3D, and 2D for K2).  L2 must
    # sit well above the solver tolerance's floor for "equal to 1e-10" to
    # mean anything: the 3D case's sine RHS gives L2 ~1e-7; in 2D Q4 the
    # sine solve reaches L2 ~1e-10, at that floor, so the 2D case takes a
    # rough RHS (hundreds of iterations, L2 of order 1 against the sine)
    def rough2d(x):
        return (np.cos(7 * x[:, 0]) + x[:, 1] ** 3
                + np.sin(13 * x[:, 0] * x[:, 1]))

    for dim, degree, refine, rhs in ((3, 4, 3, None), (2, 4, 5, rough2d)):
        rk, rp = (solve_poisson(dim=dim, degree=degree, refine=refine,
                                scatter="separable", use_pallas=pallas,
                                dtype="float64", rhs=rhs, device="cuda")
                  for pallas in (True, False))
        rel_l2 = abs(rk.l2_error - rp.l2_error) / rp.l2_error
        rel_x = (np.linalg.norm(rk.solution - rp.solution)
                 / np.linalg.norm(rp.solution))
        say("4b parity", f"f64 {dim}D Q{degree} refine {refine} "
            f"{'rough' if rhs else 'sine'} RHS: kernel {rk.iterations} it L2 "
            f"{rk.l2_error:.6e}, plain {rp.iterations} it L2 "
            f"{rp.l2_error:.6e}, L2 rel diff {rel_l2:.2e}, x rel diff "
            f"{rel_x:.2e}")
        if not (rk.converged and rk.iterations == rp.iterations
                and rel_l2 <= 1e-10):
            raise RuntimeError("f64 kernel and plain solves differ")

    # ---- 6 apply throughput: flagship K1 (17M), main-path K2 (2.1M) -----
    # kernel and plain timed in turns (plain, kernel, kernel, plain)
    def chain_ms(fn, x):
        return 1e3 * time_fn(fn, x, reps=N_CHAIN)

    def turns(kernel, plain, x):
        a = chain_ms(plain, x)
        b = chain_ms(kernel, x)
        c = chain_ms(kernel, x)
        d = chain_ms(plain, x)
        say("6 throughput", f"ms per apply in turns: plain {a:.4f}, kernel "
            f"{b:.4f}, kernel {c:.4f}, plain {d:.4f}")
        return (b + c) / 2, (a + d) / 2

    rk1 = mf.resident
    x17 = rk1.pad(torch.tensor(np.random.default_rng(11).standard_normal(
        mf.n_dofs), dtype=torch.float32, device=dev))
    ms, plain_ms = {}, {}
    ms["K1"], plain_ms["K1"] = turns(rk1.raw, rk1.plain, x17)
    ms["K1_bf16s"] = chain_ms(rk16.raw, x17.to(torch.bfloat16))
    for tier, t in (("resident-f32+cuda", ms["K1"]),
                    ("resident-bf16s+cuda", ms["K1_bf16s"]),
                    ("plain-torch-f32", plain_ms["K1"])):
        print(json.dumps({
            "metric": "3d_q4_laplace_matrix_free_apply",
            "value": mf.n_dofs / (t * 1e-3) / 1e9, "unit": "GDoF/s",
            "tier": tier, "n_dofs": mf.n_dofs, "ms_per_apply": t,
            "n_chain": N_CHAIN, "device": kind, "nvidia_smi": smi}),
            flush=True)
    k2 = KernelSeparable(3, 129, 4, *flagship_axes(4, 32, 3), torch.float32,
                         dev)
    x5 = torch.tensor(np.random.default_rng(12).standard_normal(129**3),
                      dtype=torch.float32, device=dev)
    ms["K2"], plain_ms["K2"] = turns(k2, k2.plain, x5)
    print(json.dumps({
        "metric": "apply_separable", "value": 129**3 / (ms["K2"] * 1e-3)
        / 1e9, "unit": "GDoF/s", "tier": "separable+cuda (K2)",
        "n_dofs": 129**3, "ms_per_apply": ms["K2"],
        "plain_ms_per_apply": plain_ms["K2"], "device": kind,
        "nvidia_smi": smi}), flush=True)

    say("done", f"{time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": [
        {"name": "K2 separable_apply (flat vmult)", "route": "cuda",
         "source": "tpufem_torch/csrc/separable_apply.cuh",
         "replaces": "tpufem/ops/pallas_separable.py:116",
         "launches": launches["K2"], "max_abs_err": abs_err["K2"],
         "ms": ms["K2"], "plain_ms": plain_ms["K2"]},
        {"name": "K1 separable_apply (resident, fused mask)",
         "route": "cuda", "source": "tpufem_torch/csrc/separable_apply.cuh",
         "replaces": "tpufem/ops/pallas_separable.py:217",
         "launches": launches["K1"], "max_abs_err": abs_err["K1"],
         "ms": ms["K1"], "plain_ms": plain_ms["K1"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

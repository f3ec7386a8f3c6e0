"""Operator-apply benchmark across degrees and refinements.

Port of ``tpufem/apps/bmop.py`` (the reference's ``bmop.cu``, SURVEY.md
§2): N repeated vmults per (degree, refinement), reporting s/apply and
GDoF/s for every tier, optionally beside the assembled-SpMV baseline
(``bmspmv``, BASELINE config 3).  The benchmarks, their arguments and
their record keys are the reference's:

- ``bench_config``: ``LaplaceOperator.vmult_raw`` on a ``scatter`` tier,
  with ``with_spmv`` the padded-ELL SpMV of the assembled matrix beside it;
- ``bench_resident``: the solver-resident kernels on their own layout, K1
  (``ResidentSeparable``) in 3D and K3 (``ResidentTerms2D``) in 2D;
- ``bench_varcoef``: BASELINE config 5's separable coefficient through K4
  (``ResidentTerms``) beside the per-qpoint structured tier;
- ``bench_curved``: the shell through the separable-metric tier and K4;
- ``bench_adaptive``, ``bench_adaptive_solve``: the adaptive box tier, its
  bf16 recast, the incidence tier beside it, and its Jacobi-CG, GMG-CG and
  bf16-cycle GMG-CG.

The chained rate (every benchmark but ``bench_config``) is the
reference's in-jit ``fori_loop`` run eagerly: v <- (apply(v) * 1e-7) in
v's dtype, ``n_chain = max(reps, 2)`` times (the rescale keeps the chain
finite), one warm chain, then two timed chains under CUDA events;
``bench_config`` times ``reps`` calls on the same input, as the
reference's ``time_fn`` does.  A tier that the reference drops without a
word when it raises (a kernel tier whose tiling its TPU could not meet)
is recorded instead, its exception's type and text under the record's
``tier_errors``, and the benchmark goes on.  ``bench_distributed``
(``--adaptive N --shards 4`` or ``2x2``) chains the distributed box tier's
apply over an in-process shard mesh (``tpufem_torch.parallel``); on one
card its shards share the card, so it measures what the decomposition
costs, not scaling across cards.

Run:  tpufem-torch-bmop --dim 3 --degrees 1 2 3 4 --refine 4 [--spmv]
      tpufem-torch-bmop --degrees 4 --refine 6 --resident f32
      tpufem-torch-bmop --degrees 4 --refine 3 --adaptive 2 --shards 2x2
      (python -m tpufem_torch.apps.bmop ...; --cpu or --device cpu runs
      on the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# adaptive_mesh is the reference's bmop.adaptive_mesh, kept in apps.poisson
from tpufem_torch.apps.poisson import adaptive_mesh
from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.ops.kernel_separable import ResidentSeparable
from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.ops.separable import cartesian_coef_terms, global_1d_matrices
from tpufem_torch.ops.sparse import EllMatrix
from tpufem_torch.parallel.mesh import Sharded
from tpufem_torch.solvers.box_multigrid import BoxMultigrid
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.metrics import emit
from tpufem_torch.utils.precision import torch_dtype
from tpufem_torch.utils.timer import synchronize, time_fn


def chain_seconds(apply, x, n_chain: int, what: str) -> float:
    """Seconds per apply of ``n_chain`` chained applies v <- (apply(v) *
    1e-7) in v's dtype, from x (the rescale keeps the chain finite: the
    operator's spectral radius is >> 1): one warm chain, then two timed
    chains, CUDA events around them on the card (on the first shard's
    card for a ``Sharded`` x, after waiting for every card).  Raises
    FloatingPointError ("``what`` produced non-finite output") if the
    chain's output is not finite."""

    def chain(v):
        for _ in range(n_chain):
            v = (apply(v) * 1e-7).to(v.dtype)
        return v

    parts = x.parts if isinstance(x, Sharded) else [x]
    devices = list(dict.fromkeys(a.device for a in parts))
    chain(x)
    if devices[0].type == "cuda":
        for d in devices:
            synchronize(d)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(devices[0]))
        for _ in range(2):
            y = chain(x)
        for d in devices[1:]:
            synchronize(d)
        end.record(torch.cuda.current_stream(devices[0]))
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(2):
            y = chain(x)
        dt = time.perf_counter() - t0
    ys = y.parts if isinstance(y, Sharded) else [y]
    if not np.isfinite(sum(float(a.abs().float().sum()) for a in ys)):
        raise FloatingPointError(f"{what} produced non-finite output")
    return dt / (2 * n_chain)


def _tier_error(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"


def build_adaptive_op(dim, p, refine, steps, dtype,
                      device: torch.device | str = "cuda"):
    """(mesh, dofs, constraints, op) for the adaptive benchmarks — built
    once and shared between the apply and solve sections (the host setup
    is what costs at the flagship size)."""
    device = resolve_device(device)
    mesh = adaptive_mesh(dim, refine, steps)
    dofs = DoFHandler(mesh, p)
    ac = make_hanging_node_constraints(dofs)
    op = BoxLaplaceOperator(mesh, dofs, constraints=ac, dtype=dtype,
                            device=device)
    return mesh, dofs, ac, op


def bench_adaptive(dim, p, refine, steps, dtype, reps, compare=False,
                   prebuilt=None, bf16_tier=True,
                   device: torch.device | str = "cuda"):
    """Adaptive-mesh apply benchmark: the box tier's constrained apply
    (BASELINE config 4), with optional incidence-tier comparison.

    Two precision tiers, f32 patch vectors and, for a float32 ``dtype``,
    the bf16 recast of the same operator (bf16 storage and products); the
    reported rate is the best tier's, with per-tier rates and the bf16
    tier's relative error against f32 attached.  ``prebuilt``: the tuple
    of ``build_adaptive_op``, whose device is used."""
    mesh, dofs, ac, op = (prebuilt if prebuilt is not None
                          else build_adaptive_op(dim, p, refine, steps,
                                                 dtype, device))
    n_chain = max(reps, 2)

    def chain_rate(op_):
        xs = op_.to_patch(np.ones(dofs.n_dofs))
        return chain_seconds(op_.vmult, xs, n_chain,
                             "adaptive apply"), xs

    dt, x = chain_rate(op)
    tiers = {"boxes-f32": dofs.n_dofs / dt / 1e9}
    bf16_err = None
    if bf16_tier and torch_dtype(dtype) == torch.float32:
        # the bf16 recast casts the f32 operator's device tensors: the
        # reference's fresh bf16 build, without its host setup
        op16 = op.recast("bfloat16")
        dt16, x16 = chain_rate(op16)
        tiers["boxes-bf16"] = dofs.n_dofs / dt16 / 1e9
        yr = op.vmult(x).to("cpu", torch.float64).numpy()
        y16 = op16.vmult(x16).to("cpu", torch.float64).numpy()
        bf16_err = float(np.linalg.norm(y16 - yr) / np.linalg.norm(yr))
        if tiers["boxes-bf16"] > tiers["boxes-f32"]:
            dt = dt16
    rec = {
        "bench": "bmop-adaptive",
        "dim": dim, "degree": p, "refine": refine, "adaptive_steps": steps,
        "n_dofs": dofs.n_dofs, "n_cells": mesh.n_cells,
        "n_hanging": len(ac.lines),
        "n_patch": op.n_patch,
        "patch_overhead": round(op.n_patch / dofs.n_dofs, 3),
        "scheme": max(tiers, key=tiers.get), "dtype": dtype,
        "n_rects": len(op._rect_meta), "n_fallback_rows": (
            len(ac.lines) - op.n_rect_rows),
        "s_per_apply": dt,
        "gdofs_per_s": dofs.n_dofs / dt / 1e9,
        "tiers_gdofs": {k: round(v, 4) for k, v in tiers.items()},
    }
    if bf16_err is not None:
        rec["bf16_rel_err"] = bf16_err
    if compare:
        mf = MatrixFree.build(
            mesh, dofs,
            FemConfig(dim=dim, degree=p, dtype=dtype, scatter="incidence"),
            op.device, constraints=ac,
        )
        iop = LaplaceOperator(mf)
        xg = torch.ones(dofs.n_dofs, dtype=op.dt, device=op.device)
        dt_i = time_fn(lambda _: iop.vmult(xg), xg, reps=max(1, reps // 10))
        rec["incidence_s_per_apply"] = dt_i
        rec["box_speedup_vs_incidence"] = dt_i / dt
    return rec


def bench_distributed(dim, p, refine, steps, dtype, reps, shards,
                      prebuilt=None, device: torch.device | str = "cuda"):
    """Distributed box-tier apply benchmark: the chained rate of the
    sharded apply (each shard's partial apply and the cut-plane
    exchanges) over a shard mesh (the multi-GPU bmop run of the
    reference, SURVEY.md §3.6).  Reports the aggregate GDoF/s across all
    shards; ``n_devices`` counts the distinct devices the shards sit on.
    ``prebuilt``: (mesh, dofs, constraints, op) from
    ``build_adaptive_op``."""
    from tpufem_torch.parallel.boxes import DistributedBoxLaplace

    if prebuilt is None:
        prebuilt = build_adaptive_op(dim, p, refine, steps, dtype, device)
    mesh, dofs, ac, gop = prebuilt
    dop = DistributedBoxLaplace(gop, shards=shards)
    x = dop.put_vector(gop.to_patch(np.ones(dofs.n_dofs)))
    n_chain = max(reps, 2)
    dt = chain_seconds(dop.vmult, x, n_chain, "distributed apply")
    return {
        "bench": "bmop-distributed",
        "dim": dim, "degree": p, "refine": refine, "adaptive_steps": steps,
        "n_dofs": dofs.n_dofs, "n_cells": mesh.n_cells,
        "n_hanging": len(ac.lines),
        "shards": f"{dop.sz}x{dop.sy}", "n_devices": dop.mesh.n_devices,
        "scheme": "boxes-distributed", "dtype": dtype,
        "s_per_apply": dt,
        "gdofs_per_s": dofs.n_dofs / dt / 1e9,
    }


def bench_adaptive_solve(dim, p, refine, steps, dtype, rtol=1e-5,
                         prebuilt=None, bf16_cycle=False,
                         emit_cb=None, device: torch.device | str = "cuda",
                         stage=None):
    """Adaptive whole-solve benchmark: Jacobi-CG against the
    global-coarsening GMG-CG on the box tier
    (``tpufem_torch.solvers.box_multigrid``), on the reference's b (seed 7,
    interior and non-hanging entries).  Each variant runs once warm, then
    once timed.

    ``prebuilt`` is ``build_adaptive_op``'s (mesh, dofs, constraints, op),
    optionally followed by the operator's diagonal and its ``BoxMultigrid``
    hierarchy, which are then not built again.  ``bf16_cycle`` (float32
    only) also times the mixed-precision variant (f32 outer CG, the bf16
    recast of the V-cycle hierarchy) with its true residual.  The bf16
    hierarchy is derived only after the f32 variants ran, and ``emit_cb``
    (if given) is called with the partial record first, so a failure in
    the bf16 variant does not lose the f32 lines.  Every variant's true
    residual is the f32 (or f64) operator's, relative to ||b||.

    ``stage(name, fn)`` runs each step (``build_adaptive_op``,
    ``diagonal``, ``mg_f32_build``, ``{jacobi,gmg}_{warm,timed}``,
    ``mg_bf16_recast``, ``gmg16_{warm,timed}``) and returns ``fn()``; the
    solve lab (``tpufem_torch.lab.adaptive_solve_lab``) passes one that
    clocks each step."""
    stage = stage or (lambda name, fn: fn())
    if prebuilt is None:
        prebuilt = stage("build_adaptive_op", lambda: build_adaptive_op(
            dim, p, refine, steps, dtype, device))
    mesh, dofs, ac, op, *hierarchy = prebuilt
    diag, mg = hierarchy or (None, None)
    if diag is None:
        diag = stage("diagonal", op.diagonal)
    if mg is None:
        mg = stage("mg_f32_build", lambda: BoxMultigrid(
            mesh, dofs, constraints=ac, dtype=dtype, fine_op=op,
            fine_diag=diag, device=op.device))
    rng = np.random.default_rng(7)
    mask = op.interior_mask.to("cpu", torch.float64).numpy() \
        * mg.fine.nh_mask
    xp = op.to_patch(rng.standard_normal(dofs.n_dofs))
    b = torch.as_tensor(mask * xp.to("cpu").numpy(), dtype=op.dt,
                        device=op.device)
    out = {
        "bench": "bmop-adaptive-solve", "dim": dim, "degree": dofs.degree,
        "refine": refine, "adaptive_steps": steps, "dtype": dtype,
        "n_dofs": dofs.n_dofs, "n_hanging": len(ac.lines),
        "rtol": rtol, "levels": len(mg.levels),
    }
    runs = [
        ("jacobi", "jacobi", lambda: op.cg_solve(b, diag, rtol=rtol)),
        ("gmg", "gmg", lambda: mg.cg_solve(b, rtol=rtol)),
    ]
    if bf16_cycle and torch_dtype(dtype) == torch.float32:
        runs.append(("gmg_bf16cycle", "gmg16", None))
    bnorm = float(torch.linalg.norm(b))
    for name, tag, run in runs:
        if run is None:  # the bf16 cycle, derived after the f32 lines
            if emit_cb is not None:
                emit_cb(dict(out))  # f32 lines are safe before the build
            # recast shares the f32 hierarchy's host build and its
            # Chebyshev estimates
            mg16 = stage("mg_bf16_recast",
                         lambda: mg.recast("bfloat16", solve_op=op))
            run = lambda: mg16.cg_solve(b, rtol=rtol)  # noqa: E731
        stage(f"{tag}_warm", run)
        synchronize(op.device)
        t0 = time.perf_counter()
        res = stage(f"{tag}_timed", run)
        synchronize(op.device)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_iterations"] = int(res.iterations)
        out[f"{name}_converged"] = bool(res.converged)
        # the f32 apply's own rounding floors this near eps*||A||/||b||,
        # so only the comparison across variants is meaningful
        rr = b - op.vmult(res.x.to(op.dt))
        out[f"{name}_true_rel_res"] = float(torch.linalg.norm(rr)) / bnorm
    return out


def bench_curved(dim, p, refine, dtype, reps,
                 device: torch.device | str = "cuda"):
    """Curved-geometry apply benchmark on the shell (BASELINE shell
    geometry): the separable-metric tier (orthogonal shells factor
    exactly), the per-qpoint general-metric structured tier on a CPU
    device only (as the reference runs it on its CPU rigs only), and in
    3D K4 (``MatrixFree.resident``) on the exact factorisation in the
    modes f32, bf16 and bf16s, chained on its resident layout."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    mesh = (Mesh.hyper_shell_3d(refine) if dim == 3
            else Mesh.hyper_shell_2d(refine))
    dofs = DoFHandler(mesh, p)
    x = torch.ones(dofs.n_dofs, dtype=dt, device=device)
    n_chain = max(reps, 2)

    def rate(scatter):
        mf = MatrixFree.build(
            mesh, dofs,
            FemConfig(dim=dim, degree=p, dtype=dtype, scatter=scatter),
            device)
        return chain_seconds(LaplaceOperator(mf).vmult_raw, x, n_chain,
                             "curved apply")

    tiers = {"separable(metric-factorized)": rate("separable")}
    if device.type == "cpu":
        tiers["structured(general-metric)"] = rate("structured")

    def rate_resident(mode):
        mf = MatrixFree.build(
            mesh, dofs,
            FemConfig(dim=dim, degree=p, dtype=dtype, scatter="separable",
                      use_pallas=True, pallas_mode=mode), device)
        rk = mf.resident
        if rk is None:
            raise ValueError("no resident terms kernel for this shape")
        return chain_seconds(rk.raw, rk.pad(x), n_chain,
                             "curved resident apply")

    tier_errors = {}
    if dim == 3:
        for mode in ("f32", "bf16", "bf16s"):
            name = f"resident-terms-{mode}+pallas"
            try:
                tiers[name] = rate_resident(mode)
            except Exception as e:  # recorded, not dropped
                tier_errors[name] = _tier_error(e)

    best = min(tiers, key=tiers.get)
    rec = {
        "bench": "bmop-curved",
        "dim": dim, "degree": p, "refine": refine,
        "n_dofs": dofs.n_dofs, "scheme": best,
        "tiers_gdofs": {k: dofs.n_dofs / v / 1e9 for k, v in tiers.items()},
        "dtype": dtype,
        "s_per_apply": tiers[best],
        "gdofs_per_s": dofs.n_dofs / tiers[best] / 1e9,
    }
    if tier_errors:
        rec["tier_errors"] = tier_errors
    return rec


def bench_varcoef(dim, p, refine, dtype, reps, modes=None,
                  attr_refine=None, device: torch.device | str = "cuda"):
    """Variable-coefficient apply benchmark (BASELINE config 5): the
    separable smooth coefficient c(x) = prod_a c_a(x_a) through K4 on the
    exactly factored weighted-1D terms, beside the per-qpoint structured
    tier on the same operator (the exact fallback for non-separable
    coefficients).

    On the card in 3D the terms are built once from
    ``cartesian_coef_terms`` with one ``ResidentTerms`` per mode (f32,
    bf16, bf16s by default), and no DoF handler is built at the kernel
    tiers' size; elsewhere each mode (default f32) builds its
    ``MatrixFree`` with ``coefficient_axes`` and chains its
    ``resident``.  ``attr_refine`` runs the structured attribution tier at
    a smaller mesh, its label carrying its own refinement."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    cax = [lambda x: 1.0 + 0.5 * np.sin(2.1 * np.pi * x),
           lambda y: 1.3 + y * y,
           lambda z: np.exp(0.5 * z)][:dim]

    def coef(pts):
        out = np.ones(pts.shape[0])
        for a in range(dim):
            out = out * np.asarray(cax[a](pts[:, a]))
        return out

    mesh = Mesh.hyper_cube(dim, refine)
    nd_g = ((1 << refine) * p + 1) ** dim
    x = torch.ones(nd_g, dtype=dt, device=device)
    n_chain = max(reps, 2)
    tiers = {}
    tier_errors = {}
    what = "apply"

    on_card = device.type == "cuda"
    if modes is None:
        modes = (("f32", "bf16", "bf16s")
                 if (dim == 3 and on_card) else ("f32",))
    if on_card and dim == 3:
        n_ax = 1 << refine
        npts = n_ax * p + 1
        terms = cartesian_coef_terms(p, dim, p + 1, n_ax, mesh.lower,
                                     mesh.upper, cax, np.float64)
        for mode in modes:
            name = f"resident-terms-{mode}+pallas"
            try:
                rk = ResidentTerms(npts, p, terms, dtype, mode=mode,
                                   device=device)
                tiers[name] = chain_seconds(rk.raw, rk.pad(x), n_chain, what)
                del rk
            except Exception as e:  # recorded, not dropped
                tier_errors[name] = _tier_error(e)
    else:
        dofs = DoFHandler(mesh, p)
        for mode in modes:
            name = f"resident-terms-{mode}+pallas"
            try:
                mf = MatrixFree.build(
                    mesh, dofs,
                    FemConfig(dim=dim, degree=p, dtype=dtype,
                              scatter="separable", use_pallas=True,
                              pallas_mode=mode), device,
                    coefficient_axes=cax)
                rk = mf.resident
                if rk is None:
                    raise ValueError("no resident terms kernel")
                tiers[name] = chain_seconds(rk.raw, rk.pad(x), n_chain, what)
            except Exception as e:  # recorded, not dropped
                tier_errors[name] = _tier_error(e)
    ar = refine if attr_refine is None else attr_refine
    mesh_a = mesh if ar == refine else Mesh.hyper_cube(dim, ar)
    dofs_a = DoFHandler(mesh_a, p)
    x_a = torch.ones(dofs_a.n_dofs, dtype=dt, device=device)
    akey = ("structured(per-qpoint)" if ar == refine
            else f"structured(per-qpoint)@refine{ar}")
    mf_s = MatrixFree.build(
        mesh_a, dofs_a,
        FemConfig(dim=dim, degree=p, dtype=dtype, scatter="structured"),
        device, coefficient=coef)
    op_s = LaplaceOperator(mf_s)
    tiers_gdofs = {k: nd_g / v / 1e9 for k, v in tiers.items()}
    tiers_gdofs[akey] = dofs_a.n_dofs / chain_seconds(
        op_s.vmult_raw, x_a, n_chain, what) / 1e9
    coefficient = "separable: (1+.5 sin(2.1 pi x))(1.3+y^2)e^{z/2}"
    if not tiers:  # no kernel tier ran: report the structured one
        rec = {
            "bench": "bmop-varcoef", "dim": dim, "degree": p,
            "refine": ar, "n_dofs": dofs_a.n_dofs, "scheme": akey,
            "coefficient": coefficient,
            "tiers_gdofs": tiers_gdofs, "dtype": dtype,
            "s_per_apply": dofs_a.n_dofs / tiers_gdofs[akey] / 1e9,
            "gdofs_per_s": tiers_gdofs[akey],
        }
    else:
        best = min(tiers, key=tiers.get)
        rec = {
            "bench": "bmop-varcoef", "dim": dim, "degree": p,
            "refine": refine, "n_dofs": nd_g, "scheme": best,
            "coefficient": coefficient,
            "tiers_gdofs": tiers_gdofs,
            "dtype": dtype,
            "s_per_apply": tiers[best],
            "gdofs_per_s": nd_g / tiers[best] / 1e9,
        }
    if tier_errors:
        rec["tier_errors"] = tier_errors
    return rec


def bench_resident(p, refine, dtype, reps, mode="f32", dim=3,
                   device: torch.device | str = "cuda"):
    """Solver-resident kernel apply (resident layout in and out: the rate
    chained CG applies sustain), K1 in 3D and K3 in 2D, on the unit cube's
    1D Laplace matrices, with the chained-rate protocol."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    n = 1 << refine
    npts = n * p + 1
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    h = 1.0 / n
    Kx, Mx = K1u / h, M1u * h
    if dim == 3:
        rk = ResidentSeparable(npts, p, [Kx] * 3, [Mx] * 3, dt, mode=mode,
                               device=device)
    elif dim == 2:
        rk = ResidentTerms2D(npts, p, [[Kx, Mx], [Mx, Kx]], dt, mode=mode,
                             device=device)
    else:
        raise ValueError("bench_resident supports dim 2 and 3")
    n_dofs = npts**dim
    x = rk.pad(torch.ones(n_dofs, dtype=dt, device=device))
    dt_s = chain_seconds(rk.raw, x, max(reps, 2), "resident apply")
    return {
        "bench": "bmop-resident",
        "dim": dim, "degree": p, "refine": refine, "n_dofs": n_dofs,
        "scheme": f"resident-{mode}", "dtype": dtype,
        "s_per_apply": dt_s,
        "gdofs_per_s": n_dofs / dt_s / 1e9,
    }


def bench_config(dim, p, refine, dtype, scatter, reps, with_spmv=False,
                 device: torch.device | str = "cuda"):
    """``vmult_raw`` on the ``scatter`` tier of the unit cube, ``reps``
    calls on the same input; ``with_spmv`` adds the padded-ELL SpMV of the
    assembled matrix, timed alike, and the matrix-free factor over it."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, p)
    mf = MatrixFree.build(
        mesh, dofs, FemConfig(dim=dim, degree=p, dtype=dtype,
                              scatter=scatter), device
    )
    op = LaplaceOperator(mf)
    x = torch.ones(dofs.n_dofs, dtype=dt, device=device)
    dt_mf = time_fn(lambda _: op.vmult_raw(x), x, reps=reps)
    rec = {
        "bench": "bmop",
        "dim": dim,
        "degree": p,
        "refine": refine,
        "n_dofs": dofs.n_dofs,
        "scheme": mf.scheme,
        "dtype": dtype,
        "s_per_apply": dt_mf,
        "gdofs_per_s": dofs.n_dofs / dt_mf / 1e9,
    }
    if with_spmv:
        A = EllMatrix.from_csr(assemble_laplace(dofs), dt, device)
        dt_s = time_fn(lambda _: A.matvec(x), x, reps=reps)
        rec["spmv_s_per_apply"] = dt_s
        rec["spmv_gdofs_per_s"] = dofs.n_dofs / dt_s / 1e9
        rec["mf_speedup_vs_spmv"] = dt_s / dt_mf
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degrees", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scatter", default="auto")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--spmv", action="store_true",
                    help="also run the assembled-SpMV baseline (bmspmv)")
    ap.add_argument("--curved", action="store_true",
                    help="benchmark the curved (shell) tiers instead")
    ap.add_argument("--adaptive", type=int, default=0, metavar="STEPS",
                    help="benchmark the adaptive box tier instead: STEPS "
                         "rounds of refinement toward a ball")
    ap.add_argument("--compare-incidence", action="store_true",
                    help="with --adaptive: also time the generic "
                         "incidence path for comparison")
    ap.add_argument("--resident", choices=["f32", "bf16", "bf16s"],
                    default=None,
                    help="benchmark the solver-resident kernel (resident "
                         "layout in/out, 2D/3D via --dim) in this mode")
    ap.add_argument("--shards", default=None,
                    help="with --adaptive: distributed box-tier apply "
                         "over an in-process shard mesh, '4' (z slabs) or "
                         "'2x4' (z x y); the shards share the device's "
                         "cards round-robin")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu")
    args = ap.parse_args(argv)
    if args.shards and (not args.adaptive or args.resident or args.curved
                        or args.spmv):
        ap.error("--shards runs the distributed adaptive box tier: it "
                 "requires --adaptive and excludes "
                 "--resident/--curved/--spmv")
    device = "cpu" if args.cpu else args.device
    for p in args.degrees:
        if args.resident:
            rec = bench_resident(p, args.refine, args.dtype, args.reps,
                                 mode=args.resident, dim=args.dim,
                                 device=device)
        elif args.curved:
            rec = bench_curved(args.dim, p, args.refine, args.dtype,
                               args.reps, device=device)
        elif args.adaptive and args.shards:
            rec = bench_distributed(
                args.dim, p, args.refine, args.adaptive, args.dtype,
                args.reps, args.shards, device=device,
            )
        elif args.adaptive:
            rec = bench_adaptive(
                args.dim, p, args.refine, args.adaptive, args.dtype,
                args.reps, compare=args.compare_incidence, device=device,
            )
        else:
            rec = bench_config(
                args.dim, p, args.refine, args.dtype, args.scatter,
                args.reps, with_spmv=args.spmv, device=device,
            )
        emit(rec)


if __name__ == "__main__":
    main()

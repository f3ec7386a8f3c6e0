#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpufem_torch``).

Run from the repository root on a machine with one CUDA GPU (H100):

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  1 header      the card's name and power limit (nvidia-smi), versions
  2 build       the CUDA kernels, from the sources in the checkout (one nvcc
                per source, all at once)
  3 kernels     each kernel against its plain PyTorch version on the card
                (f64 <= 1e-12, f32 <= 1e-6, bf16s <= 4e-3 max relative
                error vs the plain version in f64, on the same inputs):
                K1/K2 on random banded and Laplace operators, K4 (T = 1, 3,
                4, 7 terms; at p = 8 also PASS_T = 22, more windows than a
                block holds: passes over x) and K3 (T = 1, 2, 3) on random
                non-symmetric banded
                matrices, each at p = 1, 2, 4, 7, 8: K1, K3 and K4 on the
                band ring (csrc/resident_ring.cuh) with and without the
                fused mask into a NaN-filled resident layout (every point
                written, the pad columns zero), K3 at the segment chooser's
                count and at 1-4 segments of x, K2 by its z-march
                (csrc/separable_apply.cuh) into a NaN-filled flat grid,
                bit for bit equal to its tile routine on the same input;
                then every kernel at its main-path shapes (K2: 3D Q4 refine
                5 and 2D refine 10; K4: the coefficient operator and the
                shell's terms; K3: 2D Q4 refine 10 and 8, again at every
                segment count)
  4 main path   solve_poisson 3D Q4 refine 5 f32 through K2 (2,146,689
                DoFs), then the 16,974,593-DoF resident Jacobi-CG through
                K1, twice (bitwise-equal x); the kernel launch counts of
                these runs are the ones reported.  Then the resident solve
                once more with pallas_mode="bf16s", its K1 count apart
  4c main path  of the terms tier: solve_poisson on the 3D Q4 refine 5
                hyper_shell f32 through K4; the 16,974,593-DoF separable-
                coefficient operator's resident Jacobi-CG through K4 with
                the fused mask, twice (bitwise-equal x); the 2D Q4 refine
                8 resident Jacobi-CG through K3 with the fused mask, twice
                (bitwise-equal x).  K3/K4 counts are read here; then the 2D
                solve again with the plain f32 apply and through K3 in
                f64 (its true residual is f32 CG drift, not K3), and the
                coefficient solve once more in bf16s, its K4 count apart
  4b parity     f64 solves, kernel vs plain: equal iterations, L2 equal to
                1e-10 (cube: 3D Q4 refine 3; 2D Q4 refine 5, rough RHS;
                shell: 3D Q4 refine 3; 2D Q4 refine 5, rough RHS)
  5 lab         the K1 kernel lab (L1: v17-v20, tpufem_torch/lab): each
                kernel in each mode (f64, f32 = 3xTF32, f32h = 1xTF32,
                bf16 = bf16x3, and the copy/bands/mm ablations) against its
                plain version in f64 (``LAB_TOL``) and, for f32, f32h and
                bf16, against the emulation of its x stage's arithmetic
                (``EMU_TOL``; f32h within its class), halo zeros and two
                chained applies, at p = 1, 2, 4, 7, 8 on small grids and at
                the 16,974,593-DoF flagship (v17, v19 and v20 on their ring
                routines, csrc/lab_resident_ring.cuh, v20's x stage
                windowed, their copy and bands ablations bit for bit equal
                to the tile routine, which is checked the same way as their
                earlier schedule); then the
                lab's entry point
                ``kernel_lab.main`` at the flagship, whose L1 launch counts
                are the ones reported and whose raw applies, each timed in
                turns with its plain version (K1's copy ablation too), are
                the L1 times.  The L2a kernels (K2's lab, x first: v2, v3,
                v6, v8, v9, v12, vx, vxy, tpufem_torch/lab/separable_lab.py)
                likewise: each in each precision (f64, f32 = 3xTF32, f32h =
                1xTF32, bf16 = bf16x3, bf16d = one bf16 product; v9 is v2
                in bf16x3) against its plain version in f64 (``separable_
                lab.TOL``) and, split precisions, its emulation
                (``EMU_TOL``), every output point written, at p = 1, 2, 4,
                7, 8 and at the flagship; their counts and times come from
                the same ``kernel_lab.main`` run.  The L2b kernels (K2's
                lab, z/y first: v13, v14, v15, v16, vcopy, vband,
                tpufem_torch/csrc/lab_zyfirst.cuh) in the same way: v13-v15
                in every precision against plain and emulation, v16, vcopy
                and vband (no tensor-core stage) in f64 and f32 against
                their plain versions (vcopy exactly, vband 1e-6), and again
                at every sub-tile their routine's chooser can pick and two
                larger ones, on a ragged output layout and at the flagship;
                v15 and v14 run L1's persistent ring routine on L2's
                layouts and v13 lab_ring_kernel; their earlier schedule
                (zy_kernel) and v15's and v14's other ring routine are
                checked the same way, one input a degree and the flagship,
                and v14 is held to v15 bit for bit on both ring routines;
                v3, vxy, v2 (v6, v8 and v9 with it) and v12 run their own
                rings (lab_separable_ring.cuh; v12's launcher in
                lab_separable_band.cu), their earlier schedule (l2_kernel)
                checked the same way; v8, v6 and v9 (bf16x3) are held to v2
                bit for bit on the ring, v2 at the flagship to itself at
                two z segments a block, and v12 at the flagship to itself
                at one z tile a block and its chooser's segment.
                Every L2 output starts filled with NaN
  6 throughput  ms per apply over chains of 30 applies (CUDA events),
                kernel and plain in turns: K1 at 17M DoFs, K2 at 3D Q4
                refine 5 (2.1M) and 6 (17M) and 2D refine 10, K4 on the
                17M coefficient operator and the 2.1M shell, K3 at 2D Q4
                refine 10 (16,785,409 DoFs) and, with the fused mask, 8
                (1,050,625: the 2D CG's), against K2 at refine 10 too; K2's
                z-march in turns with its tile routine at those three
                shapes and at the flat GMG levels (GMG_K2_NPTS, by chains
                and by device time), with the march's design bound; K3
                beside EARLIER_MS (the routine of e3bfbab), K2 beside its
                tile routine;
                K1, K4, the shell's K4 and K3 at refine 10 and 8 in turns
                with the ring's copy and bands ablations (each held to its
                plain version first): the split into tile mover, z/y (2D:
                y) bands and x band;
                the shell's K4 at the sub-tiles (8, 8), (4, 8) and (4, 16)
                in turns (its blocks in waves over the card's SMs); the
                design bound of K1's and K4's padded resident layout;
                phase 5's L1 and L2 times, and as a note one torch.matmul
                of each lab's x-stage shape (no single PyTorch call
                computes K1's or K2's operator, so their library_ms is
                null); the one call that computes vcopy's function (a
                slice made contiguous) and vx's (one torch.matmul), each
                held to the kernel and timed in turns with it: their
                library_ms, with the kernel's factor over the call and the
                bytes its design moves from L2 into shared memory an apply;
                vx's x stage as the first version ran it (per-warp jobs, B
                from device memory) with shared memory sized by its flags,
                in turns with the ring; v17, v19 and v20 in turns with
                their earlier schedule (the tile routine) in each precision,
                beside their design bound, the bytes they move from L2, and
                v20 beside K1 and v16; v15 in turns with its earlier
                schedule (zy_kernel) and with L1's other ring routine; v13
                in turns with its earlier schedule and with v15 on
                lab_ring_kernel; v14 in turns with its earlier schedule and
                with v15 on its default ring routine; v3 and vxy in turns
                with their earlier schedule (l2_kernel), and vxy with vx
                (the x stage alone); v2, v8 and v12 in each precision and v9
                in bf16x3 in turns with l2_kernel, beside their ring's
                segment, grid, shared memory, design bound and L2 bytes;
                torch.matmul of (256, 256) f32, P1's
  7 probes      the toolchain probes (tpufem_torch/lab/toolchain_probe.py):
                P1's product on each routine (the wgmma tile, the earlier
                WMMA kernel) in each arithmetic at n = 256 and at the
                partial-tile ``P1_PARTIAL``, the wgmma tile also at
                ``P1_LARGE`` (a ring that reuses its stages), on seeded
                pairs against the f64 product (``P1_TOL``) and, the wgmma
                tile, the plain version in its arithmetic (the smaller of
                ``EMU_TOL`` and ``P1_PLAIN_TOL``), on ones (exactly n),
                one launch a call; the wgmma tile's largest difference
                from the earlier routine; P2's three kernels at (n_iter, m) =
                (256, 512) on the probe's inputs against their plain
                versions in the same arithmetic (``P2_TOL``), and its
                product chain alone and beside the multiply-adds on a
                seeded dense input at 8 and 256 products against the plain
                version in the same arithmetic and the f64 chain
                (``P2_DENSE_TOL``), each on the cluster chain (where the
                arithmetic takes it) and on the earlier routine; the two
                routines in turns in each arithmetic the cluster chain
                takes, with its plan and design bound; then the probes'
                entry point ``toolchain_probe.main``, whose launch counts
                are the ones reported; P1's device times (torch.profiler)
                in every arithmetic, the routines in turns, with the wgmma
                tile's plan and design bound, beside the plain
                version's and torch.matmul's (strict f32) device time and
                its chained time
  8 cell loop   the cell-loop tiers (plain PyTorch, no kernel of the
                kernels line; ``cell_loop_phase``): solve_poisson 3D Q4
                refine 5 f32 on its default tier (auto: structured) on the
                cube and the shell (general metric, rtol SHELL_RTOL), L2
                <= 1e-6; the f32 applies of the cube operator
                (structured, dense, K2, the plain separable one and the f64
                apply rounded once) against the f64 apply on the constant
                and on u, and the Jacobi-CG through each
                (``f32_rounding``); the structured f64 apply against
                K2's (1e-10), dense against structured at refine 4
                (1e-12); apply ms of
                structured, dense and K2 at refine 5; on the JAX bench's
                adaptive flagship (3D Q4, hyper_cube refine 4, 2 steps
                toward the ball: 49,806 cells, 3,302,995 DoFs) the host
                setup, incidence against colored (f64 1e-12), every apply
                bitwise equal twice, their apply ms, two f32
                solve_poisson(mesh=...) with equal iterations and bitwise-
                equal x, an f64 one (f32 L2 at most 1e-6 above it); the
                AMR loop (3D Q2 refine 3, 3 cycles) on the card, each
                cycle's eta against the CPU's solve on the same mesh
  9 gmg         geometric multigrid (``gmg_level_checks``, ``gmg_phase``):
                K2 (f64, f32) at every flat level size of the 3D and 2D Q4
                V-cycles (3D npts 9-129, 2D 9-513), K1 and K4 (f64, f32,
                bf16s, with and without the fused mask) at 3D npts 9, 17,
                33 and K3 at 2D npts 17, 33 at every segment count, against
                their plain versions as in phase 3 (K2's z-march also bit
                for bit against its tile routine); then, counts reset, the
                16,974,593-DoF flagship GeometricMultigrid(3, 4, 6,
                coarsest_refine=1, f32, use_pallas) through
                resident_gmg_cg twice (bitwise-equal x; K1 fine with the
                fused mask, K2 below) and the flat GMG-CG (equal
                iterations, x within GMG_FLAT_TOL), the true residual, again
                with pallas_mode="bf16"; BASELINE config 5
                (coefficient_axes: K4 on every level) likewise; the 2D Q4
                refine 8 hierarchy (K3 fine, K2 below); solve_poisson_mg 3D
                Q4 refine 5 f32 and solve_poisson(precond="chebyshev")
                there, L2 <= 1e-6; the launches of that path join the
                kernels line; then the GMG solves' seconds beside the
                resident Jacobi-CG on the same operator and b, and a
                torch.profiler split of the flagship's GMG iteration (K1,
                K2 per level, transfers, coarse solve, dots, elementwise,
                idle share)
  10 boxes      the adaptive box tier (plain PyTorch, no kernel of the
                kernels line; ``box_phase``) on phase 8's adaptive
                flagship (3,302,995 DoFs): the host setup (box operator in
                f64 and f32, diagonal, the GMG hierarchy), the box vmult
                and vmult_raw against the incidence tier's (f64 1e-12, f32
                1e-6) and the bf16 recast's vmult and vmult_raw against
                f32 (``BOX_BF16_TOL``, ``BOX_BF16_RAW_TOL``),
                every apply bitwise equal twice; apply ms of the box tier
                in f32 and bf16 beside incidence and colored; on the JAX
                bench's b (interior, non-hanging, N(0, 1), seed 7) at rtol
                1e-5 the box Jacobi-CG, two f32 box GMG-CGs (equal
                iterations, bitwise-equal x, fewer iterations than Jacobi)
                and the bf16-cycle GMG-CG, each with the f64 box
                operator's true residual (<= ``BOX_RES_FACTOR`` * rtol);
                solve_poisson(mesh=..., scatter="boxes", precond="gmg") in
                f32 and f64 (L2 f32 <= f64 + 1e-6)
  11 operators  the operator families beyond Laplace (``operator_term_checks``,
                ``operators_phase``): K4 on their term sets against its
                plain version as in phase 3 (heat's 4-term Helmholtz at
                dt 1e-4 and 1 and 1-term mass with and without the fused
                mask, the nine elasticity blocks unmasked; 3D npts 9, 17,
                33 at p = 2 and 4 in f64, f32 and bf16s, with the term
                group printed; then Helmholtz and mass at npts 257 and the
                blocks at 129); then, K4's launches of the f32
                runs at full width counted (heat, the elasticity apply,
                the fast solve; the rest printed apart), the JAX
                bench's 3d_heat_implicit_step (run_heat 3D Q4 refine 6,
                16,974,593 DoFs, dt 1e-4, 5 steps, resident: f32 twice,
                bitwise-equal u, and f64, L2 within HEAT_L2_GAP), its two
                K4 instances timed alone, and at refine 4 the
                tensor-product tier against the generic one in f64;
                3d_nonlinear_newton_solve (run_nonlinear 3D Q2 refine 5,
                274,625 DoFs, CG Jacobi f32 twice: equal counts,
                bitwise-equal x) and the minimal surface with GMRES;
                3d_elasticity_apply (SeparableElasticityOperator 3D Q4
                refine 5, 2,146,689 x 3 DoFs, 9 K4 launches an apply, f32
                and bf16s against the plain f64 apply, ms beside one
                block's K4 and the generic vector tier; at refine 3 in f64
                against elasticity_operator) and run_elasticity fast (3D
                Q4 refine 4, K4) and GMG (3D Q2 refine 4), f32 and f64,
                each solve's true residual held to EL_RES_FACTOR * rtol
  12 bench      the bench apps through their entry points at the JAX
                bench's flagship sizes, f32, 30 applies a chain
                (``bench_phase``): bmop's bench_resident through K1 (f32,
                bf16s; 16,974,593 DoFs) and K3 (bf16s; 2D refine 10,
                16,785,409), bench_varcoef through K4 (f32, bf16s; the
                structured attribution tier at refine 5) and bench_curved
                (the 2,146,689-DoF shell: the separable tier, K4 in f32,
                bf16, bf16s), each kernel tier present and none in
                tier_errors; the adaptive flagship's bench_adaptive (box
                f32 and bf16, bf16 within BOX_BF16_TOL, beside incidence)
                and bench_adaptive_solve (Jacobi, GMG, bf16 cycle:
                converged, GMG in fewer iterations; true residuals, printed
                beside phase 10's once both have run); bmop.main --spmv at 3D Q1-Q4 refine 4 (the
                Q4 ELL SpMV against the structured f32 apply on a seeded
                vector within SPMV_MF_TOL, each side beside its bound) and
                bmspmv.main at refine 3 (CSR cross-check within CSR_TOL);
                every rate finite and positive.  Its K1, K3 and K4
                launches are printed apart: timing repetitions of bmop,
                not main-path launches
 13 distributed the distributed layer (``distributed_phase``; plain
                PyTorch on an in-process shard mesh, every shard on the
                card, no kernel of the kernels line: the wrappers'
                counters must not move): apps.multichip.dryrun at 8
                shards in f64 (the nine parity lines: each distributed
                count equal to the single-device count on the card, x
                within 1e-9, printed beside MULTICHIP_r05.json's JAX CPU
                counts); solve_poisson(mesh=adaptive flagship, degree=4,
                precond="gmg", shards=(2, 2)) in f64 (phase 10's count,
                x within 1e-9) and f32 (L2 within 1e-6 of f64); two f32
                distributed GMG-CGs bitwise equal; the box Jacobi-CG at
                shards (4, 1) in f64 against the single-device one;
                bmop.bench_distributed 2x2 and 4x1 (f32) beside the
                single-device box apply; run_heat and run_elasticity with
                shards=4 (3D Q2, f64) against their single-device runs
 14 labs        the solver labs and the chip checks (``labs_phase``):
                apps.chip_checks (3D Q4 refine 5 f32: K2's Jacobi-CG and
                GMG-CG twice, equal iterations and bitwise-equal x; K2
                against the structured tier; GMRES and the quasilinear
                Newton solve twice; K4 on the Helmholtz terms at npts 65
                against the f64 oracle), its artifact diffed against the
                H100 golden (tpufem_torch/goldens/chip_checks_h100.json)
                by apps.check_chip_goldens; lab.resident_mask_lab at 3D Q4
                refine 6 f32 (K1, flat and fused mask, equal iterations);
                lab.cg_blas1_lab at the resident layout (257, 257, 272),
                40 iterations; lab.adaptive_prec_lab on phase 10's
                operator (f32, cells-tf32, all-tf32, bf16-patch; none
                failing) and lab.adaptive_solve_lab's solve stages on the
                same operator, its diagonal and its GMG hierarchy (the
                flagship, built by phase 10).  Its K1, K2 and K4 launches
                join the kernels line
Phases 8, 12 and 13 run in processes of their own (``chip_smoke.py --phase
N --result PATH``, two host threads each), started after phase 7 and
joined after phase 11: their seconds are mostly host setup and none of
their launches join the kernels line.  Their times share the card and the
host with phases 9-11 (and theirs with them); phase 14 runs after they
have ended.  Each child's output is printed when it is joined, and kept in
chiprun_out/chip_smoke_phase<N>.log.
Then the seconds each phase took, one JSON line with each kernel's record
(time, plain time, bound on an H100 and library time), and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

TOL = {"f64": 1e-12, "f32": 1e-6, "bf16s": 4e-3}
# phase 8's f32 applies of the cube operator held to its f64 apply
# (``f32_rounding``): name -> (scatter, use_pallas)
F32_TIERS = {"structured": ("structured", False), "dense": ("dense", False),
             "K2": ("separable", True),
             "separable plain": ("separable", False)}
# the L1 kernels' x-stage classes (max abs error / max |y| against the
# plain version in f64; the ablations compute their own functions).
# bf16x3's class is 2e-5, not 1e-5: its arithmetic alone, emulated in
# plain PyTorch (V17Kernel.emulate), passes 1e-5 on the CPU at p = 7 and 8
# (tests/test_torch_lab.py::test_emulated_x_stage_classes), and phase 5
# holds each kernel to the emulation on its own input too
LAB_TOL = {"f64": 1e-12, "f32": 1e-6, "f32h": 4e-3, "bf16": 2e-5,
           "copy": 0.0, "bands": 1e-6, "mm": 1e-6}
# an f32-storage kernel against the emulation of its x stage's arithmetic
# on the same layout.  The emulation runs the band stages as the kernel
# does (f32 tables, taps in order, one rounding per FMA), so both split
# the same qq; they differ in the order of the x stage's f32 sums (f32h,
# one TF32 rounding, is held to its class)
EMU_TOL = {"f32": 1e-6, "bf16": 1e-5}
# random inputs per kernel, mode and p at phase 5's small sizes (the
# flagship keeps one)
LAB_DRAWS = 3
LAB_KERNELS = {"v17": ("dense x stage on the TMA ring, wgmma",
                       "scripts/kernel_lab.py:581",
                       "tpufem_torch/csrc/lab_resident_ring.cuh"),
               "v18": ("fused bands: v17's ring routine",
                       "scripts/kernel_lab.py:1090",
                       "tpufem_torch/csrc/lab_resident_ring.cuh"),
               "v19": ("warp-specialised, persistent",
                       "scripts/kernel_lab.py:922",
                       "tpufem_torch/csrc/lab_resident_ring.cuh"),
               "v20": ("block-banded x stage, windowed wgmma on the ring",
                       "scripts/kernel_lab.py:747",
                       "tpufem_torch/csrc/lab_resident_ring.cuh")}
# the L2a kernels: (what the variant is, the Pallas kernel it replaces)
L2_KERNELS = {"v2": ("dense x ring feeding wgmma y and z, a z segment a "
                     "block", "scripts/kernel_lab.py:47"),
              "v3": ("band x on a TMA ring, wgmma y/z",
                     "scripts/kernel_lab.py:78"),
              "v6": ("v2's ring", "scripts/kernel_lab.py:106"),
              "v8": ("v2's ring: its transposes are the ring's operand "
                     "layouts", "scripts/kernel_lab.py:132"),
              "v9": ("v2's ring in bf16x3", "scripts/kernel_lab.py:212"),
              "v12": ("dense x ring feeding band y and z, the z taps in a "
                      "window down a z segment", "scripts/kernel_lab.py:237"),
              "vx": ("x stage alone", "scripts/kernel_lab.py:164"),
              "vxy": ("dense x ring, wgmma y stored from its accumulators",
                      "scripts/kernel_lab.py:177")}
# the L2b kernels
L2_KERNELS.update({
    "v13": ("z/y bands, two x products; L1's ring",
            "scripts/kernel_lab.py:302"),
    "v14": ("v13, next load in flight; L1's persistent ring",
            "scripts/kernel_lab.py:359"),
    "v15": ("v14, one K-stacked product; L1's persistent ring",
            "scripts/kernel_lab.py:431"),
    "v16": ("all bands", "scripts/kernel_lab.py:1347"),
    "vcopy": ("loads and stores alone", "scripts/kernel_lab.py:500"),
    "vband": ("band stages alone", "scripts/kernel_lab.py:525")})
# the library and the source of each L2 kernel's default routine
L2_SOURCES = {"v3": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "vxy": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "v2": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "v6": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "v8": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "v9": ("lab_separable_ring", "lab_separable_ring.cuh"),
              "v12": ("lab_separable_band", "lab_separable_ring.cuh"),
              "v13": ("lab_zyfirst", "lab_resident_ring.cuh"),
              "v14": ("lab_zyfirst", "lab_resident_ring.cuh"),
              "v15": ("lab_zyfirst", "lab_resident_ring.cuh")}
# storage and precision of each L2 mode
L2_MODES = {"f64": (torch.float64, "highest"),
            "f32": (torch.float32, "highest"),
            "f32h": (torch.float32, "high"),
            "bf16": (torch.float32, "bf16x3"),
            "bf16d": (torch.float32, "default")}
# the lab run whose raw apply is each L2 row's time: 3xTF32 (v9: bf16x3), on
# the variant's default routine (v3, vxy, v2, v6, v8, v9, v12: their rings;
# v13: lab_ring_kernel; v14, v15: the persistent ring)
L2_TIMED = {"v2": "v2-highest", "v3": "v3-highest", "v13": "v13-highest",
            "v14": "v14", "vxy": "vxy"}
# the lab's main path: its entry point at the flagship, every L1 and L2
# kernel
LAB_ARGS = ["--refine", "6", "--p", "4", "--reps", "20", "--variants",
            "v0", "v5", "v5-copy", "v4", "v17", "v17-h", "v17-bf",
            "v17-f64", "v18", "v19", "v19-bf", "v20", "v20-bf", "v20-h",
            "v17-copy", "v17-bands", "v17-mm", "v2-highest", "v2-high",
            "v2-default", "v3-highest", "v3-high", "v6", "v8", "v9", "v12",
            "vx", "vxy", "v13-highest", "v13-high", "v14", "v15", "v15-high",
            "v15-default", "v16", "vcopy", "vband"]
# P2's kernels against their plain versions in the same arithmetic, max
# |error| / max |o|, on the probe's inputs at (n_iter, m) = (256, 512): one
# TF32 or bf16 pass of a diagonal w is exact in f32, so those chains are
# reproduced to the bit; the split arithmetics sum three parts in the tensor
# cores' truncating f32 accumulators, 256 times over.  The multiply-add
# chain against f64: 1024 f32 roundings with a steady bias (2.8e-5 measured)
P2_TOL = {"highest": 1e-4, "high": 1e-6, "bf16x3": 1e-5, "default": 1e-6}
P2_FMA_TOL = 1e-4
# P2's product chain on a seeded dense (512, 512) input with an orthogonal w,
# after 8 and after 256 products: max |error| / max |o| against the plain
# version in the same arithmetic and against the f64 chain, about three times
# what an H100 reads (3xTF32 5.4e-5 / 1.6e-3, 1xTF32 9.7e-4 / 4.2e-3, bf16x3
# 1.9e-5 / 3.5e-4, one bf16 pass 6.6e-3 / 3.7e-2: the tensor cores' f32
# accumulators truncate, a steady loss of ~6e-6 a product that the split
# arithmetics show; a chain without its products reads 1.3-1.6).  The same
# checks at the cluster chain's smaller m (64, 128, 256, a seeded input
# each) read at most 3xTF32 1.2e-5 / 3.9e-4, 1xTF32 9.2e-4 / 7.9e-3, bf16x3
# 1.8e-5 / 2.1e-4, one bf16 pass 7.4e-3 / 7.1e-2 (m = 64, as its plain
# version reads against f64) on an H100
P2_DENSE_ITERS = (8, 256)
P2_DENSE_TOL = {"highest": (2e-4, 5e-3), "high": (3e-3, 1.2e-2),
                "bf16x3": (6e-5, 1e-3), "default": (2e-2, 1e-1)}
# its multiply-add chain on the seeded normal v against f64 (2.8e-6 / 9.1e-5
# read: the f32 constant 1.000001 is 4.6e-8 off, 4 n_iter times over)
P2_DENSE_FMA_TOL = (1e-5, 3e-4)
PROBE_N_ITER, PROBE_M = 256, 512
# P1's partial-tile size: 3 full 64-row tiles and a partial one of 16
# rows, four chunks of k the last a quarter full
P1_PARTIAL = 208
# P1's large size, the wgmma tile only: 17 chunks of k, more than any
# arithmetic's ring holds at once, and 16 full tiles and 16 rows
P1_LARGE = 1040
STORAGE = {"f64": torch.float64, "f32": torch.float32,
           "bf16s": torch.bfloat16}
N_CHAIN = 30
# ms per apply on the tile routines the kernels ran before the ring,
# printed beside this run's times and kept out of the kernels line, which
# holds only what this run measured (NVIDIA H100 80GB HBM3 at 700 W): K1's
# and K4's (3D paths of separable_apply.cuh and terms_apply.cuh, K4 with
# its mask outside) from this script's phase 6 before the TMA ring; K3's
# (terms_apply.cuh, its mask outside) from ``python
# tpufem_torch/apps/resident_probe.py --applies`` on a git archive of
# e3bfbab, in turns with this tree in one call (the mean of its two runs'
# chains; at refine 8 its device time, as phase 6 takes it there).  K2's
# earlier schedule, the tile routine, is still in separable_apply.cuh:
# phase 6 times it in turns with the z-march and adds its times here
# (K2, K2_r6, K2_2d)
EARLIER_MS = {"K1": 1.1109, "K1_bf16s": 1.1485, "K4": 1.2770,
              "K4_bf16s": 1.4755, "K4_shell": 0.1913,
              "K3": 0.0256, "K3_r10": 0.3310}
# K4's term count at p = 8 in phase 3 whose windows no sub-tile holds, so
# the chooser takes passes over x (in f64, f32 and bf16s)
PASS_T = 22
SOLVE_RTOL = 1e-5
# the shell solve's tolerance: its RHS norm is dominated by the O(1)
# inhomogeneous Dirichlet rows, while interior rows are O(h^3), so the f32
# default rtol 1e-6 stops at an L2 error of ~1e-5 in f64 as in f32 (PERF.md)
SHELL_RTOL = 1e-9
# how far the 2D f32 resident solve's true residual through K3 may exceed
# the same solve's with the plain f32 apply (both drift from rtol in f32)
DRIFT_RATIO = 3.0
# the JAX bench's adaptive flagship (tpufem/apps/bmop.py:27-35 with
# bench.py:397, 415): adaptive_mesh(dim, refine, steps), Q4; its cells and
# DoFs
ADAPTIVE = (3, 4, 2)
ADAPTIVE_SIZE = (49806, 3302995)
# the separable coefficient of tests/test_pallas.py:708-712
COEF_AXES = [lambda x: 1.0 + 0.5 * np.sin(2.1 * np.pi * x),
             lambda y: 1.3 + y * y,
             lambda z: np.exp(0.5 * z)]


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


def masked_f64(A, u64, npts, dim):
    """m·A(m·u) + (1-m)·u with the full-box boundary mask m, in f64."""
    m1 = torch.ones(npts, dtype=torch.float64, device=u64.device)
    m1[0] = m1[-1] = 0.0
    m = m1
    for _ in range(dim - 1):
        m = torch.outer(m1, m.reshape(-1))
    m = m.reshape(-1)
    return m * A(m * u64) + (1.0 - m) * u64


def plain_f64(dim, npts, Ks, Ms, u64, dirichlet):
    """The plain PyTorch version in f64 on the card."""
    from tpufem_torch.ops.separable import laplace_apply_separable

    dev = u64.device
    K = [torch.tensor(k, dtype=torch.float64, device=dev) for k in Ks]
    M = [torch.tensor(m, dtype=torch.float64, device=dev) for m in Ms]
    A = lambda v: laplace_apply_separable(v, dim, npts, K, M)
    return masked_f64(A, u64, npts, dim) if dirichlet else A(u64)


def resident_out(k, x):
    """A resident kernel's output into a NaN-filled layout; raises unless
    every point is written (finite) and the pad columns are zero."""
    y = k.raw(x, out=torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise RuntimeError(f"{type(k).__name__}: an output point is not "
                           f"written or not finite")
    if y[..., k.npts:].any():
        raise RuntimeError(f"{type(k).__name__}: a pad column is not zero")
    return y


def march_design_bound(band) -> tuple[float, str]:
    """The least time of what K2's z-march does at its schedule (its
    ``KernelSeparable.with_routine("march")``): every u point its blocks
    load (the halo'd tile's columns on the grid, each segment's planes and
    its 2P warm-up planes on the grid), each output written once; and its
    band outputs (2 a halo'd column and plane from registers, 3 TY (TX+2P)
    + 2 TY TX a plane from shared memory; 2D 2 (TX+2P) and 2 TX) at 2p+1
    multiply-adds each, at the card's f32 (f64) peak."""
    from tpufem_torch.utils.timer import roofline_ms

    p, n, dim = band.p, band.npts, band.dim
    ty, tx = band.tile
    seg = -(-n // band.nseg)

    def loaded(t):  # points of an axis cut into pieces of t, halo p each
        return sum(min(n, a + t + p) - max(0, a - p) for a in range(0, n, t))

    elem = torch.empty((), dtype=band.dtype).element_size()
    if dim == 3:
        reads = loaded(tx) * loaded(ty) * loaded(seg)
        nt = -(-n // tx) * -(-n // ty)
        lx, ly = tx + 2 * p, ty + 2 * p
        bands = nt * n * (2 * ly * lx + 3 * ty * lx + 2 * ty * tx)
    else:
        reads = loaded(tx) * loaded(seg)
        bands = -(-n // tx) * n * (2 * (tx + 2 * p) + 2 * tx)
    return roofline_ms(elem * (reads + n**dim),
                       {"fp32" if elem == 4 else "fp64":
                        bands * 2 * (2 * p + 1)})


def same_bits(a, b) -> bool:
    """a and b equal bit for bit (the sign of a zero included)."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.view(it), b.view(it))


def check_kernel(kind, dim, p, npts, mode, dirichlet, Ks, Ms, rng):
    """Launch one kernel instance on a seeded input into a NaN-filled
    output (K1: its resident layout, every point and the zero pad checked;
    K2: the flat grid, every point checked, and its routine bit for bit
    against its other routine, z-march and tile routine, on the same
    input); return (tag, max relative
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
        y = k(x, out=torch.full_like(x, float("nan")))
        rose = KernelSeparable.launches == before + 1
        other = k.with_routine("tile" if k.routine == "march" else "march")
        y_other = other.launch(x, out=torch.full_like(x, float("nan")))
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise RuntimeError(f"K2 dim={dim} p={p} npts={npts} {mode}: an "
                               f"output point is not written or not finite")
        if not same_bits(y, y_other):
            raise RuntimeError(
                f"K2 dim={dim} p={p} npts={npts} {mode}: the {k.routine} at "
                f"{k.tile} is not bitwise equal to the {other.routine} at "
                f"{other.tile} ({int((y != y_other).sum())} points differ)")
    else:
        k = ResidentSeparable(npts, p, Ks, Ms,
                              torch.float64 if mode == "f64" else
                              torch.float32, mode=mode if mode == "bf16s"
                              else "f32", dirichlet=dirichlet, device=dev)
        before = ResidentSeparable.launches
        xp = k.pad(u)
        y = k.unpad(resident_out(k, xp))
        rose = ResidentSeparable.launches == before + 1
        x = k.unpad(xp)
    ref = plain_f64(dim, npts, Ks, Ms, x.reshape(-1).to(torch.float64),
                    dirichlet)
    abs_err = float((y.to(torch.float64) - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    tag = (f"{kind} dim={dim} p={p} npts={npts} {mode} "
           f"dirichlet={int(dirichlet)} tile={k.tile}"
           + (f" routine={k.routine} segments={k.nseg} bitwise=both"
              if kind == "K2" else ""))
    if not rose:
        raise RuntimeError(f"{tag}: launch counter did not rise")
    if not rel <= TOL[mode]:
        raise RuntimeError(f"{tag}: max rel err {rel:.3e} > {TOL[mode]}")
    return tag, rel, abs_err


def segment_counts(npts, storage):
    """The segment counts phase 3 holds K3 to at a grid: the chooser's
    (None) and the forced 1-4 that its chunks of x allow."""
    from tpufem_torch.ops.kernel_separable import resident_x, ring_xc

    nchunk = resident_x(npts, storage, 2) // ring_xc(storage, 2)
    return [None] + [s for s in (1, 2, 3, 4) if s <= nchunk]


@contextlib.contextmanager
def forced_segments(segments):
    """Instances made inside cut x into ``segments`` (None: the chooser's
    count): ``kernel_separable.choose_segments`` answers it while they are
    made."""
    from tpufem_torch.ops import kernel_separable

    chooser = kernel_separable.choose_segments
    if segments is not None:
        kernel_separable.choose_segments = lambda *_: segments
    try:
        yield
    finally:
        kernel_separable.choose_segments = chooser


def plain_terms_f64(terms, x):
    """The plain PyTorch terms apply in f64 on the card (x flat or a
    grid; terms f64 numpy)."""
    from tpufem_torch.ops.separable import laplace_apply_separable_terms

    dim, npts = len(terms[0]), terms[0][0].shape[0]
    T = [[torch.tensor(X, dtype=torch.float64, device=x.device) for X in t]
         for t in terms]
    return laplace_apply_separable_terms(x.reshape(-1).to(torch.float64),
                                         dim, npts, T)


def check_terms(terms, p, mode, rng, dirichlet=False, passes=False,
                segments=None):
    """Launch the K4 (3D) or K3 (2D, x cut into ``segments``, None: the
    chooser's) wrapper on a seeded input into a NaN-filled resident layout
    (every point and the zero pad checked; the fused mask with
    ``dirichlet``); return (tag, max relative error, max abs error) against
    the plain f64 terms apply of the same (storage-rounded) input.  Raises
    when out of tolerance, when the launch counter did not rise, or with
    ``passes`` where K4's chooser kept every term's window (one pass over
    x)."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D

    dim, npts = len(terms[0]), terms[0][0].shape[0]
    dt = torch.float64 if mode == "f64" else torch.float32
    kmode = "bf16s" if mode == "bf16s" else "f32"
    u = torch.tensor(rng.standard_normal(npts**dim), device="cuda")
    cls = ResidentTerms if dim == 3 else ResidentTerms2D
    with forced_segments(segments):
        k = cls(npts, p, terms, dt, mode=kmode, dirichlet=dirichlet,
                device="cuda")
    if segments is not None and k.segments != segments:
        raise RuntimeError(f"{cls.__name__} cut x into {k.segments} "
                           f"segments, not the {segments} forced")
    before = cls.launches
    xp = k.pad(u)
    y = resident_out(k, xp)
    rose = cls.launches == before + 1
    x = k.unpad(xp).to(torch.float64)
    A = lambda v: plain_terms_f64(terms, v)
    ref = masked_f64(A, x, npts, dim) if dirichlet else A(x)
    abs_err = float((k.unpad(y).to(torch.float64) - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    tag = (f"{'K4' if dim == 3 else 'K3'} T={len(terms)} p={p} npts={npts} "
           f"{mode} dirichlet={int(dirichlet)} tile={k.tile}"
           + (f" group={k.group}" if dim == 3 else
              f" segments={k.segments}"))
    if not rose:
        raise RuntimeError(f"{tag}: launch counter did not rise")
    if passes and not k.group < len(terms):
        raise RuntimeError(f"{tag}: one pass over x, where passes were asked")
    if not rel <= TOL[mode]:
        raise RuntimeError(f"{tag}: max rel err {rel:.3e} > {TOL[mode]}")
    return tag, rel, abs_err


def ring_ptxas_summary(log: str, key: str = "lab_",
                       kernels: str = r"lab_(?:ring|window)\w*kernel") -> str:
    """Per ring kernel of the lab (names matching ``kernels``, in mangled
    names holding ``key``: lab_ring_kernel, lab_ring_pipe_kernel,
    lab_window_kernel by default; L2's v3: l2_bx_kernel, vxy:
    l2_bxy_kernel, v2: l2_bxyz_kernel, v12: l2_bxyzb_kernel) and
    precision: the registers and the spill stores of its instances, and
    the count of ptxas's wgmma serialisation warnings that name one of
    those kernels (or no kernel),
    from a build's ptxas log (none where the library came from an earlier
    build)."""
    from tpufem_torch.utils.build import ptxas_lines

    if not log.strip():
        return "no ptxas log (cached build)"
    per, warn = {}, 0
    for line in ptxas_lines(log, key):
        m = re.search(rf"({kernels})ILi(\d)ELi(\d)E.*: "
                      r"(\d+) registers, (\d+) bytes", line)
        if m:
            inst = (m.group(1), int(m.group(3)))  # kernel, precision
            regs, spill = int(m.group(4)), int(m.group(5))
            r0, r1, s1, ns, n = per.get(inst, (regs, regs, 0, 0, 0))
            per[inst] = (min(r0, regs), max(r1, regs), max(s1, spill),
                         ns + (spill > 0), n + 1)
        elif "wgmma" in line and (re.search(kernels, line)
                                  or "function '" not in line):
            warn += 1
    xp = {0: "3xTF32", 1: "1xTF32", 2: "bf16x3", 3: "f64", 4: "bf16"}
    return "; ".join(
        f"{k} {xp[x]}: {r0}-{r1} registers, {ns} of {n} spill (max {s1} B)"
        for (k, x), (r0, r1, s1, ns, n) in sorted(per.items())) + \
        f"; {warn} wgmma serialisation warnings"


def cluster_ptxas_summary(log: str) -> str:
    """P2's cluster chain (probe_cluster_kernel<XP, MODE, NT>): per
    arithmetic and column tiles a block, the registers and spill stores of
    its three modes' instances, and the count of ptxas's wgmma
    serialisation warnings, from a build's ptxas log (none where the
    library came from an earlier build)."""
    from tpufem_torch.utils.build import ptxas_lines

    if not log.strip():
        return "no ptxas log (cached build)"
    per, warn = {}, 0
    for line in ptxas_lines(log, "probe_cluster"):
        m = re.search(r"probe_cluster_kernelILi(\d)ELi(\d)ELi(\d)E.*: "
                      r"(\d+) registers, (\d+) bytes", line)
        if m:
            key = (int(m.group(1)), int(m.group(3)))
            per.setdefault(key, []).append((int(m.group(4)),
                                            int(m.group(5))))
        elif "wgmma" in line and "probe_wgmma" not in line:
            warn += 1
    xp = {0: "3xTF32", 1: "1xTF32", 2: "bf16x3", 4: "bf16"}
    return "; ".join(
        f"{xp[x]} NT={nt}: {min(r for r, _ in v)}-{max(r for r, _ in v)} "
        f"registers, max spill {max(sp for _, sp in v)} B"
        for (x, nt), v in sorted(per.items())) + \
        f"; {warn} wgmma serialisation warnings"


def p1_ptxas_summary(log: str) -> str:
    """P1's wgmma tile (probe_wgmma_kernel<XP, NB>): per arithmetic, the
    registers and spill stores of its instance, and the
    count of ptxas's wgmma serialisation warnings that name it, from a
    build's ptxas log (none where the library came from an earlier
    build)."""
    from tpufem_torch.utils.build import ptxas_lines

    if not log.strip():
        return "no ptxas log (cached build)"
    per, warn = {}, 0
    for line in ptxas_lines(log, "probe_wgmma"):
        m = re.search(r"probe_wgmma_kernelILi(\d)ELi(\d+)EE.*: "
                      r"(\d+) registers, (\d+) bytes", line)
        if m:
            per[int(m.group(1)), int(m.group(2))] = (int(m.group(3)),
                                                     int(m.group(4)))
        elif "wgmma" in line and "probe_wgmma" in line:
            warn += 1
    xp = {0: "3xTF32", 1: "1xTF32", 2: "bf16x3", 4: "bf16"}
    return "; ".join(
        f"{xp[x]} NB={nb}: {regs} registers, {spill} B spill"
        for (x, nb), (regs, spill) in sorted(per.items())) + \
        f"; {warn} wgmma serialisation warnings"


def lab_kernel(kern, mode, npts, p, n, h, dtype=None, routine=None):
    """An L1 kernel on the card; ``mode`` is a LAB_TOL key (f64: the exact
    x stage in float64); routine: v17 and v19's ring (the default) or the tile
    routine."""
    from tpufem_torch.lab.resident_lab import V17Kernel
    from tpufem_torch.ops.separable import global_1d_matrices

    K1, M1 = global_1d_matrices(p, n, p + 1)
    if dtype is None:
        dtype = torch.float64 if mode == "f64" else torch.float32
    return V17Kernel(npts, p, K1, M1, h,
                     mode={"f64": "f32", "f32h": "f32"}.get(mode, mode),
                     prec="high" if mode == "f32h" else "highest",
                     kern_name=kern, dtype=dtype, device="cuda",
                     routine=routine)


def check_lab(kern, mode, p, n, h, u, routine=None):
    """Launch one L1 kernel on the f64 input ``u`` ((n p + 1)**3 points on
    the card); return (tag, max relative error, max abs error, emulation)
    against the plain version of its mode in f64 on the same
    (storage-rounded) layout; f32, f32h and bf16 are also held to the
    emulation of their x stage's arithmetic (``V17Kernel.emulate``), and
    emulation is (its own max relative error, the kernel's max distance
    from it over max |y|), else None.  Raises when out of tolerance, when
    a halo or padding point is not zero, when two chained applies are off
    (f64, f32), when the launch counter did not rise or, for the ring
    routine's copy and bands ablations, when they are not the tile routine's
    bit for bit."""
    from tpufem_torch.lab.resident_lab import V17Kernel

    npts = n * p + 1
    k = lab_kernel(kern, mode, npts, p, n, h, routine=routine)
    ref_k = lab_kernel(kern, "f64" if mode in ("f32", "f32h", "bf16")
                       else mode, npts, p, n, h, torch.float64)
    gp = k.pad(u)
    before = V17Kernel.launches[kern]
    y = k.raw(gp)
    rose = V17Kernel.launches[kern] == before + 1
    torch.cuda.synchronize()
    tag = (f"{kern} {mode} p={p} npts={npts} {k.routine} tile={k.tile} "
           f"grid={k.grid} smem={k.smem}")
    halo = torch.ones_like(y, dtype=torch.bool)
    halo[p:p + npts, p:p + npts, :npts] = False
    if not rose:
        raise RuntimeError(f"{tag}: launch counter did not rise")
    if y[halo].any() or not torch.isfinite(y).all():
        raise RuntimeError(f"{tag}: halo/padding not zero or non-finite")
    errs = []
    for x in (gp, y) if mode in ("f64", "f32") else (gp,):
        yk = y if x is gp else k.raw(x)
        ref = ref_k.plain(x.to(torch.float64))
        abs_err = float((yk.to(torch.float64) - ref).abs().max())
        errs.append((abs_err / float(ref.abs().max()), abs_err))
    rel, abs_err = max(errs)
    if not rel <= LAB_TOL[mode]:
        raise RuntimeError(f"{tag}: max rel err {rel:.3e} (chained "
                           f"{errs[-1][0]:.3e}) > {LAB_TOL[mode]}")
    if k.routine == "ring" and mode in ("copy", "bands"):
        earlier = lab_kernel(kern, mode, npts, p, n, h, routine="tile")
        if not same_bits(y, earlier.raw(gp)):
            raise RuntimeError(f"{tag}: not the tile routine's bit for bit")
    emu = None
    if mode in ("f32", "f32h", "bf16"):
        ref = ref_k.plain(gp.to(torch.float64))
        ye = k.emulate(gp).to(torch.float64)
        emu_rel = float((ye - ref).abs().max() / ref.abs().max())
        diff = float((y.to(torch.float64) - ye).abs().max()
                     / ref.abs().max())
        tol = EMU_TOL.get(mode, LAB_TOL[mode])
        if not diff <= tol:
            raise RuntimeError(f"{tag}: off the emulation of its arithmetic "
                               f"by {diff:.3e} > {tol} (emulation's own "
                               f"max rel err {emu_rel:.3e})")
        emu = (emu_rel, diff)
    return tag, rel, errs[0][1], emu


def check_l2(v, mode, p, n, h, u, b=None, tile=None, routine=None):
    """Launch one L2 kernel (tile b, sub-tile ``tile``: None, the chooser's;
    routine: v15's, None its default) on the f64 input ``u`` ((n p + 1)**3
    points on the card) into an output
    filled with NaN; return (tag, max relative error, max abs error, emulation)
    against the plain version of its function in f64 on the same
    (storage-rounded) layout, every output point checked; a split
    precision also against ``LabKernel.emulate`` (emulation: its own max
    relative error and the kernel's max distance from it over max |y|),
    else None.  Raises when out of its class, when an output point is not
    finite or when the launch counter did not rise."""
    from tpufem_torch.lab import kernel_lab, separable_lab
    from tpufem_torch.lab.separable_lab import NO_MMA, LabKernel
    from tpufem_torch.ops.separable import global_1d_matrices

    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    dtype, prec = L2_MODES[mode]
    tol = kernel_lab.L2_OWN_TOL.get(v, separable_lab.TOL[
        separable_lab.XF64 if mode == "f64" else separable_lab.PRECS[prec]])
    k = LabKernel(v, npts, p, K1, M1, h, b=b, prec=prec, dtype=dtype,
                  device="cuda", tile=tile, routine=routine)
    gp = k.pad(u)
    before = LabKernel.launches[v]
    NT = k.nt * k.b
    y = k.raw(gp, out=torch.full((NT, NT, k.X), float("nan"), dtype=dtype,
                                 device="cuda"))
    rose = LabKernel.launches[v] == before + 1
    torch.cuda.synchronize()
    tag = (f"{v} {mode} p={p} npts={npts} b={k.b}"
           + (f" {k.routine}" if k.routine else "")
           + (f" sub-tile={k.tile}" if k.tile else "")
           + (f" rings={k.ring} grid={k.grid}" if k.ring else "")
           + (f" seg={k.seg} grid={k.grid}" if k.seg else "")
           + f" smem={k.smem}")
    if not rose:
        raise RuntimeError(f"{tag}: launch counter did not rise")
    if not torch.isfinite(y).all():
        raise RuntimeError(f"{tag}: an output point is not finite")
    ref = k.plain(gp.to(torch.float64))
    abs_err = float((y.to(torch.float64) - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    if not rel <= tol:
        raise RuntimeError(f"{tag}: max rel err {rel:.3e} > {tol}")
    emu = None
    if mode != "f64" and v not in NO_MMA:
        ye = k.emulate(gp).to(torch.float64)
        emu_rel = float((ye - ref).abs().max() / ref.abs().max())
        diff = float((y.to(torch.float64) - ye).abs().max()
                     / ref.abs().max())
        if not diff <= separable_lab.EMU_TOL[k.xp]:
            raise RuntimeError(f"{tag}: off the emulation of its arithmetic "
                               f"by {diff:.3e} > "
                               f"{separable_lab.EMU_TOL[k.xp]} (emulation's "
                               f"own max rel err {emu_rel:.3e})")
        emu = (emu_rel, diff)
    return tag, rel, abs_err, emu


class PlainResident:
    """A resident kernel's contract with ``raw`` its plain PyTorch
    version: the plain masked apply on the card, launch counts untouched."""

    def __init__(self, rk):
        self._rk = rk

    def __getattr__(self, name):
        return getattr(self._rk, name)

    def raw(self, gp):
        return self._rk.plain(gp)


def true_rel_residual(mf, b, x, terms64=None):
    """||b - A x|| / ||b|| with the constrained operator applied by the
    plain version in f64 on the card: the Laplace factorisation of
    ``mf``, or the f64 ``terms64`` of a terms operator."""
    from tpufem_torch.ops.separable import laplace_apply_separable

    m = mf.interior_mask.to(torch.float64)
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    if terms64 is not None:
        A = lambda v: plain_terms_f64(terms64, v)
    else:
        K = [k.to(torch.float64) for k in mf.Ks]
        M = [mk.to(torch.float64) for mk in mf.Ms]
        A = lambda v: laplace_apply_separable(v, mf.config.dim, mf.npts, K,
                                              M)
    Ax = m * A(m * x64) + (1.0 - m) * x64
    return float((b64 - Ax).norm() / b64.norm())


def f32_rounding(dev, refine=5) -> dict:
    """Phase 8's account of the f32 cube solves (3D Q4 at ``refine``, the
    sine solution): each f32 apply of ``F32_TIERS`` against the f64 structured apply on two fields the
    operator nearly annihilates, the constant (raw A·1, zero in exact
    arithmetic; its largest entry over the diagonal's) and the
    manufactured solution u rounded to f32 (vmult, relative 2-norm
    against the f64 apply of the same input), and the Jacobi-CG of
    ``solve_poisson`` through each apply (iterations, L2); each f32 apply
    also with its own A·1 taken out of each row (exact on the constant),
    and "f64 once" the f64 structured apply rounded once to f32.  Returns
    name -> (A·1, u error, iterations, L2, the iterations at which the
    residual first reaches 1e-3, 1e-4, 1e-5 and 1e-6 of ||b||)."""
    from tpufem_torch.apps.poisson import (
        default_solution,
        dirichlet_setup,
        poisson_operator,
    )
    from tpufem_torch.fem.assemble import assemble_rhs, integrate_difference
    from tpufem_torch.solvers.cg import cg_solve

    op64 = poisson_operator(3, 4, refine, "float64", False, dev,
                            scatter="structured")
    dofs = op64.mf.dofs
    u_exact, f = default_solution(3)
    b = assemble_rhs(dofs, f)
    g = np.zeros(dofs.n_dofs)
    g[dofs.boundary_mask] = u_exact(dofs.dof_coords[dofs.boundary_mask])
    # u rounded to f32 first: the f64 apply takes the same input
    u64 = torch.as_tensor(u_exact(dofs.dof_coords), device=dev).to(
        torch.float32).to(torch.float64)
    ones64 = torch.ones_like(u64)
    Au64 = op64.vmult(u64)
    dmax = float(op64.diagonal().abs().max())
    f32 = lambda v: v.to(torch.float32)
    applies = {name: poisson_operator(3, 4, refine, "float32", pallas, dev,
                                      scatter=scatter)
               for name, (scatter, pallas) in F32_TIERS.items()}
    runs = []
    for name, op in applies.items():
        # the apply with its own rounding of A·1 taken out of each row,
        # A x - (A·1) x: exact on the constant, as K2's difference form is
        a1 = op.vmult_raw(f32(ones64))
        c = op.mf.interior_mask * a1
        runs += [(name, op, op.vmult, op.vmult_raw),
                 (f"{name} - (A·1)x", op,
                  lambda v, op=op, c=c: op.vmult(v) - c * v,
                  lambda v, op=op, a1=a1: op.vmult_raw(v) - a1 * v)]
    runs.append(("f64 once", op64,
                 lambda v: f32(op64.vmult(v.to(torch.float64))),
                 lambda v: f32(op64.vmult_raw(v.to(torch.float64)))))
    out = {}
    for name, op, vmult, raw in runs:
        a1 = float(raw(f32(ones64)).abs().max()) / dmax
        eu = float((vmult(f32(u64)).double() - Au64).norm() / Au64.norm())
        b_con, x0 = dirichlet_setup(op, b, g)
        inv_diag = f32(1.0 / op.diagonal())
        hist = []  # ||r|| of each iteration (the CG preconditions each r)

        def jacobi(r, inv_diag=inv_diag, hist=hist):
            hist.append(float(r.norm()))
            return inv_diag * r

        res = cg_solve(vmult, f32(b_con), M_inv=jacobi, x0=f32(x0),
                       rtol=1e-6)
        l2 = integrate_difference(dofs, res.x.cpu().numpy().astype(
            np.float64), u_exact)
        bn = float(f32(b_con).norm())
        reach = [next((k for k, rn in enumerate(hist) if rn <= t * bn), None)
                 for t in (1e-3, 1e-4, 1e-5, 1e-6)]
        out[name] = (a1, eu, res.iterations, l2, reach)
        say("8 cell loop", f"f32 rounding, 3D Q4 refine {refine} cube, "
            f"{name}: max|A·1| / max diag {a1:.3e}, |A u - A64 u| / |A64 u| "
            f"{eu:.3e}; Jacobi-CG (rtol 1e-6) {res.iterations} iterations "
            f"L2 {l2:.4e}; iterations to ||r|| <= 1e-3, 1e-4, 1e-5, 1e-6 "
            f"of ||b||: {reach}")
    del applies, op64
    return out


def apply_ms_line(dev, phase, name, fn, n, dtype=torch.float32,
                  n_dofs=None) -> None:
    """Print ms per apply of ``fn`` on a seeded vector of ``n`` entries
    (chains of ``N_CHAIN`` applies, ``time_fn``), beside the bound of its
    bytes (x read, y written once) on an H100; GDoF/s counts ``n_dofs``
    (default ``n``)."""
    from tpufem_torch.utils.timer import roofline_ms, time_fn

    x = torch.randn(n, dtype=dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    t = 1e3 * time_fn(fn, x, reps=N_CHAIN)
    item = torch.empty((), dtype=dtype).element_size()
    bound, by = roofline_ms(2 * item * n, {})
    say(phase, f"apply {name}: {t:.4f} ms/apply, "
        f"{(n_dofs or n) / t / 1e6:.3f} GDoF/s, bound (x read, y written) "
        f"{bound:.4f} ms ({by}), {bound / t:.3f} of it")


def cell_loop_phase(dev, refine=5, adaptive=ADAPTIVE,
                    adaptive_size=ADAPTIVE_SIZE, l2_max=1e-6) -> None:
    """Phase 8: the cell-loop tiers (structured, dense, incidence, colored)
    through the port's entry points, the uniform ones at 3D Q4 ``refine``
    (dense against structured one refine below), the gather tiers
    on ``adaptive_mesh(*adaptive)`` of ``adaptive_size`` (cells, DoFs);
    every failure raises; the f32 structured solves' L2 is at most ``l2_max``.
    No kernel of the kernels line runs on these tiers (K2 only as their
    reference)."""
    from tpufem_torch.apps.poisson import (
        adaptive_mesh,
        default_solution,
        dirichlet_setup,
        poisson_operator,
        solve_poisson,
        solve_poisson_amr,
    )
    from tpufem_torch.fem.assemble import assemble_rhs
    from tpufem_torch.fem.constraints import make_hanging_node_constraints
    from tpufem_torch.fem.dof_handler import DoFHandler
    from tpufem_torch.fem.estimator import kelly_estimate
    from tpufem_torch.operators.laplace import LaplaceOperator
    from tpufem_torch.ops.matrix_free import MatrixFree
    from tpufem_torch.utils import native
    from tpufem_torch.utils.config import FemConfig
    from tpufem_torch.utils.timer import synchronize

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def true_rel_residual64(r, scatter="auto"):
        """||b - A x|| / ||b|| of a solve_poisson result's constrained
        system on its mesh (default solution, Q4), A and b in f64 on the
        card: x the CG's iterate, its constrained entries those of x0."""
        dofs = r.dofs
        mesh = dofs.mesh
        op = LaplaceOperator(MatrixFree.build(
            mesh, dofs, FemConfig(mesh.dim, dofs.degree, scatter=scatter),
            dev, constraints=None if mesh.is_uniform
            else make_hanging_node_constraints(dofs)))
        u_exact, f = default_solution(mesh.dim)
        g = np.zeros(dofs.n_dofs)
        bv = dofs.boundary_mask
        g[bv] = u_exact(dofs.dof_coords[bv])
        b_con, x0 = dirichlet_setup(op, assemble_rhs(dofs, f), g)
        m = op.mf.interior_mask
        x = m * torch.as_tensor(r.solution, dtype=torch.float64,
                                device=dev) + (1.0 - m) * x0
        return float((b_con - op.vmult(x)).norm() / b_con.norm())

    # ---- structured: the default tier of solve_poisson at the flagship
    for kind, rtol in (("cube", None), ("shell", SHELL_RTOL)):
        r = solve_poisson(dim=3, degree=4, refine=refine, dtype="float32",
                          mesh_kind=kind, rtol=rtol, device=dev)
        say("8 cell loop", f"solve_poisson 3D Q4 refine {refine} {kind} f32 "
            f"(auto: structured{', general metric' * (kind == 'shell')}): "
            f"dofs {r.n_dofs} iterations {r.iterations} true rel residual "
            f"(f64 operator) {true_rel_residual64(r):.3e} L2 "
            f"{r.l2_error:.4e} setup "
            f"{r.setup_time:.2f} s solve {r.solve_time:.3f} s")
        if not (r.converged and r.l2_error <= l2_max):
            raise RuntimeError(f"structured {kind} f32 solve failed its "
                               f"checks")
    f32_rounding(dev, refine)
    ops = {name: poisson_operator(3, 4, r_, dtype, pallas, dev,
                                  scatter=scatter)
           for name, r_, dtype, pallas, scatter in (
               ("structured64", refine, "float64", False, "structured"),
               ("K2_64", refine, "float64", True, "separable"),
               ("structured64_r4", refine - 1, "float64", False,
                "structured"),
               ("dense64_r4", refine - 1, "float64", False, "dense"))}
    if ops["structured64"].mf.scheme != "structured" or \
            ops["K2_64"].mf.kernel is None:
        raise RuntimeError("phase 8 built the wrong tiers")
    n5, n4 = ops["structured64"].n_dofs, ops["dense64_r4"].n_dofs
    g = torch.Generator(dev).manual_seed(8)
    x5 = torch.randn(n5, dtype=torch.float64, device=dev, generator=g)
    x4 = torch.randn(n4, dtype=torch.float64, device=dev, generator=g)
    e_k2 = rel(ops["structured64"].vmult_raw(x5), ops["K2_64"].vmult_raw(x5))
    e_dense = rel(ops["dense64_r4"].vmult_raw(x4),
                  ops["structured64_r4"].vmult_raw(x4))
    say("8 cell loop", f"f64 applies: structured vs K2 at refine {refine} "
        f"{e_k2:.3e} (tol 1e-10), dense vs structured at refine "
        f"{refine - 1} {e_dense:.3e} (tol 1e-12)")
    if not (e_k2 <= 1e-10 and e_dense <= 1e-12):
        raise RuntimeError("a uniform cell-loop tier disagrees in f64")
    del ops
    for name, scatter, pallas in (("structured", "structured", False),
                                  ("dense", "dense", False),
                                  ("K2", "separable", True)):
        op = poisson_operator(3, 4, refine, "float32", pallas, dev,
                              scatter=scatter)
        apply_ms_line(dev, "8 cell loop", f"{name} 3D Q4 refine {refine} f32",
                      op.vmult_raw, op.n_dofs)
        del op

    # ---- hanging nodes: the JAX bench's adaptive flagship shape
    t0 = time.perf_counter()
    mesh = adaptive_mesh(*adaptive)
    dofs = DoFHandler(mesh, 4)
    t_dofs = time.perf_counter() - t0
    t0 = time.perf_counter()
    ac = make_hanging_node_constraints(dofs)
    t_con = time.perf_counter() - t0
    if (mesh.n_cells, dofs.n_dofs) != adaptive_size:
        raise RuntimeError(f"adaptive mesh: {mesh.n_cells} cells, "
                           f"{dofs.n_dofs} DoFs, not {adaptive_size}")
    setup, aops = {}, {}
    for dtype in ("float64", "float32"):
        for scatter in ("incidence", "colored"):
            t0 = time.perf_counter()
            aops[scatter, dtype] = LaplaceOperator(MatrixFree.build(
                mesh, dofs, FemConfig(3, 4, scatter=scatter, dtype=dtype),
                dev, constraints=ac))
            synchronize(dev)
            setup[scatter, dtype] = time.perf_counter() - t0
    mf = aops["incidence", "float64"].mf
    say("8 cell loop", f"adaptive 3D Q4 (hyper_cube refine {adaptive[1]}, "
        f"{adaptive[2]} steps toward the ball): {mesh.n_cells} cells, "
        f"{dofs.n_dofs} DoFs, {len(ac.lines)} hanging; host setup: mesh + "
        f"DoFs {t_dofs:.2f} s, constraints {t_con:.2f} s, MatrixFree "
        f"incidence {setup['incidence', 'float64']:.2f} s (map "
        f"{tuple(mf.incidence.shape)}), colored "
        f"{setup['colored', 'float64']:.2f} s "
        f"({len(aops['colored', 'float64'].mf.colors)} colors), C^T table "
        f"{tuple(mf.con_T[1].shape)}; native helper active "
        f"{native.available()}")
    g.manual_seed(9)
    xa = torch.randn(dofs.n_dofs, dtype=torch.float64, device=dev,
                     generator=g)
    for dtype in ("float64", "float32"):
        x = xa.to(torch.float64 if dtype == "float64" else torch.float32)
        ys = {}
        for scatter in ("incidence", "colored"):
            op = aops[scatter, dtype]
            ys[scatter] = op.vmult(x)
            if not torch.equal(ys[scatter], op.vmult(x)):
                raise RuntimeError(f"{scatter} {dtype} apply is not bitwise "
                                   f"equal across two calls")
        e = rel(ys["incidence"], ys["colored"])
        tol = 1e-12 if dtype == "float64" else 1e-6
        say("8 cell loop", f"adaptive {dtype} vmult: incidence vs colored "
            f"{e:.3e} (tol {tol}), each bitwise equal across two calls")
        if not e <= tol:
            raise RuntimeError("incidence and colored disagree")
    for scatter in ("incidence", "colored"):
        op = aops[scatter, "float32"]
        apply_ms_line(dev, "8 cell loop", f"{scatter} adaptive f32 (raw)",
                      op.vmult_raw, op.n_dofs)
        apply_ms_line(dev, "8 cell loop",
                      f"{scatter} adaptive f32 (vmult: C^T A C, mask)",
                      op.vmult, op.n_dofs)
    del aops, mf
    runs = [solve_poisson(dim=3, degree=4, mesh=mesh, dtype=dtype,
                          device=dev)
            for dtype in ("float32", "float32", "float64")]
    for r, dtype in zip(runs, ("f32", "f32", "f64")):
        say("8 cell loop", f"solve_poisson(mesh=adaptive) {dtype} (auto: "
            f"incidence): iterations {r.iterations} converged "
            f"{r.converged} true rel residual (f64 operator) "
            f"{true_rel_residual64(r):.3e} L2 "
            f"{r.l2_error:.4e} setup {r.setup_time:.2f} s solve "
            f"{r.solve_time:.3f} s")
    a, b, c = runs
    if not (a.converged and b.converged and c.converged
            and a.iterations == b.iterations
            and np.array_equal(a.solution, b.solution)
            and a.l2_error <= c.l2_error + 1e-6):
        raise RuntimeError("adaptive solves: not converged, not bitwise "
                           "reproducible, or the f32 L2 is off the f64")
    say("8 cell loop", f"adaptive f32 solves: equal iterations, bitwise-"
        f"equal x; L2 f32 - f64 = {a.l2_error - c.l2_error:.3e} (<= 1e-6)")

    # ---- AMR on the card; each cycle's eta against the port's CPU solve
    # and estimate on the same mesh (the CPU's own loop may refine other
    # cells: the Kelly indicators of symmetric cells tie at the marking
    # threshold to the last bits, and a last-bit difference picks
    # another of them)
    rs = solve_poisson_amr(dim=3, degree=2, refine=3, cycles=3, device=dev)
    for cyc, r in enumerate(rs):
        q = solve_poisson(dim=3, degree=2, mesh=r.dofs.mesh, device="cpu")
        eta_cpu = float(np.sqrt((kelly_estimate(
            q.dofs, q.solution.astype(np.float64))**2).sum()))
        say("8 cell loop", f"solve_poisson_amr 3D Q2 refine 3 cycle {cyc}: "
            f"cells {r.n_cells} dofs {r.n_dofs} iterations {r.iterations} "
            f"eta {r.eta:.12e} (the CPU on this mesh: {q.iterations}, "
            f"{eta_cpu:.12e}, apart {abs(r.eta - eta_cpu) / eta_cpu:.3e})")
        if not (r.iterations == q.iterations
                and abs(r.eta - eta_cpu) <= 1e-10 * eta_cpu):
            raise RuntimeError("AMR on the card is off the CPU's solve")


# ---- phase 9: geometric multigrid ------------------------------------
# 3D Q4 and 2D Q4 level sizes of the V-cycle from coarsest refine 1 (npts
# = 4 2^r + 1): K2 on every flat level (phase 6 times its two routines
# there), K1/K4 and K3 at the smallest
GMG_K2_NPTS = {3: (9, 17, 33, 65, 129), 2: (9, 17, 33, 65, 129, 257, 513)}
GMG_RING_NPTS = {3: (9, 17, 33), 2: (17, 33)}
# how far the flat GMG-CG's x may sit from the resident one's (f32: K2 with
# the mask outside against K1's masked tables)
GMG_FLAT_TOL = 1e-4


def gmg_level_checks(rng) -> dict:
    """Phase 9's kernel-vs-plain checks at the V-cycle's level sizes (K2
    f64 and f32 at every flat level; K1 and K4, 3D, and K3, 2D at every
    segment count, in f64, f32 and bf16s with and without the fused mask,
    at the smallest), each as phase 3 holds it; returns the worst max
    relative error per mode.  Their launches are checks, not the path's."""
    from tpufem_torch.ops.separable import (
        cartesian_coef_terms,
        global_1d_matrices,
    )

    worst = {}

    def keep(mode, tag, rel):
        worst[mode] = max(worst.get(mode, 0.0), rel)
        say("9 gmg", f"{tag} max rel err {rel:.3e}")

    for dim, sizes in GMG_K2_NPTS.items():
        for npts in sizes:
            for mode in ("f64", "f32"):
                tag, rel, _ = check_kernel("K2", dim, 4, npts, mode, False,
                                           *flagship_axes(4, npts // 4, dim),
                                           rng)
                keep(mode, tag, rel)
    for npts in GMG_RING_NPTS[3]:
        n = npts // 4
        coef = cartesian_coef_terms(4, 3, 5, n, [0.0] * 3, [1.0] * 3,
                                    COEF_AXES, np.float64)
        for mode in ("f64", "f32", "bf16s"):
            for dirichlet in (False, True):
                tag, rel, _ = check_kernel("K1", 3, 4, npts, mode, dirichlet,
                                           *flagship_axes(4, n, 3), rng)
                keep(mode, tag, rel)
                tag, rel, _ = check_terms(coef, 4, mode, rng, dirichlet)
                keep(mode, tag, rel)
    for npts in GMG_RING_NPTS[2]:
        n = npts // 4
        K, M = global_1d_matrices(4, n, 5)
        lap = [[K * n, M / n], [M / n, K * n]]
        for mode in ("f64", "f32", "bf16s"):
            for dirichlet in (False, True):
                for seg in segment_counts(npts, STORAGE[mode]):
                    tag, rel, _ = check_terms(lap, 4, mode, rng, dirichlet,
                                              segments=seg)
                    keep(mode, tag, rel)
    return worst


def seconds(dev, fn):
    """(seconds, fn()): CUDA events on the card, the host clock on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def gmg_profile(dev, mg, b, wall_s) -> None:
    """Where a resident GMG-CG iteration's device time goes: one solve
    under ``torch.profiler``; the transfers and the coarse solve labelled
    by ``record_function`` around the calls the V-cycle makes (instance
    attributes, removed after); K1 (the fine level), K2 (the coarser
    levels) and the dots by kernel name, the elementwise passes the rest;
    the idle share against ``wall_s``, the same solve unprofiled.  A label
    does not collect the kernels our libraries launch (their launches are
    not children of it), so K2's time by level comes from chains of its
    applies at each level's size (CUDA events) times its launches there."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpufem_torch.solvers.resident import resident_gmg_cg
    from tpufem_torch.utils.timer import time_fn

    def labelled(name, fn):
        def call(*args):
            with record_function(name):
                return fn(*args)
        return call

    labels = ("transfer", "coarse")
    cycle = mg._cycle
    mg.restrict = labelled("transfer", mg.restrict)
    mg.prolongate = labelled("transfer", mg.prolongate)
    mg._cycle = lambda l, x: (labelled("coarse", cycle)(l, x) if l == 0
                              else cycle(l, x))
    try:
        resident_gmg_cg(mg, b, rtol=SOLVE_RTOL)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = resident_gmg_cg(mg, b, rtol=SOLVE_RTOL)
            torch.cuda.synchronize()
    finally:
        for attr in ("restrict", "prolongate", "_cycle"):
            delattr(mg, attr)
    events = prof.events()
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.name not in labels]
    total = lambda key: sum(e.time_range.elapsed_us() for e in on_card
                            if key(e.name)) / 1e3
    split = {name: sum(e.device_time_total for e in events
                       if e.name == name
                       and not str(e.device_type).endswith("CUDA")) / 1e3
             for name in labels}
    busy = total(lambda n: True)
    if not busy > 0:
        raise RuntimeError("the profiler saw no kernel of the GMG solve")
    # the V-cycle runs M_inv once before the first iteration
    n_pre = res.iterations + 1
    parts = [("K1 (fine level)", total(lambda n: "resident_ring" in n)),
             ("K2 (coarser levels)", total(lambda n: "separable_apply" in n)),
             ("transfers", split["transfer"]),
             ("coarse solve", split["coarse"]),
             ("dots (CG)", total(lambda n: "dot" in n
                                 or "reduce" in n.lower()))]
    parts.append(("elementwise (Chebyshev, CG, mask, pad/unpad)",
                  busy - sum(t for _, t in parts)))
    say("9 gmg", f"profile of one resident GMG-CG ({res.iterations} "
        f"iterations, {n_pre} V-cycles): device {busy:.3f} ms "
        f"({busy / n_pre:.4f} ms a V-cycle and its CG step), wall "
        f"unprofiled {1e3 * wall_s:.3f} ms, busy share "
        f"{busy / (1e3 * wall_s):.3f}, idle share "
        f"{1 - busy / (1e3 * wall_s):.3f}")
    for name, t in parts:
        say("9 gmg", f"  {name}: {t / n_pre:.4f} ms a V-cycle "
            f"({100 * t / busy:.1f}%)")
    for lvl in mg.levels[1:-1]:
        x = torch.randn(lvl.mf.n_dofs, dtype=torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(9))
        t = 1e3 * time_fn(lvl.mf.kernel, x, reps=N_CHAIN)
        say("9 gmg", f"  K2 at npts {lvl.npts} ({lvl.mf.n_dofs} DoFs): "
            f"{t:.4f} ms an apply (chain of {N_CHAIN}), 8 a V-cycle: "
            f"{8 * t:.4f} ms")
    top = {}
    for e in on_card:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    for name, t in sorted(top.items(), key=lambda kv: -kv[1])[:10]:
        say("9 gmg", f"    {t:9.3f} ms  {name[:100]}")


def gmg_phase(dev, coef64=None, refine=6, refine2d=8, refine_mg=5,
              l2_max=1e-6, profile=True) -> dict:
    """Phase 9: geometric multigrid through the port's entry points, the
    kernels' launch counts reset at its start and returned at the end of
    its main path (the level-size checks run before it, the Jacobi
    comparisons and the profile after).  The flagship hierarchy (3D Q4
    from refine 1 to ``refine``, f32, use_pallas: K1 fine with the fused
    mask, K2 below) through resident_gmg_cg twice (bitwise) and the flat
    GMG-CG (equal iterations, x within GMG_FLAT_TOL), again with
    pallas_mode="bf16"; BASELINE config 5 (``coefficient_axes``: K4 on
    every level) likewise, its true residual against the f64 terms
    ``coef64`` where given; the 2D hierarchy to ``refine2d`` (K3 fine, K2
    below); solve_poisson_mg at 3D Q4 ``refine_mg`` f32 (L2 <=
    ``l2_max``) and solve_poisson(precond="chebyshev") there.  Runs on the
    CPU at small sizes (the plain versions; profile=False)."""
    from tpufem_torch.apps.poisson import solve_poisson
    from tpufem_torch.apps.poisson_mg import solve_poisson_mg
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
    from tpufem_torch.solvers.cg import cg_solve
    from tpufem_torch.solvers.multigrid import GeometricMultigrid
    from tpufem_torch.solvers.resident import (
        resident_gmg_cg,
        resident_jacobi_cg,
    )

    t_phase = time.perf_counter()
    classes = {"K1": ResidentSeparable, "K2": KernelSeparable,
               "K3": ResidentTerms2D, "K4": ResidentTerms}
    counts = lambda: {k: c.launches for k, c in classes.items()}
    for cls in classes.values():
        cls.launches = 0

    def hierarchy(dim, r, **kw):
        t0 = time.perf_counter()
        mg = GeometricMultigrid(dim, 4, r, coarsest_refine=1,
                                dtype="float32", use_pallas=True, device=dev,
                                **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter() - t0
        rk = mg.fine.mf.resident
        say("9 gmg", f"GeometricMultigrid({dim}, 4, {r}, coarsest_refine=1, "
            f"f32, use_pallas{''.join(f', {k}=...' for k in kw)}): "
            f"{mg.fine.mf.n_dofs} DoFs, levels npts "
            f"{[lvl.npts for lvl in mg.levels]}, setup {t:.2f} s, fine "
            f"{type(rk).__name__} tile {rk.tile} fused mask {rk.dirichlet}, "
            f"theta/delta of the fine level {mg.fine.cheb.theta:.5f} / "
            f"{mg.fine.cheb.delta:.5f}")
        if not rk.dirichlet:
            raise RuntimeError("the fine level's kernel does not fuse the "
                               "mask")
        return mg

    def rhs(mg, seed):
        m = mg.fine.mask.cpu().to(torch.float64).numpy()
        return torch.tensor(m * np.random.default_rng(seed).standard_normal(
            m.size), dtype=torch.float32, device=dev)

    def solves(name, mg, b, terms64=None, pair=True):
        """resident_gmg_cg (twice with ``pair``: bitwise) and the flat
        GMG-CG; returns the last resident solve's seconds, and the first's
        result and K1..K4 launches."""
        runs = []
        for _ in range(2 if pair else 1):
            before = counts()
            t, res = seconds(dev, lambda: resident_gmg_cg(mg, b,
                                                          rtol=SOLVE_RTOL))
            runs.append((t, res, {k: n - before[k]
                                  for k, n in counts().items()}))
        t, res, used = runs[0]
        tf, flat = seconds(dev, lambda: cg_solve(
            mg.fine.op.vmult, b, M_inv=mg.preconditioner(), rtol=SOLVE_RTOL))
        rel_x = float((res.x - flat.x).norm() / flat.x.norm())
        r32 = float((b - mg.fine.op.vmult(res.x)).norm() / b.norm())
        mf = mg.fine.mf
        if mf.terms is not None and terms64 is None:  # f32-rounded terms
            terms64 = [[X.cpu().double().numpy() for X in t]
                       for t in mf.terms]
        r64 = true_rel_residual(mf, b, res.x, terms64)
        it = res.iterations
        # M_inv runs once before the first iteration and once in each
        per_it = ", ".join(f"{k} {n} ({n / (it + 1):.1f} a V-cycle and its "
                           f"CG step)" for k, n in used.items() if n)
        say("9 gmg", f"{name} resident GMG-CG: "
            + " / ".join(f"{r[0]:.4f} s" for r in runs)
            + f", iterations {' / '.join(str(r[1].iterations) for r in runs)}"
            f", converged {res.converged}; flat GMG-CG {tf:.4f} s, "
            f"{flat.iterations} iterations, x rel diff {rel_x:.2e}; true rel "
            f"residual (f32 flat operator) {r32:.3e}, (f64) {r64:.3e}; "
            f"launches {per_it}")
        if not (res.converged and flat.converged
                and res.iterations == flat.iterations
                and rel_x <= GMG_FLAT_TOL):
            raise RuntimeError(f"{name}: the resident GMG-CG did not converge "
                               f"or is off the flat GMG-CG")
        if pair and not (runs[1][1].iterations == it
                         and torch.equal(runs[1][1].x, res.x)):
            raise RuntimeError(f"{name}: two resident GMG-CG solves differ")
        return runs[-1][0], res, used

    # the flagship: K1 fine, K2 on refine 1..5
    mg = hierarchy(3, refine)
    b = rhs(mg, 7)
    t_gmg, res, used = solves(f"3D Q4 refine {refine} f32", mg, b)
    n_pre = res.iterations + 1
    if dev.type == "cuda" and not (used["K1"] >= 9 * n_pre
            and used["K2"] >= 8 * (len(mg.levels) - 2) * n_pre):
        raise RuntimeError(f"the V-cycle did not run its kernels: {used}")
    say("9 gmg", "two flagship resident GMG-CG solves: equal iterations, "
        "bitwise-equal x")
    mg16 = hierarchy(3, refine, pallas_mode="bf16")
    t16, res16, _ = solves(f"3D Q4 refine {refine} pallas_mode=bf16", mg16,
                           b, pair=False)
    say("9 gmg", f"pallas_mode=bf16 (the f32 instance here): x bitwise equal "
        f"to f32's {torch.equal(res16.x, res.x)}")
    del mg16, res16

    # BASELINE config 5 on the fast tier: K4 on every level
    mgc = hierarchy(3, refine, coefficient_axes=COEF_AXES)
    bc = rhs(mgc, 17)
    t_c, res_c, _ = solves(f"3D Q4 refine {refine} coefficient_axes f32",
                           mgc, bc, coef64)
    say("9 gmg", "two coefficient resident GMG-CG solves: equal iterations, "
        "bitwise-equal x")

    # 2D: K3 fine, K2 below
    mg2 = hierarchy(2, refine2d)
    b2 = rhs(mg2, 19)
    t_2d, res_2d, _ = solves(f"2D Q4 refine {refine2d} f32", mg2, b2,
                             pair=False)
    del mg2

    r = solve_poisson_mg(dim=3, degree=4, refine=refine_mg, dtype="float32",
                         device=dev)
    say("9 gmg", f"solve_poisson_mg 3D Q4 refine {refine_mg} f32 (auto: "
        f"structured levels): dofs {r['n_dofs']} iterations "
        f"{r['iterations']} residual {r['residual']:.3e} L2 "
        f"{r['l2_error']:.4e} setup {r['setup_time']:.2f} s solve "
        f"{r['solve_time']:.3f} s")
    rc = solve_poisson(dim=3, degree=4, refine=refine_mg, dtype="float32",
                       precond="chebyshev", device=dev)
    say("9 gmg", f"solve_poisson 3D Q4 refine {refine_mg} f32 "
        f"precond=chebyshev (auto: structured): iterations {rc.iterations} "
        f"converged {rc.converged} L2 {rc.l2_error:.4e} setup "
        f"{rc.setup_time:.2f} s solve {rc.solve_time:.3f} s")
    if not (r["l2_error"] <= l2_max and rc.converged
            and rc.l2_error <= l2_max):
        raise RuntimeError("solve_poisson_mg or the Chebyshev solve_poisson "
                           "failed its checks")
    launches = counts()
    say("9 gmg", f"kernel launches of the GMG path: {launches}")
    if dev.type == "cuda" and not all(launches[k] > 0 for k in classes):
        raise RuntimeError(f"a kernel of the GMG path did not run: "
                           f"{launches}")

    # beside Jacobi on the same operator and b (not counted)
    for name, m_, b_, t_ in (("flagship", mg, b, t_gmg),
                             ("coefficient_axes", mgc, bc, t_c)):
        op = m_.fine.op
        tj, rj = seconds(dev, lambda: resident_jacobi_cg(
            op, b_, diag=1.0 / m_.fine.inv_diag, rtol=SOLVE_RTOL,
            track_best=False))
        say("9 gmg", f"{name}: resident GMG-CG {t_:.4f} s against resident "
            f"Jacobi-CG {tj:.4f} s ({rj.iterations} iterations), "
            f"{tj / t_:.1f}x")
    del mgc
    if profile:
        gmg_profile(dev, mg, b, t_gmg)
    say("9 gmg", f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 10: the adaptive box tier -----------------------------------
# tests/test_boxes.py::test_box_bf16_tier_parity's class: the bf16 box
# apply against the f32 one
BOX_BF16_TOL = 5e-3
# the bf16 raw apply (no constraints, no mask) against the f32 one: about
# five units of bf16 roundoff (2^-9); it read 5.8e-3 on an H100
BOX_BF16_RAW_TOL = 1e-2
# each box solve's true relative residual (f64 box operator) at most this
# multiple of its rtol: the f32 CGs stop on their own recurrence, which
# drifts from the true residual (read at rtol 1e-5 on an H100: Jacobi
# 1.13e-5, GMG 2.7e-6, the bf16 cycle 7.0e-6)
BOX_RES_FACTOR = 10


def box_phase(dev, adaptive=ADAPTIVE, adaptive_size=ADAPTIVE_SIZE,
              l2_max=1e-6, rtol=SOLVE_RTOL, apps_out=None) -> dict:
    """Phase 10: the adaptive box tier (plain PyTorch, no kernel of the
    kernels line) on ``adaptive_mesh(*adaptive)`` of ``adaptive_size``
    (cells, DoFs), Q4: the host setup (box operator, diagonal, GMG
    hierarchy), the box operator against the incidence tier's (f64 1e-12,
    f32 1e-6) and its bf16 recast against f32 (``BOX_BF16_TOL``, the raw
    apply ``BOX_BF16_RAW_TOL``), every apply bitwise equal twice, apply ms
    beside incidence and colored; the box Jacobi-CG, two f32 GMG-CGs
    (equal iterations, bitwise-equal x) and the bf16-cycle GMG-CG at
    ``rtol`` on the JAX bench's b (interior, non-hanging, N(0, 1), seed
    7), each with the true relative residual of the f64 box operator (at
    most ``BOX_RES_FACTOR`` * ``rtol``); then solve_poisson(scatter=
    "boxes", precond="gmg") in f32 and f64 (L2 f32 <= f64 + ``l2_max``).
    Every failure raises.  Returns the three solves' true relative
    residuals by bmop's variant names (jacobi, gmg, gmg_bf16cycle).  When
    ``apps_out`` is given, the two entry-point results go into it by dtype
    name, and under "box" the mesh, DoFs, constraints, the f32 operator,
    its diagonal, its GMG hierarchy and the f32 GMG-CG's iterations: phase
    13 holds its distributed solves to them and builds none of them
    again."""
    from tpufem_torch.apps.poisson import adaptive_mesh, solve_poisson
    from tpufem_torch.fem.constraints import make_hanging_node_constraints
    from tpufem_torch.fem.dof_handler import DoFHandler
    from tpufem_torch.operators.laplace import LaplaceOperator
    from tpufem_torch.ops.boxes import BoxLaplaceOperator
    from tpufem_torch.ops.matrix_free import MatrixFree
    from tpufem_torch.solvers.box_multigrid import BoxMultigrid
    from tpufem_torch.utils.config import FemConfig
    from tpufem_torch.utils.timer import synchronize

    ph = "10 boxes"
    t_phase = time.perf_counter()
    setup = {}
    true_res = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        synchronize(dev)
        setup[name] = time.perf_counter() - t0
        return r

    mesh = adaptive_mesh(*adaptive)
    dofs = DoFHandler(mesh, 4)
    ac = make_hanging_node_constraints(dofs)
    if (mesh.n_cells, dofs.n_dofs) != adaptive_size:
        raise RuntimeError(f"adaptive mesh: {mesh.n_cells} cells, "
                           f"{dofs.n_dofs} DoFs, not {adaptive_size}")
    op64 = timed("box f64", lambda: BoxLaplaceOperator(
        mesh, dofs, constraints=ac, dtype="float64", device=dev))
    op = timed("box f32", lambda: BoxLaplaceOperator(
        mesh, dofs, constraints=ac, dtype="float32", device=dev))
    op16 = op.recast("bfloat16")
    diag = timed("diagonal", op.diagonal)
    mg = timed("hierarchy", lambda: BoxMultigrid(
        mesh, dofs, constraints=ac, dtype="float32", fine_op=op,
        fine_diag=diag, device=dev))
    say(ph, f"adaptive 3D Q4 (hyper_cube refine {adaptive[1]}, "
        f"{adaptive[2]} steps toward the ball): {mesh.n_cells} cells, "
        f"{dofs.n_dofs} DoFs, {len(ac.lines)} hanging; {len(op.boxes)} "
        f"boxes, {op.n_patch} patch entries, {len(op._pair_meta)} pair "
        f"plans, {op.n_rect_rows} hanging rows on them, single compress "
        f"{op._single_compress}; GMG levels {len(mg.levels)}, patch sizes "
        f"{[lvl.op.n_patch for lvl in mg.levels]}; host setup: box "
        f"build f64 {setup['box f64']:.2f} s, f32 {setup['box f32']:.2f} s, "
        f"diagonal {setup['diagonal']:.2f} s, hierarchy "
        f"{setup['hierarchy']:.2f} s")

    # ---- the operator against the incidence tier's, on the same x
    inc = {key: LaplaceOperator(MatrixFree.build(
        mesh, dofs, FemConfig(3, 4, scatter=scatter, dtype=dt), dev,
        constraints=ac)) for key, dt, scatter in (
            ("float64", "float64", "incidence"),
            ("float32", "float32", "incidence"),
            ("colored", "float32", "colored"))}
    x = np.random.default_rng(10).standard_normal(dofs.n_dofs)
    box_y = {}
    for tag, bop, iop, tol in (("f64", op64, inc["float64"], 1e-12),
                               ("f32", op, inc["float32"], 1e-6)):
        xp = bop.to_patch(x)
        xi = torch.as_tensor(x, device=dev).to(bop.dt)
        for name in ("vmult", "vmult_raw"):
            fn = getattr(bop, name)
            y = fn(xp)
            if not torch.equal(y, fn(xp)):
                raise RuntimeError(f"box {tag} {name} is not bitwise equal "
                                   f"across two calls")
            yb = bop.from_patch(y)
            yi = getattr(iop, name)(xi).to("cpu", torch.float64).numpy()
            e = float(np.linalg.norm(yb - yi) / np.linalg.norm(yi))
            box_y[tag, name] = yb
            say(ph, f"box {tag} {name} against incidence {e:.3e} (tol "
                f"{tol}), bitwise equal across two calls")
            if not e <= tol:
                raise RuntimeError(f"box {tag} {name} disagrees with the "
                                   f"incidence tier")
    xp16 = op16.to_patch(x)
    for name in ("vmult", "vmult_raw"):
        fn = getattr(op16, name)
        y = fn(xp16)
        if y.dtype != torch.bfloat16 or not torch.equal(y, fn(xp16)):
            raise RuntimeError(f"box bf16 {name}: not bf16 or not bitwise "
                               f"equal across two calls")
        ref = box_y["f32", name]
        e = float(np.linalg.norm(op16.from_patch(y) - ref)
                  / np.linalg.norm(ref))
        tol = BOX_BF16_TOL if name == "vmult" else BOX_BF16_RAW_TOL
        say(ph, f"box bf16 {name} against f32 {e:.3e} (tol {tol}), "
            f"bitwise equal across two calls")
        if not e <= tol:
            raise RuntimeError(f"box bf16 {name} off its class")

    # ---- apply ms: the box applies beside incidence and colored
    for tag, bop, dt in (("f32", op, torch.float32),
                         ("bf16", op16, torch.bfloat16)):
        for name in ("vmult_raw", "vmult"):
            apply_ms_line(dev, ph, f"box {tag} {name} (patch entries)",
                          getattr(bop, name), op.n_patch, dt, dofs.n_dofs)
    for key, tag in (("float32", "incidence"), ("colored", "colored")):
        for name in ("vmult_raw", "vmult"):
            apply_ms_line(dev, ph, f"{tag} f32 {name}",
                          getattr(inc[key], name), dofs.n_dofs)
    del inc, box_y

    # ---- solves on the JAX bench's b
    b = mg.fine.mnh * op.to_patch(np.random.default_rng(7).standard_normal(
        dofs.n_dofs))
    b64 = b.double()
    bn64 = float(torch.sqrt(op64.dot(b64, b64)))

    def run(name, fn, key):
        synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        synchronize(dev)
        sec = time.perf_counter() - t0
        r = b64 - op64.vmult(res.x.double())
        tr = true_res[key] = float(torch.sqrt(op64.dot(r, r))) / bn64
        say(ph, f"{name}: iterations {res.iterations} converged "
            f"{res.converged} {sec:.3f} s true rel residual (f64 box "
            f"operator, owner-weighted) {tr:.3e} (<= "
            f"{BOX_RES_FACTOR * rtol:.0e})")
        if not (res.converged and tr <= BOX_RES_FACTOR * rtol):
            raise RuntimeError(f"{name} did not converge, or its true "
                               f"residual is off its rtol")
        return res

    jac = run("box Jacobi-CG f32", lambda: op.cg_solve(b, diag, rtol=rtol),
              "jacobi")
    g1 = run("box GMG-CG f32", lambda: mg.cg_solve(b, rtol=rtol), "gmg")
    g2 = run("box GMG-CG f32 again", lambda: mg.cg_solve(b, rtol=rtol),
             "gmg")
    if not (g1.iterations == g2.iterations and torch.equal(g1.x, g2.x)):
        raise RuntimeError("box GMG-CG is not bitwise reproducible")
    if not g1.iterations < jac.iterations:
        raise RuntimeError("box GMG-CG took no fewer iterations than "
                           "Jacobi")
    mg16 = timed("bf16 recast", lambda: mg.recast("bfloat16", solve_op=op))
    run("box GMG-CG bf16 cycle (f32 CG)", lambda: mg16.cg_solve(b, rtol=rtol),
        "gmg_bf16cycle")
    if apps_out is not None:
        apps_out["box"] = dict(mesh=mesh, dofs=dofs, ac=ac, op=op, diag=diag,
                               mg=mg, gmg_iterations=g1.iterations)
    del mg, mg16, op16, op, op64, diag

    # ---- the entry point
    apps = [solve_poisson(dim=3, degree=4, mesh=mesh, scatter="boxes",
                          precond="gmg", dtype=dt, device=dev)
            for dt in ("float32", "float64")]
    for r, dt in zip(apps, ("f32", "f64")):
        say(ph, f"solve_poisson(mesh=adaptive, scatter='boxes', "
            f"precond='gmg') {dt}: iterations {r.iterations} converged "
            f"{r.converged} L2 {r.l2_error:.4e} setup {r.setup_time:.2f} s "
            f"solve {r.solve_time:.3f} s")
    a, c = apps
    if not (a.converged and c.converged
            and a.l2_error <= c.l2_error + l2_max):
        raise RuntimeError("box app solves: not converged, or the f32 L2 "
                           "is off the f64")
    say(ph, f"L2 f32 - f64 = {a.l2_error - c.l2_error:.3e} (<= {l2_max}); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if apps_out is not None:
        apps_out.update(float32=a, float64=c)
    return true_res


# ---- phase 11: the operator families beyond Laplace ---------------------
# the JAX bench's elasticity constants (bench.py:626)
EL_MU, EL_LAM = 0.8, 1.7
# the summed fast-tier elasticity apply against its plain version: a
# kernel's class (TOL) in f64 and f32; in bf16s each component sums three
# bf16-stored block outputs, each within 2^-9 of its own size, so three
# times the one-kernel class
EL_TOL = {"f64": TOL["f64"], "f32": TOL["f32"], "bf16s": 3 * TOL["bf16s"]}
# heat: the tensor-product tier against the generic one in f64
# (tests/test_tensor_product.py:96), and the f32 L2 against the f64 one
HEAT_TIER_TOL = 1e-9
HEAT_L2_GAP = 1e-6
# the fast elasticity tier against the generic vector tier in f64
EL_TIER_TOL = 1e-10
# an elasticity solve's f32 L2 at most this above its f64 one (readings on
# the H100: fast 3D Q4 refine 4 2.23e-7, GMG 3D Q2 refine 4 3.2e-9)
EL_L2_GAP = 1e-6
# an elasticity solve's true relative residual (f64 operator) at most this
# many times its rtol.  f64 (rtol 1e-10) reads 0.98 (fast) and 0.11 (GMG)
# times rtol; f32 (rtol 1e-6) stops on its recurrence residual while the
# true one sits on the f32 floor: fast Jacobi-CG (248 iterations) 318, GMG
# 22.9 times rtol (the H100 readings)
EL_RES_FACTOR = {("fast", "float32"): 400, ("gmg", "float32"): 30,
                 ("fast", "float64"): 2, ("gmg", "float64"): 2}


def operator_term_sets(p, n):
    """(name, scalar, terms) of the operator families in 3D at degree p
    on n cells an axis (h = 1/n): heat's Helmholtz M + dt K at dt 1e-4 and
    1 (4 terms), the mass (1 term), and the nine elasticity blocks
    (EL_MU, EL_LAM: 3 terms on the diagonal, 2 off it, with G and G^T)."""
    from tpufem_torch.operators.tensor_product import (
        elasticity_separable_blocks,
        helmholtz_separable_terms,
        mass_separable_terms,
    )

    h = np.full(3, 1.0 / n)
    sets = [(f"helmholtz dt={dt:g}", True,
             helmholtz_separable_terms(p, 3, p + 1, n, h, 1.0, dt))
            for dt in (1e-4, 1.0)]
    sets.append(("mass", True, mass_separable_terms(p, 3, p + 1, n, h)))
    blocks = elasticity_separable_blocks(p, 3, p + 1, n, h, EL_MU, EL_LAM)
    sets += [(f"elasticity block ({c}, {a})", False, blocks[c][a])
             for c in range(3) for a in range(3)]
    return sets


def operator_term_checks(rng) -> tuple[dict, float]:
    """Phase 11's kernel checks, as phase 3 holds K4 (``check_terms``):
    every set of ``operator_term_sets`` at 3D npts 9, 17 and 33 for p = 2
    and 4, in f64, f32 and bf16s, the scalar sets with and without the
    fused mask, the blocks unmasked; then at the main path's shapes:
    heat's Helmholtz (dt 1e-4) and mass at npts 257 (3D Q4 refine 6) in
    f64, f32 and bf16s with and without the mask, and the nine blocks at
    npts 129 (refine 5) in f32 and bf16s.  Returns the worst max relative
    error by mode and the largest f32 max abs error at the main path's
    shapes."""
    worst, abs_f32 = {}, 0.0

    def run(name, terms, p, modes, masks):
        nonlocal abs_f32
        rels, npts = [], terms[0][0].shape[0]
        for mode in modes:
            for dirichlet in masks:
                tag, rel, aerr = check_terms(terms, p, mode, rng, dirichlet)
                worst[mode] = max(worst.get(mode, 0.0), rel)
                if mode == "f32" and npts > 33:
                    abs_f32 = max(abs_f32, aerr)
                rels.append(f"{mode}{' masked' * dirichlet} {rel:.3e}")
        group = int(tag.split("group=")[1])
        say("11 operators", f"K4 {name} T={len(terms)} p={p} npts={npts} "
            f"tile={tag.split('tile=')[1].split(' group')[0]} group {group}"
            f" ({'passes over x' if group < len(terms) else 'one pass'}): "
            f"max rel err " + ", ".join(rels))

    for npts in (9, 17, 33):
        for p in (2, 4):
            for name, scalar, terms in operator_term_sets(p, (npts - 1) // p):
                run(name, terms, p, TOL, (False, True) if scalar
                    else (False,))
    for name, scalar, terms in operator_term_sets(4, 64)[0:3:2]:
        run(name, terms, 4, TOL, (False, True))
    for name, _, terms in operator_term_sets(4, 32)[3:]:
        run(name, terms, 4, ("f32", "bf16s"), (False,))
    return worst, abs_f32


def elasticity_rhs(dofs, mask, mu, lam, dtype, dev):
    """The elasticity app's right-hand side (C, n) on ``dev``."""
    from tpufem_torch.apps.elasticity import manufactured
    from tpufem_torch.fem.assemble import assemble_rhs

    _, f_component = manufactured(3, mu, lam)
    m = mask.cpu().to(torch.float64).numpy()
    return torch.tensor(np.stack([
        m * assemble_rhs(dofs, lambda p_, c=c: f_component(c, p_))
        for c in range(3)]), dtype=dtype, device=dev)


def operators_phase(dev, heat_refine=6, heat_cross_refine=4, nl_refine=5,
                    ms_refine=3, el_refine=5, el_cross_refine=3,
                    el_fast_refine=4, el_gmg_refine=4, heat_steps=5,
                    nl_l2_max=1e-5) -> dict:
    """Phase 11: the operator families through the port's entry points,
    K4's launches of its main path counted and returned: the two f32 heat
    runs at ``heat_refine``, the f32 elasticity apply at ``el_refine`` and
    the f32 fast elasticity solve.  The f64 reruns, the bf16s apply and the
    cross-checks at other sizes launch K4 too; their count is printed
    apart.

    Heat (the JAX bench's 3d_heat_implicit_step): run_heat(3D Q4
    ``heat_refine``, dt 1e-4, ``heat_steps`` steps, rtol 1e-6, resident)
    in f32 twice (bitwise-equal u) and in f64 (f32 L2 within HEAT_L2_GAP
    of it), K4's launches a step (iterations + 2: the mass apply and the
    CG's initial residual); at ``heat_cross_refine`` in f64 the tensor-
    product tier against the generic one (HEAT_TIER_TOL).  Nonlinear (the
    JAX bench's 3d_nonlinear_newton_solve): run_nonlinear(3D Q2
    ``nl_refine``, quasilinear, CG, Jacobi, f32, rtol 1e-6) twice (equal
    counts, bitwise-equal x), L2 <= ``nl_l2_max``, and the minimal surface
    with GMRES at 3D Q2 ``ms_refine`` in f64.  Elasticity (the JAX bench's
    3d_elasticity_apply): SeparableElasticityOperator(use_pallas) at 3D Q4
    ``el_refine`` in f32 and bf16s, its vmult_raw (9 K4 launches) against
    the plain f64 apply (EL_TOL), ms an apply beside one block's K4 and
    the generic vector tier at the same size (its f32 apply within
    TOL["f32"] of the plain f64 fast tier), and in f64 at
    ``el_cross_refine`` against the generic vector operator (EL_TIER_TOL);
    run_elasticity 3D Q4 ``el_fast_refine`` fast through K4 and 3D Q2
    ``el_gmg_refine`` GMG, f32 at rtol 1e-6 and f64 at 1e-10: iterations,
    true relative residual (f64 operator, at most EL_RES_FACTOR * rtol),
    L2 (f32 at most EL_L2_GAP above f64).  Runs on the CPU at small sizes (the plain versions, no
    launches)."""
    from tpufem_torch.apps.elasticity import run_elasticity
    from tpufem_torch.apps.heat import run_heat
    from tpufem_torch.apps.nonlinear import run_nonlinear
    from tpufem_torch.fem.dof_handler import DoFHandler
    from tpufem_torch.fem.mesh import Mesh
    from tpufem_torch.operators.tensor_product import (
        SeparableElasticityOperator,
    )
    from tpufem_torch.operators.vector import elasticity_operator
    from tpufem_torch.ops.kernel_terms import ResidentTerms
    from tpufem_torch.ops.matrix_free import MatrixFree
    from tpufem_torch.utils.config import FemConfig
    from tpufem_torch.utils.timer import synchronize, time_fn

    ph = "11 operators"
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    path = 0  # K4 launches of the main path
    aside = 0  # K4 launches of the reruns and cross-checks, not counted

    # ---- heat on the tensor-product tier
    heat = {}
    for run, dtype in (("f32", "float32"), ("f32 again", "float32"),
                       ("f64", "float64")):
        before = ResidentTerms.launches
        t0 = time.perf_counter()
        r = run_heat(dim=3, degree=4, refine=heat_refine, dt=1e-4,
                     steps=heat_steps, dtype=dtype, resident=True, rtol=1e-6,
                     device=dev)
        used = ResidentTerms.launches - before
        if dtype == "float32":
            path += used
        else:
            aside += used
        heat[run] = r
        its = r["iterations"]
        say(ph, f"run_heat 3D Q4 refine {heat_refine} dt 1e-4 {heat_steps} "
            f"steps {dtype} resident: {r['n_dofs']} DoFs, host setup "
            f"{r['setup_s']:.2f} s, {1e3 * r['solve_s'] / heat_steps:.2f} ms "
            f"a step ({r['solve_s']:.3f} s), CG iterations a step {its}, K4 "
            f"launches {used} ({used / heat_steps:.1f} a step), L2 "
            f"{r['l2_error']:.9e}; the call {time.perf_counter() - t0:.1f} s")
        if on_card and used != sum(its) + 2 * heat_steps:
            raise RuntimeError(f"heat {run}: {used} K4 launches, not the CG "
                               f"iterations + 2 a step")
    same = np.array_equal(heat["f32"]["u"], heat["f32 again"]["u"])
    gap = abs(heat["f32"]["l2_error"] - heat["f64"]["l2_error"])
    say(ph, f"heat: two f32 runs bitwise equal {same}; f32 L2 - f64 L2 "
        f"{gap:.3e} (limit {HEAT_L2_GAP})")
    if not (same and gap <= HEAT_L2_GAP):
        raise RuntimeError("the heat runs failed their checks")
    del heat
    if on_card:  # heat's two K4 instances alone, as its runs launch them
        npts = (1 << heat_refine) * 4 + 1
        sets = operator_term_sets(4, 1 << heat_refine)
        u = torch.randn(npts**3, device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        line = []
        for (name, _, terms), masked in ((sets[0], True), (sets[2], False)):
            k = ResidentTerms(npts, 4, terms, torch.float32,
                              dirichlet=masked, device=dev)
            line.append(f"{name} (T={len(terms)}, group {k.group}, tile "
                        f"{k.tile}{', fused mask' * masked}) "
                        f"{1e3 * time_fn(k.raw, k.pad(u), reps=N_CHAIN):.4f}"
                        f" ms")
        say(ph, f"heat's K4 at npts {npts} f32, chains of {N_CHAIN} (not "
            f"counted): " + "; ".join(line))
    cross = {}
    for resident in (True, False):
        before = ResidentTerms.launches
        cross[resident] = run_heat(dim=3, degree=4, refine=heat_cross_refine,
                                   dt=1e-4, steps=heat_steps,
                                   dtype="float64", resident=resident,
                                   device=dev)
        aside += ResidentTerms.launches - before
    rel_u = float(np.linalg.norm(cross[True]["u"] - cross[False]["u"])
                  / np.linalg.norm(cross[False]["u"]))
    say(ph, f"run_heat 3D Q4 refine {heat_cross_refine} f64: tensor-product "
        f"tier (K4) {cross[True]['solve_s']:.3f} s, iterations "
        f"{cross[True]['iterations']}; generic tier (incidence) "
        f"{cross[False]['solve_s']:.3f} s, iterations "
        f"{cross[False]['iterations']}; u rel diff {rel_u:.3e} (limit "
        f"{HEAT_TIER_TOL})")
    if not rel_u <= HEAT_TIER_TOL:
        raise RuntimeError("the heat tiers disagree")

    parts = {"heat": time.perf_counter() - t_phase}
    # ---- Newton on the functor tier (no kernel)
    kw = dict(dim=3, degree=2, refine=nl_refine, problem="quasilinear",
              linear="cg", rtol=1e-6, dtype="float32", precond="jacobi",
              device=dev)
    (o1, x1), (o2, x2) = run_nonlinear(**kw), run_nonlinear(**kw)
    for o in (o1, o2):
        say(ph, f"run_nonlinear 3D Q2 refine {nl_refine} quasilinear CG "
            f"Jacobi f32: {o['n_dofs']} DoFs, Newton {o['newton_iterations']}"
            f", linear {o['linear_iterations']}, residual "
            f"{o['residual']:.3e}, converged {o['converged']}, L2 "
            f"{o['l2_error']:.4e}, setup {o['setup_s']:.2f} s, solve "
            f"{o['solve_s']:.3f} s")
    # converged is printed, not required: in f32 ||F|| levels off near
    # 1e-6 of ||F_0|| and the line search stops the iteration there, in the
    # JAX package too (its CPU run at 3D Q2 refine 4: 18 Newton steps,
    # converged False, L2 at the f64 solve's)
    if not (math.isfinite(o1["residual"]) and o1["l2_error"] <= nl_l2_max
            and (o1["newton_iterations"], o1["linear_iterations"])
            == (o2["newton_iterations"], o2["linear_iterations"])
            and np.array_equal(x1, x2)):
        raise RuntimeError("the Newton solves failed their checks")
    o, _ = run_nonlinear(dim=3, degree=2, refine=ms_refine,
                         problem="minimal-surface", linear="gmres",
                         device=dev)
    say(ph, f"run_nonlinear 3D Q2 refine {ms_refine} minimal-surface GMRES "
        f"f64: {o['n_dofs']} DoFs, Newton {o['newton_iterations']}, linear "
        f"{o['linear_iterations']}, residual {o['residual']:.3e}, converged "
        f"{o['converged']}, solve {o['solve_s']:.3f} s")
    if not o["converged"]:
        raise RuntimeError("the minimal surface did not converge")

    parts["newton"] = time.perf_counter() - t_phase - sum(parts.values())
    # ---- elasticity: the fast tier's apply at full width
    mesh = Mesh.hyper_cube(3, el_refine)
    dofs = DoFHandler(mesh, 4)
    n = dofs.n_dofs
    mf = {dt: MatrixFree.build(mesh, dofs, FemConfig(
        3, 4, scatter="separable", dtype=dt), dev)
        for dt in ("float32", "float64")}
    plain64 = SeparableElasticityOperator(mf["float64"], EL_MU, EL_LAM)
    x = torch.randn(3, n, dtype=torch.float32, device=dev,
                    generator=torch.Generator(dev).manual_seed(11))
    for mode in ("f32", "bf16s"):
        t0 = time.perf_counter()
        op = SeparableElasticityOperator(mf["float32"], EL_MU, EL_LAM,
                                         use_pallas=True, mode=mode)
        synchronize(dev)
        t_build = time.perf_counter() - t0
        before = ResidentTerms.launches
        y = op.vmult_raw(x)
        synchronize(dev)
        used = ResidentTerms.launches - before
        if mode == "f32":
            path += used
        else:
            aside += used
        sdt = op.kernels[0][0].dt
        ref = plain64.vmult_raw(x.to(sdt).to(torch.float64))
        rel = float((y.double() - ref).abs().max() / ref.abs().max())
        ms = 1e3 * time_fn(op.vmult_raw, x, reps=N_CHAIN) if on_card else 0.0
        k_ms = {}
        if on_card:
            for c, a in ((0, 0), (0, 1)):
                k = op.kernels[c][a]
                k_ms[c, a] = 1e3 * time_fn(k.raw, k.pad(x[a]), reps=N_CHAIN)
        say(ph, f"SeparableElasticityOperator 3D Q4 refine {el_refine} "
            f"use_pallas {mode}: {n} x 3 DoFs, build {t_build:.2f} s, "
            f"vmult_raw {used} K4 launches, max rel err vs the plain f64 "
            f"apply {rel:.3e} (tol {EL_TOL[mode]}), {ms:.4f} ms an apply; "
            f"one block's K4 alone: diagonal (T=3) "
            f"{k_ms.get((0, 0), 0.0):.4f} ms, off-diagonal (T=2) "
            f"{k_ms.get((0, 1), 0.0):.4f} ms, tile "
            f"{op.kernels[0][0].tile}")
        if not (rel <= EL_TOL[mode] and torch.isfinite(y).all()
                and (used == 9 or not on_card)):
            raise RuntimeError(f"the elasticity apply ({mode}) failed its "
                               f"checks")
        del op
    mfi = MatrixFree.build(mesh, dofs, FemConfig(3, 4, scatter="incidence",
                                                 dtype="float32"), dev)
    gen = elasticity_operator(mfi, EL_MU, EL_LAM)
    rel = float((gen.vmult_raw(x).double() - plain64.vmult_raw(x.double()))
                .abs().max() / plain64.vmult_raw(x.double()).abs().max())
    g_ms = 1e3 * time_fn(gen.vmult_raw, x, reps=3, warmup=1) if on_card \
        else 0.0
    say(ph, f"generic vector tier (elasticity_operator, incidence) 3D Q4 "
        f"refine {el_refine} f32: {g_ms:.3f} ms an apply, max rel err vs "
        f"the plain f64 fast tier {rel:.3e} (tol {TOL['f32']})")
    if not rel <= TOL["f32"]:
        raise RuntimeError("the generic vector tier is off the fast one")
    del gen, mfi, plain64, mf
    mesh3 = Mesh.hyper_cube(3, el_cross_refine)
    dofs3 = DoFHandler(mesh3, 4)
    fast = SeparableElasticityOperator(MatrixFree.build(
        mesh3, dofs3, FemConfig(3, 4, scatter="separable"), dev), EL_MU,
        EL_LAM, use_pallas=True)
    gen = elasticity_operator(MatrixFree.build(
        mesh3, dofs3, FemConfig(3, 4, scatter="incidence"), dev), EL_MU,
        EL_LAM)
    x3 = torch.randn(3, dofs3.n_dofs, dtype=torch.float64, device=dev,
                     generator=torch.Generator(dev).manual_seed(13))
    rel_raw = float((fast.vmult_raw(x3) - gen.vmult_raw(x3)).norm()
                    / gen.vmult_raw(x3).norm())
    rel_con = float((fast.vmult(x3) - gen.vmult(x3)).norm()
                    / gen.vmult(x3).norm())
    say(ph, f"3D Q4 refine {el_cross_refine} f64: the fast tier (9 K4) "
        f"against elasticity_operator: vmult_raw {rel_raw:.3e}, vmult "
        f"{rel_con:.3e} (limit {EL_TIER_TOL})")
    if not max(rel_raw, rel_con) <= EL_TIER_TOL:
        raise RuntimeError("the fast elasticity tier is off the generic one")
    del fast, gen

    parts["elasticity apply"] = (time.perf_counter() - t_phase
                                 - sum(parts.values()))
    # ---- the elasticity solves, f32 beside f64
    for name, kw in (("fast", dict(degree=4, refine=el_fast_refine,
                                   fast=True, use_pallas=on_card)),
                     ("gmg", dict(degree=2, refine=el_gmg_refine,
                                  precond="gmg"))):
        m_ = Mesh.hyper_cube(3, kw["refine"])
        d_ = DoFHandler(m_, kw["degree"])
        mf64 = MatrixFree.build(m_, d_, FemConfig(
            3, kw["degree"], scatter="separable" if kw.get("fast")
            else "incidence"), dev)
        op64 = (SeparableElasticityOperator(mf64) if kw.get("fast")
                else elasticity_operator(mf64))
        b = elasticity_rhs(d_, mf64.interior_mask, 1.0, 1.0, torch.float64,
                           dev)
        l2 = {}
        for dtype, rtol in (("float32", 1e-6), ("float64", 1e-10)):
            before = ResidentTerms.launches
            o, xs = run_elasticity(dim=3, dtype=dtype, rtol=rtol, device=dev,
                                   **kw)
            used = ResidentTerms.launches - before
            if dtype == "float32":
                path += used
            else:
                aside += used
            xt = torch.tensor(xs, dtype=torch.float64, device=dev)
            true = float((b - op64.vmult(xt)).norm() / b.norm())
            limit = EL_RES_FACTOR[name, dtype] * rtol
            l2[dtype] = o["l2_error"]
            say(ph, f"run_elasticity 3D Q{kw['degree']} refine "
                f"{kw['refine']} {name} {dtype} rtol {rtol:g}: {o['n_dofs']}"
                f" x 3 DoFs, iterations {o['iterations']}, converged "
                f"{o['converged']}, true rel residual {true:.3e} (limit "
                f"{limit:.1e}), L2 {o['l2_error']:.6e}, setup "
                f"{o['setup_s']:.2f} s, solve {o['solve_s']:.3f} s, K4 "
                f"launches {used}")
            if not (o["converged"] and true <= limit
                    and (used > 0) == (on_card and bool(kw.get("fast")))):
                raise RuntimeError(f"run_elasticity {name} {dtype} failed "
                                   f"its checks")
        if not l2["float32"] <= l2["float64"] + EL_L2_GAP:
            raise RuntimeError(f"run_elasticity {name}: f32 L2 more than "
                               f"{EL_L2_GAP} above f64's")
    parts["elasticity solves"] = (time.perf_counter() - t_phase
                                  - sum(parts.values()))
    say(ph, f"K4 launches of the phase's main path {path} (f32 heat at "
        f"refine {heat_refine} twice, the f32 elasticity apply at refine "
        f"{el_refine}, the f32 fast solve); not counted {aside} (the f64 "
        f"reruns, the bf16s apply, the cross-checks); phase "
        f"{time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    if on_card and path == 0:
        raise RuntimeError("K4 did not run on the phase's main path")
    return {"K4": path}


# ---- phase 12: the bench apps ------------------------------------------
# the ELL SpMV against the structured f32 apply of the same operator on one
# seeded vector (both f32 applies of one assembled operator)
SPMV_MF_TOL = 2e-5
# bmspmv's CSR cross-check tolerance in f32 (tpufem/apps/bmspmv.py:55)
CSR_TOL = 2e-5
# the JAX bench's flagship sizes (bench.py:395-402): bench_resident (p,
# refine) in 3D (K1) and 2D (K3), bench_varcoef (p, refine, attr_refine),
# bench_curved (p, refine), the adaptive build (p, refine, steps); the
# assembled baseline's degrees and refinements
BENCH_SIZES = dict(resident=(4, 6), resident2d=(4, 10), varcoef=(4, 6, 5),
                   curved=(4, 5), adaptive=(4, 4, 2),
                   spmv_degrees=(1, 2, 3, 4), spmv_refine=4,
                   bmspmv_degrees=(1, 2, 3, 4), bmspmv_refine=3)


@contextlib.contextmanager
def bench_config_spy(bmop):
    """Inside, ``bmop.bench_config``'s operators are kept as it builds
    them: ``spy["op"]`` its last ``LaplaceOperator``, ``spy["ell"]`` its
    last ``EllMatrix`` and ``spy["csr"]`` each assembled matrix's (rows,
    nonzeros, row width), so that phase 12 holds the largest pair to each
    other without assembling it a second time."""
    spy = {"csr": []}
    cls = bmop.EllMatrix
    laplace, from_csr = bmop.LaplaceOperator, cls.__dict__["from_csr"]

    def keep_op(mf):
        spy["op"] = laplace(mf)
        return spy["op"]

    def keep_ell(A, *args, **kw):
        spy["ell"] = from_csr.__get__(None, cls)(A, *args, **kw)
        spy["csr"].append((A.shape[0], int(A.nnz),
                           spy["ell"].indices.shape[1]))
        return spy["ell"]

    bmop.LaplaceOperator = keep_op
    cls.from_csr = keep_ell
    try:
        yield spy
    finally:
        bmop.LaplaceOperator = laplace
        cls.from_csr = from_csr


def bench_phase(dev, sizes=None, reps=N_CHAIN) -> dict:
    """Phase 12: the port's bench apps through their entry points at the
    JAX bench's flagship sizes (``BENCH_SIZES``; f32, ``reps`` the JAX
    bench's chain, bench.py:70): ``bench_resident`` through K1 (f32,
    bf16s) and K3 (bf16s), ``bench_varcoef`` through K4 (f32, bf16s; the
    structured attribution tier at its own refinement), ``bench_curved``
    (the separable tier and K4 in f32, bf16, bf16s), the adaptive flagship
    (``build_adaptive_op`` once, ``bench_adaptive`` with the incidence
    tier, ``bench_adaptive_solve`` with the bf16 cycle), then
    ``bmop.main --spmv`` (the
    structured tier beside the ELL SpMV; the largest pair held to each
    other on a seeded vector within ``SPMV_MF_TOL``, each side beside its
    bound) and ``bmspmv.main`` (its CSR cross-check within ``CSR_TOL``).
    Raises on a kernel tier missing or in ``tier_errors``, a rate that is
    not finite and positive, a box solve that did not converge, a GMG-CG
    no faster in iterations than the Jacobi-CG, or a bf16 tier off
    ``BOX_BF16_TOL``.  Returns the phase's K1, K3 and K4 launches (timing
    repetitions of bmop, apart from the kernels line's main-path counts)
    under "launches" and each box solve's true residual under
    "true_rel_res", which ``main`` prints beside phase 10's."""
    import io

    from tpufem_torch.apps import bmop, bmspmv
    from tpufem_torch.ops.kernel_separable import ResidentSeparable
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
    from tpufem_torch.utils.timer import roofline_ms, synchronize

    sz = dict(BENCH_SIZES, **(sizes or {}))
    ph = "12 bench"
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]
    counted = {"K1": ResidentSeparable, "K3": ResidentTerms2D,
               "K4": ResidentTerms}
    for cls in counted.values():
        cls.launches = 0
    parts = {}

    def lap(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    def show(rec):
        say(ph, json.dumps(rec))
        rates = [v for k, v in rec.items()
                 if k.endswith(("_per_s", "_s", "s_per_apply"))
                 or "speedup" in k]
        # bench_adaptive rounds its tiers' rates to 4 decimals (the
        # reference's record), so a tiny CPU run reads 0 there
        tiers = rec.get("tiers_gdofs", {}).values()
        if not (rates and all(math.isfinite(v) and v > 0 for v in rates)
                and all(math.isfinite(v) and v >= 0 for v in tiers)):
            raise RuntimeError(f"{rec['bench']}: a rate or time is not "
                               f"finite and positive")
        return rec

    def kernel_tiers(rec, modes):
        want = {f"resident-terms-{m}+pallas" for m in modes}
        missing = sorted(want - set(rec["tiers_gdofs"]))
        if missing or "tier_errors" in rec:
            raise RuntimeError(f"{rec['bench']}: kernel tiers missing "
                               f"{missing}, tier_errors "
                               f"{rec.get('tier_errors')}")

    # ---- K1 and K3: the resident kernels on their own layout
    t0 = time.perf_counter()
    p, r = sz["resident"]
    for mode in ("f32", "bf16s"):
        show(bmop.bench_resident(p, r, "float32", reps, mode=mode,
                                 device=dev))
    p, r = sz["resident2d"]
    show(bmop.bench_resident(p, r, "float32", reps, mode="bf16s", dim=2,
                             device=dev))
    t0 = lap("resident", t0)
    # ---- K4: the separable coefficient and the shell
    p, r, ar = sz["varcoef"]
    kernel_tiers(show(bmop.bench_varcoef(3, p, r, "float32", reps,
                                         modes=("f32", "bf16s"),
                                         attr_refine=ar, device=dev)),
                 ("f32", "bf16s"))
    t0 = lap("varcoef", t0)
    p, r = sz["curved"]
    kernel_tiers(show(bmop.bench_curved(3, p, r, "float32", reps,
                                        device=dev)),
                 ("f32", "bf16", "bf16s"))
    t0 = lap("curved", t0)
    # ---- the adaptive box tier and its solves
    p, r, steps = sz["adaptive"]
    pre = bmop.build_adaptive_op(3, p, r, steps, "float32", device=dev)
    t0 = lap("adaptive build", t0)
    ad = show(bmop.bench_adaptive(3, p, r, steps, "float32", reps,
                                  compare=True, prebuilt=pre))
    if not ad["bf16_rel_err"] <= BOX_BF16_TOL:
        raise RuntimeError(f"bench_adaptive: the bf16 tier is off f32 by "
                           f"{ad['bf16_rel_err']:.3e}")
    t0 = lap("adaptive apply", t0)
    sv = show(bmop.bench_adaptive_solve(
        3, p, r, steps, "float32", prebuilt=pre, bf16_cycle=True,
        emit_cb=lambda rec: say(ph, "before the bf16 hierarchy: "
                                + json.dumps(rec))))
    del pre
    for name in ("jacobi", "gmg", "gmg_bf16cycle"):
        say(ph, f"{name}: {sv[name + '_iterations']} iterations, "
            f"converged {sv[name + '_converged']}, {sv[name + '_s']:.3f} s, "
            f"true rel residual {sv[name + '_true_rel_res']:.3e} (f32 box "
            f"operator, 2-norm of the patch vector)")
        if not sv[name + "_converged"]:
            raise RuntimeError(f"bench_adaptive_solve: {name} did not "
                               f"converge")
    if not sv["gmg_iterations"] < sv["jacobi_iterations"]:
        raise RuntimeError("bench_adaptive_solve: the GMG-CG took no fewer "
                           "iterations than the Jacobi-CG")
    t0 = lap("adaptive solves", t0)
    # ---- the assembled baseline: the structured tier beside the ELL SpMV
    argv = ["--dim", "3", "--degrees", *map(str, sz["spmv_degrees"]),
            "--refine", str(sz["spmv_refine"]), "--spmv", *dev_args]
    with bench_config_spy(bmop) as spy, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        bmop.main(argv)
    recs = [show(json.loads(line)) for line in out.getvalue().splitlines()]
    op, A = spy["op"], spy["ell"]
    v = torch.as_tensor(np.random.default_rng(12).standard_normal(
        A.indices.shape[0]), dtype=torch.float32, device=dev)
    y_mf = op.vmult_raw(v).double()
    synchronize(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    y_ell = A.matvec(v).double()
    n, K = A.indices.shape
    temps = (f"; the apply's peak above its inputs "
             f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f} GB "
             f"(two (n, K) f32 temporaries {2 * 4 * n * K / 1e9:.3f} GB; "
             f"int64 indices would add {8 * n * K / 1e9:.3f} GB)"
             if on_card else "")
    rel = float(torch.linalg.norm(y_ell - y_mf) / torch.linalg.norm(y_mf))
    say(ph, f"ELL SpMV against the structured f32 apply at "
        f"Q{recs[-1]['degree']} refine {sz['spmv_refine']} ({n} DoFs, row "
        f"width {K}) on a seeded vector: {rel:.3e} (tol {SPMV_MF_TOL})"
        f"{temps}")
    if not rel <= SPMV_MF_TOL:
        raise RuntimeError("the ELL SpMV disagrees with the structured "
                           "apply")
    csr = spy["csr"]
    del spy, op, A, v, y_mf, y_ell
    # each side beside its bound: the matrix-free apply reads x and writes
    # y (f32), the ELL apply reads its int32 indices and f32 values, x,
    # and writes y, one multiply-add per padded entry; the nonzeros alone
    # are the least any assembled SpMV reads
    for rec, (n, nnz, K) in zip(recs, csr):
        mf_b = roofline_ms(8 * n, {})[0]
        ell_b = roofline_ms(8 * n * K + 8 * n, {"fp32": 2.0 * n * K})[0]
        nnz_b = roofline_ms(8 * nnz + 8 * n, {"fp32": 2.0 * nnz})[0]
        say(ph, f"Q{rec['degree']} refine {rec['refine']}: {n} DoFs, {nnz} "
            f"nonzeros, row width {K}: {rec['scheme']} "
            f"{1e3 * rec['s_per_apply']:.4f} ms (bound {mf_b:.4f}, bytes), "
            f"ELL SpMV {1e3 * rec['spmv_s_per_apply']:.4f} ms (bound "
            f"{ell_b:.4f} padded, {nnz_b:.4f} on the nonzeros alone); "
            f"matrix-free {rec['mf_speedup_vs_spmv']:.2f}x the SpMV")
    t0 = lap("bmop --spmv", t0)
    argv = ["--dim", "3", "--degrees", *map(str, sz["bmspmv_degrees"]),
            "--refine", str(sz["bmspmv_refine"]), *dev_args]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        bmspmv.main(argv)
    for line in out.getvalue().splitlines():
        rec = show(json.loads(line))
        if not rec["csr_cross_check_rel_err"] <= CSR_TOL:
            raise RuntimeError(f"bmspmv Q{rec['degree']}: CSR cross-check "
                               f"{rec['csr_cross_check_rel_err']:.3e}")
    lap("bmspmv", t0)
    counts = {key: cls.launches for key, cls in counted.items()}
    say(ph, "launches of phase 12 (timing repetitions of bmop's chains, "
        "apart from the kernels line's main-path counts): "
        + ", ".join(f"{k} {n}" for k, n in counts.items()))
    if on_card and not all(counts.values()):
        raise RuntimeError(f"a kernel of bmop's tiers did not run: {counts}")
    say(ph, f"phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return {"launches": counts, "true_rel_res": {
        name: sv[name + "_true_rel_res"]
        for name in ("jacobi", "gmg", "gmg_bf16cycle")}}


# ---- phase 13: the distributed layer ----------------------------------
# the distributed solves' x against the single-device solve's (f64)
DIST_X_TOL = 1e-9
# |L2 f32 - L2 f64| of the distributed flagship solve_poisson
DIST_L2_TOL = 1e-6
# the side paths' sizes: 3D Q2 refine 4 (heat) and 3 (elasticity is
# vector-valued, three components a node)
DIST_SIDE = dict(heat_refine=4, el_refine=3, steps=3)


def kernel_launches() -> int:
    """Every kernel wrapper's launch count, summed (the kernels line's and
    the labs' counters)."""
    from tpufem_torch.lab import toolchain_probe
    from tpufem_torch.lab.resident_lab import V17Kernel
    from tpufem_torch.lab.separable_lab import LabKernel
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D

    return (KernelSeparable.launches + ResidentSeparable.launches
            + ResidentTerms.launches + ResidentTerms2D.launches
            + sum(V17Kernel.launches.values())
            + sum(LabKernel.launches.values())
            + sum(toolchain_probe.launches.values()))


def flagship_box(dev, adaptive=ADAPTIVE, adaptive_size=None) -> dict:
    """What ``box_phase(..., apps_out=...)["box"]`` holds, built for a
    phase that runs without phase 10: ``adaptive_mesh(*adaptive)`` (of
    ``adaptive_size`` (cells, DoFs) where given), Q4, its DoFs and
    constraints, the f32 box operator, its diagonal and GMG hierarchy;
    the GMG-CG's iterations are not known (None)."""
    from tpufem_torch.apps.poisson import adaptive_mesh
    from tpufem_torch.fem.constraints import make_hanging_node_constraints
    from tpufem_torch.fem.dof_handler import DoFHandler
    from tpufem_torch.ops.boxes import BoxLaplaceOperator
    from tpufem_torch.solvers.box_multigrid import BoxMultigrid

    mesh = adaptive_mesh(*adaptive)
    dofs = DoFHandler(mesh, 4)
    ac = make_hanging_node_constraints(dofs)
    if adaptive_size and (mesh.n_cells, dofs.n_dofs) != adaptive_size:
        raise RuntimeError(f"adaptive mesh: {mesh.n_cells} cells, "
                           f"{dofs.n_dofs} DoFs, not {adaptive_size}")
    op = BoxLaplaceOperator(mesh, dofs, constraints=ac, dtype="float32",
                            device=dev)
    diag = op.diagonal()
    mg = BoxMultigrid(mesh, dofs, constraints=ac, dtype="float32",
                      fine_op=op, fine_diag=diag, device=dev)
    return dict(mesh=mesh, dofs=dofs, ac=ac, op=op, diag=diag, mg=mg,
                gmg_iterations=None)


def distributed_phase(dev, box_apps=None, adaptive=ADAPTIVE,
                      adaptive_size=ADAPTIVE_SIZE, n_shards=8,
                      parts="abcd", side=None, reps=N_CHAIN,
                      rtol=SOLVE_RTOL) -> dict:
    """Phase 13: the distributed layer (``tpufem_torch.parallel``, plain
    PyTorch, no kernel of the kernels line) on an in-process shard mesh
    whose shards all sit on ``dev``.  (a) ``apps.multichip.dryrun`` at
    ``n_shards`` shards, f64: the JAX package's nine parity lines, each
    distributed count equal to the port's single-device count on the card
    and x within ``DIST_X_TOL`` (printed beside MULTICHIP_r05.json's JAX
    CPU count; a difference from the JAX record is printed, not failed).
    (b) The main path at full width: ``solve_poisson(mesh=adaptive_mesh(
    *adaptive), degree=4, precond="gmg", shards=(2, 2))`` in f64 (count
    equal to phase 10's single-device f64 solve, ``box_apps``, x within
    ``DIST_X_TOL``) and f32 (L2 within ``DIST_L2_TOL`` of the f64 one);
    two f32 distributed GMG-CGs on phase 10's b and hierarchy
    (``box_apps["box"]``, built here when phase 10 gave none), equal
    counts and bitwise-equal x; the box Jacobi-CG at shards (4, 1) in f64
    against the single-device one (equal counts, x within
    ``DIST_X_TOL``).  (c)
    ``bmop.bench_distributed`` at the same mesh, Q4, f32, shards 2x2 and
    4x1, beside the single-device box apply timed the same way.  (d)
    ``run_heat(shards=4)`` and ``run_elasticity(shards=4)`` (3D Q2, f64)
    against their single-device generic tiers: equal counts.  The kernel
    wrappers' counters must not move.  Returns the phase's numbers."""
    from tpufem_torch.apps import bmop
    from tpufem_torch.apps.poisson import solve_poisson
    from tpufem_torch.ops.boxes import BoxLaplaceOperator
    from tpufem_torch.parallel.box_multigrid import DistributedBoxMultigrid
    from tpufem_torch.parallel.boxes import DistributedBoxLaplace

    ph = "13 distributed"
    side = dict(DIST_SIDE, **(side or {}))
    t_phase = time.perf_counter()
    k_before = kernel_launches()
    out: dict = {}
    secs: dict = {}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    if "a" in parts:
        from tpufem_torch.apps import multichip

        t0 = time.perf_counter()
        record = json.loads(
            (Path(__file__).resolve().parent / "MULTICHIP_r05.json")
            .read_text())["tail"] if (
                Path(__file__).resolve().parent
                / "MULTICHIP_r05.json").exists() else ""
        jax_counts = multichip.record_counts(record)
        lines = multichip.dryrun(n_shards, device=dev, dtype="float64",
                                 log=lambda m: say(ph, m))
        for ln in lines:
            j = jax_counts.get(ln["section"])
            mark = ("" if j is None or j == ln["iterations"] else
                    " — differs from the JAX record")
            say(ph, f"(a) {ln['section']}: {ln['iterations']} iterations "
                f"on the card (single-device {ln['single']}), rel diff "
                f"{ln['rel']:.2e}; MULTICHIP_r05.json (JAX, CPU, 8 devices)"
                f" {j}{mark}")
        out["multichip"] = lines
        secs["a"] = time.perf_counter() - t0

    if "b" in parts or "c" in parts:
        t0 = time.perf_counter()
        built = (box_apps or {}).get("box") or flagship_box(
            dev, adaptive, adaptive_size)
        mesh, dofs, ac, op, diag, mg = (built[k] for k in (
            "mesh", "dofs", "ac", "op", "diag", "mg"))

    if "b" in parts:
        if box_apps is None:
            box_apps = {"float64": solve_poisson(
                dim=3, degree=4, mesh=mesh, scatter="boxes", precond="gmg",
                dtype="float64", device=dev)}
        ref = box_apps["float64"]
        app = {dt: solve_poisson(dim=3, degree=4, mesh=mesh, precond="gmg",
                                 shards=(2, 2), dtype=dt, device=dev)
               for dt in ("float64", "float32")}
        d64, d32 = app["float64"], app["float32"]
        e = rel(d64.solution, ref.solution)
        say(ph, f"(b) solve_poisson(mesh=adaptive, degree=4, precond='gmg',"
            f" shards=(2, 2)) f64: iterations {d64.iterations} (single "
            f"device: {ref.iterations}), x rel diff {e:.2e} (tol "
            f"{DIST_X_TOL}), L2 {d64.l2_error:.6e}, setup "
            f"{d64.setup_time:.2f} s, solve {d64.solve_time:.3f} s")
        if not (d64.converged and d64.iterations == ref.iterations
                and e <= DIST_X_TOL):
            raise RuntimeError("distributed f64 box GMG-CG off the "
                               "single-device solve")
        dl2 = abs(d32.l2_error - d64.l2_error)
        say(ph, f"(b) the same in f32: iterations {d32.iterations}, L2 "
            f"{d32.l2_error:.6e} (f64 {d64.l2_error:.6e}, |diff| "
            f"{dl2:.2e} <= {DIST_L2_TOL}), setup {d32.setup_time:.2f} s, "
            f"solve {d32.solve_time:.3f} s")
        if not (d32.converged and dl2 <= DIST_L2_TOL):
            raise RuntimeError("distributed f32 box GMG-CG off its L2")
        out["gmg"] = {"f64": (d64.iterations, e, d64.solve_time),
                      "f32": (d32.iterations, d32.l2_error,
                              d32.solve_time)}
        # two f32 distributed GMG-CGs on phase 10's b: bitwise equal
        dop = DistributedBoxLaplace(op, shards=(2, 2))
        dop.diagonal_local(diag)
        dmg = DistributedBoxMultigrid(dop, mg)
        b = mg.fine.mnh * op.to_patch(np.random.default_rng(7)
                                      .standard_normal(dofs.n_dofs))
        bl = dop.put_vector(b)
        runs = []
        for _ in range(2):
            t, r = seconds(dev, lambda: dmg.cg_solve(bl, rtol=rtol))
            runs.append((t, r))
        (t1, r1), (t2, r2) = runs
        same = (r1.iterations == r2.iterations and all(
            torch.equal(a, c) for a, c in zip(r1.x.parts, r2.x.parts)))
        single = built["gmg_iterations"]
        if single is None:
            single = mg.cg_solve(b, rtol=rtol).iterations
        say(ph, f"(b) distributed box GMG-CG f32 on phase 10's b (2x2, "
            f"rtol {rtol}): iterations {r1.iterations} and "
            f"{r2.iterations}, {t1:.3f} s and {t2:.3f} s, x bitwise equal "
            f"{same}; single-device {single}")
        if not (same and r1.converged):
            raise RuntimeError("distributed f32 GMG-CG is not bitwise "
                               "reproducible")
        out["gmg_f32_pair"] = (r1.iterations, t1, t2)
        del mg, dmg, dop, bl
        # the 1-axis cuts over hundreds of iterations: box Jacobi-CG f64
        op64 = BoxLaplaceOperator(mesh, dofs, constraints=ac,
                                  dtype="float64", device=dev)
        diag64 = op64.diagonal()
        b64 = op64.interior_mask * op64.to_patch(
            np.random.default_rng(7).standard_normal(dofs.n_dofs))
        ts, rs = seconds(dev, lambda: op64.cg_solve(b64, diag64, rtol=rtol))
        dop64 = DistributedBoxLaplace(op64, shards=(4, 1))
        bl64 = dop64.put_vector(b64)
        dl64 = dop64.diagonal_local(diag64)
        td, rd = seconds(dev, lambda: dop64.cg_solve(bl64, dl64, rtol=rtol))
        own = op64.w_owner.cpu().numpy() > 0
        xs = rs.x.cpu().numpy()
        e = rel(dop64.from_local(rd.x)[own], xs[own])
        say(ph, f"(b) box Jacobi-CG f64 (rtol {rtol}) at shards (4, 1): "
            f"iterations {rd.iterations} (single device {rs.iterations}), "
            f"x rel diff {e:.2e} (tol {DIST_X_TOL}); {td:.2f} s against "
            f"{ts:.2f} s on one shard")
        if not (rd.converged and rd.iterations == rs.iterations
                and e <= DIST_X_TOL):
            raise RuntimeError("distributed box Jacobi-CG off the "
                               "single-device solve")
        out["jacobi"] = (rd.iterations, e, td, ts)
        del op64, dop64, bl64, diag64, b64
        secs["b"] = time.perf_counter() - t0

    if "c" in parts:
        t0 = time.perf_counter()
        n_chain = max(reps, 2)
        x = op.to_patch(np.ones(dofs.n_dofs))
        t_single = bmop.chain_seconds(op.vmult, x, n_chain, "box apply")
        say(ph, f"(c) single-device box f32 apply (chained, {n_chain} "
            f"applies): {t_single * 1e3:.3f} ms, "
            f"{dofs.n_dofs / t_single / 1e9:.4f} GDoF/s")
        out["bench"] = {"single": t_single}
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        for shards in ((2, 2), (4, 1)):
            rec = bmop.bench_distributed(3, 4, adaptive[1], adaptive[2],
                                         "float32", reps, shards,
                                         prebuilt=(mesh, dofs, ac, op),
                                         device=dev)
            # shard s sits on cuda:(s mod the card count)
            n_cards = len({s % n_dev for s in range(4)})
            if not (rec["gdofs_per_s"] > 0 and rec["n_devices"] == n_cards):
                raise RuntimeError("bench_distributed record off")
            say(ph, f"(c) bench_distributed {rec['shards']}: "
                f"{rec['s_per_apply'] * 1e3:.3f} ms/apply, "
                f"{rec['gdofs_per_s']:.4f} GDoF/s on {rec['n_devices']} "
                f"device(s) ({rec['s_per_apply'] / t_single:.2f}x the "
                f"single-device apply)" + (
                    ": the shards share one card, so this is what the "
                    "decomposition costs, not scaling across cards"
                    if n_cards == 1 else ": one shard a card"))
            out["bench"][rec["shards"]] = rec["s_per_apply"]
        secs["c"] = time.perf_counter() - t0

    if "d" in parts:
        from tpufem_torch.apps.elasticity import run_elasticity
        from tpufem_torch.apps.heat import run_heat

        t0 = time.perf_counter()
        kw = dict(dim=3, degree=2, dtype="float64", device=dev)
        h1 = run_heat(refine=side["heat_refine"], steps=side["steps"], **kw)
        h4 = run_heat(refine=side["heat_refine"], steps=side["steps"],
                      shards=4, **kw)
        e = rel(h4["u"], h1["u"])
        say(ph, f"(d) run_heat 3D Q2 refine {side['heat_refine']} f64, "
            f"{side['steps']} steps: CG iterations {h4['iterations']} at 4 "
            f"shards, {h1['iterations']} on one; u rel diff {e:.2e}; "
            f"solve {h4['solve_s']:.2f} s against {h1['solve_s']:.2f} s")
        if not (h4["iterations"] == h1["iterations"] and e <= DIST_X_TOL):
            raise RuntimeError("distributed heat off the single-device run")
        (m1, x1) = run_elasticity(refine=side["el_refine"], **kw)
        (m4, x4) = run_elasticity(refine=side["el_refine"], shards=4, **kw)
        e = rel(x4, x1)
        say(ph, f"(d) run_elasticity 3D Q2 refine {side['el_refine']} f64: "
            f"CG iterations {m4['iterations']} ({m4['precond']}), "
            f"{m1['iterations']} on one; u rel diff {e:.2e}; solve "
            f"{m4['solve_s']:.2f} s against {m1['solve_s']:.2f} s")
        if not (m4["iterations"] == m1["iterations"] and e <= DIST_X_TOL):
            raise RuntimeError("distributed elasticity off the "
                               "single-device run")
        out["side"] = {"heat": (h4["iterations"], h1["iterations"]),
                       "elasticity": (m4["iterations"], m1["iterations"])}
        secs["d"] = time.perf_counter() - t0

    moved = kernel_launches() - k_before
    say(ph, f"kernel launches in phase 13: {moved} (the distributed layer "
        f"runs no kernel of the kernels line); seconds by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if moved:
        raise RuntimeError("phase 13 launched a kernel of the kernels line")
    return out


# ---- phase 14: the solver labs and the chip checks -----------------------
# the H100 golden of apps.chip_checks (apps.check_chip_goldens' default)
CHIP_GOLDEN = (Path(__file__).resolve().parent / "tpufem_torch" / "goldens"
               / "chip_checks_h100.json")
# PERF.md §5: the resident Jacobi-CG through K1 (fused mask, 16,974,593
# DoFs) at 1.2757 ms an iteration unprofiled (apps/resident_probe.py)
MASK_NOTE_MS = 1.2757


def labs_phase(dev, box_apps=None, mask_refine=6, blas_shape=None,
               blas_iters=40, adaptive=ADAPTIVE) -> dict:
    """Phase 14: the solver labs and the chip checks through their entry
    points.
    (a) ``apps.chip_checks.main`` (K2's Jacobi-CG and GMG-CG twice, K2
    against the structured tier, GMRES and Newton twice, K4 against the
    f64 oracle), its artifact written to chiprun_out/chip_checks.json and
    diffed by ``apps.check_chip_goldens`` against the H100 golden (on the
    card only: a CPU artifact has no golden); (b)
    ``lab.resident_mask_lab.run`` at 3D Q4 ``mask_refine``, f32, rtol
    1e-5 (K1, flat and fused mask: equal iterations); (c)
    ``lab.cg_blas1_lab.main`` at ``blas_shape`` (default: the resident
    layout of refine 6), ``blas_iters`` iterations; (d)
    ``lab.adaptive_prec_lab.main`` on phase 10's mesh, DoFs, constraints
    and f32 box operator (``box_apps["box"]``; built from ``adaptive``
    when absent), no variant failing, and ``lab.adaptive_solve_lab.main``
    on the same operator, its diagonal and its GMG hierarchy: only the
    solve stages run.  Returns the K1, K2 and K4 launches of (a) and (b),
    which join the kernels line."""
    from tpufem_torch.apps import check_chip_goldens, chip_checks
    from tpufem_torch.lab import (
        adaptive_prec_lab,
        adaptive_solve_lab,
        cg_blas1_lab,
        resident_mask_lab,
    )
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )
    from tpufem_torch.ops.kernel_terms import ResidentTerms

    ph = "14 labs"
    log = lambda msg: say(ph, str(msg))
    t_phase = time.perf_counter()
    classes = {"K1": ResidentSeparable, "K2": KernelSeparable,
               "K4": ResidentTerms}
    counts = lambda: {k: c.launches for k, c in classes.items()}
    secs = {}
    c0 = counts()

    # (a) the chip checks and their golden
    t0 = time.perf_counter()
    art = Path(__file__).resolve().parent / "chiprun_out" / \
        "chip_checks.json"
    chip_checks.main(out=art, device=dev, log=log)
    ca = counts()
    if dev.type == "cuda":
        rc = check_chip_goldens.main([str(art), "--golden",
                                      str(CHIP_GOLDEN)])
        if rc != 0:
            raise RuntimeError("chip checks regressed against the H100 "
                               "golden")
    else:
        log("no golden for a CPU artifact; not diffed")
    secs["a"] = time.perf_counter() - t0

    # (b) the flat against the fused mask through K1
    t0 = time.perf_counter()
    m = resident_mask_lab.run(mask_refine, "f32", SOLVE_RTOL, device=dev,
                              log=log)
    cb = counts()
    fl, fu, v = m["flat"], m["fused"], m["verdict"]
    log(f"(b) fused mask speedup {v['speedup']} ({fu['s']:.4f} s, "
        f"{fu['ms_per_iteration']:.4f} ms an iteration, against flat "
        f"{fl['s']:.4f} s, {fl['ms_per_iteration']:.4f} ms; PERF.md §5: "
        f"{MASK_NOTE_MS} ms an iteration with the fused mask), iterations "
        f"{fu['iterations']} and {fl['iterations']}")
    if not (v["same_iterations"] and fl["converged"] and fu["converged"]):
        raise RuntimeError("the flat and fused mask took unequal "
                           "iterations, or did not converge")
    del m
    secs["b"] = time.perf_counter() - t0

    # (c) the CG's BLAS-1 at the resident shape
    t0 = time.perf_counter()
    cg_blas1_lab.main(blas_shape, blas_iters, device=dev, log=log)
    secs["c"] = time.perf_counter() - t0

    # (d) the adaptive labs on phase 10's operator: the precision ladder,
    # then the solve's stages on its diagonal and hierarchy
    t0 = time.perf_counter()
    box = (box_apps or {}).get("box") or flagship_box(dev, adaptive)
    pre = tuple(box[k] for k in ("mesh", "dofs", "ac", "op"))
    pr = adaptive_prec_lab.main(*adaptive[1:], device=dev, prebuilt=pre,
                                log=log)
    if pr["failed"]:
        raise RuntimeError(f"precision ladder variants failed: "
                           f"{pr['failed']}")
    del pr
    sr = adaptive_solve_lab.main(*adaptive[1:], device=dev,
                                 prebuilt=(*pre, box["diag"], box["mg"]),
                                 log=log)
    it = sr["iterations"]
    log(f"(d) adaptive solve lab on phase 10's operator, diagonal and "
        f"hierarchy: {sr['n_dofs']} DoFs, {sr['n_hanging']} hanging, "
        f"{sr['levels']} levels; iterations {it}")
    if not it["gmg"] < it["jacobi"]:
        raise RuntimeError("the adaptive solve lab's GMG-CG took no fewer "
                           "iterations than Jacobi")
    secs["d"] = time.perf_counter() - t0

    launches = {k: cb[k] - c0[k] for k in classes}
    say(ph, f"kernel launches of the phase (a) K2 {ca['K2'] - c0['K2']}, "
        f"K4 {ca['K4'] - c0['K4']}; (b) K1 {cb['K1'] - ca['K1']}; "
        f"seconds by part " + ", ".join(f"{k} {t:.1f}"
                                        for k, t in secs.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if dev.type == "cuda" and not (ca["K2"] > c0["K2"]
                                   and ca["K4"] > c0["K4"]
                                   and cb["K1"] > ca["K1"]):
        raise RuntimeError(f"a kernel of phase 14's path did not run: "
                           f"{launches}")
    return launches


# ---- phases 8, 12 and 13 in processes of their own ---------------------
# Most of their seconds are host setup (meshes, DoFs, constraints, partition
# plans, assembly) and none of their launches join the kernels line, so
# each runs in a child process on the same card while the main process
# runs phases 9-11; phase 14 starts once they have ended, on a card it has
# to itself
CHILD_PHASES = ("8", "12", "13")
# the script's seconds by which they must have ended (its limit is 1200 s)
CHILD_DEADLINE_S = 1100.0
# host threads of each (torch's and the BLAS libraries'), so that the four
# processes' thread pools do not crowd the host's cores
CHILD_THREADS = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "2",
                 "MKL_NUM_THREADS": "2"}


def run_child_phase(name: str) -> dict:
    """Phase ``name`` (one of ``CHILD_PHASES``) in this process, as
    ``python3 chip_smoke.py --phase NAME --result PATH`` runs it: its
    numbers for ``main``, its seconds, this process's peak resident
    memory (GiB) and the wall-clock time it ended."""
    from tpufem_torch.utils.build import load_kernels

    load_kernels()  # phase 2 built them: each library loads from build/
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {}
    if name == "8":
        cell_loop_phase(dev)
    elif name == "12":
        out = bench_phase(dev)
    elif name == "13":
        distributed_phase(dev)
    else:
        raise ValueError(f"phase {name} does not run in a process of its "
                         f"own")
    out["seconds"] = time.perf_counter() - t0
    out["max_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    out["ended_at"] = time.time()
    return out


class ChildPhase:
    """One of ``CHILD_PHASES`` started in a process of its own, its output
    sent to chiprun_out/chip_smoke_phase<NAME>.log and shown by ``join``."""

    def __init__(self, name: str, out_dir: Path):
        self.name = name
        self.log = out_dir / f"chip_smoke_phase{name}.log"
        self.result = out_dir / f"chip_smoke_phase{name}.json"
        self.result.unlink(missing_ok=True)
        self.started_at = time.time()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--phase",
                 name, "--result", str(self.result)],
                stdout=f, stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent,
                env=dict(os.environ, **CHILD_THREADS))

    def join(self, timeout: float) -> dict:
        """Wait for the process, print its output; its result, or raise
        if it failed."""
        rc = self.proc.wait(timeout=timeout)
        sys.stdout.write(self.log.read_text())
        sys.stdout.flush()
        if rc != 0 or not self.result.exists():
            raise RuntimeError(f"phase {self.name} failed in its process "
                               f"(exit code {rc})")
        out = json.loads(self.result.read_text())
        # from its start to the end of its phase, the process's own start
        # (imports, the card's context, loading the kernels) included
        self.seconds = out["ended_at"] - self.started_at
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import tpufem_torch  # noqa: F401  (fails outside a checkout)
    from tpufem_torch.apps.poisson import poisson_operator, solve_poisson
    from tpufem_torch.ops.kernel_separable import (
        KernelSeparable,
        ResidentSeparable,
    )
    from tpufem_torch.utils.build import load_kernels
    from tpufem_torch.utils.timer import roofline_ms, time_fn

    t_start = time.perf_counter()
    marks = []  # (phase, start) for the seconds each phase took
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    marks.append(("1", time.perf_counter()))
    # ---- 1 header -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    say("1 header", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    marks.append(("2", time.perf_counter()))
    # ---- 2 build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = load_kernels()
    t_build = time.perf_counter() - t0
    log = "".join(f"==== {name}\n{lib.compiler_log}"
                  for name, lib in libs.items())
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_ptxas.log").write_text(log)

    def ptxas(lib):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           lib.compiler_log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             lib.compiler_log)]
        return (f"{len(regs)} kernels, registers max {max(regs, default=0)},"
                f" {sum(s > 0 for s in spills)} spilling (max "
                f"{max(spills, default=0)} bytes)")

    say("2 build", "; ".join(f"{lib.path.name} built in "
                             f"{lib.build_seconds:.1f} s, {ptxas(lib)}"
                             for lib in libs.values())
        + f" (side by side, {t_build:.1f} s in all)")
    # the ring routine of L1's v17 and v19: its instances' registers and
    # spills, and any wgmma ptxas serialised (a library reused from an
    # earlier build has no log)
    say("2 build", "lab_resident_ring in lab_resident (v17: lab_ring_kernel, "
        "v19: lab_ring_pipe_kernel, v20: lab_window_kernel, the last two's "
        "registers at launch; setmaxnreg gives their x stage 160 and their "
        "band and producer warps 96): "
        + ring_ptxas_summary(libs["lab_resident"].compiler_log))
    say("2 build", "lab_resident_ring in lab_zyfirst (v15 and v13 on L2's "
        "layouts: lab_ring_pipe_kernel, and lab_ring_kernel): "
        + ring_ptxas_summary(libs["lab_zyfirst"].compiler_log))
    say("2 build", "v3's ring in lab_separable_ring (l2_bx_kernel, one "
        "block an SM, 288 threads): " + ring_ptxas_summary(
            libs["lab_separable_ring"].compiler_log, "l2_bx_kernel",
            "l2_bx_kernel"))
    say("2 build", "vxy's ring in lab_separable_ring (l2_bxy_kernel, two "
        "blocks an SM, 256 threads, 128 registers): " + ring_ptxas_summary(
            libs["lab_separable_ring"].compiler_log, "l2_bxy_kernel",
            "l2_bxy_kernel"))
    say("2 build", "v2's ring in lab_separable_ring (l2_bxyz_kernel, one "
        "block an SM, 256 threads): " + ring_ptxas_summary(
            libs["lab_separable_ring"].compiler_log, "l2_bxyz_kernel",
            "l2_bxyz_kernel"))
    say("2 build", "v12's ring in lab_separable_band (l2_bxyzb_kernel, one "
        "block an SM, 256 threads; its z window in registers in f32 storage "
        "at p <= 6, else a shared ring): " + ring_ptxas_summary(
            libs["lab_separable_band"].compiler_log, "l2_bxyzb_kernel",
            "l2_bxyzb_kernel"))
    say("2 build", "P2's cluster chain in toolchain_probe "
        "(probe_cluster_kernel, three modes an instance): "
        + cluster_ptxas_summary(libs["toolchain_probe"].compiler_log))
    say("2 build", "P1's wgmma tile in toolchain_probe "
        "(probe_wgmma_kernel, one warpgroup a block): "
        + p1_ptxas_summary(libs["toolchain_probe"].compiler_log))

    marks.append(("3", time.perf_counter()))
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
    # K4 (3D, with and without the fused mask; at p = 8 also PASS_T terms:
    # passes over x) and K3 (2D): T terms of random non-symmetric banded
    # matrices, distinct per term and axis
    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        npts = n * p + 1
        for dim, counts in ((3, (1, 3, 4, 7) + (PASS_T,) * (p == 8)),
                            (2, (1, 2, 3))):
            for T in counts:
                terms = [[random_banded(rng, npts, p) for _ in range(dim)]
                         for _ in range(T)]
                rels = []
                for mode in ("f64", "f32", "bf16s"):
                    for dirichlet in (False, True):
                        for seg in ((None,) if dim == 3 else
                                    segment_counts(npts, STORAGE[mode])):
                            tag, rel, _ = check_terms(terms, p, mode, rng,
                                                      dirichlet, T == PASS_T,
                                                      seg)
                            worst[mode] = max(worst.get(mode, 0.0), rel)
                            group = tag.split("group=")[-1]
                            rels.append(
                                f"{mode}{' masked' * dirichlet}"
                                f"{f' group {group}' * (T == PASS_T)}"
                                + (f" segments {tag.split('segments=')[1]}"
                                   if dim == 2 else "") + f" {rel:.3e}")
                say("3 kernels", f"{'K4' if dim == 3 else 'K3'} T={T} p={p} "
                    f"npts={npts} tile="
                    f"{tag.split('tile=')[1].split(' segments')[0]}: max rel "
                    f"err " + ", ".join(rels))
    # the main path's shapes: K2 at 3D Q4 refine 5 (and 2D refine 10, phase
    # 6's), K1 at refine 6, K4 on the refine-6 coefficient operator and the
    # refine-5 shell, K3 at 2D Q4 refine 10 and refine 8, at the chooser's
    # segments and at 1-4
    abs_err = {}
    for name, kind_k, dim, n, modes in (
            ("K2", "K2", 3, 32, ("f32", "f64")),
            ("K2 2D", "K2", 2, 1024, ("f32",)),
            ("K1", "K1", 3, 64, ("f32", "bf16s"))):
        npts = 4 * n + 1
        for mode in modes:
            tag, rel, aerr = check_kernel(kind_k, dim, 4, npts, mode,
                                          kind_k == "K1",
                                          *flagship_axes(4, n, dim), rng)
            worst[mode] = max(worst.get(mode, 0.0), rel)
            if mode == "f32" and name != "K2 2D":
                abs_err[name] = max(abs_err.get(name, 0.0), aerr)
            say("3 kernels", f"{tag} max rel err {rel:.3e} "
                f"max abs err {aerr:.3e}")
    from tpufem_torch.ops.separable import (
        cartesian_coef_terms,
        global_1d_matrices,
    )

    coef64 = cartesian_coef_terms(4, 3, 5, 64, [0.0] * 3, [1.0] * 3,
                                  COEF_AXES, np.float64)
    K1u, M1u = global_1d_matrices(4, 1024, 5)
    lap2d = [[K1u * 1024, M1u / 1024], [M1u / 1024, K1u * 1024]]
    # phase 4c's other inputs, from the operators the entry point builds
    # (f64, no kernel): the refine-5 shell's r^2- and sin(theta)-weighted
    # terms (K4) and the 2D Q4 refine 8 Laplace factorisation (K3)
    to_np = lambda mats: [X.cpu().numpy() for X in mats]
    shell_terms = [to_np(t) for t in poisson_operator(
        3, 4, 5, "float64", False, dev, mesh_kind="shell").mf.terms]
    mf2 = poisson_operator(2, 4, 8, "float64", False, dev).mf
    (K0, K1), (M0, M1) = to_np(mf2.Ks), to_np(mf2.Ms)
    lap2d_r8 = [[K0, M1], [M0, K1]]
    for name, terms in (("K4", coef64), ("K4", shell_terms), ("K3", lap2d),
                        ("K3", lap2d_r8)):
        npts = terms[0][0].shape[0]
        for mode in ("f32", "bf16s"):
            for dirichlet in (True, False):
                for seg in ((None,) if name == "K4" else
                            segment_counts(npts, STORAGE[mode])):
                    tag, rel, aerr = check_terms(terms, 4, mode, rng,
                                                 dirichlet, segments=seg)
                    worst[mode] = max(worst.get(mode, 0.0), rel)
                    if mode == "f32":
                        abs_err[name] = max(abs_err.get(name, 0.0), aerr)
                    say("3 kernels", f"{tag} max rel err {rel:.3e} "
                        f"max abs err {aerr:.3e}")
    say("3 kernels", "all within tolerance; worst max rel err "
        + ", ".join(f"{m} {worst[m]:.3e} (tol {TOL[m]})" for m in TOL))

    marks.append(("4", time.perf_counter()))
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

    from tpufem_torch.apps.poisson import poisson_operator
    from tpufem_torch.solvers.resident import resident_jacobi_cg

    def flagship_operator(pallas_mode):
        t0 = time.perf_counter()
        op = poisson_operator(3, 4, 6, "float32", True, dev,
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

    marks.append(("4c", time.perf_counter()))
    # ---- 4c main path of the terms tier: K3/K4 counts reset here, read
    # after the 2D resident solve ----------------------------------------
    from tpufem_torch.operators.laplace import LaplaceOperator
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
    from tpufem_torch.ops.matrix_free import MatrixFree

    ResidentTerms.launches = 0
    ResidentTerms2D.launches = 0
    rs = solve_poisson(dim=3, degree=4, refine=5, mesh_kind="shell",
                       scatter="separable", use_pallas=True,
                       dtype="float32", rtol=SHELL_RTOL, device="cuda")
    k4_shell = ResidentTerms.launches
    say("4c main path", f"solve_poisson 3D Q4 refine 5 shell f32 K4 (rtol "
        f"{SHELL_RTOL}): dofs {rs.n_dofs} iterations {rs.iterations} "
        f"converged {rs.converged} L2 {rs.l2_error:.4e} setup "
        f"{rs.setup_time:.2f} s solve {rs.solve_time:.3f} s K4 launches "
        f"{k4_shell}")
    if not (rs.converged and rs.l2_error <= 1e-6
            and k4_shell >= rs.iterations):
        raise RuntimeError("refine-5 f32 shell solve_poisson failed its "
                           "checks")

    t0 = time.perf_counter()
    opc = poisson_operator(3, 4, 6, "float32", True, dev,
                           coefficient_axes=COEF_AXES)
    mfc = opc.mf
    t1 = time.perf_counter()
    diagc = opc.diagonal()
    torch.cuda.synchronize()
    say("4c main path", f"refine-6 coefficient_axes operator, {mfc.n_dofs} "
        f"DoFs: host setup {t1 - t0:.1f} s (mesh, DoFs, metric with points, "
        f"coef_q, terms, K4 tables), diagonal {time.perf_counter() - t1:.1f}"
        f" s; K4 tile {mfc.resident.tile} group {mfc.resident.group} fused "
        f"mask {mfc.resident.dirichlet}")
    maskc = mfc.interior_mask.cpu().numpy().astype(np.float64)
    bc = torch.tensor(maskc * np.random.default_rng(17).standard_normal(
        mfc.n_dofs), dtype=torch.float32, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = resident_jacobi_cg(opc, bc, diag=diagc, rtol=SOLVE_RTOL,
                                 track_best=False)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, res))
    (t1, rca), (t2, rcb) = runs
    rel_c = true_rel_residual(mfc, bc, rca.x, coef64)
    say("4c main path", f"3d_q4_variable_coef resident f32 K4: {t1:.3f} s / "
        f"{t2:.3f} s, iterations {rca.iterations} / {rcb.iterations}, "
        f"converged {rca.converged}, true rel residual (f64 terms) "
        f"{rel_c:.3e}")
    if not (rca.converged and rcb.converged
            and rca.iterations == rcb.iterations
            and torch.equal(rca.x, rcb.x)):
        raise RuntimeError("coefficient resident f32 solve: not converged "
                           "or not bitwise reproducible")
    say("4c main path", "two coefficient resident solves: equal iterations, "
        "bitwise-equal x")

    op2 = poisson_operator(2, 4, 8, "float32", True, dev)
    diag2 = op2.diagonal()
    mask2 = op2.mf.interior_mask.cpu().numpy().astype(np.float64)
    b2 = torch.tensor(mask2 * np.random.default_rng(19).standard_normal(
        op2.mf.n_dofs), dtype=torch.float32, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = resident_jacobi_cg(op2, b2, diag=diag2, rtol=SOLVE_RTOL,
                                 track_best=False)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, res))
    (t2d, r2), (t2e, r2b) = runs
    rk2 = op2.mf.resident
    rel2 = true_rel_residual(op2.mf, b2, r2.x)
    say("4c main path", f"2D Q4 refine 8 resident f32 K3: {op2.mf.n_dofs} "
        f"DoFs, {t2d:.3f} s / {t2e:.3f} s, iterations {r2.iterations} / "
        f"{r2b.iterations}, converged {r2.converged}, true rel residual "
        f"{rel2:.3e}, K3 tile {rk2.tile} segments {rk2.segments} fused "
        f"mask {rk2.dirichlet}")
    if not (r2.converged and r2b.converged and rk2.dirichlet
            and r2.iterations == r2b.iterations and torch.equal(r2.x, r2b.x)):
        raise RuntimeError("2D resident f32 solve: not converged through "
                           "the fused-mask K3 or not bitwise reproducible")
    say("4c main path", "two 2D resident solves: equal iterations, "
        "bitwise-equal x")
    # the counts the kernels line reports for K3/K4: the shell
    # solve_poisson and the two coefficient solves (K4), the 2D solve (K3)
    launches["K4"] = ResidentTerms.launches
    launches["K3"] = ResidentTerms2D.launches
    say("4c main path", f"kernel launches of the terms-tier main path: "
        f"K4 {launches['K4']}, K3 {launches['K3']}")
    if not (launches["K4"] >= rs.iterations + rca.iterations + rcb.iterations
            and launches["K3"] >= r2.iterations + r2b.iterations):
        raise RuntimeError(f"a kernel of the terms-tier main path did not "
                           f"run: {launches}")

    # the 2D solve's true residual sits above its rtol.  The same solve
    # (same b, diag, rtol) with the plain f32 apply on the card, and
    # through K3 in f64, tell f32 CG drift from a kernel fault: the f64
    # kernel solve must meet its rtol, and K3's f32 drift must not exceed
    # the plain version's by more than DRIFT_RATIO
    plain2 = SimpleNamespace(mf=op2.mf,
                             resident=PlainResident(op2.mf.resident))
    r2p = resident_jacobi_cg(plain2, b2, diag=diag2, rtol=SOLVE_RTOL,
                             track_best=False)
    rel2p = true_rel_residual(op2.mf, b2, r2p.x)
    op2d = poisson_operator(2, 4, 8, "float64", True, dev)
    b2d = b2.to(torch.float64)
    r2d = resident_jacobi_cg(op2d, b2d, diag=op2d.diagonal(), rtol=SOLVE_RTOL,
                             track_best=False)
    rel2d = true_rel_residual(op2d.mf, b2d, r2d.x)
    say("4c main path", f"2D Q4 refine 8 true rel residual at rtol "
        f"{SOLVE_RTOL}: K3 f32 {rel2:.3e} ({r2.iterations} it), plain f32 "
        f"{rel2p:.3e} ({r2p.iterations} it), K3 f64 {rel2d:.3e} "
        f"({r2d.iterations} it)")
    if not (r2p.converged and r2d.converged
            and rel2d <= 1.5 * SOLVE_RTOL and rel2 <= DRIFT_RATIO * rel2p):
        raise RuntimeError("2D resident solve: K3's true residual is not "
                           "explained by f32 CG drift")

    # bf16s: the coefficient operator's terms with pallas_mode="bf16s"
    # (host arrays reused), counted on its own
    mf16 = MatrixFree.from_terms(
        dataclasses.replace(mfc.config, pallas_mode="bf16s"), mfc.mesh,
        mfc.dofs, dev, coef64, interior=maskc, quad=mfc.quad,
        host_metric=mfc.host_metric, coef_q=mfc.coef_q)
    ResidentTerms.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc16 = resident_jacobi_cg(LaplaceOperator(mf16), bc, diag=diagc,
                              rtol=SOLVE_RTOL, track_best=False)
    torch.cuda.synchronize()
    tc16 = time.perf_counter() - t0
    k4_bf16s = ResidentTerms.launches
    relc16 = true_rel_residual(mfc, bc, rc16.x, coef64)
    say("4c main path", f"3d_q4_variable_coef resident bf16s K4: "
        f"{tc16:.3f} s, iterations {rc16.iterations}, true rel residual "
        f"(f64 terms) {relc16:.3e}, K4 bf16s launches {k4_bf16s}")
    if not (np.isfinite(relc16) and k4_bf16s >= rc16.iterations):
        raise RuntimeError("bf16s coefficient solve: non-finite x or the "
                           "bf16s kernel did not run")

    marks.append(("4b", time.perf_counter()))
    # ---- 4b f64 kernel-vs-plain solve parity (3D, and 2D for K2/K3).  L2
    # must sit well above the solver tolerance's floor for "equal to
    # 1e-10" to mean anything: the 3D cases' sine RHS gives L2 ~1e-7
    # (cube) and ~1e-6 (shell); in 2D Q4 the cube's sine solve reaches L2
    # ~1e-10, at that floor, so the 2D cases take a rough RHS (hundreds of
    # iterations, L2 of order 1 against the sine)
    def rough2d(x):
        return (np.cos(7 * x[:, 0]) + x[:, 1] ** 3
                + np.sin(13 * x[:, 0] * x[:, 1]))

    for mesh_kind, dim, degree, refine, rhs in (
            ("cube", 3, 4, 3, None), ("cube", 2, 4, 5, rough2d),
            ("shell", 3, 4, 3, None), ("shell", 2, 4, 5, rough2d)):
        rk, rp = (solve_poisson(dim=dim, degree=degree, refine=refine,
                                mesh_kind=mesh_kind, scatter="separable",
                                use_pallas=pallas, dtype="float64", rhs=rhs,
                                device="cuda")
                  for pallas in (True, False))
        rel_l2 = abs(rk.l2_error - rp.l2_error) / rp.l2_error
        rel_x = (np.linalg.norm(rk.solution - rp.solution)
                 / np.linalg.norm(rp.solution))
        say("4b parity", f"f64 {mesh_kind} {dim}D Q{degree} refine {refine} "
            f"{'rough' if rhs else 'sine'} RHS: kernel {rk.iterations} it L2 "
            f"{rk.l2_error:.6e}, plain {rp.iterations} it L2 "
            f"{rp.l2_error:.6e}, L2 rel diff {rel_l2:.2e}, x rel diff "
            f"{rel_x:.2e}")
        if not (rk.converged and rk.iterations == rp.iterations
                and rel_l2 <= 1e-10):
            raise RuntimeError("f64 kernel and plain solves differ")

    marks.append(("5", time.perf_counter()))
    # ---- 5 the K1 kernel lab (L1): every kernel and mode vs plain, then
    # the lab's entry point with the L1 counts reset before and read after
    from tpufem_torch.lab import kernel_lab
    from tpufem_torch.lab.resident_lab import KERNELS, V17Kernel

    lab_worst, emu_worst, emu_apart = {}, {}, {}
    # the labs' inputs from a generator of their own, as phases 4 and 6
    # seed theirs: the count of phase 3's checks no longer moves them
    rng = np.random.default_rng(21)

    def lab_case(kern, mode, p, n, h, u):
        tag, rel, aerr, emu = check_lab(kern, mode, p, n, h, u)
        lab_worst[mode] = max(lab_worst.get(mode, 0.0), rel)
        if emu is not None:
            emu_worst[mode] = max(emu_worst.get(mode, 0.0), emu[0])
            emu_apart[mode] = max(emu_apart.get(mode, 0.0), emu[1])
        return tag, aerr, f"{mode} {rel:.3e}" + (
            f" (emulated {emu[0]:.3e}, apart {emu[1]:.3e})"
            if emu is not None else "")

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        for kern in KERNELS:
            for draw in range(LAB_DRAWS):
                rels = []
                for mode in LAB_TOL:
                    u = torch.tensor(rng.standard_normal((n * p + 1)**3),
                                     device=dev)
                    rels.append(lab_case(kern, mode, p, n,
                                         [1.0 / n, 1.3 / n, 0.7 / n], u)[2])
                say("5 lab", f"{kern} p={p} npts={n * p + 1} input {draw}: "
                    "max rel err " + ", ".join(rels))
    lab_abs = {}
    u257 = torch.tensor(rng.standard_normal(257**3), device=dev)
    for kern in KERNELS:
        rels = []
        for mode in LAB_TOL:
            tag, aerr, line = lab_case(kern, mode, 4, 64, [1.0 / 64] * 3,
                                       u257)
            if mode == "f32":
                lab_abs[kern] = aerr
            rels.append(line)
        say("5 lab", f"flagship {tag.split(' ', 2)[2]}: {kern} max rel err "
            + ", ".join(rels) + f"; f32 max abs err {lab_abs[kern]:.3e}")
    # v18 on the ring is v17's launch: bit for bit v17 there in every mode,
    # one input a degree and the flagship
    def v18_is_v17(p, n, h, u):
        for mode in LAB_TOL:
            ks = [lab_kernel(kern, mode, n * p + 1, p, n, h)
                  for kern in ("v17", "v18")]
            gp = ks[0].pad(u.to(ks[0].dt))
            if ks[1].routine != "ring" or not same_bits(ks[0].raw(gp),
                                                        ks[1].raw(gp)):
                raise RuntimeError(f"v18 {mode} p={p} npts={n * p + 1} "
                                   f"({ks[1].routine}): not v17's ring bit "
                                   f"for bit")

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        v18_is_v17(p, n, [1.0 / n, 1.3 / n, 0.7 / n],
                   torch.tensor(rng.standard_normal((n * p + 1)**3),
                                device=dev))
    v18_is_v17(4, 64, [1.0 / 64] * 3, u257)
    say("5 lab", "v18 on the ring (lab_ring_kernel) bit for bit v17 there "
        f"in {', '.join(LAB_TOL)} at p = 1, 2, 4, 7, 8 and the flagship")
    # the earlier schedule of v17-v20 (the tile routine, routine="tile"; v18's
    # with fused bands) in every mode, one input a degree and the flagship
    from tpufem_torch.lab.resident_lab import RING_KERNELS

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        u = torch.tensor(rng.standard_normal((n * p + 1)**3), device=dev)
        for kern in RING_KERNELS:
            rels = [check_lab(kern, mode, p, n, [1.0 / n, 1.3 / n, 0.7 / n],
                              u, routine="tile")[1] for mode in LAB_TOL]
            say("5 lab", f"{kern} earlier routine p={p} npts={n * p + 1}: "
                "max rel err " + ", ".join(
                    f"{m} {r:.3e}" for m, r in zip(LAB_TOL, rels)))
    for kern in RING_KERNELS:
        rels = [check_lab(kern, mode, 4, 64, [1.0 / 64] * 3, u257,
                          routine="tile")[1] for mode in LAB_TOL]
        say("5 lab", f"{kern} earlier routine flagship: max rel err "
            + ", ".join(f"{m} {r:.3e}" for m, r in zip(LAB_TOL, rels)))
    say("5 lab", "all within tolerance, halo zeros kept, chains agree, "
        f"f32/f32h/bf16 within {EMU_TOL} of their emulation; worst max rel "
        "err " + ", ".join(
            f"{m} {lab_worst[m]:.3e} (tol {LAB_TOL[m]}"
            + (f", emulated {emu_worst[m]:.3e}, apart {emu_apart[m]:.3e}"
               if m in emu_worst else "")
            + ")" for m in LAB_TOL))
    # the L2 kernels, x-first and z/y-first, each variant in each precision
    # (v9: bf16x3 only; v16, vcopy, vband: no tensor-core stage, f64 and f32)
    from tpufem_torch.lab.separable_lab import (
        NO_MMA,
        VARIANTS as L2V,
        ZYFIRST,
        LabKernel,
    )

    l2_worst, l2_emu, l2_apart, l2_abs = {}, {}, {}, {}

    def l2_case(v, mode, p, n, h, u, **tiles):
        tag, rel, aerr, emu = check_l2(v, mode, p, n, h, u, **tiles)
        l2_worst[mode] = max(l2_worst.get(mode, 0.0), rel)
        if emu is not None:
            l2_emu[mode] = max(l2_emu.get(mode, 0.0), emu[0])
            l2_apart[mode] = max(l2_apart.get(mode, 0.0), emu[1])
        return tag, aerr, f"{mode} {rel:.3e}" + (
            f" (emulated {emu[0]:.3e}, apart {emu[1]:.3e})"
            if emu is not None else "")

    def l2_modes(v):
        return (["bf16"] if v == "v9" else ["f64", "f32"] if v in NO_MMA
                else list(L2_MODES))

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        for draw in range(LAB_DRAWS):
            u = torch.tensor(rng.standard_normal((n * p + 1)**3), device=dev)
            for v in L2V:
                rels = [l2_case(v, mode, p, n, [1.0 / n, 1.3 / n, 0.7 / n],
                                u)[2] for mode in l2_modes(v)]
                say("5 lab", f"{v} p={p} npts={n * p + 1} input {draw}: "
                    "max rel err " + ", ".join(rels))
    for v in L2V:
        rels = []
        for mode in l2_modes(v):
            tag, aerr, line = l2_case(v, mode, 4, 64, [1.0 / 64] * 3, u257)
            if mode == ("bf16" if v == "v9" else "f32"):
                l2_abs[v] = aerr
            rels.append(f"{line} ({tag.split(' ', 3)[3]})")
        say("5 lab", f"flagship npts=257: {v} max rel err " + ", ".join(rels)
            + f"; max abs err {l2_abs[v]:.3e}")
    # the all-band routine (vcopy, vband, v16) at every sub-tile its chooser
    # can pick and at larger ones, on an output layout of 40 rows (b = 20)
    # that 16 and 8 do not divide, and at the flagship (264 rows, ragged
    # against 16); vcopy exactly, as everywhere
    from tpufem_torch.lab.separable_lab import ZY_RING_TILES

    u39 = torch.tensor(rng.standard_normal(39**3), device=dev)
    for tile in ZY_RING_TILES + ((8, 16), (16, 8)):
        rels = [f"{v} " + l2_case(v, mode, 2, 19, [1 / 19, 1.3 / 19, 0.7 / 19],
                                  u39, b=20, tile=tile)[2]
                for v in NO_MMA for mode in ("f64", "f32")]
        rels += [f"{v} flagship " + l2_case(v, "f32", 4, 64, [1.0 / 64] * 3,
                                            u257, tile=tile)[2]
                 for v in NO_MMA]
        say("5 lab", f"sub-tile {tile}, ragged rows: max rel err "
            + ", ".join(rels))
    # v15's, v14's and v13's earlier schedule (zy_kernel, routine="tile"),
    # v3's, vxy's, v2's, v6's and v8's (l2_kernel, routine="tile") and
    # v15's and v14's other ring routine (f32 storage: lab_ring_kernel;
    # f64: the persistent one) in every precision, one input a degree and
    # the flagship (the defaults are checked above with every variant)
    from tpufem_torch.lab.separable_lab import default_routine

    def zy_other(v, p, n, h, u):
        rels = []
        for mode, (dt, _) in L2_MODES.items():
            if mode not in l2_modes(v):
                continue
            other = ("pipe" if default_routine(v, dt) == "ring" else "ring",) \
                if v in ("v15", "v14") else ()
            rels += [f"{r} " + l2_case(v, mode, p, n, h, u, routine=r)[2]
                     for r in ("tile",) + other]
        return rels

    # v14 on each of v15's ring routines: v15's instruction stream, so its
    # output is v15's bit for bit, in every mode
    from tpufem_torch.ops.separable import global_1d_matrices

    def v14_is_v15(p, n, h, u):
        K1, M1 = global_1d_matrices(p, n, p + 1)
        for mode, (dt, prec) in L2_MODES.items():
            for r in ("pipe", "ring"):
                ks = [LabKernel(v, n * p + 1, p, K1, M1, h, prec=prec,
                                dtype=dt, device="cuda", routine=r)
                      for v in ("v15", "v14")]
                gp = ks[0].pad(u.to(dt))
                if not same_bits(ks[0].raw(gp), ks[1].raw(gp)):
                    raise RuntimeError(f"v14 {mode} p={p} npts={n * p + 1} "
                                       f"({r}): not v15's bit for bit")

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        v14_is_v15(p, n, [1.0 / n, 1.3 / n, 0.7 / n],
                   torch.tensor(rng.standard_normal((n * p + 1)**3),
                                device=dev))
    v14_is_v15(4, 64, [1.0 / 64] * 3, u257)
    say("5 lab", "v14 on v15's ring routines (pipe, ring) bit for bit v15 "
        f"there in {', '.join(L2_MODES)} at p = 1, 2, 4, 7, 8 and the "
        "flagship")

    # v8 and v6 on the ring: v2's instruction stream (v8's transposes are
    # the ring's operand layouts), so their output is v2's bit for bit, in
    # every mode, and v9's in bf16x3; v2 at two z segments a block computes
    # the same bits
    def v2_family_is_v2(p, n, h, u, segs=()):
        K1, M1 = global_1d_matrices(p, n, p + 1)
        for mode, (dt, prec) in L2_MODES.items():
            ks = [LabKernel(v, n * p + 1, p, K1, M1, h, prec=prec, dtype=dt,
                            device="cuda", routine="ring", seg=s)
                  for v, s in [("v2", None), ("v6", None), ("v8", None)]
                  + [("v9", None)] * (mode == "bf16")
                  + [("v2", s) for s in segs]]
            gp = ks[0].pad(u.to(dt))
            y2 = ks[0].raw(gp)
            for k in ks[1:]:
                if not same_bits(y2, k.raw(gp)):
                    raise RuntimeError(
                        f"{k.variant} {mode} p={p} npts={n * p + 1} seg="
                        f"{k.seg}: not v2's (seg={ks[0].seg}) bit for bit")

    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        v2_family_is_v2(p, n, [1.0 / n, 1.3 / n, 0.7 / n],
                        torch.tensor(rng.standard_normal((n * p + 1)**3),
                                     device=dev))
    v2_family_is_v2(4, 64, [1.0 / 64] * 3, u257, segs=(1,))
    say("5 lab", "v8 and v6 on v2's ring bit for bit v2 in "
        f"{', '.join(L2_MODES)} and v9 in bf16x3 at p = 1, 2, 4, 7, 8 and "
        "the flagship; v2 at the flagship bit for bit at 1 z tile a block "
        "and at its chooser's segment")
    # v12's ring at the flagship: one z tile a block computes its chooser's
    # segment's bits (the z window carries across tile edges in one tap
    # order), in every mode
    K1f, M1f = global_1d_matrices(4, 64, 5)
    for mode, (dt, prec) in L2_MODES.items():
        ks = [LabKernel("v12", 257, 4, K1f, M1f, [1.0 / 64] * 3, prec=prec,
                        dtype=dt, device="cuda", seg=s) for s in (None, 1)]
        gp = ks[0].pad(u257.to(dt))
        if not same_bits(ks[0].raw(gp), ks[1].raw(gp)):
            raise RuntimeError(f"v12 {mode} at the flagship: seg 1 is not "
                               f"seg {ks[0].seg}'s bit for bit")
        del gp, ks
    say("5 lab", f"v12's ring at the flagship bit for bit at 1 z tile a "
        f"block and at its chooser's segment in {', '.join(L2_MODES)}")
    for v in ("v15", "v14", "v13", "v3", "vxy", "v2", "v6", "v8", "v9",
              "v12"):
        for p in (1, 2, 4, 7, 8):
            n = max(2, 24 // p)
            u = torch.tensor(rng.standard_normal((n * p + 1)**3), device=dev)
            say("5 lab", f"{v}'s other routines p={p} npts={n * p + 1}: max "
                "rel err " + ", ".join(zy_other(
                    v, p, n, [1.0 / n, 1.3 / n, 0.7 / n], u)))
        say("5 lab", f"{v}'s other routines flagship: max rel err "
            + ", ".join(zy_other(v, 4, 64, [1.0 / 64] * 3, u257)))
    say("5 lab", "L2a and L2b all within their classes, every point finite; "
        "worst "
        "max rel err " + ", ".join(
            f"{m} {l2_worst[m]:.3e}"
            + (f" (emulated {l2_emu[m]:.3e}, apart {l2_apart[m]:.3e})"
               if m in l2_emu else "") for m in L2_MODES))
    for kern in KERNELS:
        V17Kernel.launches[kern] = 0
    for v in L2V:
        LabKernel.launches[v] = 0
    lab_results = kernel_lab.main(LAB_ARGS)
    launches.update(V17Kernel.launches)
    launches.update({f"L2 {v}": n for v, n in LabKernel.launches.items()})
    say("5 lab", f"kernel_lab.main {' '.join(LAB_ARGS)}: L1 launches "
        f"{dict(V17Kernel.launches)}, L2 launches "
        f"{dict(LabKernel.launches)}")
    if not all(launches[kern] > 0 for kern in KERNELS):
        raise RuntimeError(f"an L1 kernel of the lab's main path did not "
                           f"run: {dict(V17Kernel.launches)}")
    if not all(n > 0 for n in LabKernel.launches.values()):
        raise RuntimeError(f"an L2 kernel of the lab's main path did not "
                           f"run: {dict(LabKernel.launches)}")
    lab_best = max((r["gdofs"], name) for name, r in lab_results.items()
                   if r["rel_err"] == r["rel_err"])
    say("5 lab", f"kernel_lab best (held against the plain version): "
        f"{lab_best[1]} {lab_best[0]:.2f} GDoF/s")

    marks.append(("6", time.perf_counter()))
    # ---- 6 apply throughput: flagship K1 (17M), main-path K2 (2.1M) -----
    # kernel and plain timed in turns (plain, kernel, kernel, plain)
    def chain_ms(fn, x):
        return 1e3 * time_fn(fn, x, reps=N_CHAIN)

    def device_ms(fn, x):
        """Device ms per apply of a chain of N_CHAIN (torch.profiler)."""
        from tpufem_torch.apps.resident_probe import device_ms as dev_ms

        return dev_ms(fn, x, N_CHAIN)

    def turns(kernel, plain, x, timer=chain_ms):
        a = timer(plain, x)
        b = timer(kernel, x)
        c = timer(kernel, x)
        d = timer(plain, x)
        say("6 throughput", f"ms per apply in turns: plain {a:.4f}, kernel "
            f"{b:.4f}, kernel {c:.4f}, plain {d:.4f}")
        return (b + c) / 2, (a + d) / 2

    rk1 = mf.resident
    x17 = rk1.pad(torch.tensor(np.random.default_rng(11).standard_normal(
        mf.n_dofs), dtype=torch.float32, device=dev))
    ms, plain_ms = {}, {}
    ms["K1"], plain_ms["K1"] = turns(rk1.raw, rk1.plain, x17)
    ms["K1_bf16s"] = chain_ms(rk16.raw, rk16.pad(rk1.unpad(x17)))
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
    earlier = dict(EARLIER_MS)

    def routine_turns(name, k, x, timer=chain_ms):
        """K2's tile routine and z-march in turns (tile, march, march,
        tile); the tile routine's mean goes to ``earlier[name]``."""
        tile, march = k.with_routine("tile"), k.with_routine("march")
        t = [timer(f, x) for f in (tile.launch, march.launch, march.launch,
                                   tile.launch)]
        earlier[name] = (t[0] + t[3]) / 2
        say("6 throughput", f"{name} {k.dim}D npts {k.npts}: ms per apply "
            f"({'device time' if timer is device_ms else 'chains'}) in "
            f"turns: tile routine {t[0]:.4f} at {tile.tile}, z-march "
            f"{t[1]:.4f} at {march.tile} x {march.nseg} segments, z-march "
            f"{t[2]:.4f}, tile routine {t[3]:.4f}; march/tile "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}; K2 runs the {k.routine}"
            "; the march's design bound {:.5f} ms ({})".format(
                *march_design_bound(march)))

    routine_turns("K2", k2, x5)
    print(json.dumps({
        "metric": "apply_separable", "value": 129**3 / (ms["K2"] * 1e-3)
        / 1e9, "unit": "GDoF/s", "tier": "separable+cuda (K2)",
        "n_dofs": 129**3, "ms_per_apply": ms["K2"],
        "plain_ms_per_apply": plain_ms["K2"], "device": kind,
        "nvidia_smi": smi}), flush=True)

    # K4 on the 17M coefficient operator and the 2.1M shell, K3 at 2D Q4
    # refine 10: the JAX bench's apply metrics of the terms tier
    def apply_line(metric, n_dofs, t, tier, **extra):
        print(json.dumps({
            "metric": metric, "value": n_dofs / (t * 1e-3) / 1e9,
            "unit": "GDoF/s", "tier": tier, "n_dofs": n_dofs,
            "ms_per_apply": t, "n_chain": N_CHAIN, **extra, "device": kind,
            "nvidia_smi": smi}), flush=True)

    rkc = mfc.resident
    xc = rkc.pad(torch.tensor(np.random.default_rng(13).standard_normal(
        mfc.n_dofs), dtype=torch.float32, device=dev))
    ms["K4"], plain_ms["K4"] = turns(rkc.raw, rkc.plain, xc)
    ms["K4_bf16s"] = chain_ms(mf16.resident.raw,
                               mf16.resident.pad(rkc.unpad(xc)))
    for tier, t in (("resident-terms-f32+cuda (K4)", ms["K4"]),
                    ("resident-terms-bf16s+cuda (K4)", ms["K4_bf16s"]),
                    ("plain-torch-f32", plain_ms["K4"])):
        apply_line("3d_q4_variable_coef_apply", mfc.n_dofs, t, tier)
    ks = ResidentTerms(129, 4, shell_terms, torch.float32, device=dev)
    xs = ks.pad(torch.tensor(np.random.default_rng(14).standard_normal(
        129**3), dtype=torch.float32, device=dev))
    ms["K4_shell"], plain_ms["K4_shell"] = turns(ks.raw, ks.plain, xs)
    apply_line("3d_shell_curved_apply", 129**3, ms["K4_shell"],
               "resident-terms-f32+cuda (K4)",
               plain_ms_per_apply=plain_ms["K4_shell"])
    # the ring's split (resident_ring.cuh): K1, K4 and the shell's K4 beside
    # their copy and bands ablations at the same sub-tile and shared memory,
    # each held to its plain version first (copy exactly), timed in turns:
    # the tile mover (copy), the z/y bands (bands - copy) and the x band
    # (apply - bands)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def split(name, rk, x, ablation, timer=chain_ms):
        """The apply beside its copy and bands ablations, in turns: (mover,
        z/y or y bands, x band) ms."""
        abl = {mode: ablation(mode) for mode in ("copy", "bands")}
        for mode, k in abl.items():
            y, yp = k.raw(x), k.plain(x)
            off = float((y - yp).abs().max() / yp.abs().max())
            if not (off <= (0.0 if mode == "copy" else 1e-5)
                    and torch.isfinite(y).all()):
                raise RuntimeError(f"{name} {mode} ablation is off its plain "
                                   f"version by {off:.3e}")
        t = [timer(fn, x) for fn in (
            abl["copy"].raw, abl["bands"].raw, rk.raw, rk.raw,
            abl["bands"].raw, abl["copy"].raw)]
        c, b, a = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
        tz, ty = rk.tile
        dim = 3 if tz > 1 or x.dim() == 3 else 2
        blocks = -(-rk.npts // ty) * (-(-rk.npts // tz) if dim == 3 else 1)
        seg = getattr(rk, "segments", None) or 1
        say("6 throughput", f"{name} at {rk.npts**dim} DoFs, sub-tile "
            f"{rk.tile} ({blocks * seg} blocks, {seg} segment(s) of x, on "
            f"{n_sm} SMs), in turns (copy, bands, apply, apply, bands, "
            f"copy): " + ", ".join(f"{v:.4f}" for v in t) + f" ms; split: "
            f"tile mover {c:.4f}, {'z/y' if dim == 3 else 'y'} bands "
            f"{b - c:.4f}, x band {a - b:.4f} ms")
        return c, b - c, a - b

    for name, rk, x, ablation in (
            ("K1", rk1, x17, lambda mode: ResidentSeparable(
                mf.npts, 4, *flagship_axes(4, 64, 3), torch.float32,
                mode=mode, device=dev, tile=rk1.tile)),
            ("K4", rkc, xc, lambda mode: ResidentTerms(
                mfc.npts, 4, coef64, torch.float32, mode=mode, device=dev,
                tile=rkc.tile)),
            ("K4 shell", ks, xs, lambda mode: ResidentTerms(
                129, 4, shell_terms, torch.float32, mode=mode, device=dev,
                tile=ks.tile))):
        split(name, rk, x, ablation)
    # the shell's K4 runs 289 blocks at (8, 8): at two an SM, a second wave
    # of 289 - 2 x SMs.  Held to its plain version and timed in turns at
    # (8, 8), (4, 8) and (4, 16); then T = 3 random banded terms at npts =
    # 121 (256 blocks at (8, 8), one wave) and 129, in turns
    tiles = ((8, 8), (4, 8), (4, 16))
    kt = {tile: ResidentTerms(129, 4, shell_terms, torch.float32, device=dev,
                              tile=tile) for tile in tiles}
    yp = ks.plain(xs)
    for tile, k in kt.items():
        off = float((k.raw(xs) - yp).abs().max() / yp.abs().max())
        if not off <= TOL["f32"]:
            raise RuntimeError(f"K4 shell at sub-tile {tile} is off its plain "
                               f"version by {off:.3e}")
    t = [chain_ms(kt[tile].raw, xs) for tile in tiles + tiles[::-1]]
    say("6 throughput", "K4 shell by sub-tile, in turns, ms: " + ", ".join(
        f"{tile} ({-(-129 // tile[0]) * -(-129 // tile[1])} blocks, "
        f"{kt[tile].smem} B a block) {t[i]:.4f} {t[-1 - i]:.4f}"
        for i, tile in enumerate(tiles)))
    rng6 = np.random.default_rng(16)
    kw = {}
    for npts in (121, 129):
        kw[npts] = ResidentTerms(npts, 4, [[random_banded(rng6, npts, 4)
                                            for _ in range(3)]
                                           for _ in range(3)],
                                 torch.float32, device=dev)
        kw[npts].x = kw[npts].pad(torch.tensor(
            rng6.standard_normal(npts**3), dtype=torch.float32, device=dev))
        y, yp = kw[npts].raw(kw[npts].x), kw[npts].plain(kw[npts].x)
        off = float((y - yp).abs().max() / yp.abs().max())
        if not off <= TOL["f32"]:
            raise RuntimeError(f"K4 T=3 at npts={npts} is off its plain "
                               f"version by {off:.3e}")
    t = [chain_ms(kw[n].raw, kw[n].x) for n in (121, 129, 129, 121)]
    say("6 throughput", "K4 T=3 random banded at sub-tile "
        f"{kw[121].tile}, in turns, ms: npts 121 ({(121 // -8)**2} blocks, "
        f"X {kw[121].X}) {t[0]:.4f} {t[3]:.4f}, npts 129 ({(129 // -8)**2} "
        f"blocks, X {kw[129].X}) {t[1]:.4f} {t[2]:.4f}; 121/129 "
        f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}")
    del kt, kw
    # K3 at 2D Q4 refine 10 (unmasked, as the tile routine before it was
    # timed) and at refine 8 with the fused mask, as the 2D resident CG
    # launches it (the kernels line's K3: there an apply is shorter than the
    # host's launch, so kernel and plain are timed by their device time under
    # torch.profiler); the 2D plan's split at both; K2 at 2D refine 10 and
    # 3D refine 6, each in turns with its plain version
    k3 = ResidentTerms2D(4097, 4, lap2d, torch.float32, device=dev)
    k3s = ResidentTerms2D(4097, 4, lap2d, torch.float32, mode="bf16s",
                          device=dev)
    u10 = torch.tensor(np.random.default_rng(15).standard_normal(4097**2),
                       dtype=torch.float32, device=dev)
    x10 = k3.pad(u10)
    ms["K3_r10"], plain_ms["K3_r10"] = turns(k3.raw, k3.plain, x10)
    ms["K3_bf16s"] = chain_ms(k3s.raw, k3s.pad(u10))
    for tier, t in (("resident-f32+cuda (K3, 2D)", ms["K3_r10"]),
                    ("resident-bf16s+cuda (K3, 2D)", ms["K3_bf16s"]),
                    ("plain-torch-f32", plain_ms["K3_r10"])):
        apply_line("apply_2d_resident", 4097**2, t, tier, degree=4,
                   refine=10)
    x8 = rk2.pad(torch.tensor(np.random.default_rng(18).standard_normal(
        1025**2), dtype=torch.float32, device=dev))
    say("6 throughput", "K3 at refine 8 by chains of 30 (host-bound): "
        "ms per apply in turns: plain {:.4f}, kernel {:.4f}, kernel {:.4f}, "
        "plain {:.4f}".format(*(chain_ms(f, x8) for f in (
            rk2.plain, rk2.raw, rk2.raw, rk2.plain))))
    ms["K3"], plain_ms["K3"] = turns(rk2.raw, rk2.plain, x8, device_ms)
    split("K3", k3, x10, lambda mode: ResidentTerms2D(
        4097, 4, lap2d, torch.float32, mode=mode, device=dev, tile=k3.tile))
    split("K3 refine 8 (fused mask; device time)", rk2, x8,
          lambda mode: ResidentTerms2D(1025, 4, lap2d_r8, torch.float32,
                                       mode=mode, device=dev, tile=rk2.tile),
          device_ms)
    k2_2d = KernelSeparable(2, 4097, 4, *flagship_axes(4, 1024, 2),
                            torch.float32, dev)
    ms["K2_2d"], plain_ms["K2_2d"] = turns(k2_2d, k2_2d.plain, u10)
    routine_turns("K2_2d", k2_2d, u10)
    k2_k3 = [chain_ms(k2_2d, u10), chain_ms(k3.raw, x10),
             chain_ms(k3.raw, x10), chain_ms(k2_2d, u10)]
    say("6 throughput", "2D Q4 refine 10 ms per apply in turns: K2 "
        "(z-march) {:.4f}, K3 {:.4f}, K3 {:.4f}, K2 {:.4f}".format(*k2_k3))
    del x10, u10
    k2r6 = KernelSeparable(3, 257, 4, *flagship_axes(4, 64, 3),
                           torch.float32, dev)
    u6 = torch.tensor(np.random.default_rng(20).standard_normal(257**3),
                      dtype=torch.float32, device=dev)
    ms["K2_r6"], plain_ms["K2_r6"] = turns(k2r6, k2r6.plain, u6)
    routine_turns("K2_r6", k2r6, u6)
    del u6
    # the flat GMG levels by chains and by device time, the tile routine
    # in turns with the march
    for dim, sizes in GMG_K2_NPTS.items():
        for npts in sizes:
            kl = KernelSeparable(dim, npts, 4,
                                 *flagship_axes(4, npts // 4, dim),
                                 torch.float32, dev)
            xl = torch.tensor(np.random.default_rng(npts).standard_normal(
                npts**dim), dtype=torch.float32, device=dev)
            routine_turns(f"K2 {dim}D {npts}", kl, xl)
            routine_turns(f"K2 {dim}D {npts}", kl, xl, device_ms)
    say("6 throughput", "K3 on the ring (fused mask at refine 8) and K2's "
        "z-march, ms per apply (earlier: K3 the routine of e3bfbab, "
        "resident_probe.py --applies on an H100 80GB HBM3 at 700 W; K2 "
        "its tile routine, in turns above): "
        + ", ".join(f"{k} {ms[k]:.4f} (earlier {earlier[k]:.4f}, "
                    f"{earlier[k] / ms[k]:.2f}x)"
                    for k in ("K3", "K3_r10", "K2", "K2_r6", "K2_2d")))

    # the L1 kernels (f32: 3xTF32) at the flagship: kernel_lab.main timed
    # each raw apply in turns with its plain version (phase 5); one
    # torch.matmul of the x-stage shape is their library call
    from tpufem_torch.lab.resident_lab import X_ALIGN

    lab = {name[:-len("-auto-raw")]: r for name, r in lab_results.items()
           if name.endswith("-auto-raw")}
    bound, design = {}, {}
    for name, r in lab.items():
        if name in KERNELS:
            ms[name], plain_ms[name] = r["ms"], r["plain_ms"]
        bound[name] = (r["bound_ms"], r["bound_by"])
        design[name] = r.get("design_ms")
    for v in L2V:
        r = lab[L2_TIMED.get(v, v)]
        ms[f"L2 {v}"], plain_ms[f"L2 {v}"] = r["ms"], r["plain_ms"]
        bound[f"L2 {v}"] = (r["bound_ms"], r["bound_by"])
    X = X_ALIGN * -(-257 // X_ALIGN)
    gen = torch.Generator(device=dev).manual_seed(5)
    A = torch.randn((257**2, 2 * X), generator=gen, device=dev)
    B = torch.randn((2 * X, X), generator=gen, device=dev)
    l1_xstage_ms = 1e3 * time_fn(lambda _: torch.matmul(A, B), A,
                                  reps=N_CHAIN)
    del A, B
    # L2a's x stage, as v2 runs it at the flagship: every tile's halo'd
    # (L, L) rows, nt = 11 tiles a side at b = 24, L = 32, times [Mx^T |
    # Kx^T]
    b2 = lab["v2-highest"]["b"]
    rows2 = (-(-257 // b2))**2 * (b2 + 8)**2
    A = torch.randn((rows2, X), generator=gen, device=dev)
    B = torch.randn((X, 2 * X), generator=gen, device=dev)
    l2_xstage_ms = 1e3 * time_fn(lambda _: torch.matmul(A, B), A,
                                  reps=N_CHAIN)
    del A, B
    # L2b's x stage: the (nt b)^2 rows of the output layout times [Kx^T;
    # Mx^T]
    rows3 = ((-(-257 // lab["v15"]["b"])) * lab["v15"]["b"])**2
    A = torch.randn((rows3, 2 * X), generator=gen, device=dev)
    B = torch.randn((2 * X, X), generator=gen, device=dev)
    zy_xstage_ms = 1e3 * time_fn(lambda _: torch.matmul(A, B), A,
                                  reps=N_CHAIN)
    del A, B
    say("6 throughput", "L1, L2 and K1 at 16,974,593 DoFs (kernel_lab.main)"
        ", ms per raw apply (plain ms; bound ms; design bound ms): "
        + ", ".join(
            f"{name} {r['ms']:.4f} ({r['plain_ms']:.4f}; "
            f"{bound[name][0]:.4f} {bound[name][1]}"
            + (f"; {design[name]:.4f}" if design[name] is not None else "")
            + ")" for name, r in lab.items())
        + f"; note, the x stages alone as one torch.matmul in f32 (not the "
        f"kernels' function): ({257**2}, {2 * X}) x ({2 * X}, {X}) "
        f"{l1_xstage_ms:.4f} (L1); ({rows2}, {X}) x ({X}, {2 * X}) "
        f"{l2_xstage_ms:.4f} (L2a); ({rows3}, {2 * X}) x ({2 * X}, {X}) "
        f"{zy_xstage_ms:.4f} (L2b)")

    # v17 and v19: the ring routine and the tile routine (their earlier schedule) in
    # turns at the flagship in each precision (earlier, ring, ring,
    # earlier), beside the ring's design bound and what it moves from L2
    from tpufem_torch.lab.resident_lab import RING_KERNELS

    def raw_ms(k, gp):
        return 1e3 * time_fn(lambda _: k.raw(gp), gp, reps=N_CHAIN)

    for kern in RING_KERNELS:
        for mode in ("f32", "f32h", "bf16", "f64"):
            kr = lab_kernel(kern, mode, 257, 4, 64, [1.0 / 64] * 3)
            kt = lab_kernel(kern, mode, 257, 4, 64, [1.0 / 64] * 3,
                            routine="tile")
            gp = kr.pad(u257.to(kr.dt))
            t = [raw_ms(k, gp) for k in (kt, kr, kr, kt)]
            say("6 throughput", f"{kern} {mode} at the flagship, ms per raw "
                f"apply in turns: earlier {t[0]:.4f}, ring {t[1]:.4f}, ring "
                f"{t[2]:.4f}, earlier {t[3]:.4f}; ring / earlier "
                f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}; the ring's design "
                f"bound {kr.design_bound()[0]:.4f} ms "
                f"({kr.design_bound()[1]}), {kr.l2_bytes() / 1e9:.3f} GB "
                f"from L2 an apply (sub-tile {kr.tile}, rings {kr.ring}, "
                f"grid {kr.grid}, {kr.smem} B a block)")
            del gp
    say("6 throughput", f"v20 (windowed wgmma x stage) beside the CUDA-core "
        f"x band, ms per apply in this run: v20 {ms['v20']:.4f} "
        f"(kernel_lab.main, 3xTF32), K1 {ms['K1']:.4f} (K1's ring, its x "
        f"band on CUDA cores, with its fused mask), v16 {ms['L2 v16']:.4f} "
        f"(L2b's all-band schedule); v20 / K1 {ms['v20'] / ms['K1']:.3f}, "
        f"v20 / v16 {ms['v20'] / ms['L2 v16']:.3f}")
    # v15 on L1's persistent ring routine (its default in f32 storage; in
    # f64 lab_ring_kernel, "ring"), in turns with its earlier schedule
    # (zy_kernel: earlier, pipe, pipe, earlier) and with the other ring
    # routine (ring, pipe, pipe, ring) in each precision
    from tpufem_torch.ops.separable import global_1d_matrices

    K1l, M1l = global_1d_matrices(4, 64, 5)
    for mode, (dt, prec) in L2_MODES.items():
        ks = {r: LabKernel("v15", 257, 4, K1l, M1l, [1.0 / 64] * 3,
                           prec=prec, dtype=dt, device="cuda", routine=r)
              for r in ("tile", "pipe", "ring")}
        gp = ks["pipe"].pad(u257.to(dt))
        t = [raw_ms(ks[r], gp) for r in ("tile", "pipe", "pipe", "tile")]
        t2 = [raw_ms(ks[r], gp) for r in ("ring", "pipe", "pipe", "ring")]
        k = ks["pipe"]
        say("6 throughput", f"v15 {mode} at the flagship, ms per raw apply "
            f"in turns: earlier {t[0]:.4f}, pipe {t[1]:.4f}, pipe "
            f"{t[2]:.4f}, earlier {t[3]:.4f} (pipe / earlier "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); ring {t2[0]:.4f}, pipe "
            f"{t2[1]:.4f}, pipe {t2[2]:.4f}, ring {t2[3]:.4f} (pipe / ring "
            f"{(t2[1] + t2[2]) / (t2[0] + t2[3]):.3f}); the pipe's design "
            f"bound {k.design_bound()[0]:.4f} ms ({k.design_bound()[1]}), "
            f"{k.l2_bytes() / 1e9:.3f} GB from L2 an apply (sub-tile "
            f"{k.tile}, rings {k.ring}, grid {k.grid}, {k.smem} B a block; "
            f"ring: grid {ks['ring'].grid}, {ks['ring'].smem} B)")
        del gp, ks
    # v13 on lab_ring_kernel (its default in every precision), in turns
    # with its earlier schedule (zy_kernel: earlier, ring, ring, earlier)
    # and with v15 on the same routine (v15, v13, v13, v15)
    for mode, (dt, prec) in L2_MODES.items():
        ks = {(v, r): LabKernel(v, 257, 4, K1l, M1l, [1.0 / 64] * 3,
                                prec=prec, dtype=dt, device="cuda",
                                routine=r)
              for v, r in (("v13", "tile"), ("v13", "ring"), ("v15", "ring"))}
        k = ks["v13", "ring"]
        gp = k.pad(u257.to(dt))
        t = [raw_ms(ks[key], gp) for key in (
            ("v13", "tile"), ("v13", "ring"), ("v13", "ring"),
            ("v13", "tile"))]
        t2 = [raw_ms(ks[key], gp) for key in (
            ("v15", "ring"), ("v13", "ring"), ("v13", "ring"),
            ("v15", "ring"))]
        say("6 throughput", f"v13 {mode} at the flagship, ms per raw apply "
            f"in turns: earlier {t[0]:.4f}, ring {t[1]:.4f}, ring "
            f"{t[2]:.4f}, earlier {t[3]:.4f} (ring / earlier "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); v15 on the ring "
            f"{t2[0]:.4f}, v13 {t2[1]:.4f}, v13 {t2[2]:.4f}, v15 "
            f"{t2[3]:.4f} (v13 / v15 {(t2[1] + t2[2]) / (t2[0] + t2[3]):.3f})"
            f"; the ring's design bound {k.design_bound()[0]:.4f} ms "
            f"({k.design_bound()[1]}), {k.l2_bytes() / 1e9:.3f} GB from L2 "
            f"an apply (sub-tile {k.tile}, rings {k.ring}, grid {k.grid}, "
            f"{k.smem} B a block)")
        del gp, ks
    # v3 on its ring (l2_bx_kernel, its default), in turns with its earlier
    # schedule (l2_kernel: earlier, ring, ring, earlier) in each precision,
    # each on its own layout (b = 16 and the tile chooser's b) of the same
    # input, beside the ring's design bound and what it moves from L2
    for mode, (dt, prec) in L2_MODES.items():
        kr, kt = (LabKernel("v3", 257, 4, K1l, M1l, [1.0 / 64] * 3,
                            prec=prec, dtype=dt, device="cuda", routine=r)
                  for r in ("ring", "tile"))
        gr, gt = kr.pad(u257.to(dt)), kt.pad(u257.to(dt))
        t = [raw_ms(k, g) for k, g in ((kt, gt), (kr, gr), (kr, gr),
                                       (kt, gt))]
        say("6 throughput", f"v3 {mode} at the flagship, ms per raw apply in "
            f"turns: earlier {t[0]:.4f}, ring {t[1]:.4f}, ring {t[2]:.4f}, "
            f"earlier {t[3]:.4f} (ring / earlier "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); the ring's design bound "
            f"{kr.design_bound()[0]:.4f} ms ({kr.design_bound()[1]}), "
            f"{kr.l2_bytes() / 1e9:.3f} GB from L2 an apply (b={kr.b}, u "
            f"slots {kr.ring[0]}, {kr.grid} blocks, {kr.smem} B a block); "
            f"earlier: b={kt.b}, design bound {kt.design_bound()[0]:.4f} ms "
            f"({kt.design_bound()[1]}), {kt.l2_bytes() / 1e9:.3f} GB")
        del gr, gt, kr, kt
    # vxy on its ring (l2_bxy_kernel, its default), in turns with its
    # earlier schedule (l2_kernel: earlier, ring, ring, earlier; b = 16 and
    # the tile chooser's b) and with vx, the x stage alone (vx, ring, ring,
    # vx; l2_x_kernel at its own b), in each precision, beside the ring's
    # design bound and what it moves from L2
    for mode, (dt, prec) in L2_MODES.items():
        kr, kt, kx = (LabKernel(v, 257, 4, K1l, M1l, [1.0 / 64] * 3,
                                prec=prec, dtype=dt, device="cuda",
                                routine=r)
                      for v, r in (("vxy", "ring"), ("vxy", "tile"),
                                   ("vx", None)))
        gr, gt, gx = (k.pad(u257.to(dt)) for k in (kr, kt, kx))
        t = [raw_ms(k, g) for k, g in ((kt, gt), (kr, gr), (kr, gr),
                                       (kt, gt))]
        tx = [raw_ms(k, g) for k, g in ((kx, gx), (kr, gr), (kr, gr),
                                        (kx, gx))]
        say("6 throughput", f"vxy {mode} at the flagship, ms per raw apply "
            f"in turns: earlier {t[0]:.4f}, ring {t[1]:.4f}, ring "
            f"{t[2]:.4f}, earlier {t[3]:.4f} (ring / earlier "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); vx {tx[0]:.4f}, ring "
            f"{tx[1]:.4f}, ring {tx[2]:.4f}, vx {tx[3]:.4f} (ring / vx "
            f"{(tx[1] + tx[2]) / (tx[0] + tx[3]):.3f}); the ring's design "
            f"bound {kr.design_bound()[0]:.4f} ms ({kr.design_bound()[1]}),"
            f" {kr.l2_bytes() / 1e9:.3f} GB from L2 an apply (b={kr.b}, "
            f"{kr.grid} blocks, {kr.smem} B a block); earlier: b={kt.b}, "
            f"design bound {kt.design_bound()[0]:.4f} ms "
            f"({kt.design_bound()[1]}), {kt.l2_bytes() / 1e9:.3f} GB; vx: "
            f"b={kx.b}, {kx.l2_bytes() / 1e9:.3f} GB")
        del gr, gt, gx, kr, kt, kx
    # v2, v8 and v9 (bf16x3) on v2's ring (l2_bxyz_kernel, their default)
    # and v12 on its own (l2_bxyzb_kernel), in turns with their earlier
    # schedule (l2_kernel: earlier, ring, ring, earlier; b = 16 and the
    # tile chooser's b, v8's with its transposed staging) in each
    # precision, beside the ring's z segment, grid, shared memory (v12: its
    # z window's place), design bound and what it moves from L2
    for v in ("v2", "v8", "v12", "v9"):
        for mode, (dt, prec) in L2_MODES.items():
            if mode not in l2_modes(v):
                continue
            kr, kt = (LabKernel(v, 257, 4, K1l, M1l, [1.0 / 64] * 3,
                                prec=prec, dtype=dt, device="cuda",
                                routine=r) for r in ("ring", "tile"))
            gr, gt = kr.pad(u257.to(dt)), kt.pad(u257.to(dt))
            t = [raw_ms(k, g) for k, g in ((kt, gt), (kr, gr), (kr, gr),
                                           (kt, gt))]
            say("6 throughput", f"{v} {mode} at the flagship, ms per raw "
                f"apply in turns: earlier {t[0]:.4f}, ring {t[1]:.4f}, ring "
                f"{t[2]:.4f}, earlier {t[3]:.4f} (ring / earlier "
                f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); the ring's design "
                f"bound {kr.design_bound()[0]:.4f} ms "
                f"({kr.design_bound()[1]}), {kr.l2_bytes() / 1e9:.3f} GB "
                f"from L2 an apply (b={kr.b}, seg={kr.seg}, {kr.grid} "
                f"blocks, {kr.smem} B a block"
                + (f", window in {kr.window}" if kr.window else "")
                + f"); earlier: b={kt.b}, design "
                f"bound {kt.design_bound()[0]:.4f} ms "
                f"({kt.design_bound()[1]}), {kt.l2_bytes() / 1e9:.3f} GB")
            del gr, gt, kr, kt
    # v14 on its default ring routine (the persistent one; f64:
    # lab_ring_kernel), in turns with its earlier schedule (zy_kernel:
    # earlier, ring, ring, earlier) and with v15 on the same routine (v15,
    # v14, v14, v15) in each precision
    for mode, (dt, prec) in L2_MODES.items():
        r = default_routine("v14", dt)
        ks = {(v, rr): LabKernel(v, 257, 4, K1l, M1l, [1.0 / 64] * 3,
                                 prec=prec, dtype=dt, device="cuda",
                                 routine=rr)
              for v, rr in (("v14", "tile"), ("v14", r), ("v15", r))}
        k = ks["v14", r]
        gp = k.pad(u257.to(dt))
        t = [raw_ms(ks[key], gp) for key in (
            ("v14", "tile"), ("v14", r), ("v14", r), ("v14", "tile"))]
        t2 = [raw_ms(ks[key], gp) for key in (
            ("v15", r), ("v14", r), ("v14", r), ("v15", r))]
        say("6 throughput", f"v14 {mode} at the flagship, ms per raw apply "
            f"in turns: earlier {t[0]:.4f}, {r} {t[1]:.4f}, {r} "
            f"{t[2]:.4f}, earlier {t[3]:.4f} ({r} / earlier "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); v15 on the {r} "
            f"{t2[0]:.4f}, v14 {t2[1]:.4f}, v14 {t2[2]:.4f}, v15 "
            f"{t2[3]:.4f} (v14 / v15 {(t2[1] + t2[2]) / (t2[0] + t2[3]):.3f})"
            f"; the {r}'s design bound {k.design_bound()[0]:.4f} ms "
            f"({k.design_bound()[1]}), {k.l2_bytes() / 1e9:.3f} GB from L2 "
            f"an apply (sub-tile {k.tile}, rings {k.ring}, grid {k.grid}, "
            f"{k.smem} B a block)")
        del gp, ks
    # the ring's mm ablation (qq = [u | u]: out = [u | u] @ [Kx^T; Mx^T])
    # beside one strict-f32 torch.matmul of the layout's data rows, timed
    # only: the port never calls it
    km = {kern: lab_kernel(kern, "mm", 257, 4, 64, [1.0 / 64] * 3)
          for kern in RING_KERNELS}
    gp = km["v17"].pad(u257.to(torch.float32))
    rows = gp[4:261, 4:261].reshape(257**2, km["v17"].X)
    A = torch.cat([rows, rows], 1).contiguous()
    B = km["v17"].xk
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yl = torch.matmul(A, B)
        for kern, k in km.items():
            yk = k.raw(gp)[4:261, 4:261].reshape(257**2, k.X)
            off = float((yk - yl).abs().max() / yl.abs().max())
            if not off <= 1e-5:
                raise RuntimeError(f"{kern} mm is off the f32 matmul by "
                                   f"{off:.3e}")
        t = [1e3 * time_fn(lambda _: torch.matmul(A, B), A, reps=N_CHAIN)]
        t += [raw_ms(km[kern], gp) for kern in ("v17", "v19", "v19", "v17")]
        t += [1e3 * time_fn(lambda _: torch.matmul(A, B), A, reps=N_CHAIN)]
        t20 = [raw_ms(km["v20"], gp) for _ in range(2)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    say("6 throughput", f"the ring's mm ablation at the flagship beside one "
        f"strict-f32 torch.matmul ({257**2}, {2 * B.shape[1]}) x "
        f"({B.shape[0]}, {B.shape[1]}) of the same product (3xTF32 off it "
        f"by <= 1e-5), ms in turns: matmul {t[0]:.4f}, v17 {t[1]:.4f}, v19 "
        f"{t[2]:.4f}, v19 {t[3]:.4f}, v17 {t[4]:.4f}, matmul {t[5]:.4f}; "
        f"v17 / matmul {(t[1] + t[4]) / (t[0] + t[5]):.2f}, v19 / matmul "
        f"{(t[2] + t[3]) / (t[0] + t[5]):.2f}; v20's windowed mm "
        f"{t20[0]:.4f}, {t20[1]:.4f}")
    del A, B, gp, rows, yl, km

    # vcopy's function (the input layout's inner (nt b)^2 rows, made
    # contiguous) and vx's ((Mx + Kx) along x of its first (nt b)^2 rows: one
    # product) are each one PyTorch call: their library_ms, each call held
    # to the kernel first.  The port calls neither.  Every other L1 and L2
    # row sums several Kronecker applies, which no single call computes
    K1f, M1f = global_1d_matrices(4, 64, 5)
    l2_library_ms = {}
    kc = LabKernel("vcopy", 257, 4, K1f, M1f, [1.0 / 64] * 3,
                   b=lab["vcopy"]["b"], device="cuda")
    kx = LabKernel("vx", 257, 4, K1f, M1f, [1.0 / 64] * 3,
                   b=lab["vx"]["b"], device="cuda")
    wx = torch.zeros((kx.X, kx.X), device=dev)
    wx[:257, :257] = torch.tensor((kx.Ms[0] + kx.Ks[0]).T, device=dev)
    ntc, ntx = kc.nt * kc.b, kx.nt * kx.b
    library = {
        "vcopy": (kc, lambda g: g[4:4 + ntc, 4:4 + ntc].contiguous(), 0.0),
        "vx": (kx, lambda g: torch.matmul(g[:ntx, :ntx], wx), 2e-6)}
    for v, (k, call, tol) in library.items():
        gp = k.pad(u257.to(torch.float32))
        y, yl = k.raw(gp), call(gp)
        off = float((y - yl).abs().max() / y.abs().max())
        if not (yl.shape == y.shape and yl.is_contiguous() and off <= tol):
            raise RuntimeError(f"{v}: the one-call equivalent is off the "
                               f"kernel by {off:.3e} > {tol}")
        t = [chain_ms(fn, gp) for fn in (
            lambda _: call(gp), lambda _: k.raw(gp), lambda _: k.raw(gp),
            lambda _: call(gp))]
        l2_library_ms[v] = (t[0] + t[3]) / 2
        say("6 throughput", f"{v} at the flagship, one PyTorch call of the "
            f"same function (off the kernel by {off:.3e}, tol {tol}) and the "
            f"kernel in turns, ms: call {t[0]:.4f}, kernel {t[1]:.4f}, kernel "
            f"{t[2]:.4f}, call {t[3]:.4f}; kernel / call "
            f"{(t[1] + t[2]) / (t[0] + t[3]):.2f}; the design moves "
            f"{k.l2_bytes() / 1e9:.3f} GB from L2 into shared memory an apply "
            f"(b={k.b}" + (f", sub-tile {k.tile}" if k.tile else "")
            + f", {k.smem} B a block)")
        del gp, y, yl
    # vx with shared memory sized by its flags and nothing else changed: the
    # first version's x stage (per-warp jobs, B from device memory) at the
    # ring's occupancy, in turns with the ring
    kj = LabKernel("vx", 257, 4, K1f, M1f, [1.0 / 64] * 3, b=kx.b,
                   device="cuda", x_jobs=True)
    gp = kx.pad(u257.to(torch.float32))
    off = float((kj.raw(gp) - kx.raw(gp)).abs().max() / kx.raw(gp).abs().max())
    if not off <= 2e-6:
        raise RuntimeError(f"vx by per-warp jobs is off the ring by {off:.3e}")
    t = [chain_ms(fn, gp) for fn in (
        lambda _: kj.raw(gp), lambda _: kx.raw(gp), lambda _: kx.raw(gp),
        lambda _: kj.raw(gp))]
    say("6 throughput", f"vx at the flagship, step 1 alone (the first "
        f"version's x stage, shared memory by flags: {kj.smem} B a block "
        f"against its 184,320) and the ring ({kx.smem} B) in turns, ms: jobs "
        f"{t[0]:.4f}, ring {t[1]:.4f}, ring {t[2]:.4f}, jobs {t[3]:.4f} (off "
        f"each other by {off:.3e})")
    del gp

    # the bound of K1-K4: each point read and written once in f32, and 2p+1
    # multiply-adds per band output (K1/K2 7 bands a point, K4 3 terms x 3,
    # K3 2 terms x 2), at the card's peaks
    def band_bound(n_dofs, bands, p=4):
        return roofline_ms(2 * 4 * n_dofs,
                           {"fp32": bands * 2 * (2 * p + 1) * n_dofs})

    bound.update(K2=band_bound(129**3, 7), K1=band_bound(mf.n_dofs, 7),
                 K4=band_bound(mfc.n_dofs, 9), K4_shell=band_bound(129**3, 9),
                 K3=band_bound(1025**2, 4), K3_r10=band_bound(4097**2, 4),
                 K2_r6=band_bound(257**3, 7), K2_2d=band_bound(4097**2, 4))
    # the design bound of K1's and K4's resident layout: each point of
    # (npts, npts, X) read and written once
    design_bound = {key: roofline_ms(2 * 4 * r.npts**2 * r.X, {})[0]
                    for key, r in (("K1", rk1), ("K4", rkc))}
    say("6 throughput", "design bound ms of the padded resident layout "
        f"{(rk1.npts, rk1.npts, rk1.X)} f32: " + ", ".join(
            f"{k} {v:.5f}" for k, v in design_bound.items()))
    say("6 throughput", "K1 and K4 on the TMA ring, ms per apply (earlier, "
        "on the tile routines, an H100 80GB HBM3 at 700 W): " + ", ".join(
            f"{k} {ms[k]:.4f} (earlier {earlier[k]:.4f}, "
            f"{earlier[k] / ms[k]:.2f}x)"
            for k in ("K1", "K1_bf16s", "K4", "K4_bf16s", "K4_shell")))
    say("6 throughput", "bound ms on an H100: " + ", ".join(
        f"{name} {bound[name][0]:.5f} ({bound[name][1]})"
        for name in ("K2", "K2_r6", "K2_2d", "K1", "K4", "K4_shell", "K3",
                     "K3_r10")))

    marks.append(("7", time.perf_counter()))
    # ---- 7 the toolchain probes: each kernel against its plain version,
    # then the probes' entry point with the counts reset before and read
    # after
    from tpufem_torch.lab import separable_lab
    from tpufem_torch.lab import toolchain_probe as tprobe

    P1_CASES = tprobe.P1_ROUTINES  # the wgmma tile, the earlier routine

    def rel_max(y, ref):
        return float((y.to(torch.float64) - ref.to(torch.float64)).abs().max()
                     / ref.abs().max())

    gen_c = torch.Generator().manual_seed(21)
    pa, pb = (torch.randn((256, 256), generator=gen_c).to(dev)
              for _ in range(2))
    pq, pr = (torch.randn((P1_PARTIAL, P1_PARTIAL), generator=gen_c).to(dev)
              for _ in range(2))
    pl, pm = (torch.randn((P1_LARGE, P1_LARGE), generator=gen_c).to(dev)
              for _ in range(2))
    p_ref = pa.double() @ pb.double()
    refs = {256: p_ref, P1_PARTIAL: pq.double() @ pr.double(),
            P1_LARGE: pl.double() @ pm.double()}
    # P1 on each routine in every arithmetic, at the probe's n = 256 and at
    # a partial-tile n (the wgmma tile also at P1_LARGE): within its class
    # of the f64 product, the wgmma tile within the smaller of EMU_TOL and
    # P1_PLAIN_TOL of the plain version in its arithmetic (the earlier
    # routine's distance printed: its one accumulator's truncating f32 sums
    # put 3xTF32 above EMU_TOL), ones @ ones exactly n, one launch a call
    for arithmetic in tprobe.ARITHMETICS:
        plain_tol = min(separable_lab.EMU_TOL[separable_lab.PRECS[arithmetic]],
                        tprobe.P1_PLAIN_TOL)
        outs = {}
        for routine in P1_CASES:
            pairs = ((pa, pb), (pq, pr)) + (
                ((pl, pm),) if routine == "wgmma" else ())
            for x, y in pairs:
                n = x.shape[0]
                ref = refs[n]
                before = tprobe.launches["P1"]
                c = tprobe.matmul(x, y, arithmetic, routine)
                ones = torch.ones((n, n), device=dev)
                exact = torch.equal(tprobe.matmul(ones, ones, arithmetic,
                                                  routine),
                                    torch.full_like(ones, float(n)))
                rose = tprobe.launches["P1"] == before + 2
                torch.cuda.synchronize()
                rel = rel_max(c, ref)
                apart = float((c - tprobe.matmul_plain(x, y, arithmetic))
                              .abs().max() / ref.abs().max())
                held = routine == "earlier" or apart <= plain_tol
                say("7 probes", f"P1 {routine} {arithmetic} n={n}: max rel "
                    f"err {rel:.3e} (class {tprobe.P1_TOL[arithmetic]}), off "
                    f"its arithmetic in plain PyTorch by {apart:.3e} (bound "
                    f"{plain_tol}{'' if routine == 'wgmma' else ', printed'}"
                    f"), ones @ ones == {n}: {exact}, launches +2: {rose}")
                if not (rose and exact and held
                        and rel <= tprobe.P1_TOL[arithmetic]):
                    raise RuntimeError(f"P1 {routine} {arithmetic} n={n} "
                                       f"failed its checks")
                if n == 256:
                    outs[routine] = c
                    if routine == "wgmma" and arithmetic == "bf16x3":
                        abs_err["P1"] = float((c.double() - ref).abs().max())
        say("7 probes", f"P1 {arithmetic} n=256: the wgmma tile against the "
            "earlier routine, max |difference| / max |c|: " + format(float(
                (outs["wgmma"] - outs["earlier"]).abs().max()
                / p_ref.abs().max()), ".3e"))
    ca = torch.full((PROBE_M, PROBE_M), 1e-3, device=dev)
    cw = torch.eye(PROBE_M, device=dev) * 0.999
    cv = torch.ones((PROBE_M, PROBE_M), device=dev)
    # a seeded dense input; w orthogonal (Q of a seeded normal matrix), so a
    # chain of any depth keeps its norm and amplifies no rounding
    gen_c.manual_seed(22)
    ra, rw, rv = (torch.randn((PROBE_M, PROBE_M), generator=gen_c)
                  for _ in range(3))
    rw = torch.linalg.qr(rw.double())[0].float().contiguous()
    ra, rw, rv = ra.to(dev), rw.to(dev), rv.to(dev)
    dense64 = {n_it: tprobe.chain_plain("both", ra.double(), rw.double(),
                                        rv.double(), n_it)
               for n_it in P2_DENSE_ITERS}
    # every check on each routine the arithmetic takes at m = 512: the
    # cluster chain (the default where the table gives it) and the earlier
    # routine
    def p2_routines(arithmetic):
        return tuple(dict.fromkeys((tprobe.chain_routine(arithmetic, PROBE_M),
                                    "earlier")))

    # the seeded dense input (a, w, v), the product chain alone and beside
    # the multiply-adds, at 8 products and at the probe's 256: against the
    # plain version in the same arithmetic and against the exact f64 chain
    # (a kernel that skipped its products would read above 1)
    def p2_dense(arithmetic, routine, dense, dense64):
        ra, rw, rv = dense
        m = ra.shape[0]
        for n_it, tol, fma_tol in zip(P2_DENSE_ITERS,
                                      P2_DENSE_TOL[arithmetic],
                                      P2_DENSE_FMA_TOL):
            o64, vo64 = dense64[n_it]
            oe, _ = tprobe.chain_plain("mma", ra, rw, rv, n_it,
                                       arithmetic=arithmetic)
            for mode in ("mma", "both"):
                o, vo = tprobe.chain(mode, ra, rw, rv, n_it,
                                     arithmetic=arithmetic, routine=routine)
                torch.cuda.synchronize()
                apart, o_err = rel_max(o, oe), rel_max(o, o64)
                vo_err = (rel_max(vo, vo64) if mode == "both"
                          else 0.0 if torch.equal(vo, rv) else float("inf"))
                say("7 probes", f"P2 {routine} {mode} {arithmetic} ({n_it}, "
                    f"{m}) "
                    f"on a seeded dense input: o off its plain version in "
                    f"the same arithmetic by {apart:.3e}, off the f64 chain "
                    f"by {o_err:.3e} (tol {tol:.1e} each; the plain version "
                    f"itself {rel_max(oe, o64):.3e}), vo {vo_err:.3e} (tol "
                    f"{fma_tol})")
                if not (apart <= tol and o_err <= tol
                        and vo_err <= fma_tol):
                    raise RuntimeError(f"P2 {routine} {mode} {arithmetic} "
                                       f"on the seeded dense input at "
                                       f"({n_it}, {m}) failed its checks")

    for arithmetic, routine in ((x, r) for x in tprobe.ARITHMETICS
                                for r in p2_routines(x)):
        o_ref, _ = tprobe.chain_plain("mma", ca, cw, cv, PROBE_N_ITER,
                                      arithmetic=arithmetic)
        _, vo_ref = tprobe.chain_plain("fma", ca.double(), cw.double(),
                                       cv.double(), PROBE_N_ITER)
        o_exact = 1e-3 * 0.999**PROBE_N_ITER
        for mode in tprobe.MODES:
            before = tprobe.launches[f"P2 {mode}"]
            o, vo = tprobe.chain(mode, ca, cw, cv, PROBE_N_ITER,
                                 arithmetic=arithmetic, routine=routine)
            rose = tprobe.launches[f"P2 {mode}"] == before + 1
            torch.cuda.synchronize()
            o_err = 0.0 if mode == "fma" else rel_max(o, o_ref)
            vo_err = 0.0 if mode == "mma" else rel_max(vo, vo_ref)
            through = (torch.equal(o, ca) if mode == "fma" else
                       torch.equal(vo, cv) if mode == "mma" else True)
            if arithmetic == "default" and mode == "both" and \
                    routine == "cluster":
                abs_err["P2"] = max(float((o - o_ref).abs().max()), float(
                    (vo.double() - vo_ref).abs().max()))
            say("7 probes", f"P2 {routine} {mode} {arithmetic} "
                f"({PROBE_N_ITER}, "
                f"{PROBE_M}): o off its plain version by {o_err:.3e} (tol "
                f"{P2_TOL[arithmetic]})"
                + ("" if mode == "fma" else f", o[0, 0] / (1e-3 0.999^n_iter)"
                   f" = {float(o[0, 0]) / o_exact:.6f}")
                + f", vo off the f64 chain by "
                f"{vo_err:.3e} (tol {P2_FMA_TOL}), other stream copied "
                f"through: {through}")
            if not (rose and through and o_err <= P2_TOL[arithmetic]
                    and vo_err <= P2_FMA_TOL):
                raise RuntimeError(f"P2 {routine} {mode} {arithmetic} "
                                   f"failed its checks")
        p2_dense(arithmetic, routine, (ra, rw, rv), dense64)
    # the cluster chain's plans at the smaller m that the table sends to it
    # (C = 2 and 4, one and two stripe buffers, one and two n32 tiles a
    # block; 3xTF32 up to m = 256): the seeded dense checks at each
    for m in (m for m in tprobe.CLUSTER_MS if m < PROBE_M):
        gen_c.manual_seed(22 + m)
        dense = [torch.randn((m, m), generator=gen_c) for _ in range(3)]
        dense[1] = torch.linalg.qr(dense[1].double())[0].float()
        dense = [t.contiguous().to(dev) for t in dense]
        m64 = {n_it: tprobe.chain_plain("both", *(t.double() for t in dense),
                                        n_it)
               for n_it in P2_DENSE_ITERS}
        for arithmetic in tprobe.ARITHMETICS:
            if tprobe.chain_routine(arithmetic, m) != "cluster":
                continue
            plan = tprobe.chain_plan(arithmetic, m, "cluster",
                                     dense[0].device.index)
            say("7 probes", f"P2 cluster {arithmetic} at m = {m}: C "
                f"{plan['cluster']}, {plan['nbuf']} stripe buffers, "
                f"{m // (32 * plan['cluster'])} n32 tiles a block, "
                f"{plan['active_clusters']} clusters active, {plan['smem']} "
                "B a block")
            p2_dense(arithmetic, "cluster", dense, m64)
    # P2's function (both): a, w, v read, o and vo written; n_iter products
    # in each pass of the arithmetic on the whole card and 4 n_iter
    # multiply-adds a value
    bound_p2 = {x: roofline_ms(5 * 4 * PROBE_M**2, {
        "tf32" if x in ("highest", "high") else "bf16":
        (3 if x in ("highest", "bf16x3") else 1) * 2.0 * PROBE_N_ITER
        * PROBE_M**3, "fp32": 2.0 * 4 * PROBE_N_ITER * PROBE_M**2})
        for x in tprobe.ARITHMETICS}
    # the two routines in turns (earlier, cluster, cluster, earlier) in
    # each arithmetic the cluster chain takes at (256, 512), each probe
    # timing its three modes, beside its plan and design bound
    def p2_line(rec):
        return (f"{rec['routine']} mma {rec['t_mxu_ms']:.4f} fma "
                f"{rec['t_vpu_ms']:.4f} both {rec['t_both_ms']:.4f} ms "
                f"(overlap {rec['overlap_fraction']:.3f}, "
                f"{rec['us_per_product']:.3f} us a product; C "
                f"{rec['cluster']}, {rec['nbuf']} stripe buffers, "
                f"{rec['blocks']} blocks on {rec['sms']} SMs in "
                f"{rec['waves']} waves, {rec['active_clusters']} clusters "
                f"active, {rec['smem']} B a block; design bound "
                f"{rec['design_bound_ms']:.4f} ms "
                f"({rec['design_bound_by']}))")

    for arithmetic in tprobe.ARITHMETICS:
        if tprobe.chain_routine(arithmetic, PROBE_M) != "cluster":
            continue
        recs = [tprobe.probe_co_scheduling(arithmetic=arithmetic, routine=r,
                                           device=dev)
                for r in ("earlier", "cluster", "cluster", "earlier")]
        say("7 probes", f"P2 {arithmetic} at ({PROBE_N_ITER}, {PROBE_M}) "
            f"in turns: " + "; ".join(p2_line(r) for r in recs)
            + f"; the function's bound {bound_p2[arithmetic][0]:.4f} ms "
            f"({bound_p2[arithmetic][1]})")
    for key in tprobe.launches:
        tprobe.launches[key] = 0
    probe_out = tprobe.main()
    launches["P1"] = tprobe.launches["P1"]
    launches["P2"] = tprobe.launches["P2 both"]
    say("7 probes", f"toolchain_probe.main: launches {tprobe.launches}")
    if not all(n > 0 for n in tprobe.launches.values()):
        raise RuntimeError(f"a probe kernel of the probes' main path did "
                           f"not run: {tprobe.launches}")
    co = {r["probe"]: r for r in probe_out}["vpu_mxu_co_scheduling"]
    bal = co["balanced"]
    ms["P2"] = co["t_both_ms"]
    say("7 probes", f"P2 at ({co['n_iter']}, {co['m']}), {co['arithmetic']}, "
        f"{co['fma_per_product']} FMAs a product: mma {co['t_mxu_ms']:.4f} "
        f"ms, fma {co['t_vpu_ms']:.4f} ms, both {co['t_both_ms']:.4f} ms, "
        f"overlap {co['overlap_fraction']:.3f}; balanced at "
        f"{bal['fma_per_product']} FMAs a product: mma "
        f"{bal['t_mxu_ms']:.4f}, fma {bal['t_vpu_ms']:.4f},"
        f" both {bal['t_both_ms']:.4f} ms, overlap "
        f"{bal['overlap_fraction']:.3f} ({co['routine']} routine: C "
        f"{co['cluster']}, {co['blocks']} blocks on {co['sms']} SMs in "
        f"{co['waves']} waves, {co['active_clusters']} clusters active, "
        f"{co['smem']} B a block, "
        f"{co['us_per_product']:.3f} us a product, design bound "
        f"{co['design_bound_ms']:.4f} ms)")
    plain_ms["P2"] = 1e3 * time_fn(
        lambda _: tprobe.chain_plain("both", ca, cw, cv, PROBE_N_ITER)[0], ca,
        reps=3, warmup=1)
    # P1's times by device time (torch.profiler; a chain of launches is
    # paced by the host's): in every arithmetic the earlier routine and the
    # wgmma tile in turns (earlier, wgmma, wgmma, earlier), beside the
    # wgmma tile's plan and design bound; then the plain version and
    # torch.matmul in strict f32 (utils/precision.py), the one-call
    # equivalent
    turns_p1 = ("earlier", "wgmma", "wgmma", "earlier")
    p1_dev = {}
    for arithmetic in tprobe.ARITHMETICS:
        times = {}
        for routine in turns_p1:
            times.setdefault(routine, []).append(device_ms(
                lambda _, r=routine, x=arithmetic: tprobe.matmul(
                    pa, pb, x, r), pa))
        p1_dev[arithmetic] = {k: sum(v) / len(v) for k, v in times.items()}
        say("7 probes", f"P1 {arithmetic} (256, 256) device ms in turns: "
            f"earlier {times['earlier'][0]:.5f}, wgmma "
            f"{times['wgmma'][0]:.5f}, wgmma {times['wgmma'][1]:.5f}, "
            f"earlier {times['earlier'][1]:.5f}; plan: "
            + "{columns} columns, {blocks} blocks, {stages} of {chunks} "
            "chunks in flight, {smem} B a block".format(
                **tprobe.p1_plan(arithmetic, 256))
            + f"; design bound {tprobe.p1_design_bound(256, arithmetic):.6f}"
            " ms")
    ms["P1"] = p1_dev["bf16x3"]["wgmma"]
    plain_ms["P1"] = device_ms(lambda _: tprobe.matmul_plain(pa, pb), pa)
    p1_library_ms = device_ms(lambda _: torch.matmul(pa, pb), pa)
    p1_chain_ms = 1e3 * time_fn(lambda _: tprobe.matmul(pa, pb), pa,
                                reps=N_CHAIN)
    # P1: two (256, 256) f32 operands read, one written; three bf16 passes.
    # P2: its function in one bf16 pass (bound_p2)
    bound["P1"] = roofline_ms(3 * 4 * 256**2, {"bf16": 3 * 2.0 * 256**3})
    bound["P2"] = bound_p2["default"]
    say("7 probes", f"P1 (256, 256) bf16x3 on the wgmma tile "
        f"{ms['P1']:.5f} ms device time (by "
        f"chains {p1_chain_ms:.4f}; earlier routine "
        f"{p1_dev['bf16x3']['earlier']:.5f}), plain "
        f"{plain_ms['P1']:.5f}, torch.matmul (strict f32) "
        f"{p1_library_ms:.5f}, bound {bound['P1'][0]:.6f} "
        f"({bound['P1'][1]}); P2 both {ms['P2']:.4f} ms, "
        f"plain {plain_ms['P2']:.4f}, bound {bound['P2'][0]:.4f} "
        f"({bound['P2'][1]})")

    # ---- 8, 12 and 13 start in processes of their own; 9-11 run here
    # meanwhile, and 14 once those processes have ended
    children = {}
    try:
        for name in CHILD_PHASES:
            children[name] = ChildPhase(name, out_dir)

        marks.append(("9", time.perf_counter()))
        # ---- 9 geometric multigrid: K1-K4 at the V-cycle's level sizes
        # against their plain versions, then the GMG path with its counts
        worst = gmg_level_checks(np.random.default_rng(2026))
        say("9 gmg", "level sizes all within tolerance; worst max rel err "
            + ", ".join(f"{m} {worst[m]:.3e} (tol {TOL[m]})" for m in TOL))
        for key, n in gmg_phase(dev, coef64).items():
            launches[key] += n

        marks.append(("10", time.perf_counter()))
        # ---- 10 the adaptive box tier (no kernel of the kernels line) ---
        box_apps = {}
        box_res = box_phase(dev, apps_out=box_apps)

        marks.append(("11", time.perf_counter()))
        # ---- 11 the operator families: K4 on their term sets against its
        # plain version, then heat, Newton and elasticity with K4's counts
        worst, aerr = operator_term_checks(np.random.default_rng(2027))
        say("11 operators", "term sets all within tolerance; worst max rel "
            "err " + ", ".join(f"{m} {worst[m]:.3e} (tol {TOL[m]})"
                               for m in TOL))
        abs_err["K4"] = max(abs_err["K4"], aerr)
        for key, n in operators_phase(dev).items():
            launches[key] += n

        marks.append(("join", time.perf_counter()))
        # ---- 8 the cell-loop tiers (no kernel of the kernels line); 12 the
        # bench apps (bmop, bmspmv) at the JAX bench's flagship sizes, their
        # K1/K3/K4 launches timing repetitions, printed apart; 13 the
        # distributed layer (no kernel of the kernels line)
        child_out = {}
        for name in CHILD_PHASES:
            left = CHILD_DEADLINE_S - (time.perf_counter() - t_start)
            child_out[name] = children[name].join(timeout=max(left, 1.0))
        bench_res = child_out["12"]["true_rel_res"]
        say("12 bench", "box solves' true rel residuals (f32 box operator, "
            "2-norm of the patch vector) beside phase 10's (f64 box "
            "operator, owner-weighted): " + ", ".join(
                f"{k} {bench_res[k]:.3e} and {box_res[k]:.3e}"
                for k in bench_res))

        marks.append(("14", time.perf_counter()))
        # ---- 14 the solver labs and the chip checks with their H100
        # golden; K1, K2 and K4 launches of the checks and the mask lab
        # counted
        for key, n in labs_phase(dev, box_apps).items():
            launches[key] += n
    finally:
        for child in children.values():
            child.stop()

    marks.append(("end", time.perf_counter()))
    say("done", "seconds by phase: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:]))
        + "; in processes of their own, started with 9: "
        + ", ".join(f"{name} {children[name].seconds:.1f} (the phase "
                    f"{child_out[name]['seconds']:.1f}, peak resident "
                    f"{child_out[name]['max_rss_gib']:.1f} GiB)"
                    for name in CHILD_PHASES)
        + f"; this process's peak resident "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
        f" GiB")
    say("done", f"{time.perf_counter() - t_start:.1f} s; {smi}")
    l2_src = {v: L2_SOURCES.get(v, ("lab_zyfirst", "lab_zyfirst.cuh")
                                if v in ZYFIRST else ("lab_separable",
                                                      "lab_separable.cuh"))
              for v in L2V}
    records = [
        ("K2", "K2 separable_apply (flat vmult, z-march)",
         "tpufem_torch/csrc/separable_apply.cuh",
         "tpufem/ops/pallas_separable.py:116", abs_err["K2"], None),
        ("K1", "K1 resident_ring (Laplace plan, fused mask)",
         "tpufem_torch/csrc/resident_ring.cuh",
         "tpufem/ops/pallas_separable.py:217", abs_err["K1"], None),
        ("K4", "K4 resident_ring (term plan, fused mask)",
         "tpufem_torch/csrc/resident_ring.cuh",
         "tpufem/ops/pallas_separable.py:729", abs_err["K4"], None),
        ("K3", "K3 resident_ring (2D terms plan, fused mask)",
         "tpufem_torch/csrc/resident_ring.cuh",
         "tpufem/ops/pallas_separable.py:1057", abs_err["K3"], None),
    ] + [(kern, f"{kern} {Path(LAB_KERNELS[kern][2]).stem} "
          f"({LAB_KERNELS[kern][0]}, 3xTF32)", LAB_KERNELS[kern][2],
          LAB_KERNELS[kern][1], lab_abs[kern], None) for kern in KERNELS] + [
        (f"L2 {v}", f"{v} {l2_src[v][0]} ({L2_KERNELS[v][0]}, "
         f"{'bf16x3' if v == 'v9' else 'f32' if v in NO_MMA else '3xTF32'})",
         f"tpufem_torch/csrc/{l2_src[v][1]}", L2_KERNELS[v][1], l2_abs[v],
         l2_library_ms.get(v)) for v in L2V] + [
        ("P1", "P1 toolchain_probe (bf16x3 product, wgmma tile)",
         "tpufem_torch/csrc/toolchain_probe.cuh",
         "scripts/toolchain_probe.py:36", abs_err["P1"], p1_library_ms),
        ("P2", "P2 toolchain_probe (cluster chain: products and "
         "multiply-adds in one kernel, one bf16 pass)",
         "tpufem_torch/csrc/toolchain_probe.cuh",
         "scripts/toolchain_probe.py:88", abs_err["P2"], None)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launches[key], "max_abs_err": aerr, "ms": ms[key],
         "plain_ms": plain_ms[key], "bound_ms": bound[key][0],
         "bound_by": bound[key][1], "library_ms": lib}
        for key, name, source, rep, aerr, lib in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--phase" in sys.argv[1:]:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--phase", choices=CHILD_PHASES, required=True)
        ap.add_argument("--result", type=Path, required=True)
        args = ap.parse_args()
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        args.result.write_text(json.dumps(run_child_phase(args.phase)))
        sys.exit(0)
    sys.exit(main())

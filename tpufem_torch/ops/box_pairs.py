"""Dense 2:1 interface transfers for the box tier (index-free C/Cᵀ).

The port's copy of ``tpufem/ops/box_pairs.py`` (only the imports differ;
the measurements quoted below are the JAX package's, on its TPU).

The rect machinery (``box_interface``) proves which hanging rows
follow the tensor-product interpolation and applies them with batched
gathers + one scatter.  Measured on the JAX package's TPU, EVERY index-based
HLO costs ~0.3 ms fixed + ~20 ns/element (a 142k-row sorted-unique
scatter-set alone is 2.8 ms) — the constraint application was 2/3 of the
whole 3.3M-DoF adaptive apply.

This module eliminates the index ops: for each consecutive box pair
(coarse C, fine F, size ratio 2) it builds ONE dense separable
prolongation over the overlap volume of the two lattices,

    V = P_z · P_y · P_x · U_C        (dense matmuls, set-semantics rows)

and the constrained rows are committed with a dense 0/1 mask,

    u_F ← u_F · (1 − h) + h · V ,

with Cᵀ as the transposed chain (restriction) added on the coarse block
and the same mask zeroing the hanging rows.  Shared lattice copies
(fine nodes coinciding with coarse nodes) are reconciled by strided-slab
sum/broadcast sweeps over the same overlap — no gather, no scatter
anywhere on the hot path.  Rows/copies the volume cannot prove stay on
the (small) index fallback.

Correctness relies on three structural facts, each enforced at setup:
- the 1D prolongation is cell-local Lagrange interpolation, so rows at
  coarse-node-aligned positions are exact identity rows (a fine node ON
  the interface plane reads only that coarse plane);
- dead coarse lattice entries stay exactly 0.0 in every solver vector
  (they receive only zero-weight contributions), so over-reading them is
  harmless in C, and Cᵀ clamps them with a dense alive mask;
- every masked row was verified against its AffineConstraints entry by
  the rect analysis (box_interface) before entering h.

Reference analogue: in-kernel hanging-node interpolation,
``hanging_nodes.cuh`` (SURVEY.md §2/§3.4) — same math, volume-dense
instead of per-thread.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufem_torch.solvers.multigrid import prolongation_1d


@dataclasses.dataclass
class PairPlan:
    """Static per-pair transfer plan (all host data; arrays -> device at
    operator setup)."""

    bc: int
    bf: int
    src_sl: tuple  # slices into the coarse box lattice
    dst_sl: tuple  # slices into the fine box lattice
    P: list  # per lattice axis: (nf_a, nc_a) prolongation block (np)
    h: np.ndarray  # dst-block shaped 0/1 ownership mask
    alive: np.ndarray  # src-block shaped 0/1 live-coarse-node mask
    # compress sweep: strided fine sub-block <-> aligned coarse sub-block
    sub_f: tuple  # strided slices into the fine box lattice
    sub_c: tuple  # slices into the coarse box lattice
    msh: np.ndarray  # sub-block shaped 0/1 shared-copy mask

    @property
    def S(self) -> list:
        """Per-axis 0/1 selection matrices (n_sub_a, dst_extent_a)
        picking the shared (coarse-aligned) fine positions — the up
        sweep's strided read as a matmul (strided slices along the
        lane axis lower poorly on the JAX package's TPU)."""
        out = []
        for sf, df in zip(self.sub_f, self.dst_sl):
            n = (sf.stop - 1 - sf.start) // 2 + 1
            S = np.zeros((n, df.stop - df.start))
            S[np.arange(n), sf.start - df.start + 2 * np.arange(n)] = 1.0
            out.append(S)
        return out

    @property
    def E(self) -> np.ndarray:
        """msh expanded to the dst block (1 at shared fine positions).
        P rows there are EXACT identity rows (entries snapped at build),
        so the compress down sweep rides the same prolongation einsum:
        F_blk += E * P(C_src)."""
        e = np.zeros(tuple(sl.stop - sl.start for sl in self.dst_sl))
        loc = tuple(
            slice(sf.start - df.start, sf.stop - df.start, sf.step)
            for sf, df in zip(self.sub_f, self.dst_sl))
        e[loc] = self.msh
        return e


def build_pair_plans(boxes, rects, p: int, d: int):
    """Build dense transfer plans for every 2:1 pair present in `rects`.

    Returns (plans, dropped_rects): plans sorted coarse-to-fine;
    dropped_rects are rects whose region does not fit a pair's overlap
    volume (their rows must stay on the gather fallback).
    """
    by_pair: dict = {}
    for r in rects:
        by_pair.setdefault((r.bc, r.bf), []).append(r)

    plans, dropped = [], []
    for (bc, bf), prects in sorted(by_pair.items()):
        C, F = boxes[bc], boxes[bf]
        if C.size != 2 * F.size:
            dropped.extend(prects)
            continue
        src_sl, dst_sl, P = [], [], []
        sub_f, sub_c = [], []
        ok = True
        for a in range(d):  # lattice axes, z..x
            xyz = d - 1 - a
            g0f = int(F.lo[xyz]) * p  # fine-unit global of F node 0
            g1f = g0f + F.nb[a] * p
            gcb = int(C.lo[xyz]) * 2 * p  # global of C node 0
            nbc = C.nb[a]
            u0 = min(max((g0f - gcb) // (2 * p), 0), nbc - 1)
            u1 = min(max(-((-(g1f - gcb)) // (2 * p)), u0 + 1), nbc)
            if u1 <= u0:
                ok = False
                break
            base = gcb + 2 * p * u0
            r0 = max(0, g0f - base)
            r1 = min(2 * (u1 - u0) * p, g1f - base)
            if r1 < r0:
                ok = False
                break
            Pf = prolongation_1d(p, u1 - u0)
            # snap: rows at coarse-node-aligned positions must be EXACT
            # identity rows (the compress sweeps rely on it)
            Pf = np.where(np.abs(Pf) < 1e-12, 0.0, Pf)
            Pf = np.where(np.abs(Pf - 1.0) < 1e-12, 1.0, Pf)
            P.append(Pf[r0 : r1 + 1])
            src_sl.append(slice(u0 * p, u1 * p + 1))
            f_start = base + r0 - g0f
            dst_sl.append(slice(f_start, f_start + (r1 - r0 + 1)))
            # strided shared subgrid: fine block f with even global coord
            fs0 = f_start + ((gcb - g0f - f_start) % 2)
            if fs0 >= f_start + (r1 - r0 + 1):
                ok = False
                break
            sub_f.append(slice(fs0, f_start + (r1 - r0 + 1), 2))
            j0 = (g0f + fs0 - gcb) // 2
            n_sub = (f_start + (r1 - r0) - fs0) // 2 + 1
            sub_c.append(slice(j0, j0 + n_sub))
        if not ok:
            dropped.extend(prects)
            continue

        src_sl, dst_sl = tuple(src_sl), tuple(dst_sl)
        sub_f, sub_c = tuple(sub_f), tuple(sub_c)
        alive = (C.gid[src_sl] >= 0).astype(np.float64)
        msh = ((C.gid[sub_c] >= 0) & (C.gid[sub_c] == F.gid[sub_f])
               ).astype(np.float64)

        # ownership mask from the verified rect rows
        dst_shape = tuple(sl.stop - sl.start for sl in dst_sl)
        h = np.zeros(dst_shape)
        for r in prects:
            loc, fits = [], True
            kmask = 0
            mshape = []
            for a in range(d):
                fs = r.fslice[a]
                if isinstance(fs, slice):
                    lo = fs.start - dst_sl[a].start
                    hi = fs.stop - dst_sl[a].start
                    if lo < 0 or hi > dst_shape[a]:
                        fits = False
                        break
                    loc.append(slice(lo, hi))
                    mshape.append(hi - lo)
                    kmask += 1
                else:
                    i = fs - dst_sl[a].start
                    if i < 0 or i >= dst_shape[a]:
                        fits = False
                        break
                    loc.append(i)
            if not fits:
                dropped.append(r)
                continue
            h[tuple(loc)] = np.maximum(
                h[tuple(loc)], r.mask.reshape(tuple(mshape)))
        plans.append(PairPlan(bc=bc, bf=bf, src_sl=src_sl, dst_sl=dst_sl,
                              P=P, h=h, alive=alive,
                              sub_f=sub_f, sub_c=sub_c, msh=msh))
    return plans, dropped


def uncovered_multi_rows(boxes, plans, gids, live, starts, ends):
    """Indices into the multi-DoF list whose copies are NOT fully
    reconciled by the pair-plan chain sweeps (these keep the index-based
    compress fallback).

    A multi DoF is covered when its copies sit in CONSECUTIVE boxes
    k..k+m and each consecutive pair of copies lies inside that pair's
    shared subgrid with msh == 1.
    """
    # flat patch index -> (box, lattice coords) lookup tables
    box_starts = np.array([b.offset for b in boxes])
    covered_sets = []
    for pl in plans:
        F = boxes[pl.bf]
        C = boxes[pl.bc]
        fg = np.zeros(F.lattice_shape, dtype=bool)
        fg[pl.dst_sl][tuple(
            slice(s.start - d0.start, s.stop - d0.start, s.step)
            for s, d0 in zip(pl.sub_f, pl.dst_sl))] = pl.msh > 0
        cg = np.zeros(C.lattice_shape, dtype=bool)
        cg[pl.sub_c] = pl.msh > 0
        covered_sets.append((pl.bc, pl.bf, cg.reshape(-1), fg.reshape(-1)))

    counts = ends - starts
    multi = np.nonzero(counts > 1)[0]
    out = []
    for r, gi in enumerate(multi):
        copies = live[starts[gi] : ends[gi]]
        bx = np.searchsorted(box_starts, copies, side="right") - 1
        order = np.argsort(bx)
        copies, bx = copies[order], bx[order]
        if not (np.diff(bx) == 1).all():
            out.append(r)
            continue
        ok = True
        for k in range(len(copies) - 1):
            pc, pf = copies[k], copies[k + 1]
            hit = False
            for bc, bf, cg, fg in covered_sets:
                if bc == bx[k] and bf == bx[k + 1]:
                    if (cg[pc - boxes[bc].offset]
                            and fg[pf - boxes[bf].offset]):
                        hit = True
                        break
            if not hit:
                ok = False
                break
        if not ok:
            out.append(r)
    return np.asarray(out, dtype=np.int64)

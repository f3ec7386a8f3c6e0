"""Structured hanging-node resolution for the box tier.

The port's copy of ``tpufem/ops/box_interface.py`` (only the imports
differ; the measurements quoted below are the JAX package's, on its TPU).

The gather-based C/Cᵀ application costs ~10 random memory accesses per
constraint nonzero (~70 ms at 142k hanging rows / 2.3M nonzeros on the
flagship adaptive mesh — 10x the cell loop itself).  This module removes
the random access for the regular bulk of the interface:

In a 2:1 forest, level interfaces are unions of axis-aligned COARSE FACES,
and the constraint rows of the fine nodes on a coarse face are exactly the
tensor-product subface interpolation — the same 1D embedding the reference
applies in-kernel (``hanging_nodes.cuh``'s resolve_hanging_nodes,
SURVEY.md §2/§3.4).  Grouping interface faces into maximal rectangles, the
whole C application per rectangle becomes

    V_fine = F₁ · U_coarse · F₂ᵀ        (dense matmuls)

on STATIC lattice slices of the coarse/fine box segments — no gather, no
scatter — with a precomputed 0/1 mask selecting the rows this rectangle
owns.  Cᵀ is the transpose chain accumulated the same way.  Rows whose
constraints deviate from the tensor prediction (true 3D edge constraints
at region borders, chain-closure rows) are VERIFIED out at setup and stay
on the gather fallback; the split is exact by construction because every
rectangle row is checked against its ``AffineConstraints`` entry before it
is assigned.

Measured coverage on the flagship adaptive benchmark (3D Q4, ball
refinement, 142k hanging rows): ~95% of rows / ~98% of nonzeros move to
the structured path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from tpufem_torch.solvers.multigrid import prolongation_1d


@dataclasses.dataclass
class InterfaceRect:
    """One maximal rectangle of interface coarse faces (static data)."""

    bf: int  # fine box index
    bc: int  # coarse box index
    fslice: tuple  # static basic-index tuple into the fine box lattice
    cslice: tuple  # static basic-index tuple into the coarse box lattice
    F: list  # per tangential axis: (n_fine, n_coarse) embedding (np)
    mask: np.ndarray  # fine region shape; 1 = row owned by this rectangle
    rows: np.ndarray  # constraint-row indices owned (diagnostics)


def _box_of_gid(boxes):
    """First (owner) copy of each gid: (box index, lattice coords)."""
    n = max(int(b.gid.max()) for b in boxes) + 1
    box_id = np.full(n, -1, dtype=np.int32)
    flat_pos = np.full(n, -1, dtype=np.int64)
    for i in reversed(range(len(boxes))):
        g = boxes[i].gid.reshape(-1)
        ok = g >= 0
        box_id[g[ok]] = i
        flat_pos[g[ok]] = np.nonzero(ok)[0]
    return box_id, flat_pos


def _coords(flat, shape):
    return np.stack(np.unravel_index(flat, shape), axis=-1)  # (..., d)


def build_interface_rects(boxes, constraints, p: int, d: int,
                          merge: str = "maximal"):
    """Decompose the hanging-node constraints into interface rectangles.

    Returns (rects, leftover_rows): leftover_rows indexes into the sorted
    constrained-dof list (``AffineConstraints.padded_arrays`` order) and
    keeps the gather fallback for everything not proven structured.
    """
    cdofs, masters, weights, inhom = constraints.padded_arrays()
    ncon = len(cdofs)
    box_id, flat_pos = _box_of_gid(boxes)

    # row -> fine box + lattice coords (owner copy)
    rb = box_id[cdofs]
    rpos = np.zeros((ncon, d), dtype=np.int64)
    for i, b in enumerate(boxes):
        sel = rb == i
        if sel.any():
            rpos[sel] = _coords(flat_pos[cdofs[sel]], b.lattice_shape)

    # dense gid -> constraint-row lookup (the dict + per-node Python
    # verification loop cost 21 s of the 53 s flagship setup, measured)
    crow = np.full(len(box_id), -1, dtype=np.int64)
    crow[cdofs] = np.arange(ncon)

    # rows with an inhomogeneity must keep the gather path (the rect
    # apply is purely linear)
    assigned = np.zeros(ncon, dtype=bool)
    inhomogeneous = inhom != 0.0
    rects: list[InterfaceRect] = []

    # candidate planes from seed rows (full face interpolation: masters
    # span a (p+1)^(d-1) grid with one shared coarse-plane coordinate)
    live_w = weights != 0.0
    nnz = live_w.sum(axis=1)
    k_face = (p + 1) ** (d - 1)
    seeds = np.nonzero(nnz == k_face)[0]
    planes: dict[tuple, list[int]] = {}
    if len(seeds):
        # (S, k_face) live masters per seed, vectorized (nonzero returns
        # row-major order and every seed row has exactly k_face lives)
        srow, spos = np.nonzero(live_w[seeds])
        ms = masters[seeds[srow], spos].reshape(-1, k_face)
        mb = np.where(ms >= 0, box_id[np.maximum(ms, 0)], -1)
        same_box = (mb == mb[:, :1]).all(axis=1) & (mb[:, 0] >= 0)
        for bc in np.unique(mb[same_box, 0]):
            sel = same_box & (mb[:, 0] == bc)
            mpos = _coords(flat_pos[ms[sel]],
                           boxes[int(bc)].lattice_shape)  # (S', k, d)
            eq = (mpos == mpos[:, :1, :]).all(axis=1)  # (S', d)
            one = eq.sum(axis=1) == 1
            if not one.any():
                continue
            ax_s = np.argmax(eq[one], axis=1)
            rr = seeds[sel][one]
            zc_s = mpos[one, 0][np.arange(one.sum()), ax_s]
            zf_s = rpos[rr, ax_s]
            for r, ax, zc, zf in zip(rr, ax_s, zc_s, zf_s):
                key = (int(rb[r]), int(bc), int(ax), int(zc), int(zf))
                planes.setdefault(key, []).append(int(r))

    for (bf, bc, ax, zc, zf), plane_rows in planes.items():
        fine, coarse = boxes[bf], boxes[bc]
        if 2 * fine.size != coarse.size:
            continue  # only 2:1 interfaces are tensor-predictable
        tan = [a for a in range(d) if a != ax]
        # geometric offset fine->coarse along each tangential lattice
        # axis, in FINE node units: lattice axis a corresponds to xyz
        # axis d-1-a; box lo is in cell-size units, node spacing s/p
        off = []
        for a in tan:
            xyz = d - 1 - a
            # global position (units s_f/p) of node index i in each box:
            #   fine:   2*p*lo_f[xyz]/ (s_f cells) ... lo is in units of
            #           own size: global = lo * p (own-size cells * p)
            # fine global = (lo_f[xyz] * p + i_f), coarse global =
            #   (lo_c[xyz] * 2p + 2 i_c)  [coarse spacing = 2 fine units]
            off.append((int(fine.lo[xyz]) * p, int(coarse.lo[xyz]) * 2 * p))
        # coarse-face grid covered by seed rows: face cell coords along
        # tangential axes of the COARSE lattice
        pr = np.asarray(plane_rows)
        fpos = rpos[pr][:, tan]  # fine node coords in fine lattice
        # fine node -> coarse face cell: global = lo_f*p + i_f;
        # face cell u satisfies global in [lo_c*2p + 2p*u, +2p]
        glob = fpos + np.array([o[0] for o in off])[None, :]
        rel = glob - np.array([o[1] for o in off])[None, :]
        ucell = rel // (2 * p)
        if (ucell < 0).any():
            continue
        grid_shape = tuple(int(ucell[:, k].max()) + 1 for k in range(d - 1))
        covered = np.zeros(grid_shape, dtype=bool)
        covered[tuple(ucell[:, k] for k in range(d - 1))] = True

        if merge == "bounding":
            # ONE rectangle per interface plane.  Over-coverage is exact
            # (unverified/absent rows stay mask=0; dead coarse nodes
            # provably receive zero in Cᵀ) but measured SLOWER on the
            # flagship (840 -> 78 rects, 16.7 -> 19.3 ms): the per-rect
            # einsum cost scales with region area, not op count.  Kept
            # for meshes whose interfaces fragment pathologically.
            rect_list = [[
                (int(ucell[:, k].min()), int(ucell[:, k].max()) + 1)
                for k in range(d - 1)
            ]]
        else:
            rect_list = _max_rectangles(covered)

        for rect in rect_list:
            u0 = [r0 for (r0, _) in rect]
            m = [r1 - r0 for (r0, r1) in rect]
            # coarse node region: [u0*p, (u0+m)*p] per tangential axis
            ci0 = [u0[k] * p for k in range(d - 1)]
            cn = [m[k] * p + 1 for k in range(d - 1)]
            # fine node region: global = lo_f*p + i_f
            fi0 = [2 * p * u0[k] + off[k][1] - off[k][0]
                   for k in range(d - 1)]
            fn = [2 * m[k] * p + 1 for k in range(d - 1)]
            if any(fi0[k] < 0 for k in range(d - 1)):
                continue
            ok_extent = True
            for k in range(d - 1):
                if (ci0[k] + cn[k] > coarse.lattice_shape[tan[k]]
                        or fi0[k] + fn[k] > fine.lattice_shape[tan[k]]):
                    ok_extent = False
            if not ok_extent:
                continue
            F = [prolongation_1d(p, m[k]) for k in range(d - 1)]
            # verify every fine node in the region against its
            # constraint row; build the ownership mask
            mask = np.zeros(tuple(fn), dtype=np.float64)
            rows_here = []
            cg = coarse.gid
            fgid = fine.gid
            csl = [None] * d
            csl[ax] = zc
            fsl = [None] * d
            fsl[ax] = zf
            for k in range(d - 1):
                csl[tan[k]] = slice(ci0[k], ci0[k] + cn[k])
                fsl[tan[k]] = slice(fi0[k], fi0[k] + fn[k])
            cregion = cg[tuple(csl)]  # coarse gids (cn...)
            fregion = fgid[tuple(fsl)]  # fine gids (fn...)
            # dead coarse nodes (gid -1) are safe: any row predicted to
            # reference them fails verification (mask 0), so they receive
            # exactly zero in Cᵀ and their garbage is masked out in C
            ok_nodes, rows_ok = _verify_region(
                fregion, cregion, F, crow, assigned, inhomogeneous,
                masters, weights, live_w, nnz)
            mask[ok_nodes] = 1.0
            rows_here = rows_ok.tolist()
            if not rows_here:
                continue
            assigned[np.asarray(rows_here)] = True
            rects.append(InterfaceRect(
                bf=bf, bc=bc, fslice=tuple(fsl), cslice=tuple(csl),
                F=F, mask=mask, rows=np.asarray(rows_here),
            ))

    leftover = np.nonzero(~assigned)[0]
    return rects, leftover


def _verify_region(fregion, cregion, F, crow, assigned, inhom,
                   masters, weights, live_w, nnz_act):
    """Vectorized per-node verification of a candidate rectangle.

    A fine node is verified iff its constraint row EQUALS the tensor
    prediction prod_k F[k][i_k, :] over the coarse region: support sets
    match (counts equal + every support node alive + every actual master
    found inside the per-axis bands) and weights agree to 1e-10.
    Replaces the per-node Python loop (21 s of the 53 s flagship setup).

    Returns (ok_nodes index tuple into the region, row indices)."""
    fn = fregion.shape
    dm1 = len(fn)
    bands = []
    for k in range(dm1):
        A = np.abs(F[k]) > 1e-13
        cnt = A.sum(axis=1)
        first = np.argmax(A, axis=1)
        last = F[k].shape[1] - 1 - np.argmax(A[:, ::-1], axis=1)
        contig = (last - first + 1 == cnt) & (cnt > 0)
        bands.append((first, last, cnt, contig))

    g = fregion.reshape(-1)
    r = np.where(g >= 0, crow[np.maximum(g, 0)], -1)
    rs0 = np.maximum(r, 0)
    cand = (r >= 0) & ~assigned[rs0] & ~inhom[rs0]

    I = np.stack(np.unravel_index(np.arange(g.size), fn), axis=-1)
    cnt_node = np.ones(g.size, dtype=np.int64)
    for k in range(dm1):
        first, last, cnt, contig = bands[k]
        cand &= contig[I[:, k]]
        cnt_node *= cnt[I[:, k]]
    cand &= cnt_node == nnz_act[rs0]

    # all-support-alive via inclusive prefix sums over the coarse region
    Ps = (cregion >= 0).astype(np.int64)
    for k in range(dm1):
        Ps = np.cumsum(Ps, axis=k)
    Ppad = np.pad(Ps, [(1, 0)] * dm1)
    a = np.stack([bands[k][0][I[:, k]] for k in range(dm1)], axis=-1)
    b = np.stack([bands[k][1][I[:, k]] for k in range(dm1)], axis=-1)
    if dm1 == 1:
        alive_n = Ppad[b[:, 0] + 1] - Ppad[a[:, 0]]
    else:
        alive_n = (Ppad[b[:, 0] + 1, b[:, 1] + 1]
                   - Ppad[a[:, 0], b[:, 1] + 1]
                   - Ppad[b[:, 0] + 1, a[:, 1]]
                   + Ppad[a[:, 0], a[:, 1]])
    cand &= alive_n == np.prod(b - a + 1, axis=-1)

    idxs = np.nonzero(cand)[0]
    if len(idxs) == 0:
        return tuple(np.zeros(0, np.int64) for _ in range(dm1)), \
            np.zeros(0, np.int64)

    rr = r[idxs]
    m, w, lv = masters[rr], weights[rr], live_w[rr]  # (L, Km)
    cflat = cregion.reshape(-1)
    order = np.argsort(cflat, kind="stable")
    sortc = cflat[order]
    pos = np.clip(np.searchsorted(sortc, m), 0, len(sortc) - 1)
    found = sortc[pos] == m
    J = np.unravel_index(order[pos], cregion.shape)
    predw = np.ones(m.shape)
    okm = found.copy()
    for k in range(dm1):
        ik = I[idxs, k][:, None]
        jk = J[k]
        okm &= (jk >= a[idxs, k][:, None]) & (jk <= b[idxs, k][:, None])
        predw *= F[k][ik, jk]
    okm &= np.abs(predw - w) <= 1e-10
    rowok = np.where(lv, okm, True).all(axis=1)
    keep = idxs[rowok]
    return np.unravel_index(keep, fn), r[keep]


def _max_rectangles(covered: np.ndarray):
    """Greedy maximal-rectangle cover of a boolean grid.

    Returns a list of per-axis (start, end) tuples; rectangles are
    disjoint and cover every True cell.  1D grids give maximal runs.
    """
    cov = covered.copy()
    out = []
    if cov.ndim == 1:
        i = 0
        n = len(cov)
        while i < n:
            if not cov[i]:
                i += 1
                continue
            j = i
            while j < n and cov[j]:
                j += 1
            out.append([(i, j)])
            i = j
        return out
    # 2D greedy: for each top-left uncovered True cell, grow the widest
    # run, then extend downward while full rows match
    n1, n2 = cov.shape
    for i in range(n1):
        j = 0
        while j < n2:
            if not cov[i, j]:
                j += 1
                continue
            j2 = j
            while j2 < n2 and cov[i, j2]:
                j2 += 1
            i2 = i + 1
            while i2 < n1 and cov[i2, j:j2].all():
                i2 += 1
            out.append([(i, i2), (j, j2)])
            cov[i:i2, j:j2] = False
            j = j2
    return out

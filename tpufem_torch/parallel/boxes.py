"""Distributed box tier: adaptive (2:1 forest) meshes on a shard mesh at
box-tier speed.

Port of ``tpufem/parallel/boxes.py``.  The decomposition is the JAX
package's, and its host plan (cuts, slabs, on-cut flags, the per-shard
parameters, owner weights and cut groups) is built by the same numpy code
and held equal to it by the tests:

- slab cuts along the leading lattice axis z, optionally crossed with
  cuts along y (3D, a 2-axis ``(sz, sy)`` mesh; the lane axis x is never
  cut), aligned to the coarsest cell size, so every cut plane is a coarse
  node plane in every box and the pair transfers never reach across it;
- each shard's local patch vector is its per-box slabs, padded to
  shard-uniform shapes (dead cells carry zero weights and masks);
- the apply is ``BoxLaplaceOperator``'s own chain (C, the cell loops, the
  folded C^T, the copy sweeps) on each shard's local geometry, followed by
  one reconciliation of the cut planes per sharded axis: two
  single-neighbour ``ppermute``s of the raw per-box plane partials, then a
  sum of every physical node over all its (box, side) copies.

The JAX package does that sum with ``jax.ops.segment_sum`` into the gid
groups and an ``.at[].add`` whose padded slots repeat index 0 with weight
0.  The port sums each genuine slot's group through a gather-sum table
built on the host (the incidence tier's form, ``matrix_free.
transpose_table``) and writes only the genuine slots, which are distinct:
no float atomics, so two solves on the card are bitwise equal.

Dots carry owner weights (the global copy owner times plane ownership:
a shared plane belongs to the lower shard), summed by ``psum`` in fixed
shard order.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo
from tpufem_torch.ops.boxes import Box, BoxLaplaceOperator
from tpufem_torch.ops.matrix_free import transpose_table
from tpufem_torch.ops.structured import global_interp_matrices
from tpufem_torch.parallel.mesh import Sharded, ShardMesh, smap, to_host
from tpufem_torch.solvers.cg import cg_solve as _cg_solve
from tpufem_torch.solvers.chebyshev import chebyshev_smooth


def _tree_stack(trees):
    """Stack a list of equal-structure (dict/tuple/list/array) trees leaf
    by leaf along a new leading axis (the JAX package's stacked
    per-shard pytree)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_stack([t[i] for t in trees])
                        for i in range(len(t0)))
    return np.stack([np.asarray(t) for t in trees])


class _LocalBoxApply(BoxLaplaceOperator):
    """One shard's apply: borrows BoxLaplaceOperator's in-place apply
    methods (``_distribute_``, ``_cells``, ``_pair_delta_t_inline_``,
    ``_compress_``) on the shard's local slab geometry.  Never calls
    ``BoxLaplaceOperator.__init__``: it holds only what those methods read,
    made from the shard's host plan on the shard's device."""

    def __init__(self, boxes, box_nb, pair_meta, cell_scheme, dim, p, dt,
                 device, plan, S, D_col):
        self.device, self.dt = device, dt
        self.boxes = boxes
        self.dim, self.p = dim, p
        self._cell_scheme = cell_scheme
        self._dense = False
        self._has_fallback = False
        self._rect_groups = []
        self._pair_meta = pair_meta
        self.has_hanging = bool(pair_meta)
        self.S = S.to(device)
        self.D_col = D_col.to(device)
        dev = self._dev
        self._box_args = []
        for nb, (a1, a2) in zip(box_nb, plan["box_args"]):
            if cell_scheme == "global-general":
                self._box_args.append((nb, dev(a1), None))
            else:
                self._box_args.append((nb, dev(a1), dev(a2)))
        self._box_EG = [(tuple(map(dev, E)), tuple(map(dev, G)))
                        for E, G in plan["box_EG"]]
        self.interior_mask = dev(plan["interior_mask"])
        self._exterior_mask = dev(1.0 - plan["interior_mask"])
        self.w_owner = dev(plan["w_owner"])
        empty_i = self._idx(np.zeros((0, 1), np.int64))
        empty_w = dev(np.zeros((0, 1)))
        none = (self._idx(np.zeros(0, np.int64)),) * 2
        self._multi_idx, self._multi_w, self._multi_set = (empty_i, empty_w,
                                                           none)
        self._multi_fb_idx, self._multi_fb_w = empty_i, empty_w
        self._multi_fb_set = none
        if pair_meta:
            self._pair_P = [tuple(map(dev, P)) for P in plan["pair_P"]]
            self._pair_S = [tuple(map(dev, S_)) for S_ in plan["pair_S"]]
            self._pair_h = [dev(h) for h in plan["pair_h"]]
            self._pair_1mh = [dev(1.0 - h) for h in plan["pair_h"]]
            self._pair_alive = [dev(a) for a in plan["pair_alive"]]
            self._pair_msh = [dev(m) for m in plan["pair_msh"]]
            self._pair_1mmsh = [dev(1.0 - m) for m in plan["pair_msh"]]
            self._pair_E = [dev(E) for E in plan["pair_E"]]

    def raw_local(self, x: torch.Tensor) -> torch.Tensor:
        """The shard's partial apply before the cut-plane exchange: C of
        the masked input, the cell loops, C^T folded in, the copy sweeps."""
        xh = self._distribute_(self.interior_mask * x)
        y = self._cells(xh)
        if self._pair_meta:
            self._pair_delta_t_inline_(y)
            self._compress_(y)
        return y


def _slab_rows(a_cells: int, r_cells: int, p: int, LZ: int,
               g_off: int, g_len: int):
    """(valid_mask (LZ,), clipped global-row indices (LZ,)) for local
    z-node L <-> global-region row a_cells*p + L - g_off; rows beyond the
    REAL slab (r_cells == 0: none; else L > r_cells*p) are invalid."""
    L = np.arange(LZ)
    g = a_cells * p + L - g_off
    ok = (g >= 0) & (g < g_len)
    if r_cells == 0:
        ok &= False
    else:
        ok &= L <= r_cells * p
    return ok, np.clip(g, 0, max(g_len - 1, 0))


def parse_shards(shards) -> tuple[int, int]:
    """The shard grid ``(sz, sy)`` from ``N``, ``"N"``, ``"SZxSY"`` (the
    ``--shards`` option) or a pair: one number is the 1-axis grid
    ``(N, 1)``."""
    if isinstance(shards, str):
        shards = shards.lower().split("x")
    elif np.isscalar(shards):
        shards = (shards,)
    parts = [int(x) for x in shards]
    return (parts[0], 1) if len(parts) == 1 else (parts[0], parts[1])


class DistributedBoxLaplace:
    """Shard a :class:`BoxLaplaceOperator` over a 1- or 2-axis shard mesh.

    Parameters: the global operator, the shard count (1-axis z slabs) or
    ``shards=(sz, sy)`` (3D only: a 2-axis z x y mesh), and an optional
    device a shard (``ShardMesh``; default: the operator's device type,
    round-robin over its cards).  ``vmult`` / ``cg_solve`` act on
    ``Sharded`` local patch vectors of ``NL`` entries a shard;
    ``to_local`` / ``from_local`` convert at the IO boundaries (the JAX
    package's stacked ``(sz*sy, NL)`` layout, host numpy).

    Cut planes along each sharded lattice axis reconcile by the
    raw-partial exchange and gid-group sum, z then y.  Corner lines (on
    both cut sets) are exact because the y phase reads the z-reconciled
    values and counts each (gid, y-side) once through representative
    weights.
    """

    def __init__(self, gop: BoxLaplaceOperator, n_shards: int = None,
                 axis_name: str = "shard", devices=None, shards=None):
        if gop._cell_scheme not in ("global", "global-general"):
            raise NotImplementedError(
                "distributed box tier needs the global cell schemes")
        if gop._has_fallback:
            raise NotImplementedError(
                "gather-fallback constraint rows present — use "
                "GeneralPartitioner for this mesh")
        if gop._pair_meta:
            if not gop._single_compress:
                raise NotImplementedError("single-compress required")
            if int(gop._multi_fb_idx.shape[0]):
                raise NotImplementedError(
                    "sweep-uncovered multi copies present")
        elif int(gop._multi_idx.shape[0]):
            raise NotImplementedError(
                "multi copies without dense pair plans")
        sz, sy = parse_shards(n_shards if shards is None else shards)
        if sy > 1 and gop.dim != 3:
            raise NotImplementedError("2-axis box sharding needs dim=3 "
                                      "(never cut the lane axis)")
        self.gop = gop
        self.sz, self.sy = sz, sy
        self.n_shards = sz * sy
        self.axis_name = axis_name
        self.axis_name_y = axis_name + "_y"
        self.mesh = ShardMesh((sz, sy), (self.axis_name, self.axis_name_y),
                              devices=devices, device=gop.device)
        d, p = gop.dim, gop.p
        self.dim, self.p, self.dt = d, p, gop.dt
        boxes = gop.boxes
        n_shards = self.n_shards

        # ---- cuts per sharded lattice axis: coarsest-size-aligned, -----
        # balanced by active cells.  Lattice axis 0 = xyz axis d-1 (z),
        # lattice axis 1 = xyz axis d-2 (y, 3D 2-axis only).
        self.cuts_units = self._make_cuts(0, sz)
        self.cuts_y = self._make_cuts(1, sy) if sy > 1 else None

        # ---- per-box slab geometry per axis -----------------------------
        self._slab = self._make_slabs(0, self.cuts_units)
        self._slab_y = (self._make_slabs(1, self.cuts_y) if sy > 1
                        else [(np.zeros(1, int),
                               np.full(1, b.nb[1] if d > 1 else 1, int),
                               b.nb[1] if d > 1 else 1) for b in boxes])

        # on-cut flags per axis row/column: does box bi's slab start/end
        # ON the cut plane (vs. at a box end strictly inside the shard)?
        # Only on-cut planes take part in the cross-shard reconciliation.
        self._bot_cut, self._top_cut = self._make_flags(
            0, self.cuts_units, self._slab, sz)
        if sy > 1:
            self._bot_cut_y, self._top_cut_y = self._make_flags(
                1, self.cuts_y, self._slab_y, sy)
        else:
            nbox = len(boxes)
            self._bot_cut_y = np.zeros((1, nbox), bool)
            self._top_cut_y = np.zeros((1, nbox), bool)

        # local template boxes (shard-uniform shapes)
        lboxes, lnb = [], []
        off = 0
        for bi, b in enumerate(boxes):
            NCZ = self._slab[bi][2]
            lat = (NCZ * p + 1,) + b.lattice_shape[1:]
            nb = (NCZ,) + b.nb[1:]
            if sy > 1:
                NCY = self._slab_y[bi][2]
                lat = (lat[0], NCY * p + 1) + b.lattice_shape[2:]
                nb = (nb[0], NCY) + b.nb[2:]
            lboxes.append(Box(
                size=b.size, lo=b.lo, nb=nb, cells=b.cells[:0],
                lattice_shape=lat, gid=np.zeros(0), active=np.zeros(0),
                offset=off))
            lnb.append(nb)
            off += int(np.prod(lat))
        self.NL = off
        self.lboxes = lboxes

        # full-extent pair metadata on the sharded axes (unsharded
        # tangential slices stay global-static)
        lmeta = []
        for meta in gop._pair_meta:
            lc = lboxes[meta["bc"]].lattice_shape
            lf = lboxes[meta["bf"]].lattice_shape
            nloc = 2 if sy > 1 else 1

            def _loc(sls, lat):
                return tuple(slice(0, lat[a]) for a in range(nloc)) \
                    + tuple(sls[nloc:])

            lmeta.append(dict(
                bc=meta["bc"], bf=meta["bf"],
                src_sl=_loc(meta["src_sl"], lc),
                dst_sl=_loc(meta["dst_sl"], lf),
                sub_c=_loc(meta["sub_c"], lc),
                sub_f=meta["sub_f"],
            ))
        self._lmeta, self._lnb = lmeta, tuple(lnb)

        # ---- per-shard host plans, stacked as the JAX package stacks ----
        self._plans = [self._shard_params(s) for s in range(n_shards)]
        self.params = _tree_stack(self._plans)
        # per-shard top-plane index per box and axis (r*p; 0 when empty)
        tops = np.stack([
            np.array([int(r[s // sy]) * p for (_, r, _) in self._slab])
            for s in range(n_shards)]).astype(np.int32)
        self.params["plane_top"] = tops
        if sy > 1:
            topy = np.stack([
                np.array([int(r[s % sy]) * p
                          for (_, r, _) in self._slab_y])
                for s in range(n_shards)]).astype(np.int32)
            self.params["plane_top_y"] = topy

        # ---- cut-plane reconciliation groups ---------------------------
        # Raw plane partials are exchanged per box; each physical node on
        # a cut plane then gets the SUM over ALL its (box, shard-side)
        # copies — grouped by global DoF id (the same id is computed on
        # both sides from the global box lattice, so no second exchange
        # is needed: both shards reconstruct identical totals).  With a
        # second sharded axis the y phase runs on the z-reconciled values:
        # corner slots (on a z cut too) contribute through ONE
        # representative per (gid, y-side) — all same-side copies are
        # equal after the z SET — while their set weights cover every
        # copy; non-corner slots sum raw partials as in the z phase.
        self._build_cut_groups(0)
        if sy > 1:
            self._build_cut_groups(1)

        # ---- the shards' device data ------------------------------------
        self.locals = [
            _LocalBoxApply(lboxes, self._lnb, lmeta, gop._cell_scheme, d, p,
                           gop.dt, self.mesh.devices[s], self._plans[s],
                           gop.S, gop.D_col)
            for s in range(n_shards)]
        self.w_owner = Sharded(lo.w_owner for lo in self.locals)
        self.interior_mask = Sharded(lo.interior_mask for lo in self.locals)
        self._exterior = Sharded(lo._exterior_mask for lo in self.locals)
        self._recon = [self._reconcile_tables(0)]
        if sy > 1:
            self._recon.append(self._reconcile_tables(1))
        self._diag_local = None

    # ------------------------------------------------------------------
    # sharded-axis helpers (lattice axis 0 = z = xyz d-1; axis 1 = y)
    def _axis_xyz(self, ax: int) -> int:
        return self.dim - 1 - ax

    def _axis_row(self, s: int, ax: int) -> int:
        return s // self.sy if ax == 0 else s % self.sy

    def _nbr(self, s: int, ax: int, step: int):
        """Shard index of the axis-ax neighbor, or None at the edge."""
        iz, iy = divmod(s, self.sy)
        if ax == 0:
            iz += step
            if not (0 <= iz < self.sz):
                return None
        else:
            iy += step
            if not (0 <= iy < self.sy):
                return None
        return iz * self.sy + iy

    def _cut_ok(self, ax: int, c: int) -> bool:
        """A cut at unit coord ``c`` is valid unless it strands a 2:1
        fill: if some pair's COARSE box has no cells on one side of c
        while the pair's hanging (dst) rows extend to that side, the
        shard on that side can neither C-fill those rows (the identity
        source plane of the coarse box does not exist in its slab) nor
        land their C^T delta."""
        gop = self.gop
        p = gop.p
        a = self._axis_xyz(ax)
        for meta in gop._pair_meta:
            bfb = gop.boxes[meta["bf"]]
            bcb = gop.boxes[meta["bc"]]
            f0 = int(bfb.lo[a]) * bfb.size
            f1 = f0 + int(bfb.nb[ax]) * bfb.size
            b0 = int(bcb.lo[a]) * bcb.size
            b1 = b0 + int(bcb.nb[ax]) * bcb.size
            sl = meta["dst_sl"][ax]
            lat = bfb.lattice_shape[ax]
            r0 = 0 if sl.start is None else int(sl.start)
            r1 = lat if sl.stop is None else int(sl.stop)
            h0 = f0 + r0 * bfb.size / p
            h1 = f0 + (r1 - 1) * bfb.size / p
            if b0 >= c and h0 <= c and f0 < c:
                return False  # lower shard: fine cells, no coarse plane
            if b1 <= c and h1 >= c and f1 > c:
                return False  # upper shard, symmetric
        return True

    def _make_cuts(self, ax: int, ns: int) -> np.ndarray:
        mesh, boxes = self.gop.mesh, self.gop.boxes
        s_max = max(b.size for b in boxes)
        ncand = mesh.U // s_max
        slot = mesh.origins[:, self._axis_xyz(ax)] // s_max
        wt = np.bincount(slot, minlength=ncand).astype(np.float64)
        cum = np.cumsum(wt)
        cuts = [0]
        for s in range(1, ns):
            k = int(np.searchsorted(cum, cum[-1] * s / ns,
                                    side="left")) + 1
            # strictly increasing while slots remain: an EMPTY shard row
            # between non-empty ones would break the single-neighbor
            # plane adjacency.  Unavoidable empties (ns > slots) land at
            # the END, where their planes are dead.
            k = min(max(k, cuts[-1] + 1), ncand)
            if cuts[-1] >= ncand:
                cuts.append(ncand)
                continue
            if not self._cut_ok(ax, k * s_max):
                # nudge to the nearest valid INTERIOR coarse-aligned
                # plane; snapping to the domain end would silently leave
                # the remaining shards empty, so that case raises instead
                allowed = [j for j in range(cuts[-1] + 1, ncand)
                           if self._cut_ok(ax, j * s_max)]
                if not allowed:
                    raise NotImplementedError(
                        "no valid cut plane on this axis: every "
                        "interior coarse-aligned plane strands a 2:1 "
                        "interface fill — reduce shards or use "
                        "GeneralPartitioner")
                k = min(allowed, key=lambda j: abs(j - k))
            cuts.append(k)
        cuts.append(ncand)
        return np.asarray(cuts) * s_max

    def _make_slabs(self, ax: int, cuts: np.ndarray):
        out = []
        for b in self.gop.boxes:
            z0 = int(b.lo[self._axis_xyz(ax)])
            a = np.clip(cuts[:-1] // b.size - z0, 0, b.nb[ax])
            e = np.clip(cuts[1:] // b.size - z0, 0, b.nb[ax])
            r = np.maximum(e - a, 0)
            out.append((a.astype(int), r.astype(int),
                        max(int(r.max()), 1)))
        return out

    def _make_flags(self, ax: int, cuts, slabs, ns: int):
        nbox = len(self.gop.boxes)
        bot = np.zeros((ns, nbox), bool)
        top = np.zeros((ns, nbox), bool)
        for bi, b in enumerate(self.gop.boxes):
            z0u = int(b.lo[self._axis_xyz(ax)]) * b.size
            a, r, _ = slabs[bi]
            for i in range(ns):
                if int(r[i]) <= 0:
                    continue
                bot[i, bi] = z0u + int(a[i]) * b.size == cuts[i]
                top[i, bi] = (z0u + int(a[i] + r[i]) * b.size
                              == cuts[i + 1])
        return bot, top

    def _face_gids(self, bi: int, ax: int, c_units: int, s: int):
        """Localized gid face of box bi on the axis-ax plane at c_units
        (None when the box has no lattice plane there).  The OTHER
        sharded axis is restricted to shard s's slab (invalid rows -1);
        unsharded axes stay global."""
        b, lb, p = self.gop.boxes[bi], self.lboxes[bi], self.p
        z0u = int(b.lo[self._axis_xyz(ax)]) * b.size
        j, rem = divmod(c_units - z0u, b.size)
        if rem or j < 0 or j > b.nb[ax]:
            return None
        gid = b.gid.reshape(b.lattice_shape)
        face = np.take(gid, j * p, axis=ax)  # global face, axis removed
        oax = 1 - ax  # the other sharded lattice axis
        if self.sy <= 1 and oax == 1:
            return face.reshape(-1)
        if oax == 0:
            slab, row = self._slab, self._axis_row(s, 0)
        else:
            slab, row = self._slab_y, self._axis_row(s, 1)
        a, r, _ = slab[bi]
        # face axis 0 is the other sharded axis for both ax=0 (face =
        # (y, x...)) and ax=1 (face = (z, x...))
        Lloc = lb.lattice_shape[oax]
        ok, gz = _slab_rows(int(a[row]), int(r[row]), p, Lloc,
                            0, face.shape[0])
        out = np.full((Lloc,) + face.shape[1:], -1, np.int64)
        out[ok] = face[gz[ok]]
        return out.reshape(-1)

    def _face_idx(self, bi: int, ax: int, row: int) -> np.ndarray:
        """Flat local patch indices of box bi's axis-ax plane at local
        row index ``row``."""
        lb = self.lboxes[bi]
        grid = np.arange(int(np.prod(lb.lattice_shape)),
                         dtype=np.int64).reshape(lb.lattice_shape)
        return (lb.offset + np.take(grid, row, axis=ax)).reshape(-1)

    def _corner_mask(self, bi: int, ax: int, s: int) -> np.ndarray:
        """For axis-ax faces: which slots lie on a cut of the OTHER
        sharded axis (corner lines — already axis-oax reconciled)."""
        lb = self.lboxes[bi]
        oax = 1 - ax
        face_shape = tuple(n for a, n in enumerate(lb.lattice_shape)
                           if a != ax)
        m = np.zeros(face_shape, bool)
        if self.sy <= 1:
            return m.reshape(-1)
        if oax == 0:
            slab, flags_b, flags_t, row = (self._slab, self._bot_cut,
                                           self._top_cut,
                                           self._axis_row(s, 0))
        else:
            slab, flags_b, flags_t, row = (self._slab_y, self._bot_cut_y,
                                           self._top_cut_y,
                                           self._axis_row(s, 1))
        _, r, _ = slab[bi]
        if flags_b[row, bi]:
            m[0] = True
        if flags_t[row, bi]:
            m[int(r[row]) * self.p] = True
        return m.reshape(-1)

    def _build_cut_groups(self, ax: int):
        """Per-shard gid groups + weights + scatter indices for the
        axis-ax cut planes, stored in params as cut_{seg,wm,wr,ws,idx}
        (ax=0) / cut_{...}_y (ax=1).  wm = my summation weight, wr =
        received summation weight, ws = my SET weight (differs from wm
        only on corner slots, which sum through one representative but
        set every copy)."""
        p = self.p
        n_shards = self.n_shards
        lboxes, boxes = self.lboxes, self.gop.boxes
        cuts = self.cuts_units if ax == 0 else self.cuts_y
        slabs = self._slab if ax == 0 else self._slab_y
        bot, top = ((self._bot_cut, self._top_cut) if ax == 0
                    else (self._bot_cut_y, self._top_cut_y))
        faceL = [int(np.prod(lb.lattice_shape) // lb.lattice_shape[ax])
                 for lb in lboxes]
        T = sum(faceL)
        segs = np.zeros((n_shards, 2 * T), np.int32)
        wm = np.zeros((n_shards, 2 * T))
        wr = np.zeros((n_shards, 2 * T))
        ws = np.zeros((n_shards, 2 * T))
        idxs = np.zeros((n_shards, 2 * T), np.int64)
        for s in range(n_shards):
            row = self._axis_row(s, ax)
            half_off = 0  # disjoint id blocks for the two cuts
            for half, c in ((0, int(cuts[row + 1])),
                            (1, int(cuts[row]))):
                base = half * T
                gvec = np.full(T, -1, np.int64)
                corner = np.zeros(T, bool)
                off = 0
                for bi in range(len(boxes)):
                    g = self._face_gids(bi, ax, c, s)
                    if g is not None:
                        gvec[off:off + faceL[bi]] = g
                        corner[off:off + faceL[bi]] = self._corner_mask(
                            bi, ax, s)
                    off += faceL[bi]
                ok = gvec >= 0
                if ok.any():
                    uniq, inv = np.unique(gvec[ok], return_inverse=True)
                    segs[s, base:base + T][ok] = inv + half_off
                    half_off += len(uniq)
                nbr = self._nbr(s, ax, +1 if half == 0 else -1)
                nrow = None if nbr is None else self._axis_row(nbr, ax)
                valid_m = np.zeros(T, bool)
                valid_r = np.zeros(T, bool)
                off = 0
                for bi, lb in enumerate(lboxes):
                    _, r, _ = slabs[bi]
                    sl = slice(off, off + faceL[bi])
                    okb = ok[off:off + faceL[bi]]
                    mine = (top if half == 0 else bot)[row, bi]
                    recv = (nrow is not None
                            and (bot if half == 0 else top)[nrow, bi])
                    lrow = int(r[row]) * p if half == 0 else 0
                    valid_m[sl] = okb & bool(mine)
                    valid_r[sl] = okb & bool(recv)
                    if mine:
                        idxs[s, base + off:base + off + faceL[bi]] = \
                            self._face_idx(bi, ax, lrow)
                    off += faceL[bi]
                # summation weights: in the SECOND (y) phase, corner
                # slots are already z-reconciled (all same-side copies
                # equal) and count once per (gid, side); the z phase sums
                # raw values everywhere
                wsum_m = valid_m.astype(np.float64)
                wsum_r = valid_r.astype(np.float64)
                if ax == 1:
                    for vec, wv in ((valid_m, wsum_m), (valid_r, wsum_r)):
                        seen: set = set()
                        cidx = np.nonzero(corner & vec)[0]
                        for k in cidx:
                            g = int(gvec[k])
                            if g in seen:
                                wv[k] = 0.0
                            else:
                                seen.add(g)
                wm[s, base:base + T] = wsum_m
                wr[s, base:base + T] = wsum_r
                ws[s, base:base + T] = valid_m.astype(np.float64)
        suff = "" if ax == 0 else "_y"
        self.params["cut_seg" + suff] = segs
        self.params["cut_wm" + suff] = wm
        self.params["cut_wr" + suff] = wr
        self.params["cut_ws" + suff] = ws
        self.params["cut_idx" + suff] = idxs.astype(np.int32)

    def _reconcile_tables(self, ax: int):
        """The device form of the axis-ax cut groups, per shard: the
        genuine set slots (``ws != 0``; distinct local indices), and for
        each the gather-sum table over [my top | my bottom | from next |
        from prev | 0] of its gid group's weighted members."""
        suff = "" if ax == 0 else "_y"
        pr = self.params
        out = []
        for s, dev in enumerate(self.mesh.devices):
            seg = pr["cut_seg" + suff][s].astype(np.int64)
            T2 = len(seg)
            seg2 = np.concatenate([seg, seg])
            w2 = np.concatenate([pr["cut_wm" + suff][s],
                                 pr["cut_wr" + suff][s]])
            sel = np.nonzero(pr["cut_ws" + suff][s] != 0.0)[0]
            live = np.nonzero(w2 != 0.0)[0]
            tc, tr, tv = transpose_table(live, seg2[live], w2[live],
                                         2 * T2)
            pos = np.searchsorted(tc, seg[sel])
            if len(sel) and not np.array_equal(
                    tc[np.minimum(pos, len(tc) - 1)], seg[sel]):
                raise AssertionError("cut slot without a weighted group")
            as_i = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                             device=dev)
            out.append(dict(
                y_idx=as_i(pr["cut_idx" + suff][s][sel]),
                self_pos=as_i(sel),
                tab=as_i(tr[pos]),
                tw=torch.as_tensor(tv[pos],
                                   dtype=self.dt, device=dev),
                top=[int(t) for t in pr[
                    "plane_top" if ax == 0 else "plane_top_y"][s]]))
        return out

    # ------------------------------------------------------------------
    def _slice_ax(self, arr, bi: int, s: int, ax: int, axis_pos: int,
                  per: int, pad_to: int, fill=0.0):
        """Slice box bi's shard-s axis-ax slab from a global per-box
        array along array axis ``axis_pos`` (``per`` entries per cell)."""
        slab = self._slab if ax == 0 else self._slab_y
        row = self._axis_row(s, ax)
        a, r, _ = slab[bi]
        lo, n = int(a[row]) * per, int(r[row]) * per
        out_shape = (arr.shape[:axis_pos] + (pad_to,)
                     + arr.shape[axis_pos + 1:])
        out = np.full(out_shape, fill, dtype=arr.dtype)
        if n > 0:
            so = [slice(None)] * arr.ndim
            si_ = [slice(None)] * arr.ndim
            so[axis_pos] = slice(0, n)
            si_[axis_pos] = slice(lo, lo + n)
            out[tuple(so)] = arr[tuple(si_)]
        return out

    def _loc_nodes(self, arr, bi: int, s: int):
        """Localize a full-lattice per-box node array to shard s's slab
        (both sharded axes), zero-filling dead rows.  arr's leading dims
        are the box's global lattice."""
        b, lb, p = self.gop.boxes[bi], self.lboxes[bi], self.p
        az, rz, _ = self._slab[bi]
        iz = self._axis_row(s, 0)
        okz, gz = _slab_rows(int(az[iz]), int(rz[iz]), p,
                             lb.lattice_shape[0], 0, b.lattice_shape[0])
        out = arr[gz] * okz.reshape((-1,) + (1,) * (arr.ndim - 1))
        if self.sy > 1:
            ay, ry, _ = self._slab_y[bi]
            iy = self._axis_row(s, 1)
            oky, gy = _slab_rows(int(ay[iy]), int(ry[iy]), p,
                                 lb.lattice_shape[1], 0,
                                 b.lattice_shape[1])
            out = out[:, gy] * oky.reshape((1, -1) + (1,)
                                           * (arr.ndim - 2))
        return out

    def _shard_params(self, s: int):
        """Shard s's host plan (f64 numpy; the JAX package casts each
        array to the operator's dtype here, the port when it uploads)."""
        gop, d, p = self.gop, self.dim, self.p
        q1 = p + 1
        sy = self.sy
        iz, iy = self._axis_row(s, 0), self._axis_row(s, 1)
        pr: dict = {}
        # box args + interior mask + owner weights + E/G operators
        box_args, box_EG = [], []
        im_parts, w_parts = [], []
        im_g = to_host(gop.interior_mask)
        w_g = to_host(gop.w_owner)
        si = ShapeInfo(p, Quadrature.gauss(q1))
        for bi, (b, lb) in enumerate(zip(gop.boxes, self.lboxes)):
            NCZ = self._slab[bi][2]
            # interior mask + owner weights: slab node planes
            seg_im = im_g[b.offset : b.offset + b.n_nodes].reshape(
                b.lattice_shape)
            seg_w = w_g[b.offset : b.offset + b.n_nodes].reshape(
                b.lattice_shape)
            im_l = self._loc_nodes(seg_im, bi, s)
            w_l = self._loc_nodes(seg_w, bi, s)
            # shared planes owned by the lower shard along each axis
            if int(self._slab[bi][0][iz]) > 0:
                w_l[0] = 0.0
            if sy > 1 and int(self._slab_y[bi][0][iy]) > 0:
                w_l[:, 0] = 0.0
            im_parts.append(im_l.reshape(-1))
            w_parts.append(w_l.reshape(-1))
            # cell-loop operands
            _, arg1, arg2 = gop._box_args[bi]
            if gop._cell_scheme == "global-general":
                # the port keeps the packed metric component-major:
                # (ncomp, nqz[, nqy], ..., nqx)
                g = to_host(arg1)
                g = self._slice_ax(g, bi, s, 0, 1, q1, NCZ * q1)
                if sy > 1:
                    NCY = self._slab_y[bi][2]
                    g = self._slice_ax(g, bi, s, 1, 2, q1, NCY * q1)
                box_args.append((g, np.zeros(1)))
            else:
                wb = to_host(arg2)  # (nz, q1, ny, q1[, nx, q1])
                wb = self._slice_ax(wb, bi, s, 0, 0, 1, NCZ)
                if sy > 1:
                    NCY = self._slab_y[bi][2]
                    wb = self._slice_ax(wb, bi, s, 1, 2, 1, NCY)
                box_args.append((to_host(arg1), wb))
            E_t, G_t = gop._box_EG[bi]
            Ez, Gz = global_interp_matrices(p, NCZ, si.S, si.D_col)
            E_loc = (np.asarray(Ez, np.float64),)
            G_loc = (np.asarray(Gz, np.float64),)
            if sy > 1:
                NCY = self._slab_y[bi][2]
                Ey, Gy = global_interp_matrices(p, NCY, si.S, si.D_col)
                E_loc += (np.asarray(Ey, np.float64),)
                G_loc += (np.asarray(Gy, np.float64),)
            k = len(E_loc)
            box_EG.append(
                (E_loc + tuple(to_host(E) for E in E_t[k:]),
                 G_loc + tuple(to_host(G) for G in G_t[k:])))
        pr["box_args"] = tuple(box_args)
        pr["box_EG"] = tuple(box_EG)
        pr["interior_mask"] = np.concatenate(im_parts)
        pr["w_owner"] = np.concatenate(w_parts)

        # pair transfers: sharded-axis factors/masks localized per shard
        if gop._pair_meta:
            pair_P, pair_h, pair_alive = [], [], []
            pair_msh, pair_E, pair_S = [], [], []
            nax = 2 if sy > 1 else 1  # localized tensor axes
            for i, meta in enumerate(gop._pair_meta):
                bc, bf = meta["bc"], meta["bf"]
                Pt = gop._pair_P[i]
                St = gop._pair_S[i]
                hg = to_host(gop._pair_h[i])
                Eg = to_host(gop._pair_E[i])
                ag = to_host(gop._pair_alive[i])
                mg = to_host(gop._pair_msh[i])
                P_loc, S_loc = [], []
                okf_ax, okc_ax, oks_ax = [], [], []
                gf_ax, gc_ax, gsub_ax = [], [], []
                for ax in range(nax):
                    slab = self._slab if ax == 0 else self._slab_y
                    row = self._axis_row(s, ax)
                    ac, rc, _ = slab[bc]
                    af, rf, _ = slab[bf]
                    Lc = self.lboxes[bc].lattice_shape[ax]
                    Lf = self.lboxes[bf].lattice_shape[ax]
                    d0 = meta["dst_sl"][ax].start
                    nf = meta["dst_sl"][ax].stop - d0
                    s0 = meta["src_sl"][ax].start
                    nc = meta["src_sl"][ax].stop - s0
                    j0 = meta["sub_c"][ax].start
                    nsub = meta["sub_c"][ax].stop - j0
                    okf, gf = _slab_rows(int(af[row]), int(rf[row]), p,
                                         Lf, d0, nf)
                    okc, gc = _slab_rows(int(ac[row]), int(rc[row]), p,
                                         Lc, s0, nc)
                    oks, gsub = _slab_rows(int(ac[row]), int(rc[row]), p,
                                           Lc, j0, nsub)
                    Pg = to_host(Pt[ax])
                    Sg = to_host(St[ax])
                    mk = (okf[:, None] & okc[None, :]).astype(np.float64)
                    P_loc.append(Pg[np.ix_(gf, gc)] * mk)
                    # S rows live on the coarse sub grid, cols on the
                    # fine dst
                    mk = (oks[:, None] & okf[None, :]).astype(np.float64)
                    S_loc.append(Sg[np.ix_(gsub, gf)] * mk)
                    okf_ax.append(okf)
                    okc_ax.append(okc)
                    oks_ax.append(oks)
                    gf_ax.append(gf)
                    gc_ax.append(gc)
                    gsub_ax.append(gsub)

                def _loc_mask(arr, oks_, gs_):
                    out = arr[gs_[0]] * oks_[0].reshape(
                        (-1,) + (1,) * (arr.ndim - 1))
                    for ax in range(1, len(gs_)):
                        sh = [1] * arr.ndim
                        sh[ax] = -1
                        out = np.take(out, gs_[ax], axis=ax) \
                            * oks_[ax].reshape(sh)
                    return out

                h_l = _loc_mask(hg, okf_ax, gf_ax)
                E_l = _loc_mask(Eg, okf_ax, gf_ax)
                a_l = _loc_mask(ag, okc_ax, gc_ax)
                m_l = _loc_mask(mg, oks_ax, gsub_ax)
                # cut-plane rows are excluded from the local sweeps: they
                # are reconciled exactly by the cross-shard plane groups
                # (raw-partial sums over every box/shard copy)
                if self._bot_cut[iz, bf]:
                    E_l[0] = 0.0
                if self._top_cut[iz, bf]:
                    E_l[int(self._slab[bf][1][iz]) * p] = 0.0
                if self._bot_cut[iz, bc]:
                    m_l[0] = 0.0
                if self._top_cut[iz, bc]:
                    m_l[int(self._slab[bc][1][iz]) * p] = 0.0
                if sy > 1:
                    if self._bot_cut_y[iy, bf]:
                        E_l[:, 0] = 0.0
                    if self._top_cut_y[iy, bf]:
                        E_l[:, int(self._slab_y[bf][1][iy]) * p] = 0.0
                    if self._bot_cut_y[iy, bc]:
                        m_l[:, 0] = 0.0
                    if self._top_cut_y[iy, bc]:
                        m_l[:, int(self._slab_y[bc][1][iy]) * p] = 0.0
                pair_P.append(tuple(P_loc)
                              + tuple(to_host(M) for M in Pt[nax:]))
                pair_S.append(tuple(S_loc)
                              + tuple(to_host(M) for M in St[nax:]))
                pair_h.append(h_l)
                pair_E.append(E_l)
                pair_alive.append(a_l)
                pair_msh.append(m_l)
            pr.update(pair_P=tuple(pair_P), pair_h=tuple(pair_h),
                      pair_alive=tuple(pair_alive),
                      pair_msh=tuple(pair_msh), pair_E=tuple(pair_E),
                      pair_S=tuple(pair_S))
        return pr

    # ---- IO boundaries (host) ----------------------------------------
    def _loc_window(self, bi: int, s: int):
        """(z window, y window, valid) node-row windows of box bi's
        shard-s slab in the GLOBAL box lattice + local plane counts."""
        p = self.p
        az, rz, _ = self._slab[bi]
        iz, iy = self._axis_row(s, 0), self._axis_row(s, 1)
        if int(rz[iz]) == 0:
            return None
        npz = int(rz[iz]) * p + 1
        loz = int(az[iz]) * p
        if self.sy > 1:
            ay, ry, _ = self._slab_y[bi]
            if int(ry[iy]) == 0:
                return None
            npy = int(ry[iy]) * p + 1
            loy = int(ay[iy]) * p
        else:
            b = self.gop.boxes[bi]
            npy = b.lattice_shape[1] if self.dim > 1 else 1
            loy = 0
        return loz, npz, loy, npy

    def to_local(self, u_patch) -> np.ndarray:
        """Global patch vector -> (n_shards, NL) stacked local slabs."""
        u = to_host(u_patch) if isinstance(u_patch, torch.Tensor) \
            else np.asarray(u_patch)
        out = np.zeros((self.n_shards, self.NL), dtype=u.dtype)
        for s in range(self.n_shards):
            for bi, (b, lb) in enumerate(zip(self.gop.boxes,
                                             self.lboxes)):
                win = self._loc_window(bi, s)
                if win is None:
                    continue
                loz, npz, loy, npy = win
                seg = u[b.offset : b.offset + b.n_nodes].reshape(
                    b.lattice_shape)
                dst = out[s, lb.offset : lb.offset
                          + int(np.prod(lb.lattice_shape))].reshape(
                              lb.lattice_shape)
                dst[:npz, :npy] = seg[loz : loz + npz, loy : loy + npy]
        return out

    def from_local(self, u_local) -> np.ndarray:
        """Owned planes of the stacked local vector -> global patch
        (shared cut planes belong to the lower shard along each axis).
        Takes a ``Sharded`` vector or the stacked host array."""
        u = (self.mesh.stack(u_local) if isinstance(u_local, Sharded)
             else np.asarray(u_local))
        out = np.zeros(self.gop.n_patch, dtype=u.dtype)
        for s in range(self.n_shards):
            iz, iy = self._axis_row(s, 0), self._axis_row(s, 1)
            for bi, (b, lb) in enumerate(zip(self.gop.boxes,
                                             self.lboxes)):
                win = self._loc_window(bi, s)
                if win is None:
                    continue
                loz, npz, loy, npy = win
                fz = 0 if int(self._slab[bi][0][iz]) == 0 else 1
                fy = 0
                if self.sy > 1 and int(self._slab_y[bi][0][iy]) > 0:
                    fy = 1
                seg = u[s, lb.offset : lb.offset
                        + int(np.prod(lb.lattice_shape))].reshape(
                            lb.lattice_shape)
                dst = out[b.offset : b.offset + b.n_nodes].reshape(
                    b.lattice_shape)
                dst[loz + fz : loz + npz, loy + fy : loy + npy] = (
                    seg[fz:npz, fy:npy])
        return out

    def put_vector(self, u_patch) -> Sharded:
        """Global patch vector (tensor or host array) -> Sharded local
        slabs in the operator's dtype."""
        return self.mesh.put(self.to_local(u_patch), dtype=self.dt)

    # ---- collectives ---------------------------------------------------
    def _reconcile_axis(self, y: Sharded, ax: int) -> Sharded:
        """Cross-shard compress of the axis-ax cut planes: exchange RAW
        per-box plane faces (two single-neighbor ppermutes), sum each
        physical node over its (box, shard-side) copies through the
        gather-sum tables, and SET every local copy to the total.  Both
        shards of a cut reconstruct identical totals from symmetric
        information, so one round trip suffices — the compress(add) +
        update_ghost_values pair of SURVEY.md §3.6 fused into a single
        exchange.  Writes into ``y``'s parts, which the apply made."""
        ns = self.sz if ax == 0 else self.sy
        aname = self.axis_name if ax == 0 else self.axis_name_y
        tabs = self._recon[ax]
        tops, bots = [], []
        for s, ys in enumerate(y.parts):
            tt, bb = [], []
            for bi, lb in enumerate(self.lboxes):
                n = int(np.prod(lb.lattice_shape))
                seg = ys[lb.offset : lb.offset + n].view(lb.lattice_shape)
                tt.append(seg.select(ax, tabs[s]["top"][bi]).reshape(-1))
                bb.append(seg.select(ax, 0).reshape(-1))
            tops.append(torch.cat(tt))
            bots.append(torch.cat(bb))
        top, bot = Sharded(tops), Sharded(bots)
        if ns > 1:
            # from row+1: their bottom faces (pair with my top cut)
            from_next = self.mesh.ppermute(
                bot, aname, [(k, k - 1) for k in range(1, ns)])
            # from row-1: their top faces (pair with my bottom cut)
            from_prev = self.mesh.ppermute(
                top, aname, [(k, k + 1) for k in range(ns - 1)])
        else:
            from_next = torch.zeros_like(bot)
            from_prev = torch.zeros_like(top)
        for s, ys in enumerate(y.parts):
            t = tabs[s]
            buf = torch.cat([top.parts[s], bot.parts[s], from_next.parts[s],
                             from_prev.parts[s], ys.new_zeros(1)])
            tot = (t["tw"] * buf[t["tab"]]).sum(dim=1)
            ys[t["y_idx"]] = ys[t["y_idx"]] + (tot - buf[t["self_pos"]])
        return y

    def vmult(self, x_local: Sharded) -> Sharded:
        """Sharded local patch vector -> the constrained apply, same
        layout: each shard's partial apply, the cut-plane reconciliation
        (z, then y on a 2-axis mesh), the mask algebra."""
        y = Sharded(lo.raw_local(xs)
                    for lo, xs in zip(self.locals, x_local.parts))
        y = self._reconcile_axis(y, 0)
        if self.sy > 1:
            # the y phase reads the z-reconciled values (corner lines
            # count once per side via the representative weights)
            y = self._reconcile_axis(y, 1)
        return self.interior_mask * y + self._exterior * x_local

    def dot(self, u: Sharded, v: Sharded) -> Sharded:
        """Owner-weighted dot, psum'd in fixed shard order."""
        return self.mesh.psum(smap(lambda w, a, b: torch.dot(w * a, b),
                                   self.w_owner, u, v))

    def diagonal_local(self, diag_patch=None) -> np.ndarray:
        """(n_shards, NL) slab diagonal (pads/dead get 1).  Both copies of
        a shared plane carry the value, so the Jacobi M_inv is consistent
        across shards.  ``diag_patch``: the operator's patch diagonal when
        the caller has it (else ``gop.diagonal()``); kept after the first
        call."""
        if self._diag_local is None:
            dg = to_host(self.gop.diagonal() if diag_patch is None
                       else diag_patch)
            loc = self.to_local(dg)
            self._diag_local = np.where(loc != 0.0, loc, 1.0)
        return self._diag_local

    def cg_solve(self, b_local: Sharded, diag_local, x0=None, rtol=1e-10,
                 maxiter=10000, precond: str = "jacobi",
                 cheb_degree: int = 4):
        """Distributed preconditioned CG on the Sharded patch vector with
        the owner-weighted psum dot.  precond "chebyshev" smooths with
        degree-``cheb_degree`` Chebyshev, theta/delta estimated once on
        the global operator (the single-device path's estimate, so the
        counts are the same); its inner applies carry the plane
        exchanges but no dot products."""
        if not isinstance(diag_local, Sharded):
            diag_local = self.mesh.put(diag_local, dtype=self.dt)
        if precond == "chebyshev":
            gop = self.gop
            if cheb_degree not in gop._cheb_cache:
                gop._cheb_cache[cheb_degree] = gop.cheb_params(
                    gop.diagonal(), degree=cheb_degree)
            cp = gop._cheb_cache[cheb_degree]
            inv_diag = 1.0 / diag_local
            M_inv = lambda r: chebyshev_smooth(self.vmult, inv_diag, cp, r)
        else:
            M_inv = lambda r: r / diag_local
        return _cg_solve(self.vmult, b_local, M_inv=M_inv, x0=x0,
                         rtol=rtol, maxiter=maxiter, dot=self.dot)

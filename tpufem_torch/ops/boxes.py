"""Box-structured apply tier for adaptive (2:1 forest) meshes.

Port of ``tpufem/ops/boxes.py``.  Cells of size ``s`` in a 2:1 forest
have s-aligned origins, so each size group lives on a sparse sub-lattice.
Per group the tier takes the bounding-box lattice and runs a gather-free
cell loop of ``ops.structured`` (or ``ops.dense_local``) over the whole
box, inactive cells masked by zero quadrature weights.

- The solver vector is the concatenation of the per-box node lattices
  (the "patchwork vector"); CG updates are elementwise, and dots carry
  0/1 owner weights so that each DoF counts once.
- Nodes shared between boxes are duplicated; after each raw apply the
  copies are reconciled (sum the partial results of all copies, write
  the total back), by dense sweeps over the 2:1 pair overlaps
  (``box_pairs``) and a small index fallback.  Hanging nodes apply C and
  C^T, densely per 2:1 pair where ``box_interface`` proved the rows
  tensor-structured, by index lists in patch coordinates elsewhere.

Correctness contract: ``vmult`` equals the condensed assembled operator
C^T A C with identity on constrained rows, to rounding.

The port differs from the JAX package in form only:
- it is eager: the device tensors are attributes, nothing is threaded
  through ``jit`` as an argument;
- every index write goes to distinct indices.  Where the JAX package adds
  into repeated indices (its segment sum and C^T's scatter-add) the port
  sums through a transpose table built on the host (``matrix_free.
  transpose_table``), and where its index is a lattice slice the port
  adds into the slice, so every apply is the same from run to run on the
  card;
- an apply writes in place into the tensors it made itself (the masked
  input, the cell loop's result), never into one the caller holds; the
  public ``compress``, ``distribute`` and ``distribute_transpose`` clone
  their argument once;
- f32 runs true f32 (``utils.precision``), where the JAX package runs the
  pair and axis products at bf16x3 on its TPU (``axis_mm_precision``):
  the port's f32 box tier is the more exact of the two;
- the host tables are built in f64 numpy and cast on the device (numpy
  has no bfloat16).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo
from tpufem_torch.ops.dense_local import (
    build_dense_local_matrix,
    laplace_apply_dense,
)
from tpufem_torch.ops.matrix_free import resolve_device, transpose_table
from tpufem_torch.ops.structured import (
    _axis_mm,
    global_interp_matrices,
    laplace_apply_global_diag,
    laplace_apply_global_general,
    laplace_apply_structured,
    sym_metric_components,
)
from tpufem_torch.solvers.cg import cg_solve as _cg_solve
from tpufem_torch.solvers.chebyshev import (
    chebyshev_smooth,
    make_chebyshev_params,
)
from tpufem_torch.utils.precision import torch_dtype

_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.bfloat16: "bfloat16"}


@dataclasses.dataclass
class Box:
    """One size group's bounding-box lattice (host/static data)."""

    size: int  # cell edge length in mesh integer units
    lo: np.ndarray  # (d,) lattice origin in size units, xyz order
    nb: tuple  # cells per axis, (z, ..., x) order (slowest first)
    cells: np.ndarray  # mesh cell indices in this group
    lattice_shape: tuple  # node lattice shape, (z, ..., x) order
    gid: np.ndarray  # lattice_shape int64 global DoF id, -1 = dead node
    active: np.ndarray  # nb bool — cell present in the mesh
    offset: int = 0  # start of this box's segment in the patch vector

    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.lattice_shape))


def _local_lattice(p: int, d: int) -> np.ndarray:
    """(nn, d) per-axis local node index, xyz column order, x fastest."""
    n1 = p + 1
    idx = np.arange(n1**d)
    return np.stack([(idx // n1**a) % n1 for a in range(d)], axis=-1)


def build_boxes(mesh: Mesh, dofs: DoFHandler) -> list[Box]:
    """Group leaves by size; one bounding-box lattice per group (copy of
    the JAX package's ``build_boxes``)."""
    p, d = dofs.degree, mesh.dim
    I = _local_lattice(p, d)  # (nn, d) xyz
    boxes: list[Box] = []
    offset = 0
    for s in sorted(np.unique(mesh.sizes).tolist(), reverse=True):
        sel = np.nonzero(mesh.sizes == s)[0]
        lat = mesh.origins[sel] // s  # (ng, d) xyz
        lo = lat.min(axis=0)
        nb_xyz = lat.max(axis=0) - lo + 1
        rel = lat - lo  # (ng, d)
        nb = tuple(int(x) for x in nb_xyz[::-1])  # (z, ..., x)
        lattice_shape = tuple(n * p + 1 for n in nb)
        active = np.zeros(nb, dtype=bool)
        active[tuple(rel[:, a] for a in range(d - 1, -1, -1))] = True
        gid = np.full(lattice_shape, -1, dtype=np.int64)
        # node position per (cell, local node), per axis: rel*p + I
        pos = rel[:, None, :] * p + I[None, :, :]  # (ng, nn, d) xyz
        flat = np.zeros(pos.shape[:2], dtype=np.int64)
        for a in range(d):  # x fastest in memory (C order, z leading)
            stride = int(np.prod(lattice_shape[d - a :])) if a else 1
            flat += pos[:, :, a] * stride
        gid.reshape(-1)[flat.ravel()] = dofs.cell_dofs[sel].ravel()
        boxes.append(Box(
            size=int(s), lo=lo, nb=nb, cells=sel,
            lattice_shape=lattice_shape, gid=gid, active=active,
            offset=offset,
        ))
        offset += int(np.prod(lattice_shape))
    return boxes


def _copies_by_gid(boxes: list[Box]):
    """gid -> np.ndarray of flat patch indices (all copies, owner first)."""
    all_gid = np.concatenate([b.gid.reshape(-1) for b in boxes])
    live = np.nonzero(all_gid >= 0)[0]
    order = np.argsort(all_gid[live], kind="stable")
    live = live[order]
    g = all_gid[live]
    starts = np.nonzero(np.concatenate([[True], g[1:] != g[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(g)]])
    return g[starts], live, starts, ends


def _set_table(idx: np.ndarray, valid: np.ndarray):
    """The genuine slots of a padded (n, K) copy table: their flat patch
    indices (distinct: each patch entry is one copy of one DoF) and their
    rows.  ``y[slots] = v[rows]`` is the reference's set of
    ``repeat(v, K)`` at ``idx.reshape(-1)``, whose pad slots repeat the
    row's first copy with the same value."""
    rows, cols = np.nonzero(valid)
    return idx[rows, cols], rows


def _cast_floats(v, dt: torch.dtype):
    """``v`` with every floating tensor in it (tuples, lists and dicts
    walked) cast to ``dt``; anything else unchanged."""
    if isinstance(v, torch.Tensor):
        return v.to(dt) if v.is_floating_point() else v
    if type(v) in (tuple, list):
        return type(v)(_cast_floats(a, dt) for a in v)
    if isinstance(v, dict):
        return {k: _cast_floats(a, dt) for k, a in v.items()}
    return v


class BoxLaplaceOperator:
    """Matrix-free Laplace on an adaptive mesh in patchwork representation.

    The whole solver loop (CG + Jacobi/Chebyshev) runs on the patch vector;
    ``to_patch`` / ``from_patch`` convert at the boundaries of the
    computation only.  ``cell_scheme``: "global" (global quadrature-grid
    matmuls, the default), "dense" (one shared local matrix a box,
    constant coefficient only; else "structured"), "structured" (the
    blocked sum factorisation) or, forced on curved meshes,
    "global-general" (the per-qpoint packed metric).
    """

    def __init__(
        self,
        mesh: Mesh,
        dofs: DoFHandler,
        constraints=None,  # AffineConstraints (hanging nodes), or None
        coefficient: Optional[Callable] = None,
        dtype: str = "float32",
        constrained_mask: Optional[np.ndarray] = None,
        structured_interfaces: bool = True,
        cell_scheme: str = "global",
        device: torch.device | str = "cuda",
    ):
        self.device = resolve_device(device)
        if (mesh.transform is not None
                or getattr(mesh, "support_points", None) is not None):
            # curved adaptive or support-point geometry: the per-box cell
            # loop carries the full per-qpoint packed symmetric metric
            # (dead lattice cells get G = 0)
            cell_scheme = "global-general"
        self.mesh, self.dofs = mesh, dofs
        self.coefficient = coefficient
        p, d = dofs.degree, mesh.dim
        self.p, self.dim = p, d
        self.dt = torch_dtype(dtype)
        quad = Quadrature.gauss(p + 1)
        si = ShapeInfo(p, quad)
        self.S = self._dev(si.S)
        self.D_col = self._dev(si.D_col)
        self.boxes = build_boxes(mesh, dofs)
        self.n_patch = sum(b.n_nodes for b in self.boxes)
        self.n_dofs = dofs.n_dofs

        # ---- per-box apply constants -------------------------------------
        if cell_scheme == "dense" and coefficient is not None:
            cell_scheme = "structured"
        self._cell_scheme = cell_scheme
        w1 = np.asarray(quad.weights_1d)
        ext = mesh.upper - mesh.lower  # (d,) physical extents, xyz
        self._dense = cell_scheme == "dense"
        self._box_args = []  # per box (nb, arg1, arg2) of its cell loop
        self._box_EG = []  # per box ((E z..x), (Gd z..x)), global schemes
        eg_cache: dict = {}
        gsym_cells = None
        if cell_scheme == "global-general":
            from tpufem_torch.fem.mapping import compute_metric

            metric = compute_metric(mesh, quad,
                                    need_points=coefficient is not None)
            jxw = metric.jxw
            if coefficient is not None:
                jxw = jxw * coefficient(
                    metric.quad_points.reshape(-1, d)
                ).reshape(jxw.shape)
            gsym_cells = sym_metric_components(metric.inv_jac, jxw)
        q1 = p + 1
        ncomp = d * (d + 1) // 2
        for b in self.boxes:
            h = b.size / mesh.U * ext  # (d,) physical cell widths, xyz
            scale = self._dev(1.0 / h**2 * np.prod(h))
            if cell_scheme in ("global", "global-general"):
                EG = []
                for n_ax in b.nb:  # tensor-axis order z..x
                    if n_ax not in eg_cache:
                        E, Gd = global_interp_matrices(p, n_ax, si.S,
                                                       si.D_col)
                        eg_cache[n_ax] = (self._dev(E), self._dev(Gd))
                    EG.append(eg_cache[n_ax])
                self._box_EG.append(
                    (tuple(e for e, _ in EG), tuple(g for _, g in EG)))
                if cell_scheme == "global-general":
                    # packed symmetric metric on the box q-grid, dead
                    # cells G = 0; component-major, as ops.structured
                    # takes it
                    rel = mesh.origins[b.cells] // b.size - b.lo  # xyz
                    gs = gsym_cells[b.cells].reshape(
                        (len(b.cells),) + (q1,) * d + (ncomp,))
                    blk = np.zeros(tuple(np.ravel(
                        [(n, q1) for n in b.nb])) + (ncomp,))
                    ix: list = []
                    for a in range(d):  # tensor-axis order z..x
                        ix.append(rel[:, d - 1 - a])
                        ix.append(slice(None))
                    blk[tuple(ix)] = gs
                    gbox = blk.reshape(
                        tuple(n * q1 for n in b.nb) + (ncomp,))
                    self._box_args.append(
                        (b.nb, self._dev(np.moveaxis(gbox, -1, 0)), None))
                    continue
                wb = self._weight_block(b, w1)
                if coefficient is not None:
                    wb = wb * self._coef_block(b, coefficient, quad)
                self._box_args.append((b.nb, scale, self._dev(wb)))
                continue
            if self._dense:
                # the scale rounded to the dtype first, as the reference
                # builds its local matrix from the device scale
                A_loc = build_dense_local_matrix(
                    p, d, p + 1, scale.to(torch.float64).cpu().numpy())
                amask = self._dev(b.active.reshape(-1).astype(np.float64))
                self._box_args.append((b.nb, self._dev(A_loc), amask))
                continue
            wb = self._weight_block(b, w1)
            if coefficient is not None:
                # the reference multiplies by the coefficient block
                # unconditionally and so raises without a coefficient
                # (ROADMAP.md queue 3, observations); the port reads no
                # coefficient as 1
                wb = wb * self._coef_block(b, coefficient, quad)
            self._box_args.append((b.nb, scale, self._dev(wb)))

        # ---- copy reconciliation (compress) -----------------------------
        gids, live, starts, ends = _copies_by_gid(self.boxes)
        counts = ends - starts
        self._owner = np.full(self.n_dofs, -1, dtype=np.int64)
        self._owner[gids] = live[starts]
        if np.any(self._owner < 0):
            raise AssertionError("DoF without a patch copy")
        multi = np.nonzero(counts > 1)[0]
        Kc = int(counts[multi].max()) if len(multi) else 1
        m_idx = np.zeros((len(multi), Kc), dtype=np.int64)
        m_w = np.zeros((len(multi), Kc))
        for r, gi in enumerate(multi):
            c = live[starts[gi] : ends[gi]]
            m_idx[r, : len(c)] = c
            m_idx[r, len(c) :] = c[0]  # pad = owner (0-weight / re-set)
            m_w[r, : len(c)] = 1.0
        self._multi_idx = self._idx(m_idx)
        self._multi_w = self._dev(m_w)
        self._multi_set = tuple(map(self._idx, _set_table(m_idx, m_w > 0)))
        self._Kc = Kc

        # owner weights for dots (1 exactly once per DoF)
        w_own = np.zeros(self.n_patch)
        w_own[self._owner] = 1.0
        self.w_owner = self._dev(w_own)

        # ---- constraints mapped to patch coordinates --------------------
        self.constraints = constraints
        con_mask_g = np.zeros(self.n_dofs, dtype=bool)
        if constrained_mask is None:
            constrained_mask = dofs.boundary_mask
        con_mask_g |= constrained_mask
        self._rect_meta = []
        self._rect_groups = []
        self._pairs = []
        self.n_rect_rows = 0
        if constraints is not None and constraints.lines:
            con_mask_g |= constraints.constrained_mask()
            cdofs, masters, weights, inhom = constraints.padded_arrays()
            cdofs_all = cdofs
            if structured_interfaces:
                from tpufem_torch.ops.box_interface import (
                    build_interface_rects,
                )

                rects, leftover = build_interface_rects(
                    self.boxes, constraints, p, d)
                if structured_interfaces != "rects":
                    # dense 2:1 pair transfers (box_pairs): index-free
                    # C/C^T; rects whose region does not fit stay on the
                    # gather fallback
                    from tpufem_torch.ops.box_pairs import build_pair_plans

                    plans, dropped = build_pair_plans(
                        self.boxes, rects, p, d)
                    if dropped:
                        extra = np.unique(np.concatenate(
                            [r.rows for r in dropped]))
                        leftover = np.union1d(leftover, extra)
                    drop_ids = {id(r) for r in dropped}
                    rects = [r for r in rects if id(r) not in drop_ids]
                    self._pairs = plans
                for r in rects:
                    self._rect_meta.append((r.bf, r.bc, r.fslice, r.cslice))
            if self._pairs:
                self.n_rect_rows = len(cdofs) - len(leftover)
            elif structured_interfaces:
                self._build_rect_groups(rects)
                self.n_rect_rows = len(cdofs) - len(leftover)
            else:
                leftover = np.arange(len(cdofs))
            cdofs = cdofs[leftover]
            masters = masters[leftover]
            weights = weights[leftover]
            inhom = inhom[leftover]
            # gather masters from owner copies
            self._mast_idx = self._idx(self._owner[masters])
            self._mast_w = self._dev(weights)
            self._con_inhom = self._dev(inhom)
            # write interpolated values to every copy of each hanging dof
            cc_idx, cc_row = self._all_copies(cdofs, live, starts, ends,
                                              gids)
            self._con_first = self._idx(cc_idx[:, 0])
            self._con_set = tuple(map(self._idx,
                                      _set_table(cc_idx, cc_row > 0)))
            # C^T: (hanging value) * w added to every copy of the master,
            # as a gather-sum over the transpose table
            rows, tgt, wts = [], [], []
            for i in range(len(cdofs)):
                for j in range(masters.shape[1]):
                    if weights[i, j] == 0.0:
                        continue
                    for c in self._gid_copies(int(masters[i, j]), live,
                                              starts, ends, gids):
                        rows.append(i)
                        tgt.append(c)
                        wts.append(weights[i, j])
            tc, tr, tv = transpose_table(
                np.asarray(rows, np.int64), np.asarray(tgt, np.int64),
                np.asarray(wts, np.float64), len(cdofs))
            self._ct_T = (self._idx(tc), self._idx(tr), self._dev(tv))
            self.has_hanging = True
            self._has_fallback = len(cdofs) > 0
        else:
            self.has_hanging = False
            self._has_fallback = False

        # ---- dense pair-transfer device data (box_pairs) ----------------
        self._pair_meta = []
        self._single_compress = False
        if self._pairs:
            self._build_pair_data(m_idx, m_w, multi, gids, live, starts,
                                  ends, cdofs_all)

        # interior mask per patch entry: 0 on constrained copies AND dead
        m = np.zeros(self.n_patch)
        interior_g = ~con_mask_g
        for b in self.boxes:
            g = b.gid.reshape(-1)
            seg = np.zeros(b.n_nodes)
            ok = g >= 0
            seg[ok] = interior_g[g[ok]].astype(np.float64)
            m[b.offset : b.offset + b.n_nodes] = seg
        self.interior_mask = self._dev(m)
        self._exterior_mask = self._dev(1.0 - m)
        self._cheb_cache: dict = {}

    # ------------------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        """Host f64 data as a device tensor in the operator's dtype."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dt,
                               device=self.device)

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    @staticmethod
    def _weight_block(b: Box, w1: np.ndarray) -> np.ndarray:
        """Active-cell mask times the quadrature weights, broadcastable
        against the blocked layout (quadrature dims at odd positions)."""
        d = len(b.nb)
        wb = b.active.astype(np.float64).reshape(
            tuple(np.ravel([(n, 1) for n in b.nb])))
        for a in range(d):  # quadrature dims at odd positions, z..x
            sh = [1] * (2 * d)
            sh[2 * (d - 1 - a) + 1] = len(w1)
            wb = wb * w1.reshape(sh)
        return wb

    def _build_rect_groups(self, rects) -> None:
        """The rect tier's tables (``structured_interfaces="rects"``):
        rects batched into same-shape groups, one master-region gather for
        all groups, the owned rows as a sorted set of distinct indices,
        and C^T's sum onto the distinct masters through a transpose table
        (the reference's segment sum)."""
        by_shape: dict = {}
        for r in rects:
            by_shape.setdefault(r.mask.shape, []).append(r)
        fidx_np, cidx_np, mask_np = [], [], []
        self._rect_sizes = []
        self._rc_sizes = []
        for rs in by_shape.values():
            fidx = np.stack([self._region_indices(r.bf, r.fslice)
                             for r in rs])
            cidx = np.stack([self._region_indices(r.bc, r.cslice)
                             for r in rs])
            mask = np.stack([r.mask for r in rs])
            self._rect_groups.append(tuple(self._dev(Fk) for Fk in rs[0].F))
            self._rect_sizes.append((fidx.shape, fidx.size))
            self._rc_sizes.append((cidx.shape, cidx.size))
            fidx_np.append(fidx.reshape(-1))
            cidx_np.append(cidx.reshape(-1))
            mask_np.append(mask.reshape(-1) != 0)
        if not fidx_np:
            return
        self._rc_gather = self._idx(np.concatenate(cidx_np))
        fc = np.concatenate(fidx_np)
        cc = np.concatenate(cidx_np)
        mc = np.concatenate(mask_np)
        keep = np.nonzero(mc)[0]
        dst = fc[keep]
        assert len(np.unique(dst)) == len(dst), (
            "rect ownership masks must be row-disjoint")
        order = np.argsort(dst, kind="stable")
        self._rs_src = self._idx(keep[order])
        self._rs_dst = self._idx(dst[order])
        self._rs_keep = self._idx(keep)  # ascending
        self._rs_gather = self._idx(fc[keep])
        self._rs_total = int(len(fc))
        order_c = np.argsort(cc, kind="stable")
        cs = cc[order_c]
        seg = np.concatenate([[0], np.cumsum(cs[1:] != cs[:-1])])
        # segment s sums md[order_c[k]] over k with seg[k] == s: the
        # transpose table of (position, segment), padded with len(cc)
        _, tr, _ = transpose_table(order_c.astype(np.int64), seg,
                                   np.ones(len(seg)), len(cc))
        self._ct_seg = self._idx(tr)
        self._ct_uniq = self._idx(np.unique(cs))

    def _build_pair_data(self, m_idx, m_w, multi, gids, live, starts, ends,
                         cdofs_all) -> None:
        """Device data of the dense pair transfers, and the compress
        fallback of the multi DoFs the pair sweeps do not cover."""
        from tpufem_torch.ops.box_pairs import uncovered_multi_rows

        fb = uncovered_multi_rows(self.boxes, self._pairs, gids, live,
                                  starts, ends)
        # sweep-excluded rows must be UNTOUCHED by the sweeps: zero their
        # positions out of every msh mask so the index fallback sees
        # unmodified copies
        box_offs = np.array([b.offset for b in self.boxes])
        for r in fb:
            gi = multi[r]
            for c in live[starts[gi] : ends[gi]]:
                bi = int(np.searchsorted(box_offs, c, side="right")) - 1
                bx = self.boxes[bi]
                crd = np.unravel_index(int(c) - bx.offset, bx.lattice_shape)
                for pl in self._pairs:
                    if pl.bf == bi:
                        sls, arr = pl.sub_f, pl.msh
                    elif pl.bc == bi:
                        sls, arr = pl.sub_c, pl.msh
                    else:
                        continue
                    idx, inside = [], True
                    for a, sl in enumerate(sls):
                        st = sl.step or 1
                        if (crd[a] < sl.start or crd[a] >= sl.stop
                                or (crd[a] - sl.start) % st):
                            inside = False
                            break
                        idx.append((crd[a] - sl.start) // st)
                    if inside:
                        arr[tuple(idx)] = 0.0
        self._multi_fb_idx = self._idx(m_idx[fb])
        self._multi_fb_w = self._dev(m_w[fb])
        self._multi_fb_set = tuple(map(self._idx,
                                       _set_table(m_idx[fb], m_w[fb] > 0)))
        self._pair_P, self._pair_h, self._pair_1mh = [], [], []
        self._pair_alive, self._pair_msh, self._pair_1mmsh = [], [], []
        self._pair_E, self._pair_S = [], []
        for pl in self._pairs:
            self._pair_meta.append(dict(
                bc=pl.bc, bf=pl.bf, src_sl=pl.src_sl, dst_sl=pl.dst_sl,
                sub_f=pl.sub_f, sub_c=pl.sub_c))
            self._pair_P.append(tuple(self._dev(Pa) for Pa in pl.P))
            self._pair_h.append(self._dev(pl.h))
            self._pair_1mh.append(self._dev(1.0 - pl.h))
            self._pair_alive.append(self._dev(pl.alive))
            self._pair_msh.append(self._dev(pl.msh))
            self._pair_1mmsh.append(self._dev(1.0 - pl.msh))
            self._pair_E.append(self._dev(pl.E))
            self._pair_S.append(tuple(self._dev(Sa) for Sa in pl.S))
        # ONE compress per apply: C^T deltas fold into the partial field
        # before the single reconciliation — valid only when hanging rows
        # are single-copy (their partials are already totals) and no
        # gather-fallback C^T rows exist (those write to every master copy
        # directly, which double-counts under a later compress)
        hang_gids = set(int(g) for g in cdofs_all)
        multi_gids = set(int(g) for g in gids[multi])
        self._single_compress = (
            not (hang_gids & multi_gids) and not self._has_fallback)

    # ------------------------------------------------------------------
    def recast(self, dtype) -> "BoxLaplaceOperator":
        """Shallow dtype clone: shares all host structure (boxes, pair
        metadata, index tensors) and casts only the floating device
        tensors — equivalent to rebuilding with ``dtype=``, which casts
        the same host data, at no host cost.  The original is
        untouched."""
        new = copy.copy(self)
        dt = torch_dtype(dtype)
        for k, v in vars(self).items():
            setattr(new, k, _cast_floats(v, dt))
        new.dt = dt
        new._cheb_cache = {}
        return new

    # ------------------------------------------------------------------
    @staticmethod
    def _gid_copies(g, live, starts, ends, gids):
        gi = np.searchsorted(gids, g)
        return live[starts[gi] : ends[gi]]

    def _all_copies(self, dlist, live, starts, ends, gids):
        """(n, Kc) padded copy indices + 0/1 validity for a DoF list."""
        copies = [self._gid_copies(int(g), live, starts, ends, gids)
                  for g in dlist]
        K = max((len(c) for c in copies), default=1)
        idx = np.zeros((len(dlist), K), dtype=np.int64)
        row = np.zeros((len(dlist), K))
        for i, c in enumerate(copies):
            idx[i, : len(c)] = c
            idx[i, len(c) :] = c[0]
            row[i, : len(c)] = 1.0
        return idx, row

    def _coef_block(self, b: Box, coefficient, quad) -> np.ndarray:
        """Per-cell x per-qpoint coefficient on the box lattice, in the
        interleaved ([nz,qz,]ny,qy,nx,qx) layout (dead cells get the
        coefficient at their lattice position; their weight is 0)."""
        d, p = self.dim, self.p
        q1 = p + 1
        mesh = self.mesh
        qp = np.asarray(quad.points_1d)  # (q1,) on [0,1]
        axes = []
        for a in range(d):  # xyz
            nba = b.nb[d - 1 - a]
            cells = (b.lo[a] + np.arange(nba)) * b.size  # lattice origins
            x = (cells[:, None] + b.size * qp[None, :]) / mesh.U
            axes.append(mesh.lower[a]
                        + (mesh.upper[a] - mesh.lower[a]) * x)  # (nba, q1)
        shape = tuple(np.ravel([(b.nb[k], q1) for k in range(d)]))
        pts = np.zeros(shape + (d,))
        for a in range(d):
            k = d - 1 - a  # position among (z..x)
            sh = [1] * (2 * d)
            sh[2 * k], sh[2 * k + 1] = b.nb[k], q1
            pts[..., a] = axes[a].reshape(sh) * np.ones(shape)
        return coefficient(pts.reshape(-1, d)).reshape(shape)

    def _region_indices(self, bi: int, sl) -> np.ndarray:
        """Flat patch indices of a static lattice slice of box bi."""
        b = self.boxes[bi]
        grid = np.arange(b.n_nodes, dtype=np.int64).reshape(b.lattice_shape)
        return b.offset + grid[sl]

    # ------------------------------------------------------------------
    # patch <-> global transfers (setup/IO boundary only; host numpy)
    def to_patch(self, u_global: np.ndarray) -> torch.Tensor:
        u_global = np.asarray(u_global)
        out = np.zeros(self.n_patch, dtype=u_global.dtype)
        for b in self.boxes:
            g = b.gid.reshape(-1)
            ok = g >= 0
            seg = np.zeros(b.n_nodes, dtype=u_global.dtype)
            seg[ok] = u_global[g[ok]]
            out[b.offset : b.offset + b.n_nodes] = seg
        return torch.as_tensor(out, device=self.device).to(self.dt)

    def from_patch(self, u_patch) -> np.ndarray:
        if isinstance(u_patch, torch.Tensor):
            u = u_patch.detach().to("cpu", torch.float64).numpy()
        else:
            u = np.asarray(u_patch, dtype=np.float64)
        return u[self._owner]

    # ------------------------------------------------------------------
    # in-place forms: each writes into its argument, which the caller
    # owns (a tensor made earlier in the same apply)
    def _seg(self, u: torch.Tensor, bi: int) -> torch.Tensor:
        b = self.boxes[bi]
        return u[b.offset : b.offset + b.n_nodes].view(b.lattice_shape)

    @staticmethod
    def _pair_apply(P, U: torch.Tensor, transpose: bool = False):
        """Separable per-axis contraction (set-semantics prolongation or
        its transpose), one matmul an axis in U's dtype (a mixed cycle
        passes f32 vectors to a bf16 level)."""
        for a, Pa in enumerate(P):
            Pa = Pa.to(U.dtype)
            U = _axis_mm(Pa.T if transpose else Pa, U, a)
        return U

    def _compress_(self, y: torch.Tensor) -> torch.Tensor:
        """Sum partial contributions across all copies of each shared DoF
        and write the total to every copy: pair sweeps where the pairs
        cover the copies, a gather-sum and a write into distinct indices
        elsewhere."""
        if self._pair_meta:
            self._sweep_compress_(y)
            mi = self._multi_fb_idx
            if mi.shape[0]:
                tot = (y[mi] * self._multi_fb_w).sum(dim=1)
                slots, rows = self._multi_fb_set
                y[slots] = tot[rows]
            return y
        mi = self._multi_idx
        if mi.shape[0] == 0:
            return y
        tot = (y[mi] * self._multi_w).sum(dim=1)
        slots, rows = self._multi_set
        y[slots] = tot[rows]
        return y

    def _sweep_compress_(self, y: torch.Tensor) -> None:
        """Copy reconciliation over the pair chain: the down sweep adds the
        coarse partials onto the shared fine-lattice copies (the
        prolongation's exact identity rows, committed by E), the up sweep
        writes the fine totals back (selection matrices S)."""
        for i, meta in enumerate(self._pair_meta):  # coarse -> fine
            V = self._pair_apply(self._pair_P[i],
                                 self._seg(y, meta["bc"])[meta["src_sl"]])
            self._seg(y, meta["bf"])[meta["dst_sl"]].add_(
                self._pair_E[i] * V)
        for i in reversed(range(len(self._pair_meta))):  # fine -> coarse
            meta = self._pair_meta[i]
            Fs = self._pair_apply(self._pair_S[i],
                                  self._seg(y, meta["bf"])[meta["dst_sl"]])
            Cs = self._seg(y, meta["bc"])[meta["sub_c"]]
            Cs.copy_(self._pair_msh[i] * Fs + self._pair_1mmsh[i] * Cs)

    def _pair_distribute_(self, u: torch.Tensor) -> None:
        """Dense C: per pair, prolong the coarse overlap block and commit
        the verified hanging rows with the 0/1 ownership mask (masters are
        never hanging, so pair order is free)."""
        for i, meta in enumerate(self._pair_meta):
            V = self._pair_apply(self._pair_P[i],
                                 self._seg(u, meta["bc"])[meta["src_sl"]])
            blk = self._seg(u, meta["bf"])[meta["dst_sl"]]
            blk.copy_(blk * self._pair_1mh[i] + self._pair_h[i] * V)

    def _pair_restrict_hanging(self, y: torch.Tensor, i: int):
        """Pair i's C^T delta on its coarse block, with the pair's hanging
        rows of y zeroed in place."""
        meta = self._pair_meta[i]
        blk = self._seg(y, meta["bf"])[meta["dst_sl"]]
        dC = self._pair_apply(self._pair_P[i], blk * self._pair_h[i],
                              transpose=True) * self._pair_alive[i]
        blk.mul_(self._pair_1mh[i])
        return dC

    def _pair_distribute_t_(self, y: torch.Tensor) -> torch.Tensor:
        """Dense C^T: restrict the masked hanging rows onto the coarse
        blocks as a delta field, zero the hanging rows, reconcile the
        delta across shared copies with the compress, add."""
        delta = torch.zeros_like(y)
        for i, meta in enumerate(self._pair_meta):
            dC = self._pair_restrict_hanging(y, i)
            self._seg(delta, meta["bc"])[meta["src_sl"]].add_(dC)
        return y.add_(self._compress_(delta))

    def _pair_delta_t_inline_(self, y: torch.Tensor) -> None:
        """C^T folded into the partial field: hanging rows (single-copy,
        so partial == total) restricted onto the coarse blocks as partials;
        the one compress that follows reconciles both together."""
        for i, meta in enumerate(self._pair_meta):
            dC = self._pair_restrict_hanging(y, i)
            self._seg(y, meta["bc"])[meta["src_sl"]].add_(dC)

    @staticmethod
    def _rect_interp_b(F, Uc):
        """Batched V = F1 · U (·F2^T) over the rect dim r."""
        F = [Fk.to(Uc.dtype) for Fk in F]
        if len(F) == 1:
            return torch.einsum("af,rf->ra", F[0], Uc)
        return torch.einsum("af,bg,rfg->rab", F[0], F[1], Uc)

    @staticmethod
    def _rect_interp_t_b(F, Yf):
        F = [Fk.to(Yf.dtype) for Fk in F]
        if len(F) == 1:
            return torch.einsum("af,ra->rf", F[0], Yf)
        return torch.einsum("af,bg,rab->rfg", F[0], F[1], Yf)

    def _rect_distribute_(self, u: torch.Tensor) -> None:
        """Structured part of C, batched by rect shape group: all groups
        read the same pre-update vector (masters are never hanging rows),
        and the interpolated values are written once each into the
        sorted distinct owned rows."""
        uc_cat = u[self._rc_gather]  # ONE gather for every group
        vs, off = [], 0
        for F, (shape, size) in zip(self._rect_groups, self._rc_sizes):
            uc = uc_cat[off:off + size].view(shape)
            vs.append(self._rect_interp_b(F, uc).reshape(-1))
            off += size
        v_all = torch.cat(vs) if len(vs) > 1 else vs[0]
        u[self._rs_dst] = v_all[self._rs_src]

    def _rect_distribute_t_(self, y: torch.Tensor) -> None:
        """Structured part of C^T: owned rows read and zeroed, transpose-
        interpolated per group, summed onto the distinct masters through
        the transpose table, then reconciled across shared copies."""
        yk = y[self._rs_gather]  # owned-row values, keep (ascending) order
        y[self._rs_dst] = 0.0
        yf_cat = y.new_zeros(self._rs_total)
        yf_cat[self._rs_keep] = yk
        ds, off = [], 0
        for F, (shape, size) in zip(self._rect_groups, self._rect_sizes):
            yf = yf_cat[off:off + size].view(shape)
            ds.append(self._rect_interp_t_b(F, yf).reshape(-1))
            off += size
        md = torch.cat(ds + [y.new_zeros(1)])  # a zero for the table pad
        delta = torch.zeros_like(y)
        delta[self._ct_uniq] = md[self._ct_seg].sum(dim=1)
        y.add_(delta)
        # shared-copy fix: every copy of a multi DoF must carry the TOTAL
        # delta, not just its own box's share
        mi = self._multi_idx
        if mi.shape[0]:
            dtot = (delta[mi] * self._multi_w).sum(dim=1)
            base = y[mi[:, 0]] - delta[mi[:, 0]]
            slots, rows = self._multi_set
            y[slots] = (base + dtot)[rows]

    def _distribute_(self, u: torch.Tensor,
                     homogeneous: bool = True) -> torch.Tensor:
        if not self.has_hanging:
            return u
        if self._pair_meta:
            self._pair_distribute_(u)
        elif self._rect_groups:
            self._rect_distribute_(u)
        if not self._has_fallback:
            return u
        vals = (self._mast_w * u[self._mast_idx]).sum(dim=1)
        if not homogeneous:
            vals = vals + self._con_inhom
        slots, rows = self._con_set
        u[slots] = vals[rows].to(u.dtype)
        return u

    def _distribute_transpose_(self, y: torch.Tensor) -> torch.Tensor:
        if not self.has_hanging:
            return y
        if self._has_fallback:
            yc = torch.cat([y[self._con_first], y.new_zeros(1)])
            slots, _ = self._con_set
            y[slots] = 0.0
            tc, tr, tv = self._ct_T
            y[tc] = y[tc] + (tv * yc[tr]).sum(dim=1)
        if self._pair_meta:
            y = self._pair_distribute_t_(y)
        elif self._rect_groups:
            self._rect_distribute_t_(y)
        return y

    # ------------------------------------------------------------------
    def _cells(self, u: torch.Tensor) -> torch.Tensor:
        """Per-box cell loops, PARTIAL sums (copies unreconciled); a new
        tensor."""
        parts = []
        for i, (nb, arg1, arg2) in enumerate(self._box_args):
            b = self.boxes[i]
            xb = u[b.offset : b.offset + b.n_nodes]
            if self._cell_scheme == "global-general":
                E_list, G_list = self._box_EG[i]
                yb = laplace_apply_global_general(
                    xb, self.dim, nb, self.p, E_list, G_list, arg1)
            elif self._cell_scheme == "global":
                E_list, G_list = self._box_EG[i]
                yb = laplace_apply_global_diag(
                    xb, self.dim, nb, self.p, E_list, G_list, arg1, arg2)
            elif self._dense:
                yb = laplace_apply_dense(xb, self.dim, nb, self.p, arg1,
                                         mask_cells=arg2)
            else:
                yb = laplace_apply_structured(
                    xb, self.dim, nb, self.p, self.S, self.D_col, arg1,
                    arg2)
            parts.append(yb)
        return torch.cat(parts)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """Constrained apply y = m C^T A C (m x) + (1-m) x on the patch
        vector (same semantics as LaplaceOperator.vmult)."""
        m = self.interior_mask
        xh = self._distribute_(m * x)
        if self._single_compress and self._pair_meta:
            y = self._cells(xh)
            self._pair_delta_t_inline_(y)
            self._compress_(y)
        else:
            y = self._distribute_transpose_(self._compress_(self._cells(xh)))
        return m * y + self._exterior_mask * x

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Raw apply (A x in patch space, copies reconciled)."""
        return self._compress_(self._cells(x))

    def compress(self, y: torch.Tensor) -> torch.Tensor:
        return self._compress_(y.clone())

    def distribute(self, u: torch.Tensor,
                   homogeneous: bool = True) -> torch.Tensor:
        """u -> C u on the patch vector (hanging values interpolated)."""
        return self._distribute_(u.clone(), homogeneous=homogeneous)

    def distribute_transpose(self, y: torch.Tensor) -> torch.Tensor:
        """y -> C^T y: hanging-row values pushed to masters, zeroed."""
        return self._distribute_transpose_(y.clone())

    # ------------------------------------------------------------------
    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Owner-weighted dot == global-space dot."""
        return torch.dot(self.w_owner * a, b)

    def cheb_params(self, diag_patch, degree: int = 4,
                    smoothing_range: float = 20.0):
        """Chebyshev preconditioner parameters for the patch operator (the
        reference's ``PreconditionChebyshev`` over the box tier)."""
        return make_chebyshev_params(self.vmult, diag_patch, self.n_patch,
                                     degree=degree,
                                     smoothing_range=smoothing_range)

    def cg_solve(self, b_patch, diag_patch, x0=None, rtol=1e-10,
                 maxiter=10000, precond: str = "jacobi",
                 cheb_degree: int = 4):
        """Preconditioned CG in patch space with the owner-weighted dot.
        precond: "jacobi" (diagonal) or "chebyshev" (degree-``cheb_degree``
        Chebyshev over the Jacobi-preconditioned operator; its parameters
        are estimated once per degree and kept)."""
        if precond == "chebyshev":
            if cheb_degree not in self._cheb_cache:
                self._cheb_cache[cheb_degree] = self.cheb_params(
                    diag_patch, degree=cheb_degree)
            cp = self._cheb_cache[cheb_degree]
            inv_diag = 1.0 / diag_patch
            M_inv = lambda r: chebyshev_smooth(self.vmult, inv_diag, cp, r)
        else:
            M_inv = lambda r: r / diag_patch
        return _cg_solve(self.vmult, b_patch, M_inv=M_inv, x0=x0, rtol=rtol,
                         maxiter=maxiter, dot=self.dot)

    def diagonal(self) -> torch.Tensor:
        """Patch-space diagonal of the constrained operator (constrained
        and dead entries get 1), from the incidence tier's diagonal."""
        from tpufem_torch.operators.laplace import LaplaceOperator
        from tpufem_torch.ops.matrix_free import MatrixFree
        from tpufem_torch.utils.config import FemConfig

        cfg = FemConfig(dim=self.dim, degree=self.p,
                        dtype=_DTYPE_NAMES[self.dt], scatter="incidence")
        mf = MatrixFree.build(self.mesh, self.dofs, cfg, self.device,
                              coefficient=self.coefficient,
                              constraints=self.constraints)
        diag_g = LaplaceOperator(mf).diagonal().to(
            "cpu", torch.float64).numpy()
        d = np.ones(self.n_patch)
        for b in self.boxes:
            g = b.gid.reshape(-1)
            ok = g >= 0
            seg = np.ones(b.n_nodes)
            seg[ok] = diag_g[g[ok]]
            d[b.offset : b.offset + b.n_nodes] = seg
        # constrained entries are identity rows already (diag 1); dead = 1
        return self._dev(d)

"""General-mesh partitioner: distributed apply and solve on ARBITRARY cell
partitions — adaptive meshes with hanging nodes included.

Port of ``tpufem/parallel/general.py``, the counterpart of the
reference's ``GpuPartitioner`` + ``MultiGpuVector`` with arbitrary
owned/ghost index lists and two-phase exchange (SURVEY.md §2, §3.6).
The host plan (``GeneralPartitioner.build``) is the JAX package's numpy
code, held equal to it by the tests: cells go to shards (default:
balanced contiguous blocks), each DoF is owned by the lowest shard whose
cells reference it and is a ghost on every other, and the per-shard local
vector is

    [ owned (padded to P) | ghosts (padded to G) | 1 zero dump slot ].

- ``update_ghosts``: "a2a", the pairwise ``all_to_all`` of the padded
  per-pair lists (O(halo) traffic), or "gather", an ``all_gather`` of
  every owned block and a gather through ``ghost_src`` (O(N));
- ``compress_add``: the reverse exchange (a2a), or each shard's ghost
  partials in an (n_shards*P,) contribution vector, one ``psum``, each
  shard adding its own slice (gather);
- dots: per-shard owned-masked sums, ``psum``'d in fixed shard order.

The local apply is the generic gather -> sum-factorised cell kernel ->
incidence sum pipeline with the hanging-node C/C^T per shard (each shard
carries the constraint rows of every constrained DoF its cells touch).

Where the JAX package adds into repeated indices (the a2a compress's
owned targets, C^T's masters, the padded slots that all point at the dump
slot), the port sums each target's entries through a gather-sum table
built on the host and writes distinct indices only, so applies are
bitwise reproducible on the card.  Vectors may carry leading axes (the
vector operators' components, ``parallel.vector``): every local op and
exchange indexes the last axis.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from tpufem_torch.operators.generic import (
    QuadContext,
    eval_fields,
    integrate_fields,
)
from tpufem_torch.operators.laplace import laplace_cell_apply
from tpufem_torch.ops.matrix_free import MatrixFree, transpose_table
from tpufem_torch.parallel.mesh import Sharded, ShardMesh, smap, to_host
from tpufem_torch.solvers.cg import CGResult, cg_solve
from tpufem_torch.solvers.chebyshev import ChebyshevParams, chebyshev_smooth
from tpufem_torch.utils.precision import torch_dtype


def _balanced_contiguous(n_cells: int, n_shards: int) -> np.ndarray:
    """cell -> shard id, contiguous blocks, sizes differing by <= 1."""
    bounds = np.linspace(0, n_cells, n_shards + 1).astype(np.int64)
    owner = np.zeros(n_cells, dtype=np.int32)
    for s in range(n_shards):
        owner[bounds[s] : bounds[s + 1]] = s
    return owner


@dataclasses.dataclass(frozen=True)
class GeneralPartitioner:
    """Owned/ghost index lists for an arbitrary cell partition + stacked
    per-shard host data for the distributed generic apply."""

    n_shards: int
    n_dofs: int
    P: int  # owned slots per shard (padded)
    G: int  # ghost slots per shard (padded)
    NC: int  # cells per shard (padded)
    axis_name: str
    dtype: Any  # torch dtype of the solve
    dim: int
    # host (numpy) index data, stacked with leading shard dim
    l2g: np.ndarray  # (n_shards, NL) int64, -1 pads
    own_counts: np.ndarray  # (n_shards,)
    cell_counts: np.ndarray  # (n_shards,)
    cell_dofs: np.ndarray  # (n_shards, NC, nn) int32 local slots
    incidence: np.ndarray  # (n_shards, NL, K) int32 flat positions
    interior: np.ndarray  # (n_shards, NL)
    owned_mask: np.ndarray  # (n_shards, NL)
    ghost_src: np.ndarray  # (n_shards, G) int64 into (n_shards*P,)+pad
    # pairwise exchange plan (all_to_all path): for each ordered shard
    # pair, padded local-position lists (pads -> the dump slot)
    pair_send: np.ndarray  # (n_shards, n_shards, M) int32 owned positions
    pair_recv: np.ndarray  # (n_shards, n_shards, M) int32 ghost slots
    # constraint rows (hanging nodes), local ids; zero-row pads
    con_dofs: np.ndarray | None  # (n_shards, CL) int32
    con_masters: np.ndarray | None  # (n_shards, CL, K) int32
    con_weights: np.ndarray | None  # (n_shards, CL, K)
    # metric (cartesian xor general), padded cells are zeroed
    metric_kind: str
    inv_h: np.ndarray | None  # (n_shards, NC, d)
    det: np.ndarray | None  # (n_shards, NC)
    inv_jac: np.ndarray | None  # (n_shards, NC, nq, d, d)
    jxw: np.ndarray | None  # (n_shards, NC, nq)
    coef_q: np.ndarray | None  # (n_shards, NC, nq)
    # shared small operators (host f64)
    S: Any
    D: Any
    D_col: Any
    w_q: Any | None
    device: torch.device = torch.device("cuda")  # the MatrixFree's

    @property
    def NL(self) -> int:
        return self.P + self.G + 1

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        mf: MatrixFree,
        n_shards: int,
        cell_shard: Optional[np.ndarray] = None,
        axis_name: str = "shard",
    ) -> "GeneralPartitioner":
        """Partition a built cell-loop MatrixFree (any mesh — uniform,
        adaptive with hanging nodes, curved) into per-shard data; any
        cell -> shard map works."""
        from tpufem_torch.utils.native import build_incidence

        cd = np.asarray(mf.dofs.cell_dofs)
        nc, nn = cd.shape
        n_dofs = mf.n_dofs
        d = mf.config.dim
        if mf.host_metric is None or mf.S is None:
            raise ValueError("GeneralPartitioner needs a cell-loop "
                             "MatrixFree (scatter 'incidence', 'colored', "
                             "'structured' or 'dense')")
        if cell_shard is None:
            cell_shard = _balanced_contiguous(nc, n_shards)
        cell_shard = np.asarray(cell_shard, dtype=np.int32)
        assert cell_shard.shape == (nc,)

        shard_cells = [np.where(cell_shard == s)[0] for s in range(n_shards)]

        # DoF owner = lowest shard referencing it: one batched fancy-index
        # write per shard, descending, so the lowest shard wins
        owner = np.full(n_dofs, -1, dtype=np.int32)
        for s in range(n_shards - 1, -1, -1):
            owner[cd[shard_cells[s]]] = s
        assert (owner >= 0).all(), "mesh has DoFs referenced by no cell"

        # referenced set per shard: own cells' dofs + masters of any
        # constrained dof among them (C/C^T need masters locally);
        # constraint rows are looked up through a dof->row index array
        con_idx = None
        if mf.has_hanging:
            cg, mg, wg = mf.con_host
            cg, mg, wg = np.asarray(cg), np.asarray(mg), np.asarray(wg)
            if len(cg):
                con_idx = np.full(n_dofs, -1, dtype=np.int64)
                con_idx[cg] = np.arange(len(cg))

        referenced = []
        for s in range(n_shards):
            ref = np.unique(cd[shard_cells[s]])
            if con_idx is not None:
                rows_s = con_idx[ref]
                rows_s = rows_s[rows_s >= 0]
                if len(rows_s):
                    m, w = mg[rows_s], wg[rows_s]
                    ref = np.union1d(ref, m[w != 0.0])
            referenced.append(ref)

        own_lists = [r[owner[r] == s] for s, r in enumerate(referenced)]
        ghost_lists = [r[owner[r] != s] for s, r in enumerate(referenced)]
        Pn = max(len(o) for o in own_lists)
        Gn = max(max((len(g) for g in ghost_lists), default=0), 1)
        NCn = max(len(c) for c in shard_cells)
        NL = Pn + Gn + 1
        dump = NL - 1

        # position of each dof inside its owner's owned list (for ghost_src)
        own_pos = np.full(n_dofs, -1, dtype=np.int64)
        own_pos_local = np.full(n_dofs, -1, dtype=np.int64)
        for s, o in enumerate(own_lists):
            own_pos[o] = s * Pn + np.arange(len(o))
            own_pos_local[o] = np.arange(len(o))

        l2g = np.full((n_shards, NL), -1, dtype=np.int64)
        ghost_src = np.full((n_shards, Gn), n_shards * Pn, dtype=np.int64)
        m_glob = to_host(mf.interior_mask)
        interior = np.zeros((n_shards, NL), m_glob.dtype)
        owned_mask = np.zeros((n_shards, NL), m_glob.dtype)
        # ONE (n_dofs,) global->local scratch, reset between shards by
        # un-writing only the touched entries
        g2l_s = np.full(n_dofs, dump, dtype=np.int64)

        cell_dofs_l = np.full((n_shards, NCn, nn), dump, dtype=np.int32)
        con_dl = con_ml = con_wl = None
        if con_idx is not None:
            wdt = wg.dtype
            shard_rows = [
                referenced[s][con_idx[referenced[s]] >= 0]
                for s in range(n_shards)
            ]
            CL = max(max((len(r) for r in shard_rows), default=0), 1)
            Kc = mg.shape[1]
            con_dl = np.full((n_shards, CL), dump, dtype=np.int32)
            con_ml = np.full((n_shards, CL, Kc), dump, dtype=np.int32)
            con_wl = np.zeros((n_shards, CL, Kc), dtype=wdt)

        for s in range(n_shards):
            o, g = own_lists[s], ghost_lists[s]
            l2g[s, : len(o)] = o
            l2g[s, Pn : Pn + len(g)] = g
            g2l_s[o] = np.arange(len(o))
            g2l_s[g] = Pn + np.arange(len(g))
            ghost_src[s, : len(g)] = own_pos[g]
            interior[s, : len(o)] = m_glob[o]
            interior[s, Pn : Pn + len(g)] = m_glob[g]
            owned_mask[s, : len(o)] = 1
            # local cell arrays (padded cells -> dump slots)
            cells = shard_cells[s]
            cell_dofs_l[s, : len(cells)] = g2l_s[cd[cells]]
            # local constraint rows, vectorized over the shard's rows
            if con_idx is not None and len(shard_rows[s]):
                rows = shard_rows[s]
                ci = con_idx[rows]
                mgr, wgr = mg[ci], wg[ci]  # (L, Kc)
                con_dl[s, : len(rows)] = g2l_s[rows]
                con_ml[s, : len(rows)] = np.where(
                    wgr != 0.0, g2l_s[mgr], dump)
                con_wl[s, : len(rows)] = wgr
            # reset the touched scratch entries for the next shard
            g2l_s[o] = dump
            g2l_s[g] = dump

        # pairwise exchange plan: for each (owner q -> shard s) pair, the
        # owned positions q sends and the ghost slots s writes, padded to
        # the max pair count (pads route through the zero dump slot)
        pair_counts = np.zeros((n_shards, n_shards), dtype=np.int64)
        for s in range(n_shards):
            q_of = owner[ghost_lists[s]]
            for q in range(n_shards):
                pair_counts[q, s] = int(np.sum(q_of == q))
        M = max(int(pair_counts.max()), 1)
        pair_send = np.full((n_shards, n_shards, M), dump, dtype=np.int32)
        pair_recv = np.full((n_shards, n_shards, M), dump, dtype=np.int32)
        for s in range(n_shards):
            g = ghost_lists[s]
            q_of = owner[g]
            for q in range(n_shards):
                sel = np.where(q_of == q)[0]
                pair_send[q, s, : len(sel)] = own_pos_local[g[sel]]
                pair_recv[s, q, : len(sel)] = Pn + sel

        def slice_cells(arr, fill=0.0):
            if arr is None:
                return None
            a = np.asarray(arr)
            out = np.full((n_shards, NCn) + a.shape[1:], fill, dtype=a.dtype)
            for s, cells in enumerate(shard_cells):
                out[s, : len(cells)] = a[cells]
            return out

        # per-shard incidence over local slots (padded to common K)
        incs = [
            build_incidence(cell_dofs_l[s], NL, NCn * nn)
            for s in range(n_shards)
        ]
        K = max(i.shape[1] for i in incs)
        inc = np.full((n_shards, NL, K), NCn * nn, dtype=np.int32)
        for s, i in enumerate(incs):
            inc[s, :, : i.shape[1]] = i

        hm = mf.host_metric
        return cls(
            n_shards=n_shards,
            n_dofs=n_dofs,
            P=Pn,
            G=Gn,
            NC=NCn,
            axis_name=axis_name,
            dtype=torch_dtype(mf.config.dtype),
            dim=d,
            l2g=l2g,
            own_counts=np.array([len(o) for o in own_lists]),
            cell_counts=np.array([len(c) for c in shard_cells]),
            cell_dofs=cell_dofs_l,
            incidence=inc,
            interior=interior,
            owned_mask=owned_mask,
            ghost_src=ghost_src,
            pair_send=pair_send,
            pair_recv=pair_recv,
            con_dofs=con_dl,
            con_masters=con_ml,
            con_weights=con_wl,
            metric_kind=mf.metric_kind,
            inv_h=slice_cells(hm.inv_h),
            det=slice_cells(hm.det),
            inv_jac=slice_cells(hm.inv_jac),
            jxw=slice_cells(hm.jxw),
            coef_q=slice_cells(mf.coef_q),
            S=to_host(mf.S),
            D=to_host(mf.D),
            D_col=to_host(mf.D_col),
            w_q=None if mf.metric_kind != "cartesian" else hm.w_q,
            device=mf.device,
        )

    # ------------------------------------------------------------------
    def device_mesh(self, devices=None) -> ShardMesh:
        return ShardMesh((self.n_shards,), (self.axis_name,),
                         devices=devices, device=self.device)

    def to_local(self, u_global: np.ndarray) -> np.ndarray:
        """(n_dofs,) -> (n_shards, NL) with ghosts imported, pads zero."""
        u = np.asarray(u_global)
        out = np.zeros((self.n_shards, self.NL), dtype=u.dtype)
        live = self.l2g >= 0
        out[live] = u[self.l2g[live]]
        return out

    def to_global(self, u_local) -> np.ndarray:
        """(n_shards, NL) (or a Sharded value) -> (n_dofs,) from owned
        slots."""
        u = (ShardMesh.stack(u_local) if isinstance(u_local, Sharded)
             else np.asarray(u_local))
        out = np.zeros(self.n_dofs, dtype=u.dtype)
        for s in range(self.n_shards):
            n = self.own_counts[s]
            out[self.l2g[s, :n]] = u[s, :n]
        return out


def _inverse(d: Sharded) -> Sharded:
    """1 / d where d != 0, else 0, shard by shard."""
    return smap(lambda a: torch.where(a != 0, 1.0 / a, 0.0), d)


def _gather_sum_table(pos_vals: np.ndarray, targets: np.ndarray,
                      valid: np.ndarray, pad: int):
    """The distinct ``targets`` of the valid entries and, per target, the
    entry positions summed into it (padded with ``pad``): the accumulating
    scatter ``y[targets] += v[positions]`` as a gather-sum."""
    pos = np.nonzero(valid)[0]
    tc, tr, _ = transpose_table(pos_vals[pos].astype(np.int64),
                                targets[pos].astype(np.int64),
                                np.ones(len(pos)), pad)
    return tc, tr


class _Shard:
    """One shard's device data: what ``operators.generic``'s
    ``eval_fields``/``integrate_fields`` and ``operators.laplace``'s
    ``laplace_cell_apply`` read of a MatrixFree (the local metric on
    ``cell_data``'s names), plus the local index tables."""

    def __init__(self, part: GeneralPartitioner, s: int, exchange: str,
                 device: torch.device):
        dt = part.dtype
        f = lambda a: (None if a is None else
                       torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                                       device=device))
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                      device=device)
        self.config = SimpleNamespace(dim=part.dim)
        self.metric_kind = part.metric_kind
        self.S, self.D, self.D_col = f(part.S), f(part.D), f(part.D_col)
        self.w_q = f(part.w_q)
        pick = lambda a: None if a is None else a[s]
        self.inv_h, self.det = f(pick(part.inv_h)), f(pick(part.det))
        self.inv_jac, self.jxw = f(pick(part.inv_jac)), f(pick(part.jxw))
        self.coef_dev = f(pick(part.coef_q))
        self.cell_dofs = i(part.cell_dofs[s])
        self.inc = i(part.incidence[s])
        self.interior = f(part.interior[s])
        self.owned = f(part.owned_mask[s])
        P, G, NL, ns = part.P, part.G, part.NL, part.n_shards
        dump = NL - 1
        if exchange == "a2a":
            send = part.pair_send[s].astype(np.int64)  # (ns, M): to each
            recv = part.pair_recv[s].astype(np.int64)  # (ns, M): from each
            self.send, self.recv = i(send), i(recv)
            rflat = recv.reshape(-1)
            ok = rflat != dump
            self.recv_pos, self.recv_dst = i(np.nonzero(ok)[0]), i(rflat[ok])
            sflat = send.reshape(-1)
            tc, tr = _gather_sum_table(np.arange(len(sflat)), sflat,
                                       sflat != dump, len(sflat))
            self.send_dst, self.send_tab = i(tc), i(tr)
        else:
            src = part.ghost_src[s]
            ok = src < ns * P
            self.ghost_src = i(src)
            self.ghost_pos, self.ghost_dst = i(np.nonzero(ok)[0]), i(src[ok])
        self.con = None
        if part.con_dofs is not None:
            cd = part.con_dofs[s].astype(np.int64)
            cm = part.con_masters[s].astype(np.int64)
            cw = np.asarray(part.con_weights[s], np.float64)
            rows = np.nonzero(cd != dump)[0]
            # C^T: y[masters] += w * y[cdofs], as a gather-sum over the
            # (row, slot) entries with a nonzero weight
            r_, k_ = np.nonzero(cw[rows] != 0.0)
            tc, tr, tv = transpose_table(
                np.arange(len(r_)), cm[rows][r_, k_], cw[rows][r_, k_],
                len(r_))
            self.con = dict(slots=i(cd[rows]), masters=i(cm[rows]),
                            weights=f(cw[rows]), t_src=i(cd[rows][r_]),
                            t_dst=i(tc), t_tab=i(tr), t_w=f(tv))

    def cell_data(self) -> None:
        """The local tensors are made at construction."""


class GeneralDistributedOperator:
    """Distributed constrained Laplace vmult + CG over a GeneralPartitioner
    (the reference's multi-GPU vmult composition, SURVEY.md §3.6:
    update_ghost_values -> per-device cell loop -> compress(add), with the
    hanging-node C/C^T resolved per device).

    exchange: "a2a" (pairwise all_to_all of the padded per-pair lists,
    O(halo) traffic), "gather" (all_gather of every owned block, O(N)),
    or "auto": "a2a" whenever its padded plan ships fewer elements than
    the gather (``exchange_traffic``).

    quad_op: an optional quadrature-point functor with the
    ``operators.generic`` contract (mass, Helmholtz, any weak form,
    nonlinear ones for ``newton_solve``); None keeps the Laplace cell
    kernel.  needs_values/needs_gradients prune the unused transforms."""

    def __init__(self, part: GeneralPartitioner, device_mesh=None,
                 exchange: str = "auto", quad_op=None,
                 needs_values: bool = True, needs_gradients: bool = True):
        if exchange not in ("auto", "gather", "a2a"):
            raise ValueError(f"unknown exchange scheme {exchange!r}")
        if exchange == "auto":
            M = part.pair_send.shape[2]
            exchange = "a2a" if M < part.P else "gather"
        self.exchange = exchange
        self.quad_op = quad_op
        self._needs_v = needs_values and quad_op is not None
        self._needs_g = needs_gradients or quad_op is None
        self.part = part
        self.mesh = (device_mesh if device_mesh is not None
                     else part.device_mesh())
        self.shards = [_Shard(part, s, exchange, d)
                       for s, d in enumerate(self.mesh.devices)]
        self.interior = Sharded(sh.interior for sh in self.shards)
        self.owned = Sharded(sh.owned for sh in self.shards)

    # hooks the vector-valued subclass overrides (component axis)
    @property
    def _global_shape(self):
        return (self.part.n_dofs,)

    def _to_global(self, arr):
        return self.part.to_global(arr)

    def exchange_traffic(self) -> dict:
        """Elements shipped per shard per ghost update, from the plan
        arrays: "a2a" the padded pairwise buffer, n_shards * M
        (proportional to the halo); "gather" every owned block, n_shards
        * P (proportional to N); the actual ghost count; and the scheme
        this operator selected."""
        p = self.part
        return {
            "a2a": int(p.n_shards * p.pair_send.shape[2]),
            "gather": int(p.n_shards * p.P),
            "ghosts": int(max((p.ghost_src[s] < p.n_shards * p.P).sum()
                              for s in range(p.n_shards))),
            "selected": self.exchange,
        }

    # -- exchanges (the last axis is the local slot axis) -------------
    def _update_ghosts(self, x: Sharded) -> Sharded:
        p = self.part
        lead = x.parts[0].dim() - 1
        if self.exchange == "a2a":
            sb = Sharded(xs[..., sh.send] for xs, sh in zip(x.parts,
                                                            self.shards))
            rb = self.mesh.all_to_all(sb, p.axis_name, split_dim=lead,
                                      concat_dim=lead)
            out = []
            for xs, r, sh in zip(x.parts, rb.parts, self.shards):
                flat = r.reshape(r.shape[:lead] + (-1,))
                xs = xs.clone()
                xs[..., sh.recv_dst] = flat[..., sh.recv_pos]
                xs[..., p.NL - 1] = 0.0
                out.append(xs)
            return Sharded(out)
        own = Sharded(xs[..., : p.P] for xs in x.parts)
        allg = self.mesh.all_gather(own, p.axis_name, dim=lead, tiled=True)
        out = []
        for o, g, sh in zip(own.parts, allg.parts, self.shards):
            z1 = o.new_zeros(o.shape[:lead] + (1,))
            flat = torch.cat([g, z1], dim=-1)
            out.append(torch.cat([o, flat[..., sh.ghost_src], z1], dim=-1))
        return Sharded(out)

    def _compress_add(self, y: Sharded) -> Sharded:
        p = self.part
        lead = y.parts[0].dim() - 1
        if self.exchange == "a2a":
            # reverse exchange: ship ghost partials back to their owners
            sb = Sharded(ys[..., sh.recv] for ys, sh in zip(y.parts,
                                                            self.shards))
            rb = self.mesh.all_to_all(sb, p.axis_name, split_dim=lead,
                                      concat_dim=lead)
            out = []
            for ys, r, sh in zip(y.parts, rb.parts, self.shards):
                flat = r.reshape(r.shape[:lead] + (-1,))
                flat = torch.cat([flat, flat.new_zeros(
                    flat.shape[:lead] + (1,))], dim=-1)
                add = flat[..., sh.send_tab].sum(dim=-1)
                ys = ys.clone()
                ys[..., sh.send_dst] = ys[..., sh.send_dst] + add
                # ghosts are now stale partials: zero and re-import
                ys[..., p.P:] = 0.0
                out.append(ys)
            return self._update_ghosts(Sharded(out))
        contrib = []
        for ys, sh in zip(y.parts, self.shards):
            c = ys.new_zeros(ys.shape[:lead] + (p.n_shards * p.P + 1,))
            c[..., sh.ghost_dst] = ys[..., p.P + sh.ghost_pos]
            contrib.append(c)
        tot = self.mesh.psum(Sharded(contrib), p.axis_name)
        out = []
        for s, (ys, t) in enumerate(zip(y.parts, tot.parts)):
            me = self.mesh.axis_index(p.axis_name)[s]
            own = ys[..., : p.P] + t[..., me * p.P : (me + 1) * p.P]
            out.append(torch.cat([own, own.new_zeros(
                own.shape[:lead] + (p.G + 1,))], dim=-1))
        return self._update_ghosts(Sharded(out))

    def _ddot(self, owned: Sharded):
        mesh, axis = self.mesh, self.part.axis_name

        def dot(a: Sharded, b: Sharded) -> Sharded:
            return mesh.psum(Sharded(
                torch.dot((ai * oi).reshape(-1), bi.reshape(-1))
                for ai, oi, bi in zip(a.parts, owned.parts, b.parts)), axis)

        return dot

    # -- the shard-local pieces -----------------------------------------
    def _cell_apply(self, sh: _Shard, u_loc: torch.Tensor) -> torch.Tensor:
        """Per-shard sum-factorised cell kernel (SURVEY.md §3.4): the
        Laplace form of ``operators.laplace`` (quad_op None) or the
        generic FEEvaluation pipeline of ``operators.generic``; leading
        axes ride in the cell batch."""
        if self.quad_op is None:
            return laplace_cell_apply(sh, u_loc)
        ctx = QuadContext(config=None, metric_kind=sh.metric_kind,
                          coef_q=sh.coef_dev)
        vals, grads = eval_fields(sh, u_loc, self._needs_v, self._needs_g)
        sv, sg = self.quad_op(vals, grads, ctx)
        if isinstance(sv, (list, tuple)):
            sv = torch.stack(list(sv))
        if isinstance(sg, (list, tuple)):
            sg = torch.stack(list(sg))
        return integrate_fields(sh, sv, sg)

    @staticmethod
    def _distribute(sh: _Shard, u: torch.Tensor) -> torch.Tensor:
        """C on the local slots: each constrained row's value from its
        masters (a new tensor)."""
        c = sh.con
        vals = (c["weights"] * u[..., c["masters"]]).sum(dim=-1)
        u = u.clone()
        u[..., c["slots"]] = vals
        return u

    @staticmethod
    def _distribute_t(sh: _Shard, y: torch.Tensor) -> torch.Tensor:
        """C^T on the local partials: constrained rows pushed to their
        masters through the gather-sum table, then zeroed (a new
        tensor)."""
        c = sh.con
        yc = y[..., c["t_src"]]
        yc = torch.cat([yc, yc.new_zeros(yc.shape[:-1] + (1,))], dim=-1)
        add = (c["t_w"] * yc[..., c["t_tab"]]).sum(dim=-1)
        y = y.clone()
        y[..., c["slots"]] = 0.0
        y[..., c["t_dst"]] = y[..., c["t_dst"]] + add
        return y

    def _raw_partial(self, sh: _Shard, u: torch.Tensor) -> torch.Tensor:
        """Cell loop + incidence sum on consistent local data: the
        shard's partial result."""
        v = self._cell_apply(sh, u[..., sh.cell_dofs])
        lead = v.shape[:-2]
        flat = torch.cat([v.reshape(lead + (-1,)),
                          v.new_zeros(lead + (1,))], dim=-1)
        return flat[..., sh.inc].sum(dim=-1)

    def vmult(self, x: Sharded) -> Sharded:
        """Constrained apply on consistent local data -> consistent y:
        m C^T A C (m x) + (1 - m) x."""
        ys = []
        for sh, xs in zip(self.shards, x.parts):
            xm = sh.interior * xs
            if sh.con is not None:
                xm = self._distribute(sh, xm)
            y = self._raw_partial(sh, xm)
            if sh.con is not None:
                y = self._distribute_t(sh, y)
            ys.append(y)
        y = self._compress_add(Sharded(ys))
        return self.interior * y + (1.0 - self.interior) * x

    def _residual(self, b_partial: Sharded, u: Sharded) -> Sharded:
        """Consistent local u -> consistent masked NONLINEAR residual
        m * C^T(R(C u) - b) for Newton: the iterate carries its Dirichlet
        values (no pre-mask), and the RHS is subtracted as an owner
        partial (``owned * b``) before C^T/compress, so shared and hanging
        rows credit their masters exactly once."""
        ys = []
        for sh, us, bs in zip(self.shards, u.parts, b_partial.parts):
            uh = self._distribute(sh, us) if sh.con is not None else us
            y = self._raw_partial(sh, uh) - bs
            if sh.con is not None:
                y = self._distribute_t(sh, y)
            ys.append(y)
        return self.interior * self._compress_add(Sharded(ys))

    def _refresh_hanging(self, u: Sharded) -> Sharded:
        return Sharded(self._distribute(sh, us) if sh.con is not None
                       else us for sh, us in zip(self.shards, u.parts))

    # ------------------------------------------------------------------
    def put_vector(self, u_global) -> Sharded:
        loc = self.part.to_local(np.asarray(u_global, np.float64))
        return self.mesh.put(loc, dtype=self.part.dtype)

    def cheb_params(self, diag_global, degree: int = 4,
                    smoothing_range: float = 20.0) -> ChebyshevParams:
        """Chebyshev theta/delta of D^-1 A by a distributed power
        iteration from ``np.random.default_rng(0)``'s draw (the JAX
        package's start vector exactly), owner-weighted psum dots."""
        rng = np.random.default_rng(0)
        u = self.put_vector(rng.standard_normal(self._global_shape))
        d_l = self.put_vector(np.asarray(diag_global))
        inv_diag = _inverse(d_l)
        dot = self._ddot(self.owned)
        for _ in range(25):
            w = inv_diag * self.vmult(u)
            u = w / torch.sqrt(dot(w, w))
        w = inv_diag * self.vmult(u)
        lam = float(1.05 * dot(u, w) / dot(u, u))
        upper, lower = 1.2 * lam, lam / smoothing_range
        return ChebyshevParams(theta=0.5 * (upper + lower),
                               delta=0.5 * (upper - lower), degree=degree)

    def cg_solve(self, b_global, diag_global, x0_global=None,
                 rtol: float = 1e-10, maxiter: int = 10000,
                 precond: str = "jacobi", cheb_degree: int = 4,
                 cheb_params=None):
        """Distributed preconditioned CG from global vectors; returns
        (x_global, iterations, residual).  precond "chebyshev": degree
        ``cheb_degree`` Chebyshev from ``cheb_params`` or a distributed
        power-iteration estimate (its inner applies exchange ghosts but
        do no dots)."""
        b_l = self.put_vector(b_global)
        d_l = self.put_vector(np.asarray(diag_global))
        x0_l = (None if x0_global is None
                else self.put_vector(x0_global))
        res = self.cg_solve_local(b_l, d_l, x0_local=x0_l, rtol=rtol,
                                  maxiter=maxiter, precond=precond,
                                  cheb_degree=cheb_degree,
                                  cheb_params=cheb_params,
                                  diag_global=diag_global)
        return (self._to_global(res.x), int(res.iterations),
                float(res.residual))

    def cg_solve_local(self, b_local: Sharded, diag_local: Sharded,
                       x0_local=None, rtol: float = 1e-10,
                       maxiter: int = 10000, precond: str = "jacobi",
                       cheb_degree: int = 4, cheb_params=None,
                       diag_global=None) -> CGResult:
        """``cg_solve`` on Sharded local vectors, returning a CGResult with
        the local solution (for callers that keep state sharded across
        many solves, e.g. time stepping)."""
        if precond not in ("jacobi", "chebyshev"):
            raise ValueError(f"precond must be 'jacobi' or 'chebyshev', "
                             f"got {precond!r}")
        inv_diag = _inverse(diag_local)
        if precond == "chebyshev":
            if cheb_params is None:
                dg = (diag_global if diag_global is not None
                      else self._to_global(diag_local))
                cheb_params = self.cheb_params(dg, degree=cheb_degree)
            cp = ChebyshevParams(cheb_params.theta, cheb_params.delta,
                                 cheb_degree)
            M_inv = lambda r: chebyshev_smooth(self.vmult, inv_diag, cp, r)
        else:
            M_inv = lambda r: inv_diag * r
        if x0_local is None:
            x0_local = torch.zeros_like(b_local)
        return cg_solve(self.vmult, b_local, M_inv=M_inv, x0=x0_local,
                        rtol=rtol, maxiter=maxiter,
                        dot=self._ddot(self.owned))

    def newton_solve(self, b_global, u0_global=None, rtol: float = 1e-10,
                     atol: float = 0.0, maxiter: int = 30,
                     linear: str = "cg", linear_rtol=None,
                     linear_maxiter: int = 2000):
        """Distributed matrix-free Newton-Krylov (requires ``quad_op``,
        which may be nonlinear in values and gradients): the port's
        ``solvers.newton.newton_solve`` on Sharded vectors, its Jacobian
        ``torch.func.linearize`` of the distributed residual through the
        ghost exchanges (the derivative of an exchange is the same
        exchange), the Eisenstat-Walker forcing and the line search on
        psum'd scalars, so every shard takes the same trajectory.
        Dirichlet values ride in ``u0_global``; hanging rows act as Krylov
        identity rows and are refreshed by C on the returned solution.
        Returns a NewtonResult in global numbering."""
        if self.quad_op is None:
            raise ValueError("newton_solve requires quad_op")
        from tpufem_torch.solvers.newton import newton_solve as _newton

        b_l = self.put_vector(np.asarray(b_global))
        u0_l = (torch.zeros_like(b_l) if u0_global is None
                else self.put_vector(np.asarray(u0_global)))
        b_partial = self.owned * b_l
        # start with the hanging rows consistent
        u00 = self._refresh_hanging(u0_l)
        res = _newton(self._residual, b_partial, u00, mask=self.interior,
                      rtol=rtol, atol=atol, maxiter=maxiter, linear=linear,
                      linear_rtol=linear_rtol,
                      linear_maxiter=linear_maxiter,
                      dot=self._ddot(self.owned))
        x = self._refresh_hanging(res.x)
        return res._replace(x=self.part.to_global(x))

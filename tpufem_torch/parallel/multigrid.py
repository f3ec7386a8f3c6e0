"""Distributed geometric multigrid over a slab-decomposed shard mesh.

Port of ``tpufem/parallel/multigrid.py``: the reference's multi-GPU
vector composed with the full solver stack (SURVEY.md §2 "GMG transfer",
§3.6).  Every level lives in the ghosted-slab representation of
``parallel.partitioner``:

- the fine and coarse slabs are aligned (coarse cell k <-> fine cells 2k,
  2k+1), so every fine plane's interpolation support lies in the shard's
  own ghosted coarse slab: **prolongation is local** (a row/column slice
  of the global 1D prolongation; duplicated interface planes get identical
  values from the embedding rows);
- restriction is the transpose over owned fine planes (each duplicated
  interface plane counted by one shard) followed by one interface
  ``compress_add`` on the coarse level;
- the coarsest level is solved by the replicated dense inverse after an
  ``all_gather``.

The operation sequence is ``solvers.multigrid.GeometricMultigrid._cycle``'s,
so GMG-CG iteration counts compare directly with the single-device solver.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.structured import laplace_apply_structured
from tpufem_torch.parallel.mesh import Sharded, ShardMesh, smap, to_host
from tpufem_torch.parallel.partitioner import Partitioner
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.chebyshev import chebyshev_smooth
from tpufem_torch.solvers.multigrid import GeometricMultigrid


def _shard_struct_w(struct_w: np.ndarray, part: Partitioner) -> np.ndarray:
    """Slab-shard an interleaved ([nz,qz,]...) weight block along z cells:
    (n_shards, nz_local, qz, rest...).  Broadcastable (size-1 nz) blocks
    are replicated."""
    w = np.asarray(struct_w)
    ns, cz = part.n_shards, part.local_cells_z
    if w.shape[0] == 1:  # constant-coefficient broadcastable block
        return np.broadcast_to(w[None], (ns,) + w.shape)
    return np.stack([w[k * cz : (k + 1) * cz] for k in range(ns)])


class DistributedGMG:
    """Slab-sharded V-cycle built from a (global) GeometricMultigrid.

    Per-level sharded data (interior mask, inverse diagonal, the
    quadrature/coefficient weights) live on the shards (``lvl_data``);
    the Chebyshev scalars, the 1D prolongations and the coarse inverse are
    replicated."""

    def __init__(self, gmg: GeometricMultigrid, n_shards: int,
                 axis_name: str = "shard", mesh: ShardMesh | None = None):
        self.gmg = gmg
        self.axis_name = axis_name
        dim, p = gmg.dim, gmg.degree
        self.dim, self.p = dim, p
        self.parts: list[Partitioner] = []
        for lvl in gmg.levels:
            n = (lvl.npts - 1) // p
            self.parts.append(
                Partitioner(dim, n, p, n_shards, axis_name=axis_name)
            )
        self.n_shards = n_shards
        self.mesh = (mesh if mesh is not None
                     else self.parts[-1].device_mesh(device=gmg.device))
        rep = self.mesh.replicate
        # per-level structured-apply constants (replicated; O(1) each)
        self._scale = [rep(lvl.mf.struct_scale) for lvl in gmg.levels]
        self._S = rep(gmg.levels[0].mf.S)
        self._D_col = rep(gmg.levels[0].mf.D_col)
        self._P = [rep(P) for P in gmg.P1d]
        self._coarse_inv = rep(gmg.coarse_inv)

    # ------------------------------------------------------------------
    def build_lvl_data(self, dtype=None):
        """Per level (mask, inv_diag, w) on the shards, and the level's
        Chebyshev parameters."""
        out = []
        for lvl, part in zip(self.gmg.levels, self.parts):
            dt = dtype if dtype is not None else lvl.mask.dtype
            put = lambda a: self.mesh.put(a, dtype=dt)
            mask = put(part.to_local(to_host(lvl.mask)))
            inv_diag = put(part.to_local(to_host(lvl.inv_diag)))
            w = put(_shard_struct_w(to_host(lvl.mf.struct_w), part))
            out.append((mask, inv_diag, w, lvl.cheb))
        return tuple(out)

    # ------------------------------------------------------------------
    def _vmult_raw_local(self, l: int, x_loc: Sharded, w_loc: Sharded):
        part = self.parts[l]
        ns_local = (part.local_cells_z,) + (part.n,) * (self.dim - 1)
        y = smap(lambda x, S, D, sc, w: laplace_apply_structured(
            x, self.dim, ns_local, self.p, S, D, sc, w).reshape(
                part.local_shape), x_loc, self._S, self._D_col,
            self._scale[l], w_loc)
        return part.compress_add(y, self.mesh)

    def _vmult_local(self, l: int, x_loc: Sharded, m_loc: Sharded,
                     w_loc: Sharded) -> Sharded:
        y = self._vmult_raw_local(l, m_loc * x_loc, w_loc)
        return m_loc * y + (1.0 - m_loc) * x_loc

    # ------------------------------------------------------------------
    def _axis_slices(self, l: int, s: int):
        """(fine-row, coarse-col) index ranges of shard s's slabs in the
        level-l global 1D prolongation."""
        pf, pc = self.parts[l], self.parts[l - 1]
        idx = self.mesh.axis_index(self.axis_name)[s]
        zf0 = idx * pf.local_cells_z * self.p
        zc0 = idx * pc.local_cells_z * self.p
        return zf0, pf.local_npts_z, zc0, pc.local_npts_z

    @staticmethod
    def _apply_z(M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Contract the leading (z) dim of a local block with M (out, in)."""
        return torch.tensordot(M, t, dims=([1], [0]))

    def _apply_rest(self, M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Apply M along every non-z axis (full, unsharded axes)."""
        for axis in range(1, self.dim):
            t = torch.movedim(torch.matmul(torch.movedim(t, axis, -1), M.T),
                              -1, axis)
        return t

    def prolongate_local(self, l: int, xc_loc: Sharded) -> Sharded:
        """Coarse level l-1 slab -> fine level l slab; purely local."""
        out = []
        for s, (xc, Pg) in enumerate(zip(xc_loc.parts, self._P[l - 1].parts)):
            zf0, lzf, zc0, lzc = self._axis_slices(l, s)
            P_loc = Pg[zf0 : zf0 + lzf, zc0 : zc0 + lzc]
            out.append(self._apply_rest(Pg, self._apply_z(P_loc, xc)))
        return Sharded(out)

    def restrict_local(self, l: int, rf_loc: Sharded) -> Sharded:
        """Fine slab -> coarse slab: transpose over owned fine planes,
        then compress the coarse interface planes."""
        part_c = self.parts[l - 1]
        out = []
        for s, (rf, Pg) in enumerate(zip(rf_loc.parts, self._P[l - 1].parts)):
            zf0, lzf, zc0, lzc = self._axis_slices(l, s)
            # owner convention: the duplicated interface plane belongs to
            # the shard whose slab STARTS with it — zero the last plane
            # elsewhere
            keep = torch.ones(lzf, dtype=rf.dtype, device=rf.device)
            if self.mesh.axis_index(self.axis_name)[s] != self.n_shards - 1:
                keep[-1] = 0.0
            t = rf * keep.reshape((lzf,) + (1,) * (self.dim - 1))
            P_loc = Pg[zf0 : zf0 + lzf, zc0 : zc0 + lzc]
            t = self._apply_z(P_loc.T, t)
            out.append(self._apply_rest(Pg.T, t))
        return part_c.compress_add(Sharded(out), self.mesh)

    def coarse_solve_local(self, b_loc: Sharded) -> Sharded:
        """Replicated dense coarse inverse after all_gather; deterministic
        and identical on every shard."""
        part = self.parts[0]
        g = self.mesh.all_gather(b_loc, self.axis_name)  # (ns, lz, ...)
        out = []
        for s, (gs, Ainv) in enumerate(zip(g.parts,
                                           self._coarse_inv.parts)):
            owned = gs[:, :-1].reshape((-1,) + tuple(gs.shape[2:]))
            full = torch.cat([owned, gs[-1, -1:]], dim=0)
            x = torch.mv(Ainv, full.reshape(-1))
            grid = x.reshape((self.gmg.levels[0].npts,) * self.dim)
            z0 = (self.mesh.axis_index(self.axis_name)[s]
                  * part.local_cells_z * self.p)
            out.append(grid[z0 : z0 + part.local_npts_z])
        return Sharded(out)

    # ------------------------------------------------------------------
    def vcycle_local(self, b_loc: Sharded, lvl_data) -> Sharded:
        """One V-cycle on local slabs — operation for operation the
        sequence of GeometricMultigrid._cycle."""
        return self._cycle_local(len(self.gmg.levels) - 1, b_loc, lvl_data)

    def _cycle_local(self, l: int, b: Sharded, lvl_data) -> Sharded:
        m, inv_diag, w, cheb = lvl_data[l]
        if l == 0:
            return self.coarse_solve_local(b)
        A = lambda x: self._vmult_local(l, x, m, w)
        b = m * b
        x = chebyshev_smooth(A, inv_diag, cheb, b)
        r = m * (b - A(x))
        mc = lvl_data[l - 1][0]
        rc = mc * self.restrict_local(l, r)
        xc = self._cycle_local(l - 1, rc, lvl_data)
        x = x + m * self.prolongate_local(l, xc)
        return chebyshev_smooth(A, inv_diag, cheb, b, x0=x)


def distributed_gmg_cg_solve(
    gmg: GeometricMultigrid,
    n_shards: int,
    b: np.ndarray,
    rtol: float = 1e-10,
    maxiter: int = 1000,
    device_mesh: ShardMesh | None = None,
    axis_name: str = "shard",
):
    """GMG-preconditioned CG with every level slab-sharded (SURVEY.md §3.6
    composed with §3.5).  Returns (x_global, iterations, residual)."""
    dgmg = DistributedGMG(gmg, n_shards, axis_name=axis_name,
                          mesh=device_mesh)
    part, mesh = dgmg.parts[-1], dgmg.mesh
    fine = gmg.levels[-1]
    lvl_data = dgmg.build_lvl_data()
    b_l = mesh.put(part.to_local(np.asarray(b, np.float64)),
                   dtype=fine.mask.dtype)
    m, _, w, _ = lvl_data[-1]
    L = len(gmg.levels) - 1
    res = cg_solve(lambda x: dgmg._vmult_local(L, x, m, w), b_l,
                   M_inv=lambda r: dgmg.vcycle_local(r, lvl_data),
                   rtol=rtol, maxiter=maxiter,
                   dot=lambda a, c: part.dot(a, c, mesh))
    return part.to_global(res.x), int(res.iterations), float(res.residual)

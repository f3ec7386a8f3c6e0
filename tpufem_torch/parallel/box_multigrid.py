"""Distributed adaptive GMG: the box-tier V-cycle on a shard mesh.

Port of ``tpufem/parallel/box_multigrid.py``: ``DistributedBoxLaplace``
(the sharded fine-level apply with cut-plane reconciliation) composed
with ``BoxMultigrid`` (the global-coarsening forest hierarchy), the
reference's multi-GPU partitioner driving the GMG solve of
``poisson_mg.cu`` (SURVEY.md §3.5 + §3.6).

- The finest level is sharded: Chebyshev smoothing rides the distributed
  apply, vectors stay in the per-shard slab layout.
- Every coarser level is replicated: the restricted defect is summed over
  all shards once a V-cycle, then the identical deterministic sub-cycle
  runs.  The JAX package runs it on every shard; the port runs it once,
  on the hierarchy's device, and copies the coarse correction to each
  device the shards sit on (one card: no copy), which gives the same bits
  on every shard.
- The shard-local form of the finest transfer is the JAX package's: the
  1D transfer factor along each sharded lattice axis row-sliced per shard
  into a dense (local rows x coarse region) matrix — identity-row
  selections for unchanged and same-spacing groups, subface embedding
  rows for the 2:1 group, zero rows on slab padding — applied as one
  matmul an axis in the single-device ``_pair_apply``'s axis order, so
  every shard computes the single-device transfer's dot products for the
  rows it owns.  Restriction differs from the single-device path only by
  the association of the shard sum.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.structured import _axis_mm
from tpufem_torch.parallel.boxes import DistributedBoxLaplace
from tpufem_torch.parallel.mesh import Sharded
from tpufem_torch.solvers.box_multigrid import BoxMultigrid
from tpufem_torch.solvers.cg import cg_solve as _cg_solve
from tpufem_torch.solvers.chebyshev import ChebyshevParams, chebyshev_smooth


class DistributedBoxMultigrid:
    """GMG-preconditioned CG on the Sharded per-shard patch vector.

    Iteration counts match the single-device :class:`BoxMultigrid` (same
    smoother scalars, same transfer dot products, psum'd dots in a fixed
    order)."""

    def __init__(self, dop: DistributedBoxLaplace, mg: BoxMultigrid):
        if mg.levels[-1].op is not dop.gop:
            raise ValueError(
                "BoxMultigrid must be built with fine_op = dop.gop "
                "(box indices of the finest transfer must match)")
        if len(mg.levels) < 2:
            raise ValueError("need at least 2 levels for a V-cycle")
        self.dop, self.mg = dop, mg
        L = len(mg.levels) - 1
        self._rules = mg._rules[L]
        p = dop.p
        sy = dop.sy
        nsh = 2 if sy > 1 else 1
        self._nsh = nsh
        gboxes = dop.gop.boxes
        S = dop.n_shards

        def _local_factor(rule, ax):
            """(S, L_ax, nc_region) per-shard row-slice of the axis-ax
            transfer factor (ax in {0 z, 1 y})."""
            bf = rule["bf"]
            nf = gboxes[bf].lattice_shape[ax]
            Lax = dop.lboxes[bf].lattice_shape[ax]
            if rule["kind"] == "embed":
                F = rule["P"][ax]
            else:
                F = np.eye(nf)
            slab = dop._slab[bf] if ax == 0 else dop._slab_y[bf]
            az, rz = slab[0], slab[1]
            out = np.zeros((S, Lax, F.shape[1]))
            for s in range(S):
                row = s // sy if ax == 0 else s % sy
                a, r = int(az[row]), int(rz[row])
                if r == 0:
                    continue
                l = np.arange(Lax)
                g = a * p + l
                ok = (l <= r * p) & (g < nf)
                out[s][ok] = F[g[ok]]
            return out

        dt = dop.dt
        mesh = dop.mesh
        self.factors = {0: [_local_factor(r, 0) for r in self._rules]}
        if nsh > 1:
            self.factors[1] = [_local_factor(r, 1) for r in self._rules]
        # per shard: (M0 per rule, M1 per rule or None)
        self._M = [
            tuple(tuple(torch.as_tensor(F[s], dtype=dt,
                                        device=mesh.devices[s])
                        for F in self.factors[ax])
                  for ax in range(nsh))
            for s in range(S)]
        self.inv_diag = mesh.put(1.0 / dop.diagonal_local(), dtype=dt)
        self.nh = mesh.put(dop.to_local(mg.levels[L].nh_mask), dtype=dt)
        self._mnh = dop.interior_mask * self.nh
        # the tangential embed factors, on the hierarchy's device
        self._tP = list(mg._transfers[L])
        lvl = mg.levels[L]
        self.cheb = ChebyshevParams(lvl.cheb.theta, lvl.cheb.delta,
                                    mg.smoother_degree)

    # ---- the V-cycle -----------------------------------------------------
    def _prolongate_local(self, zc: Sharded) -> Sharded:
        """Replicated level-(L-1) patch (hanging rows filled) -> local
        fine slab correction; every local fine box written once."""
        lc = self.mg.levels[-2].op
        out = []
        for s, z in enumerate(zc.parts):
            M = self._M[s]
            parts = []
            for ri, r in enumerate(self._rules):
                bc = lc.boxes[r["bc"]]
                U = z[bc.offset : bc.offset + bc.n_nodes].view(
                    bc.lattice_shape)[r["sl"]]
                # ascending axis order 0, 1, 2 — the association of the
                # single-device _pair_apply
                U = _axis_mm(M[0][ri], U, 0)
                if self._nsh > 1:
                    U = _axis_mm(M[1][ri], U, 1)
                if r["kind"] == "embed":
                    for t in range(self._nsh, self.dop.dim):
                        U = _axis_mm(self._tP[ri][t].to(U.device), U, t)
                parts.append(U.reshape(-1))
            out.append(torch.cat(parts))
        return Sharded(out)

    def _restrict_local(self, rf: Sharded) -> torch.Tensor:
        """Local fine residual -> the level-(L-1) defect, once on the
        hierarchy's device: owner-weighted per-shard adjoint transfer, the
        sum over shards, then the coarse level's compress + C^T +
        interior mask."""
        lc = self.mg.levels[-2].op
        rw = self.dop.w_owner * rf
        ts = []
        for s, f in enumerate(rw.parts):
            M = self._M[s]
            t = f.new_zeros(lc.n_patch)
            for ri, r in enumerate(self._rules):
                lb = self.dop.lboxes[r["bf"]]
                n = int(np.prod(lb.lattice_shape))
                F = f[lb.offset : lb.offset + n].view(lb.lattice_shape)
                F = _axis_mm(M[0][ri].T, F, 0)
                if self._nsh > 1:
                    F = _axis_mm(M[1][ri].T, F, 1)
                if r["kind"] == "embed":
                    for ta in range(self._nsh, self.dop.dim):
                        F = _axis_mm(self._tP[ri][ta].to(F.device).T, F,
                                     ta)
                lc._seg(t, r["bc"])[r["sl"]].add_(F)
            ts.append(t)
        t = self.dop.mesh.reduce(Sharded(ts), lc.device)
        t = lc._compress_(t)
        t = lc._distribute_transpose_(t)
        return lc.interior_mask * t

    def _mcycle(self, b: Sharded) -> Sharded:
        """One V-cycle on the local slab vector (the M^-1 body)."""
        mg, dop = self.mg, self.dop
        m = dop.interior_mask
        A = dop.vmult
        b = m * b
        x = chebyshev_smooth(A, self.inv_diag, self.cheb, b)
        r = m * (b - A(x))
        rc = self._restrict_local(r)
        xc = mg._cycle(len(mg.levels) - 2, rc)
        zc = mg.levels[-2].op._distribute_(xc)
        x = x + self._mnh * self._prolongate_local(dop.mesh.replicate(zc))
        return chebyshev_smooth(A, self.inv_diag, self.cheb, b, x0=x)

    # ---- public API -------------------------------------------------------
    def vcycle(self, b_local: Sharded) -> Sharded:
        """One distributed V-cycle."""
        return self._mcycle(b_local)

    def cg_solve(self, b_local: Sharded, x0=None, rtol=1e-10,
                 maxiter=1000):
        """Distributed GMG-CG: psum dots with owner weights, coarse levels
        replicated."""
        return _cg_solve(self.dop.vmult, b_local, M_inv=self._mcycle, x0=x0,
                         rtol=rtol, maxiter=maxiter, dot=self.dop.dot)

"""Geometric multigrid on adaptive (2:1 forest) meshes — the box tier.

Port of ``tpufem/solvers/box_multigrid.py``: the GMG stack of the
reference's ``poisson_mg.cu`` extended to adaptively refined meshes the
way deal.II's global-coarsening transfer does.  Every level is a complete
2:1 forest obtained by clamping cell sizes to a floor, so each level
solves the same boundary-value problem on a coarser adaptive mesh and
adjacent levels differ by exactly one 2:1 refinement sweep.

- Level vectors are the box tier's patchwork vectors: a
  ``BoxLaplaceOperator`` per level gives the constrained vmult, the
  diagonal, C/C^T and the copy reconciliation; the V-cycle adds only the
  inter-level transfer.
- The transfer is index-free and separable.  Between adjacent levels each
  fine box matches one rule: ``same`` (an unchanged size group: the
  segment as it is), ``slice`` (a same-spacing subregion of the coarse
  floor group: a lattice slice) or ``embed`` (the new fine floor group:
  per-axis 1D subface-embedding matmuls of the parent region).
  Restriction is the exact transpose with owner weights, followed by the
  coarse level's compress and C^T.  Every product is one matmul an axis
  in the vector's dtype (strict f32 in f32), and the restriction adds
  into lattice slices, so no index is written twice.
- Above the forest's largest size the hierarchy continues with uniform
  2:1 coarsenings down to a coarsest grid solved with a dense inverse,
  built in f64 on the host.

The JAX package threads every device array through ``jit`` as an
argument (``device_args``, the ``*_with`` methods); here the tensors are
attributes of the levels and the cycle is Python.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.shapes import subface_interpolation_1d
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.solvers.cg import cg_solve as _cg_solve
from tpufem_torch.solvers.chebyshev import (
    ChebyshevParams,
    chebyshev_smooth,
    make_chebyshev_params,
)
from tpufem_torch.utils.precision import torch_dtype


def coarsen_floor(mesh: Mesh, floor: int) -> Mesh:
    """The mesh with every cell smaller than ``floor`` replaced by its
    size-``floor`` ancestor (deduplicated).  2:1 balance is preserved:
    clamping levels at a ceiling cannot increase any neighbor level gap.
    """
    o = mesh.origins.copy()
    s = mesh.sizes.copy()
    small = s < floor
    o[small] = (o[small] // floor) * floor
    s[small] = floor
    rows = np.concatenate([o, s[:, None]], axis=1)
    rows = np.unique(rows, axis=0)
    m2 = Mesh(mesh.dim, mesh.nbase, mesh.max_level, rows[:, :-1],
              rows[:, -1], mesh.lower, mesh.upper,
              transform=mesh.transform)
    m2.transform_jac = mesh.transform_jac
    m2.separable_metric = mesh.separable_metric
    return m2


def embed_1d(p: int, lo_f: int, n_f: int, c0: int, n_c: int) -> np.ndarray:
    """1D node-grid 2:1 embedding for an OFFSET region: fine cells at
    global (fine-unit) indices ``lo_f .. lo_f+n_f-1`` interpolated from
    coarse cells ``c0 .. c0+n_c-1``.  Generalizes
    ``solvers.multigrid.prolongation_1d`` (= the ``lo_f=0, c0=0`` case);
    overlapping rows (shared fine nodes) receive identical values."""
    P = np.zeros((n_f * p + 1, n_c * p + 1))
    C = [subface_interpolation_1d(p, 0), subface_interpolation_1d(p, 1)]
    for j in range(n_f):
        g = lo_f + j
        k = g // 2 - c0
        P[j * p : (j + 1) * p + 1, k * p : (k + 1) * p + 1] = C[g % 2]
    return P


@dataclasses.dataclass
class BoxMGLevel:
    mesh: Mesh
    dofs: DoFHandler
    op: BoxLaplaceOperator
    inv_diag: torch.Tensor  # patch space, the level's dtype
    cheb: ChebyshevParams
    nh_mask: np.ndarray  # 1 except on hanging-row copies (host)
    mnh: torch.Tensor | None = None  # interior mask * nh_mask (device)


def _build_rules(coarse_boxes, fine_boxes, floor_c: int, p: int, d: int):
    """Static transfer metadata for one adjacent level pair (coarse floor
    ``floor_c`` → fine floor ``floor_c // 2``).  Returns a list of dicts;
    ``P`` holds host numpy per-axis matrices for ``embed`` rules."""
    by_size = {b.size: (i, b) for i, b in enumerate(coarse_boxes)}
    rules = []
    for fi, bf in enumerate(fine_boxes):
        if bf.size > floor_c:
            ci, bc = by_size[bf.size]
            if not (np.array_equal(bf.lo, bc.lo) and bf.nb == bc.nb):
                raise AssertionError(
                    "size group above the floor changed between levels")
            rules.append(dict(kind="same", bf=fi, bc=ci,
                              sl=(slice(None),) * d, P=None))
        elif bf.size == floor_c:
            ci, bc = by_size[floor_c]
            off = bf.lo - bc.lo  # xyz, in floor_c units
            sl = tuple(
                slice(int(off[d - 1 - t]) * p,
                      int(off[d - 1 - t]) * p + bf.lattice_shape[t])
                for t in range(d))
            rules.append(dict(kind="slice", bf=fi, bc=ci, sl=sl, P=None))
        else:
            if bf.size * 2 != floor_c:
                raise AssertionError("fine group below half the floor")
            ci, bc = by_size[floor_c]
            Ps, sls = [], []
            for t in range(d):
                a = d - 1 - t
                lo = int(bf.lo[a])
                nf = int(bf.nb[t])
                c0 = lo // 2
                n_c = (lo + nf - 1) // 2 + 1 - c0
                s0 = (c0 - int(bc.lo[a])) * p
                sls.append(slice(s0, s0 + n_c * p + 1))
                Ps.append(embed_1d(p, lo, nf, c0, n_c))
            rules.append(dict(kind="embed", bf=fi, bc=ci,
                              sl=tuple(sls), P=Ps))
    return rules


def _rounded(params: ChebyshevParams, dt: torch.dtype) -> ChebyshevParams:
    """theta and delta rounded to ``dt``: the reference keeps them as
    device scalars in the level's dtype."""
    r = lambda v: float(torch.tensor(v, dtype=torch.float64).to(dt))
    return ChebyshevParams(r(params.theta), r(params.delta), params.degree)


class BoxMultigrid:
    """V-cycle preconditioner over global-coarsening forest levels.

    ``cg_solve`` runs the GMG-preconditioned CG on the finest level's
    patch vector — drop-in for ``BoxLaplaceOperator.cg_solve`` where the
    mesh is adaptive.
    """

    def __init__(
        self,
        mesh: Mesh,
        dofs: DoFHandler,
        constraints=None,
        coefficient: Optional[Callable] = None,
        dtype: str = "float32",
        smoother_degree: int = 4,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 8192,
        coarse_cheb_degree: int = 16,
        fine_op: Optional[BoxLaplaceOperator] = None,
        fine_diag=None,
        solve_op: Optional[BoxLaplaceOperator] = None,
        exact_defect: bool = True,
        device: torch.device | str = "cuda",
    ):
        # solve_op: operator of the OUTER CG in cg_solve (A, dots,
        # residual), typically f32, while the V-cycle hierarchy runs at
        # `dtype` — dtype="bfloat16" gives the mixed-precision GMG-CG.
        # Same mesh/dofs layout required.  None = the fine level's own
        # operator.  exact_defect: in a mixed-precision cycle, compute the
        # FINEST level's defects with solve_op instead of the dt-rounded
        # operator (see _cycle).
        self.device = resolve_device(device)
        self.solve_op = solve_op
        self._exact_defect = exact_defect
        self.dim, self.p = mesh.dim, dofs.degree
        self.smoother_degree = smoother_degree
        dt = torch_dtype(dtype)
        d = mesh.dim
        smax, smin = int(mesh.sizes.max()), int(mesh.sizes.min())
        U = mesh.U
        if np.any(mesh.origins + mesh.sizes[:, None] > U) or np.any(
                mesh.origins < 0):
            raise ValueError("BoxMultigrid needs a full logical-cube mesh")

        # floors: uniform coarsenings above smax while the grid halves
        # evenly, then one forest level per octave down to the real mesh
        top = smax
        while top < (1 << mesh.max_level) and (U // top) % 2 == 0:
            top *= 2
        floors = []  # descending: floors[0] = coarsest, floors[-1] = smin
        f = top
        while f >= smin:
            floors.append(f)
            f //= 2
        # levels[0] = coarsest
        self.levels: list[BoxMGLevel] = []
        for fl in floors:
            if fl == smin:
                mesh_l, dofs_l, cons_l = mesh, dofs, constraints
                op = fine_op
            else:
                mesh_l = coarsen_floor(mesh, fl)
                dofs_l = DoFHandler(mesh_l, self.p)
                cons_l = (make_hanging_node_constraints(dofs_l)
                          if not mesh_l.is_uniform else None)
                op = None
            if op is None:
                op = BoxLaplaceOperator(
                    mesh_l, dofs_l, constraints=cons_l,
                    coefficient=coefficient, dtype=dtype,
                    device=self.device)
            diag = (fine_diag if (fl == smin and fine_diag is not None)
                    else op.diagonal())
            cheb = _rounded(make_chebyshev_params(
                op.vmult, diag, op.n_patch, degree=smoother_degree,
                smoothing_range=smoothing_range), op.dt)
            nh = np.ones(op.n_patch)
            if cons_l is not None and cons_l.lines:
                cm = cons_l.constrained_mask()
                for b in op.boxes:
                    g = b.gid.reshape(-1)
                    ok = g >= 0
                    seg = np.ones(b.n_nodes)
                    seg[ok] = (~cm[g[ok]]).astype(np.float64)
                    nh[b.offset : b.offset + b.n_nodes] = seg
            self.levels.append(self._level(BoxMGLevel(
                mesh=mesh_l, dofs=dofs_l, op=op, inv_diag=1.0 / diag,
                cheb=cheb, nh_mask=nh)))

        # transfer rules per adjacent pair: self._rules[l] maps level
        # l-1 (coarse) -> l (fine); the embed matrices on the device
        self._rules = [None]
        for l in range(1, len(self.levels)):
            self._rules.append(_build_rules(
                self.levels[l - 1].op.boxes, self.levels[l].op.boxes,
                floors[l - 1], self.p, d))
        self._transfers = self._transfer_tensors(dt)

        # coarsest solve: dense inverse of the assembled constrained
        # operator in global DoF space (tiny), else fixed Chebyshev
        c0 = self.levels[0]
        self._coarse_dense = c0.dofs.n_dofs <= coarse_max_dofs
        if self._coarse_dense:
            A = assemble_laplace(c0.dofs, coefficient=coefficient).toarray()
            bmask = c0.dofs.boundary_mask
            A[bmask, :] = 0.0
            A[:, bmask] = 0.0
            A[bmask, bmask] = 1.0
            Ainv = np.linalg.inv(A)
            # patch <-> global index maps for the coarsest level
            gmap = np.zeros(c0.op.n_patch, dtype=np.int64)
            live = np.zeros(c0.op.n_patch)
            for b in c0.op.boxes:
                g = b.gid.reshape(-1)
                ok = g >= 0
                gm = np.zeros(b.n_nodes, dtype=np.int64)
                gm[ok] = g[ok]
                gmap[b.offset : b.offset + b.n_nodes] = gm
                live[b.offset : b.offset + b.n_nodes] = ok
            self._coarse = {
                "Ainv": c0.op._dev(Ainv),
                "owner": c0.op._idx(c0.op._owner),
                "gmap": c0.op._idx(gmap),
                "live": c0.op._dev(live),
            }
        else:
            self._coarse_cheb_degree = coarse_cheb_degree
            self._coarse = {"cheb": _rounded(make_chebyshev_params(
                c0.op.vmult, 1.0 / c0.inv_diag, c0.op.n_patch,
                degree=coarse_cheb_degree,
                smoothing_range=smoothing_range * 4), c0.op.dt)}

    @staticmethod
    def _level(lvl: BoxMGLevel) -> BoxMGLevel:
        """The level with its device mask m * nh."""
        lvl.mnh = lvl.op.interior_mask * lvl.op._dev(lvl.nh_mask)
        return lvl

    def _transfer_tensors(self, dt: torch.dtype) -> list:
        c = self.levels[0].op
        return [() if rules is None else tuple(
            () if r["P"] is None else tuple(
                torch.as_tensor(Pa, dtype=dt, device=c.device)
                for Pa in r["P"])
            for r in rules) for rules in self._rules]

    # ------------------------------------------------------------------
    def recast(self, dtype, solve_op=None,
               exact_defect=None) -> "BoxMultigrid":
        """Mixed-precision clone sharing all host-side construction: the
        level meshes, DoF handlers, constraints, transfer rules, the
        Chebyshev estimates (rounded to ``dtype``) and the coarse dense
        inverse are reused; only the device tensors are cast
        (``BoxLaplaceOperator.recast``).  ``mg.recast("bfloat16")`` is
        the cheap form of ``BoxMultigrid(..., dtype="bfloat16",
        solve_op=fine_f32_op)``.

        solve_op: operator for the outer CG; default = this hierarchy's
        solve operator (its own fine op when it has none).  exact_defect:
        default inherits ``self``.
        """
        new = copy.copy(self)
        dt = torch_dtype(dtype)
        new.solve_op = (solve_op if solve_op is not None
                        else (self.solve_op if self.solve_op is not None
                              else self.levels[-1].op))
        if exact_defect is not None:
            new._exact_defect = exact_defect
        new.levels = [
            self._level(dataclasses.replace(
                lvl, op=lvl.op.recast(dt), inv_diag=lvl.inv_diag.to(dt),
                cheb=_rounded(lvl.cheb, dt)))
            for lvl in self.levels
        ]
        new._transfers = [tuple(tuple(P.to(dt) for P in Ps) for Ps in tr)
                          for tr in self._transfers]
        coarse = dict(self._coarse)
        for k in ("Ainv", "live"):
            if k in coarse:
                coarse[k] = coarse[k].to(dt)
        if "cheb" in coarse:
            coarse["cheb"] = _rounded(coarse["cheb"], dt)
        new._coarse = coarse
        return new

    # ------------------------------------------------------------------
    def prolongate(self, l: int, zc: torch.Tensor) -> torch.Tensor:
        """Coarse level l-1 patch (hanging rows FILLED via distribute)
        → fine level l patch; every fine box written exactly once, in
        box order."""
        lf, lc = self.levels[l], self.levels[l - 1]
        parts = []
        for ri, r in enumerate(self._rules[l]):
            U = lc.op._seg(zc, r["bc"])[r["sl"]]
            if r["kind"] == "embed":
                U = BoxLaplaceOperator._pair_apply(self._transfers[l][ri], U)
            parts.append(U.reshape(-1))
        out = torch.cat(parts)
        assert out.shape[0] == lf.op.n_patch
        return out

    def restrict(self, l: int, rf: torch.Tensor) -> torch.Tensor:
        """Owner-weighted adjoint of ``prolongate`` + coarse compress +
        coarse C^T + coarse interior mask: the level-(l-1) defect of a
        fine residual (hanging/Dirichlet rows zero)."""
        lf, lc = self.levels[l], self.levels[l - 1]
        rw = lf.op.w_owner * rf
        t = torch.zeros(lc.op.n_patch, dtype=rw.dtype, device=rw.device)
        for ri, r in enumerate(self._rules[l]):
            F = lf.op._seg(rw, r["bf"])
            if r["kind"] == "embed":
                F = BoxLaplaceOperator._pair_apply(
                    self._transfers[l][ri], F, transpose=True)
            lc.op._seg(t, r["bc"])[r["sl"]].add_(F)
        t = lc.op._compress_(t)
        t = lc.op._distribute_transpose_(t)
        return lc.op.interior_mask * t

    # ------------------------------------------------------------------
    def _coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        c0 = self.levels[0]
        cd = self._coarse
        if self._coarse_dense:
            z_g = torch.mv(cd["Ainv"].to(b.dtype), b[cd["owner"]])
            return cd["live"] * z_g[cd["gmap"]]
        cheb = ChebyshevParams(cd["cheb"].theta, cd["cheb"].delta,
                               self._coarse_cheb_degree)
        dt = c0.op.dt
        # the smoother applies run in the level's dtype (a mixed cycle
        # passes the solve dtype's b)
        return chebyshev_smooth(c0.op.vmult, c0.inv_diag, cheb,
                                b.to(dt)).to(b.dtype)

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == 0:
            return self._coarse_solve(b)
        lvl = self.levels[l]
        lc = self.levels[l - 1]
        m = lvl.op.interior_mask
        Af = lvl.op.vmult
        st = b.dtype
        dt_l = lvl.op.dt
        if dt_l == st:
            # uniform-precision level
            b = m * b
            x = chebyshev_smooth(Af, lvl.inv_diag, lvl.cheb, b)
            r = m * (b - Af(x))
            rc = self.restrict(l, r)
            xc = self._cycle(l - 1, rc)
            zc = lc.op._distribute_(xc)  # xc is this cycle's own tensor
            x = x + lvl.mnh * self.prolongate(l, zc)
            return chebyshev_smooth(Af, lvl.inv_diag, lvl.cheb, b, x0=x)
        # mixed precision (a bf16 hierarchy under an f32 solve): the
        # smoother applies run in the level's dtype while the cycle's
        # spine (defect, transfers, correction) stays in the solve dtype.
        # Post-smoothing uses the delta form x <- x + S(b - A x), so the
        # coarse correction is never rounded to dt_l.  With exact_defect
        # and solve_op, the finest defect uses the solve operator.
        if (self._exact_defect and self.solve_op is not None
                and l == len(self.levels) - 1):
            sop = self.solve_op
            res = lambda v: sop.vmult(v.to(sop.dt)).to(st)
        else:
            res = lambda v: Af(v.to(dt_l)).to(st)
        b = m * b
        x = chebyshev_smooth(Af, lvl.inv_diag, lvl.cheb,
                             b.to(dt_l)).to(st)
        r = m * (b - res(x))
        rc = self.restrict(l, r)
        xc = self._cycle(l - 1, rc)
        zc = lc.op._distribute_(xc)
        x = x + (lvl.mnh * self.prolongate(l, zc)).to(st)
        r2 = m * (b - res(x))
        return x + chebyshev_smooth(Af, lvl.inv_diag, lvl.cheb,
                                    r2.to(dt_l)).to(st)

    def preconditioner(self, b: torch.Tensor) -> torch.Tensor:
        """M^-1 b: one V-cycle on the finest patch vector (the reference's
        ``preconditioner_with``), in b's dtype."""
        return self._cycle(len(self.levels) - 1, b)

    def vcycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle on the finest patch vector."""
        return self.preconditioner(b)

    @property
    def fine(self) -> BoxMGLevel:
        return self.levels[-1]

    # ------------------------------------------------------------------
    def cg_solve(self, b_patch, x0=None, rtol=1e-10, maxiter=1000):
        """GMG-preconditioned CG on the finest patch vector, with the solve
        operator's owner-weighted dot."""
        sop = self.solve_op if self.solve_op is not None else self.fine.op
        b_patch = torch.as_tensor(b_patch, device=sop.device).to(sop.dt)
        return _cg_solve(sop.vmult, b_patch,
                         M_inv=lambda r: self.preconditioner(r).to(sop.dt),
                         x0=x0, rtol=rtol, maxiter=maxiter, dot=sop.dot)

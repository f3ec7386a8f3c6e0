"""Geometric multigrid V-cycle preconditioner on uniform level hierarchies.

Port of ``tpufem/solvers/multigrid.py``, the GMG stack of the reference's
``poisson_mg.cu`` (SURVEY.md §3.5): a Chebyshev-smoothed operator on
every level, sum-factorised level transfer, a direct coarse solve.

- The levels are the uniformly refined meshes of one geometry; the FE
  spaces nest, so each level operator is the Galerkin operator without
  assembling P^T A P.
- The transfer is the global separable form: on a tensor-product node
  grid the prolongation is P1d (x) ... (x) P1d, one strict-f32 (or f64)
  ``torch.matmul`` per axis, no accumulating scatter.
- The coarsest level is solved by a dense inverse (constrained rows the
  identity), built in f64 on the host, one matrix-vector product on the
  device.
- Under ``use_pallas`` every level's operator applies through the
  separable scheme's kernels: K2 on the flat vectors of a Laplace level,
  K4 (3D) or K3 (2D) on a terms level (``coefficient_axes``);
  ``resident_context`` runs the fine level on its resident kernel (K1,
  K4 or K3).

The JAX package threads every device array through ``jit`` as an
argument (``device_args``, the ``*_with`` methods) and traces the level
loop; here the tensors are attributes and the loop is Python.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_laplace
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.shapes import subface_interpolation_1d
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.chebyshev import (
    ChebyshevParams,
    chebyshev_smooth,
    make_chebyshev_params,
)
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype


def prolongation_1d(p: int, n_coarse_cells: int) -> np.ndarray:
    """1D node-grid prolongation from n cells to 2n, dense (2 n p + 1,
    n p + 1), f64.  The rows of child c of coarse cell k interpolate by
    the subface matrix; shared fine nodes get equal rows from both
    children.  Copy of ``tpufem/solvers/multigrid.py::prolongation_1d``."""
    n = n_coarse_cells
    nc_pts = n * p + 1
    nf_pts = 2 * n * p + 1
    P = np.zeros((nf_pts, nc_pts))
    C = [subface_interpolation_1d(p, 0), subface_interpolation_1d(p, 1)]
    for k in range(n):
        for c in (0, 1):
            rows = (2 * k + c) * p + np.arange(p + 1)
            cols = k * p + np.arange(p + 1)
            P[np.ix_(rows, cols)] = C[c]
    return P


@dataclasses.dataclass
class MGLevel:
    mf: MatrixFree
    op: LaplaceOperator
    inv_diag: torch.Tensor
    cheb: ChebyshevParams
    mask: torch.Tensor  # interior mask (homogeneous constraints per level)
    npts: int  # nodes per axis of this level's tensor grid


class GeometricMultigrid:
    """V-cycle preconditioner over uniformly refined meshes."""

    def __init__(
        self,
        dim: int,
        degree: int,
        finest_refine: int,
        coarsest_refine: int = 1,
        dtype: str = "float64",
        smoother_degree: int = 4,
        coefficient: Optional[Callable] = None,
        scatter: str = "auto",
        n_cycles: int = 1,
        nbase: int = 1,
        use_pallas: bool = False,
        pallas_mode: str = "f32",
        pallas_dirichlet: bool | None = None,
        mesh_factory: Optional[Callable] = None,
        coefficient_axes: Optional[list] = None,
        device: torch.device | str = "cuda",
    ):
        """``mesh_factory(refine) -> Mesh`` gives the level meshes of one
        geometry (default: the hyper_cube with ``nbase`` cells an axis at
        refine 0; e.g. ``Mesh.hyper_shell_2d``).  With ``use_pallas`` and
        no pointwise ``coefficient`` every level takes the separable
        scheme and its kernels; otherwise ``scatter`` (``auto``: the
        structured tier).  ``coefficient_axes``: a separable variable
        coefficient (``MatrixFree.build``), BASELINE config 5 on the
        kernels' terms tier."""
        if coarsest_refine > finest_refine:
            raise ValueError("coarsest_refine must be <= finest_refine")
        if coefficient is not None and coefficient_axes is not None:
            raise ValueError(
                "pass either coefficient or coefficient_axes, not both")
        self.device = resolve_device(device)
        self.dim, self.degree = dim, degree
        self.dtype = torch_dtype(dtype)
        self.n_cycles = n_cycles
        self.nbase = nbase
        if mesh_factory is None:
            mesh_factory = lambda r: Mesh.hyper_cube(dim, r, nbase=nbase)
        # a pointwise coefficient has no separable factorisation: it takes
        # a cell-loop tier and no kernel
        pallas_ok = use_pallas and coefficient is None
        self.levels: list[MGLevel] = []
        for r in range(coarsest_refine, finest_refine + 1):
            mesh = mesh_factory(r)
            dofs = DoFHandler(mesh, degree)
            cfg = FemConfig(dim=dim, degree=degree, dtype=dtype,
                            scatter="separable" if pallas_ok else scatter,
                            use_pallas=pallas_ok,
                            pallas_mode=pallas_mode,
                            pallas_dirichlet=pallas_dirichlet)
            mf = MatrixFree.build(mesh, dofs, cfg, self.device,
                                  coefficient=coefficient,
                                  coefficient_axes=coefficient_axes)
            op = LaplaceOperator(mf)
            diag = op.diagonal()
            cheb = make_chebyshev_params(op.vmult, diag, dofs.n_dofs,
                                         degree=smoother_degree)
            self.levels.append(MGLevel(
                mf=mf, op=op, inv_diag=1.0 / diag, cheb=cheb,
                mask=mf.interior_mask,
                npts=nbase * (1 << r) * degree + 1))
        # 1D prolongations between consecutive levels, built on the host
        self.P1d = [
            torch.as_tensor(prolongation_1d(degree, nbase * (1 << r)),
                            dtype=self.dtype, device=self.device)
            for r in range(coarsest_refine, finest_refine)]
        # coarse dense inverse (constrained rows/cols -> identity), f64
        lvl0 = self.levels[0]
        coarse_coef = coefficient
        if coefficient_axes is not None:
            def coarse_coef(pts, _cax=list(coefficient_axes)):
                out = np.ones(pts.shape[0])
                for a, ca in enumerate(_cax):
                    out = out * np.asarray(ca(pts[:, a]))
                return out
        K = assemble_laplace(lvl0.mf.dofs, coefficient=coarse_coef).toarray()
        m = lvl0.mask.cpu().to(torch.float64).numpy()
        Kc = (m[:, None] * K * m[None, :]) + np.diag(1.0 - m)
        self.coarse_inv = torch.as_tensor(np.linalg.inv(Kc),
                                          dtype=self.dtype,
                                          device=self.device)

    # ------------------------------------------------------------------
    def _tensor_apply(self, P: torch.Tensor, x: torch.Tensor, npts_in: int,
                      npts_out: int) -> torch.Tensor:
        """Apply P (npts_out, npts_in) along each axis of the tensor grid,
        x first (the JAX package's ``einsum("fi,...i->...f")``)."""
        d = self.dim
        t = x.reshape((npts_in,) * d)  # index order (z, y, x): x fastest
        for axis in range(d):
            ax = d - 1 - axis
            t = torch.movedim(torch.matmul(torch.movedim(t, ax, -1), P.T),
                              -1, ax)
        return t.reshape(-1)

    def prolongate(self, level: int, xc: torch.Tensor) -> torch.Tensor:
        """Coarse level - 1 -> fine level (MGTransfer prolongate)."""
        return self._tensor_apply(self.P1d[level - 1], xc,
                                  self.levels[level - 1].npts,
                                  self.levels[level].npts)

    def restrict(self, level: int, xf: torch.Tensor) -> torch.Tensor:
        """Fine level -> coarse level - 1 (restrict_and_add: P^T)."""
        return self._tensor_apply(self.P1d[level - 1].T, xf,
                                  self.levels[level].npts,
                                  self.levels[level - 1].npts)

    # ------------------------------------------------------------------
    def vcycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle of the fine-level right-hand side."""
        return self._cycle(len(self.levels) - 1, b)

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == 0:
            return torch.mv(self.coarse_inv, b)
        lvl = self.levels[l]
        m, A = lvl.mask, lvl.op.vmult
        b = m * b
        x = chebyshev_smooth(A, lvl.inv_diag, lvl.cheb, b)
        r = m * (b - A(x))
        rc = self.levels[l - 1].mask * self.restrict(l, r)
        xc = self._cycle(l - 1, rc)
        x = x + m * self.prolongate(l, xc)
        return chebyshev_smooth(A, lvl.inv_diag, lvl.cheb, b, x0=x)

    def _precondition(self, b: torch.Tensor) -> torch.Tensor:
        """M_inv b (PreconditionMG): ``n_cycles`` V-cycles, each after the
        first on the fine residual."""
        L = len(self.levels) - 1
        x = self._cycle(L, b)
        for _ in range(self.n_cycles - 1):
            r = b - self.levels[L].op.vmult(x)
            x = x + self._cycle(L, r)
        return x

    def preconditioner(self) -> Callable:
        """The M_inv callable for ``cg_solve``."""
        return self._precondition

    @property
    def fine(self) -> MGLevel:
        return self.levels[-1]

    # ------------------------------------------------------------------
    def resident_context(self):
        """The fine-level solver-resident V-cycle: (A, m_inv, rk), or None
        when the fine level has no resident kernel (``use_pallas`` off) or
        the hierarchy has one level.

        The fine level dominates the cycle's cost (two Chebyshev smooths,
        a residual and the outer CG apply), so its vectors stay in the
        resident kernel's layout: K1 in 3D, K4 under
        ``coefficient_axes``, K3 in 2D.  Its operator is the kernel with
        the fused mask where the kernel has it (``rk.dirichlet``), else
        the mask algebra around ``rk.raw``.  Coarser levels keep the flat
        path, with one ``unpad`` before restriction and one ``pad`` after
        prolongation per cycle.  ``A`` and ``m_inv`` take and return
        resident layouts.

        As in the reference, the mask and the inverse diagonal are padded
        into the kernel's storage dtype: in bf16s mode the fine level's
        vectors, and the CG's around it, are bf16 (the coarser levels stay
        in the hierarchy's dtype)."""
        fine = self.levels[-1]
        rk = fine.mf.resident
        L = len(self.levels) - 1
        if rk is None or L == 0:
            return None
        m = rk.pad(fine.mask)
        inv_diag = rk.pad(fine.inv_diag)
        if rk.dirichlet:  # the kernel applies m·A(m·x) + (1-m)·x itself
            A = rk.raw
        else:
            def A(gp):
                return m * rk.raw(m * gp) + (1.0 - m) * gp
        coarse_mask = self.levels[L - 1].mask

        def m_inv(b_res):
            b_res = m * b_res
            x = chebyshev_smooth(A, inv_diag, fine.cheb, b_res)
            r = m * (b_res - A(x))
            rc = coarse_mask * self.restrict(L, rk.unpad(r).to(self.dtype))
            xc = self._cycle(L - 1, rc)
            x = x + m * rk.pad(self.prolongate(L, xc))
            return chebyshev_smooth(A, inv_diag, fine.cheb, b_res, x0=x)

        return A, m_inv, rk

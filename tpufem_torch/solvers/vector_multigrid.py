"""Geometric multigrid for vector-valued operators (elasticity GMG).

Port of ``tpufem/solvers/vector_multigrid.py``, deal.II's step-8/step-16
composition (``Multigrid`` over an ``FESystem`` elasticity operator):

- level operators: the multi-component ``VectorOperator`` on the
  incidence cell loop;
- transfers: the scalar 1D tensor-product embeddings of
  ``solvers.multigrid`` (``prolongation_1d``), per component (components
  share the scalar DoF layout, so the prolongation is block-diagonal),
  one strict-f32 (or f64) ``torch.matmul`` per axis;
- smoother: Chebyshev on the vector operator (``solvers.chebyshev``);
- coarse solve: the dense constrained inverse of the assembled elasticity
  block matrix (``fem.assemble.assemble_elasticity``, f64 on the host).

Vectors are (C, n_dofs) tensors throughout.  The JAX package threads its
device arrays through ``jit`` (``device_args``, the ``*_with`` forms);
here they are attributes and the level loop is Python.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_elasticity
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.vector import VectorOperator, elasticity_operator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.chebyshev import (
    ChebyshevParams,
    chebyshev_smooth,
    make_chebyshev_params,
)
from tpufem_torch.solvers.multigrid import prolongation_1d
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.precision import torch_dtype


@dataclass
class VectorMGLevel:
    mf: MatrixFree
    op: VectorOperator
    inv_diag: torch.Tensor  # (C, n_dofs)
    cheb: ChebyshevParams
    mask: torch.Tensor  # (n_dofs,) scalar interior mask (shared by comps)
    npts: int


class VectorMultigrid:
    """V-cycle preconditioner for elasticity over uniformly refined
    hyper_cube levels.  ``op_factory(mf) -> VectorOperator`` generalises
    beyond elasticity; ``coarse_matrix(dofs) -> (C n, C n) ndarray`` must
    assemble the matching coarse block operator."""

    def __init__(
        self,
        dim: int,
        degree: int,
        finest_refine: int,
        coarsest_refine: int = 1,
        dtype: str = "float64",
        smoother_degree: int = 4,
        mu: float = 1.0,
        lam: float = 1.0,
        n_cycles: int = 1,
        op_factory: Optional[Callable] = None,
        coarse_matrix: Optional[Callable] = None,
        device: torch.device | str = "cuda",
    ):
        if coarsest_refine > finest_refine:
            raise ValueError("coarsest_refine must be <= finest_refine")
        self.device = resolve_device(device)
        self.dim, self.degree = dim, degree
        self.dtype = torch_dtype(dtype)
        self.n_cycles = n_cycles
        if op_factory is None:
            op_factory = lambda mf: elasticity_operator(mf, mu=mu, lam=lam)
        if coarse_matrix is None:
            coarse_matrix = lambda dofs: assemble_elasticity(
                dofs, mu=mu, lam=lam).toarray()
        self.levels: list[VectorMGLevel] = []
        for r in range(coarsest_refine, finest_refine + 1):
            mesh = Mesh.hyper_cube(dim, r)
            dofs = DoFHandler(mesh, degree)
            mf = MatrixFree.build(
                mesh, dofs, FemConfig(dim=dim, degree=degree, dtype=dtype,
                                      scatter="incidence"), self.device)
            op = op_factory(mf)
            C = op.n_components
            diag = op.diagonal()  # (C, n)
            cheb = make_chebyshev_params(
                lambda xf, _op=op, _C=C: _op.vmult(
                    xf.reshape(_C, -1)).reshape(-1),
                diag.reshape(-1), C * dofs.n_dofs, degree=smoother_degree)
            self.levels.append(VectorMGLevel(
                mf=mf, op=op, inv_diag=1.0 / diag, cheb=cheb,
                mask=mf.interior_mask, npts=(1 << r) * degree + 1))
        self.C = self.levels[0].op.n_components
        self.P1d = [
            torch.as_tensor(prolongation_1d(degree, 1 << r), dtype=self.dtype,
                            device=self.device)
            for r in range(coarsest_refine, finest_refine)]
        # the coarse dense inverse of the block system; constrained rows of
        # every component -> identity (component-major, as vmult_flat)
        lvl0 = self.levels[0]
        K = coarse_matrix(lvl0.mf.dofs)
        m = np.tile(lvl0.mask.cpu().to(torch.float64).numpy(), self.C)
        Kc = (m[:, None] * K * m[None, :]) + np.diag(1.0 - m)
        self.coarse_inv = torch.as_tensor(np.linalg.inv(Kc), dtype=self.dtype,
                                          device=self.device)

    # -- transfers: the scalar tensor-product embedding per component -----
    def _tensor_apply(self, P: torch.Tensor, x: torch.Tensor, npts_in: int,
                      npts_out: int) -> torch.Tensor:
        """Apply P (npts_out, npts_in) along each grid axis of every
        component of x (C, npts_in^d), x first."""
        d = self.dim
        t = x.reshape((x.shape[0],) + (npts_in,) * d)
        for axis in range(d):
            ax = d - axis  # the component axis leads
            t = torch.movedim(torch.matmul(torch.movedim(t, ax, -1), P.T),
                              -1, ax)
        return t.reshape(x.shape[0], -1)

    def prolongate(self, level: int, xc: torch.Tensor) -> torch.Tensor:
        return self._tensor_apply(self.P1d[level - 1], xc,
                                  self.levels[level - 1].npts,
                                  self.levels[level].npts)

    def restrict(self, level: int, xf: torch.Tensor) -> torch.Tensor:
        return self._tensor_apply(self.P1d[level - 1].T, xf,
                                  self.levels[level].npts,
                                  self.levels[level - 1].npts)

    # -- V-cycle ---------------------------------------------------------
    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == 0:
            return torch.mv(self.coarse_inv, b.reshape(-1)).reshape(self.C,
                                                                    -1)
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
        """M_inv b: ``n_cycles`` V-cycles, each after the first on the fine
        residual; b and the result are (C, n)."""
        L = len(self.levels) - 1
        x = self._cycle(L, b)
        for _ in range(self.n_cycles - 1):
            r = b - self.levels[L].op.vmult(x)
            x = x + self._cycle(L, r)
        return x

    def preconditioner(self) -> Callable:
        """The M_inv callable for ``cg_solve`` on (C, n) vectors."""
        return self._precondition

    @property
    def fine(self) -> VectorMGLevel:
        return self.levels[-1]

"""MatrixFree: the port's device data for the matrix-free Laplace apply.

Port of ``tpufem/ops/matrix_free.py::MatrixFree.build``.  Schemes
(``FemConfig.scatter``; ``auto`` resolves to ``structured`` on a uniform
mesh with nq1 == p+1, else ``incidence``, and to ``separable`` under
``use_pallas``, which any other scheme refuses):

- ``separable`` on a uniform mesh: either the Laplace factorisation of a
  uniform Cartesian grid, per-axis 1D operators ``Ks``/``Ms`` (the plain
  apply); with ``use_pallas`` the CUDA kernels attach where the JAX
  package attaches its Pallas kernels (``matrix_free.py:357-424``): K2
  (``KernelSeparable``) in 2D and 3D, K1 (``ResidentSeparable``) in 3D and
  K3 (``ResidentTerms2D``) in 2D; or a sum of tensor products of weighted
  1D matrices, ``terms``: an orthogonal curved mesh
  (``Mesh.separable_metric``, the hyper_shell), a separable coefficient
  (``coefficient_axes``) or a CP-expanded generic one
  (``coefficient_cp_tol``); with ``use_pallas`` K4 (``ResidentTerms``) or
  K3 attaches (``_terms_with_kernel``).  A kernel that cannot be built
  raises; nothing falls back to the plain apply on a CUDA device.
- ``structured``: the gather-free blocked cell loop of a uniform mesh
  (``ops.structured``), Cartesian (with a pointwise coefficient) or on
  the global quadrature grid with the per-point metric (curved meshes).
- ``dense``: one shared (nn, nn) local matrix (uniform Cartesian mesh,
  constant coefficient; ``ops.dense_local``).
- ``incidence`` / ``colored``: the general cell loop of any mesh,
  adaptive ones with hanging nodes included — gather the cells' local
  values, the FEEvaluation sequence per cell batch
  (``operators.laplace.laplace_cell_apply``), and a scatter that is free
  of conflicts within a launch: incidence a padded gather-sum per DoF,
  colored one add into distinct indices per color.  Hanging-node
  constraints apply as C (``distribute``) and C^T
  (``distribute_transpose``, a gather-sum over a host-built transpose
  table, master -> (constraint row, weight)).

No scheme uses an accumulating scatter over repeated indices, so every
apply is the same from run to run on the card.  The cell-loop tiers run
no hand-written kernel: the JAX package attaches its Pallas kernels only
in the separable scheme.

``boxes`` builds as in the JAX package: the constraint tables and the
host data, with the incidence branch behind ``gather``/``scatter`` and
``LaplaceOperator.diagonal``.  Its ``LaplaceOperator`` has no apply there
(the JAX package's raises TypeError, its device data carrying no cell->DoF
map), and neither has the port's; the box tier's operator is
``ops.boxes.BoxLaplaceOperator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.fem.coloring import color_cells
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mapping import Metric, compute_metric
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import ShapeInfo
from tpufem_torch.ops.dense_local import build_dense_local_matrix
from tpufem_torch.ops.kernel_separable import KernelSeparable, ResidentSeparable
from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
from tpufem_torch.ops.separable import (
    build_separable_metric_terms,
    build_separable_operators,
    cartesian_coef_terms,
    cp_coef_terms,
)
from tpufem_torch.ops.structured import (
    global_interp_matrices,
    sym_metric_components,
)
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.native import build_incidence
from tpufem_torch.utils.precision import torch_dtype


def resolve_device(device: torch.device | str) -> torch.device:
    """The requested device; a CUDA device that is absent raises (the port
    never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch version on the CPU")
    return device


def _fuse_mask(config, interior: np.ndarray, dofs: DoFHandler,
               npts: int) -> bool:
    """Whether a resident kernel (K1, K3, K4) fuses the Dirichlet mask: the
    constrained set is the DoF handler's boundary and that is the full
    boundary of the (npts,)^dim box, whose mask is separable (the kernels
    fold it into their 1D tables).  ``config.pallas_dirichlet``: None =
    auto, fuse exactly when representable; True requires it."""
    g = np.arange(npts)
    e = (g == 0) | (g == npts - 1)
    box = e
    for _ in range(config.dim - 1):
        box = (box[:, None] | e[None, :]).reshape(-1)
    plain_mask = (np.array_equal(interior == 0.0, dofs.boundary_mask)
                  and np.array_equal(dofs.boundary_mask, box))
    if config.pallas_dirichlet and not plain_mask:
        # the fused kernel bakes the FULL-boundary separable mask in; any
        # other constraint set would be mis-masked
        raise ValueError(
            "pallas_dirichlet=True requires the plain full-boundary "
            "Dirichlet mask (no extra constraints / custom "
            "constrained_mask)")
    return plain_mask if config.pallas_dirichlet is None \
        else config.pallas_dirichlet


def _terms_with_kernel(terms, npts, p, d, config, device, interior, dofs):
    """The K4 (3D) or K3 (2D) wrapper of a sum-of-tensor-products operator
    under ``use_pallas``, the mask fused by ``_fuse_mask``'s rule, else
    None (JAX ``matrix_free.py:44-66``, which falls back to its XLA apply
    where the kernel's tiling is unmet; here a kernel that cannot be built
    raises)."""
    if not config.use_pallas:
        return None
    cls = ResidentTerms if d == 3 else ResidentTerms2D
    return cls(npts, p, terms, torch_dtype(config.dtype),
               mode=config.pallas_mode,
               dirichlet=_fuse_mask(config, interior, dofs, npts),
               device=device)


def _canonical_order(mesh: Mesh, n: int) -> np.ndarray:
    """Cells of a uniform mesh in canonical lattice order (x fastest): a
    mesh from ``refine()`` is not lexicographic, and a field put into the
    blocked layout in another order is transposed (JAX
    ``matrix_free.py:425-437``)."""
    lat = mesh.origins // int(mesh.sizes[0])  # (nc, d)
    canonical = np.zeros(mesh.n_cells, dtype=np.int64)
    for a in range(mesh.dim):
        canonical += lat[:, a] * n**a
    return np.argsort(canonical)


def _to_blocked(arr: np.ndarray, order: np.ndarray, n: int, q1: int,
                d: int) -> np.ndarray:
    """(nc, nq, *trail) per-cell quadrature field -> blocked layout
    ([nz,qz,]ny,qy,nx,qx, *trail), cells taken in ``order``."""
    trail = arr.shape[2:]
    a2 = arr[order].reshape((n,) * d + (q1,) * d + trail)
    perm = []
    for i in range(d):
        perm += [i, d + i]
    return np.transpose(a2, perm + list(range(2 * d, 2 * d + len(trail))))


def transpose_table(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    pad: int):
    """Padded transpose of a sparse list of entries (row, col, val): the
    distinct cols ``tc`` (nt,), and per col the rows ``tr`` (nt, K) and
    values ``tv`` (nt, K) of its entries, in row order, padded with row
    ``pad`` and value 0.  ``(tv * x_pad[tr]).sum(1)`` added at ``tc`` is
    the accumulating scatter ``y[cols] += vals * x[rows]`` as a gather-sum
    in a fixed order, with one write per index."""
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    tc, start, counts = np.unique(cols, return_index=True,
                                  return_counts=True)
    K = int(counts.max()) if len(counts) else 1
    slot = np.arange(len(cols)) - np.repeat(start, counts)
    pos = np.repeat(np.arange(len(tc)), counts)
    tr = np.full((len(tc), K), pad, dtype=np.int64)
    tv = np.zeros((len(tc), K))
    tr[pos, slot] = rows
    tv[pos, slot] = vals
    return tc, tr, tv


@dataclasses.dataclass
class MatrixFree:
    """Static + device data for one (mesh, degree, quadrature) instance."""

    config: FemConfig
    mesh: Mesh
    dofs: DoFHandler
    device: torch.device
    n_dofs: int
    # grid points per axis of a uniform mesh (cells per axis * p + 1)
    npts: int | None
    interior_mask: torch.Tensor  # (n_dofs,) 1 unconstrained, 0 constrained
    scheme: str = "separable"  # resolved scatter scheme
    Ks: list | None = None  # per-axis (npts, npts) 1D stiffness, x first
    Ms: list | None = None  # per-axis 1D mass (both config dtype)
    # sum-of-tensor-products operator: terms[a][b] (npts, npts), b = 0 is x
    terms: list | None = None
    kernel: KernelSeparable | None = None  # K2: flat vmult (use_pallas)
    # solver-resident kernel: K1 (3D Laplace), K3 (2D), K4 (3D terms)
    resident: ResidentSeparable | ResidentTerms | ResidentTerms2D | None = None
    quad: Quadrature | None = None
    host_metric: Metric | None = None  # host f64 metric (setup, diagonal)
    coef_q: np.ndarray | None = None  # (nc, nq) f64 coefficient at qpoints
    # certified relative coefficient error of a CP-expanded operator
    coef_cp_err: float | None = None
    jacobi_diag: torch.Tensor | None = None  # given diagonal (bridge.py)
    # ---- cell-loop tiers (structured, dense, incidence, colored) --------
    # 1D shape matrices (config dtype): values S (nq1, n1), gradients D,
    # collocation derivative D_col (nq1, nq1) when nq1 == n1
    S: torch.Tensor | None = None
    D: torch.Tensor | None = None
    D_col: torch.Tensor | None = None
    metric_kind: str = "cartesian"  # 'cartesian' | 'general'
    uniform_n: int | None = None  # cells per axis (uniform meshes)
    # structured: Cartesian scale inv_h^2 * det (d,), x first, and the
    # weight block broadcastable against the blocked layout (coefficient
    # folded in); curved meshes: the packed metric on the global
    # quadrature grid (ncomp, (n*q1,)*d), see ops.structured
    struct_scale: torch.Tensor | None = None
    struct_w: torch.Tensor | None = None
    struct_gsym: torch.Tensor | None = None
    global_EG: tuple | None = None  # per-axis (E, Gd) lists, curved only
    dense_A: torch.Tensor | None = None  # (nn, nn) shared local matrix
    # per-cell device data of the gather tiers and the device diagonal,
    # uploaded on first use (``cell_data``): the cell->DoF map (nc, nn),
    # the metric (cartesian: inv_h (nc, d), det (nc,), w_q (nq,); general:
    # inv_jac (nc, nq, d, d), jxw (nc, nq)) and the coefficient (nc, nq)
    cell_dofs: torch.Tensor | None = None
    inv_h: torch.Tensor | None = None
    det: torch.Tensor | None = None
    w_q: torch.Tensor | None = None
    inv_jac: torch.Tensor | None = None
    jxw: torch.Tensor | None = None
    coef_dev: torch.Tensor | None = None
    # built lazily on first use, as in the reference (the uniform tiers
    # never touch them; at 3.3M DoFs the incidence map is ~0.2 GB):
    # incidence (n_dofs, K) flat positions into the locals, padded with
    # nc*nn (an appended zero); colors a list of (cells, dofs) per color
    incidence: torch.Tensor | None = None
    colors: list | None = None
    # hanging-node constraints (None without): C rows (con_dofs (ncon,),
    # con_masters (ncon, K), con_weights, con_inhom), and C^T as the
    # transpose table (con_T: distinct masters (nm,), constraint rows
    # (nm, Kt) padded with ncon, weights (nm, Kt)); con_host the host
    # padded arrays (setup use)
    con_dofs: torch.Tensor | None = None
    con_masters: torch.Tensor | None = None
    con_weights: torch.Tensor | None = None
    con_inhom: torch.Tensor | None = None
    con_T: tuple | None = None
    con_host: tuple | None = None
    constraints_obj: object | None = None  # host AffineConstraints

    @classmethod
    def build(cls, mesh: Mesh, dofs: DoFHandler, config: FemConfig,
              device: torch.device | str, coefficient=None,
              constrained_mask: np.ndarray | None = None,
              constraints=None,
              coefficient_axes: list | None = None,
              coefficient_cp_tol: float | None = None,
              coefficient_cp_max_rank: int = 6) -> "MatrixFree":
        """Host setup (the reference's ``reinit``).

        ``coefficient``: a pointwise variable coefficient c(x) (vectorized
        on physical points (N, d)); the per-qpoint tiers take it exactly,
        the separable scheme only through ``coefficient_cp_tol``.
        ``constrained_mask``: constrained DoFs (default: the boundary);
        ``constraints``: an AffineConstraints (hanging nodes), whose DoFs
        are constrained too.

        ``coefficient_axes``: a separable variable coefficient, d
        per-axis callables with c(x) = prod_a c_a(x_a); the separable
        operator factors exactly into weighted 1D matrices.  The pointwise
        coefficient is synthesized from it for the other tiers and the
        diagonal.

        ``coefficient_cp_tol``: separable scheme with a generic pointwise
        ``coefficient``: CP-expand it at the quadrature grid to this
        relative tolerance (up to ``coefficient_cp_max_rank`` ranks, d
        terms each); the achieved error is ``coef_cp_err``.
        """
        p, d = config.degree, config.dim
        if mesh.dim != d or dofs.degree != p:
            raise ValueError("mesh/dofs do not match the config's dim/degree")
        if coefficient_axes is not None:
            if coefficient is not None:
                raise ValueError(
                    "pass either coefficient or coefficient_axes, not both")
            if len(coefficient_axes) != d:
                raise ValueError(f"coefficient_axes needs {d} callables")
            cax = list(coefficient_axes)

            def coefficient(pts, _cax=cax):  # noqa: F811
                out = np.ones(pts.shape[0])
                for a, ca in enumerate(_cax):
                    out = out * np.asarray(ca(pts[:, a]))
                return out
        quad = Quadrature.gauss(config.nq1)
        metric = compute_metric(mesh, quad,
                                need_points=coefficient is not None)
        coef_q = None
        if coefficient is not None:
            coef_q = np.asarray(coefficient(metric.quad_points.reshape(
                -1, d)), np.float64).reshape(mesh.n_cells, -1)
        if constrained_mask is None:
            constrained_mask = dofs.boundary_mask
        if constraints is not None and constraints.lines:
            constrained_mask = constrained_mask | \
                constraints.constrained_mask()
        else:
            constraints = None
        interior = (~constrained_mask).astype(np.float64)

        structured_ok = mesh.is_uniform and config.nq1 == p + 1
        cartesian_ok = structured_ok and metric.kind == "cartesian"
        dense_ok = cartesian_ok and coef_q is None
        scheme = config.scatter
        if scheme == "auto":
            # the gather-free blocked cell loop on uniform grids, else the
            # general cell loop; under use_pallas the separable scheme,
            # the only one with kernels (the JAX package resolves auto to
            # structured there and leaves use_pallas unread)
            scheme = ("separable" if config.use_pallas
                      else "structured" if structured_ok else "incidence")
        if config.use_pallas and scheme != "separable":
            raise ValueError(
                f"use_pallas attaches kernels only in the separable scheme, "
                f"not scatter={scheme!r}")
        if scheme == "structured" and not structured_ok:
            raise ValueError(
                "structured scheme needs a uniform mesh and nq1 == p+1")
        if scheme == "dense" and not dense_ok:
            raise ValueError("dense scheme needs a uniform Cartesian mesh, "
                             "nq1 == p+1 and no variable coefficient")
        common = dict(interior=interior, quad=quad, host_metric=metric)
        if scheme == "separable":
            # an orthogonal curved mesh, a separable coefficient or a
            # CP-expanded generic one keep the separable scheme; any other
            # pointwise coefficient takes a per-qpoint tier
            sep_metric_ok = (structured_ok and coef_q is None
                             and mesh.separable_metric is not None)
            sep_coef_ok = cartesian_ok and coefficient_axes is not None
            sep_cp_ok = (cartesian_ok and coefficient is not None
                         and coefficient_cp_tol is not None
                         and coefficient_axes is None)
            if not (dense_ok or sep_metric_ok or sep_coef_ok or sep_cp_ok):
                raise ValueError(
                    "separable scheme needs a uniform Cartesian mesh (or an "
                    "orthogonal separable metric), nq1 == p+1 and no "
                    "non-separable variable coefficient (pass "
                    "coefficient_axes for a separable one, or "
                    "coefficient_cp_tol to CP-expand it)")
            n = int(mesh.U // mesh.sizes[0])
            if sep_metric_ok and metric.kind == "general":
                # orthogonal curved mesh (polar/spherical shell): the
                # operator factors exactly into sums of tensor products of
                # weighted 1D matrices (JAX matrix_free.py:262-279)
                terms = build_separable_metric_terms(
                    p, d, config.nq1, n, mesh.separable_metric, np.float64)
                return cls.from_terms(config, mesh, dofs, device, terms,
                                      **common)
            if sep_coef_ok:
                terms = cartesian_coef_terms(
                    p, d, config.nq1, n, mesh.lower, mesh.upper,
                    coefficient_axes, np.float64)
                return cls.from_terms(config, mesh, dofs, device, terms,
                                      coef_q=coef_q, **common)
            if sep_cp_ok:
                terms, cp_err = cp_coef_terms(
                    p, d, config.nq1, n, mesh.lower, mesh.upper, coefficient,
                    np.float64, tol=coefficient_cp_tol,
                    max_rank=coefficient_cp_max_rank)
                return cls.from_terms(config, mesh, dofs, device, terms,
                                      coef_q=coef_q, coef_cp_err=cp_err,
                                      **common)
            h = 1.0 / metric.inv_h[0]  # (d,) physical cell widths
            Ks, Ms = build_separable_operators(p, d, config.nq1, n, h,
                                               np.float64)
            return cls.from_operators(config, mesh, dofs, device, Ks, Ms,
                                      **common)
        return cls._cell_loop(config, mesh, dofs, resolve_device(device),
                              scheme, metric, coef_q, constraints, **common)

    @classmethod
    def _cell_loop(cls, config, mesh, dofs, device, scheme, metric, coef_q,
                   constraints, interior, quad, host_metric):
        """The structured, dense, incidence and colored tiers."""
        p, d, q1 = config.degree, config.dim, config.nq1
        dt = torch_dtype(config.dtype)
        as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dt,
                                           device=device)
        si = ShapeInfo(p, quad)
        mf = cls(config=config, mesh=mesh, dofs=dofs, device=device,
                 n_dofs=dofs.n_dofs, npts=None,
                 interior_mask=as_dev(interior), scheme=scheme, quad=quad,
                 host_metric=host_metric, coef_q=coef_q,
                 S=as_dev(si.S), D=as_dev(si.D),
                 D_col=None if si.D_col is None else as_dev(si.D_col),
                 metric_kind=metric.kind, constraints_obj=constraints)
        if mesh.is_uniform:
            mf.uniform_n = n = int(mesh.U // mesh.sizes[0])
            mf.npts = n * p + 1
        if scheme == "structured" and metric.kind == "general":
            # curved uniform mesh: jxw (* coefficient) J^-1 J^-T per
            # qpoint on the global quadrature grid, component-major (the
            # JAX package keeps the components last, a layout chosen for
            # its TPU's tiling); the global interpolation operators
            order = _canonical_order(mesh, n)
            jxw = metric.jxw if coef_q is None else metric.jxw * coef_q
            gsym = _to_blocked(sym_metric_components(metric.inv_jac, jxw),
                               order, n, q1, d)
            ncomp = d * (d + 1) // 2
            mf.struct_gsym = as_dev(np.moveaxis(
                np.ascontiguousarray(gsym).reshape((n * q1,) * d + (ncomp,)),
                -1, 0).copy())
            E, Gd = global_interp_matrices(p, n, si.S, si.D_col)
            mf.global_EG = ([as_dev(E)] * d, [as_dev(Gd)] * d)
        elif scheme in ("structured", "dense"):
            inv_h0 = metric.inv_h[0]  # identical for all cells
            scale = inv_h0**2 * metric.det[0]  # f64, rounded once to dt
            mf.struct_scale = as_dev(scale)
            if scheme == "dense":
                mf.dense_A = as_dev(build_dense_local_matrix(
                    p, d, q1, np.asarray(scale, np.dtype(config.dtype))))
            else:
                # weight block broadcastable against the blocked layout:
                # quadrature dims at odd positions, axis order z..x
                w1 = np.asarray(quad.weights_1d)
                wb = np.ones([1] * (2 * d))
                for a in range(d):
                    sh = [1] * (2 * d)
                    sh[2 * (d - 1 - a) + 1] = q1
                    wb = wb * w1.reshape(sh)
                if coef_q is not None:
                    wb = wb * _to_blocked(coef_q, _canonical_order(mesh, n),
                                          n, q1, d)
                mf.struct_w = as_dev(wb)
        if constraints is not None:
            c, m, w, ih = constraints.padded_arrays()
            mf.con_host = (c, m, w)
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=device)
            mf.con_dofs, mf.con_masters = idx(c), idx(m)
            mf.con_weights, mf.con_inhom = as_dev(w), as_dev(ih)
            genuine = w != 0.0  # pad slots: master 0, weight 0
            rows = np.nonzero(genuine)[0]
            tc, tr, tv = transpose_table(rows, m[genuine], w[genuine],
                                         len(c))
            mf.con_T = (idx(tc), idx(tr), as_dev(tv))
        if scheme in ("incidence", "colored"):
            mf.cell_data()
            if scheme == "colored":
                mf._ensure_colors()
            else:
                mf._ensure_incidence()
        return mf

    # ------------------------------------------------------------------
    def cell_data(self) -> None:
        """Upload the per-cell data of the gather tiers (the cell->DoF
        map, the metric, the coefficient), once."""
        if self.cell_dofs is not None:
            return
        dt = self.interior_mask.dtype
        as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dt,
                                           device=self.device)
        m = self.host_metric
        self.cell_dofs = torch.as_tensor(
            self.dofs.cell_dofs.astype(np.int64), device=self.device)
        if m.kind == "cartesian":
            self.inv_h, self.det, self.w_q = (as_dev(m.inv_h),
                                              as_dev(m.det), as_dev(m.w_q))
        else:
            self.inv_jac, self.jxw = as_dev(m.inv_jac), as_dev(m.jxw)
        if self.coef_q is not None:
            self.coef_dev = as_dev(self.coef_q)

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """read_dof_values for all cells: (n_dofs,) -> (nc, nn)."""
        self.cell_data()
        return u[self.cell_dofs]

    def _ensure_incidence(self) -> torch.Tensor:
        if self.incidence is None:
            nc, nn = self.dofs.cell_dofs.shape
            inc = build_incidence(self.dofs.cell_dofs, self.n_dofs, nc * nn)
            self.incidence = torch.as_tensor(inc.astype(np.int64),
                                             device=self.device)
        return self.incidence

    def _ensure_colors(self) -> list:
        if self.colors is None:
            cd = self.dofs.cell_dofs
            self.colors = [
                (torch.as_tensor(cells.astype(np.int64), device=self.device),
                 torch.as_tensor(cd[cells].reshape(-1).astype(np.int64),
                                 device=self.device))
                for cells in color_cells(self.mesh, cd)]
        return self.colors

    def scatter_incidence(self, v_loc: torch.Tensor) -> torch.Tensor:
        """distribute_local_to_global, transpose-gather scheme: each DoF
        sums its fixed-K padded list of positions in the flattened locals
        (the pad points at an appended zero) — no scatter at all."""
        inc = self._ensure_incidence()
        flat = torch.cat([v_loc.reshape(-1), v_loc.new_zeros(1)])
        return flat[inc].sum(dim=1)

    def scatter_colored(self, v_loc: torch.Tensor) -> torch.Tensor:
        """distribute_local_to_global, graph-colored scheme: per color one
        add into distinct indices (the reference's colored plain store)."""
        dst = v_loc.new_zeros(self.n_dofs)
        for cells, idx in self._ensure_colors():
            dst[idx] = dst[idx] + v_loc[cells].reshape(-1)
        return dst

    def scatter(self, v_loc: torch.Tensor) -> torch.Tensor:
        if self.scheme == "colored":
            return self.scatter_colored(v_loc)
        return self.scatter_incidence(v_loc)

    # ------------------------------------------------------------------
    # hanging-node constraint application (C and C^T), the reference's
    # resolve_hanging_nodes<false/true>
    @property
    def has_hanging(self) -> bool:
        return self.con_dofs is not None

    def distribute(self, u: torch.Tensor,
                   homogeneous: bool = True) -> torch.Tensor:
        """u -> C u: constrained entries replaced by their interpolation."""
        if not self.has_hanging:
            return u
        vals = (self.con_weights * u[self.con_masters]).sum(dim=1)
        if not homogeneous:
            vals = vals + self.con_inhom
        u = u.clone()
        u[self.con_dofs] = vals
        return u

    def distribute_transpose(self, y: torch.Tensor) -> torch.Tensor:
        """y -> C^T y: constrained contributions accumulated to masters,
        constrained entries zeroed; the accumulation is the transpose
        table's gather-sum, one write per master."""
        if not self.has_hanging:
            return y
        tc, tr, tv = self.con_T
        yc = torch.cat([y[self.con_dofs], y.new_zeros(1)])
        y = y.clone()
        y[self.con_dofs] = 0.0
        y[tc] = y[tc] + (tv * yc[tr]).sum(dim=1)
        return y

    @classmethod
    def from_operators(cls, config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                       device: torch.device | str, Ks, Ms,
                       interior: np.ndarray, quad=None, host_metric=None,
                       jacobi_diag: np.ndarray | None = None) -> "MatrixFree":
        """MatrixFree from host arrays: per-axis f64 1D operators and the
        interior mask; attaches the kernels under ``config.use_pallas``."""
        p, d = config.degree, config.dim
        device = resolve_device(device)
        dt = torch_dtype(config.dtype)
        npts = int(mesh.U // mesh.sizes[0]) * p + 1
        Ks = [np.asarray(K, np.float64) for K in Ks]
        Ms = [np.asarray(M, np.float64) for M in Ms]
        kernel = resident = None
        if config.use_pallas:
            kernel = KernelSeparable(d, npts, p, Ks, Ms, dt, device)
            if d == 3:
                resident = ResidentSeparable(
                    npts, p, Ks, Ms, dt, mode=config.pallas_mode,
                    dirichlet=_fuse_mask(config, interior, dofs, npts),
                    device=device)
            else:
                # the 2-term Laplace factorisation through K3: the 2D
                # resident CG (JAX matrix_free.py:408-424), the mask fused
                resident = ResidentTerms2D(
                    npts, p, [[Ks[0], Ms[1]], [Ms[0], Ks[1]]], dt,
                    mode=config.pallas_mode,
                    dirichlet=_fuse_mask(config, interior, dofs, npts),
                    device=device)
        as_dev = lambda a: torch.tensor(np.asarray(a), dtype=dt,
                                        device=device)
        return cls(
            config=config, mesh=mesh, dofs=dofs, device=device,
            n_dofs=dofs.n_dofs, npts=npts, interior_mask=as_dev(interior),
            Ks=[as_dev(K) for K in Ks], Ms=[as_dev(M) for M in Ms],
            kernel=kernel, resident=resident, quad=quad,
            host_metric=host_metric,
            jacobi_diag=None if jacobi_diag is None else as_dev(jacobi_diag))

    @classmethod
    def from_terms(cls, config: FemConfig, mesh: Mesh, dofs: DoFHandler,
                   device: torch.device | str, terms, interior: np.ndarray,
                   quad=None, host_metric=None, coef_q=None,
                   coef_cp_err=None,
                   jacobi_diag: np.ndarray | None = None) -> "MatrixFree":
        """MatrixFree of a sum-of-tensor-products operator from host
        arrays: ``terms[a][b]`` f64 1D matrices (b = 0 is x) and the
        interior mask; K4/K3 attaches under ``config.use_pallas``."""
        p, d = config.degree, config.dim
        device = resolve_device(device)
        dt = torch_dtype(config.dtype)
        npts = int(mesh.U // mesh.sizes[0]) * p + 1
        terms = [[np.asarray(X, np.float64) for X in term] for term in terms]
        resident = _terms_with_kernel(terms, npts, p, d, config, device,
                                      interior, dofs)
        as_dev = lambda a: torch.tensor(np.asarray(a), dtype=dt,
                                        device=device)
        return cls(
            config=config, mesh=mesh, dofs=dofs, device=device,
            n_dofs=dofs.n_dofs, npts=npts, interior_mask=as_dev(interior),
            terms=[[as_dev(X) for X in term] for term in terms],
            resident=resident, quad=quad, host_metric=host_metric,
            coef_q=coef_q, coef_cp_err=coef_cp_err,
            jacobi_diag=None if jacobi_diag is None else as_dev(jacobi_diag))

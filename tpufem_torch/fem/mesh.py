"""Structured quad/hex meshes with optional 2:1 adaptive refinement.

Reference analogue: the role deal.II's ``Triangulation``/``GridGenerator``
plays for the reference (SURVEY.md L0): ``hyper_cube`` + ``refine_global`` and
the adaptive variant that produces hanging nodes (SURVEY.md §3.1).

Design: cells live in a forest of quadtrees/octrees over an ``nbase``^dim base
grid of the unit cube. Every cell is identified by integer origin coordinates
in units of ``1 / U`` per axis, where ``U = nbase * 2**max_level``, plus its
integer size ``s = 2**(max_level - level)``. All topology queries (shared
vertices/edges/faces, coarse-fine neighbors) reduce to exact integer
arithmetic — no floating-point geometry. Physical geometry is a separate
concern: ``lower + (upper-lower) * logical`` plus an optional smooth
``transform`` producing curved meshes (deal.II MappingQ analogue).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


class Mesh:
    """Leaf cells of a 2:1-balanced structured refinement forest.

    Attributes:
      dim:        2 or 3
      nbase:      base grid cells per axis (int)
      max_level:  deepest refinement level present (defines the integer unit)
      origins:    (ncells, dim) int64 — cell origin in 1/U units
      sizes:      (ncells,) int64 — cell edge length in 1/U units
      lower/upper:(dim,) float64 physical bounding box
      transform:  optional map [0,1]^dim logical -> physical (vectorized)
    """

    def __init__(
        self,
        dim: int,
        nbase: int,
        max_level: int,
        origins: np.ndarray,
        sizes: np.ndarray,
        lower: Optional[Sequence[float]] = None,
        upper: Optional[Sequence[float]] = None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.dim = dim
        self.nbase = nbase
        self.max_level = max_level
        self.origins = np.asarray(origins, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.lower = np.asarray(
            lower if lower is not None else [0.0] * dim, dtype=np.float64
        )
        self.upper = np.asarray(
            upper if upper is not None else [1.0] * dim, dtype=np.float64
        )
        self.transform = transform
        # Optional analytic Jacobian of the transform: callable
        # (N, dim) -> (N, dim, dim) with J[n, a, b] = d phys_a / d x_b.
        # When present, compute_metric uses the EXACT mapping geometry
        # (the reference's higher-order MappingQ analogue) instead of the
        # Q1 multilinear fallback.
        self.transform_jac = None
        # Optional multiplicative-separable metric (orthogonal transforms
        # such as polar/spherical maps): separable_metric[a][b] is a 1D
        # callable on logical x_b in [0,1] (None = 1) with the weak-form
        # weight of gradient term a equal to prod_b w[a][b](x_b) — the
        # exact factorization the separable tier assembles 1D weighted
        # matrices from (tpufem.ops.separable.global_1d_weighted).
        self.separable_metric = None
        # Optional DISCRETE polynomial geometry (the reference's MappingQ,
        # SURVEY.md §2/L0: geometry known only at support points —
        # perturbed nodes, imported meshes): (nc, (m+1)^dim, dim) physical
        # support-point coords per cell (lexicographic, x fastest) on an
        # equidistant Q_m lattice of the reference cell, plus the mapping
        # degree m.  Takes precedence over transform/transform_jac in
        # compute_metric.  Set via ``set_mapping_q`` or directly.
        self.support_points = None
        self.mapping_degree = None

    def _like(self, origins: np.ndarray, sizes: np.ndarray,
              max_level: int) -> "Mesh":
        """New Mesh with the same domain/map but different cells.

        Carries ``transform_jac`` / ``separable_metric`` (attributes set
        after __init__) — without this every refine/coarsen/balance pass
        silently dropped the exact mapping geometry and downstream
        metric/estimator code fell back to the Q1 multilinear map.
        """
        m = Mesh(self.dim, self.nbase, max_level, origins, sizes,
                 self.lower, self.upper, self.transform)
        m.transform_jac = self.transform_jac
        m.separable_metric = self.separable_metric
        # support_points are PER-CELL and do not survive cell changes:
        # re-derive them on the new mesh with set_mapping_q if needed
        return m

    # ------------------------------------------------------------------
    def set_mapping_q(self, degree: int, perturb=None) -> "Mesh":
        """Attach a discrete Q_``degree`` geometry (deal.II ``MappingQ``
        analogue, SURVEY.md §2 L0): per-cell support points sampled from
        the mesh's current geometry (transform or affine), optionally
        moved by ``perturb(pts) -> pts`` (vectorized on physical
        coords).  After this call the geometry is known ONLY through the
        stored support points — compute_metric builds the per-qpoint
        metric from the polynomial interpolant, exactly how the
        reference handles imported/perturbed meshes whose geometry has
        no closed form.  Returns self (chainable)."""
        m = int(degree)
        if m < 1:
            raise ValueError("mapping degree must be >= 1")
        n1 = m + 1
        nodes = np.linspace(0.0, 1.0, n1)
        idx = np.arange(n1**self.dim)
        ref = np.stack([nodes[(idx // n1**a) % n1]
                        for a in range(self.dim)], axis=-1)  # (k, d)
        logical = (self.origins[:, None, :]
                   + self.sizes[:, None, None] * ref[None]) / self.U
        pts = self.to_physical(logical)
        if perturb is not None:
            d = self.dim
            pts = np.asarray(perturb(pts.reshape(-1, d))).reshape(pts.shape)
        self.support_points = np.asarray(pts, np.float64)
        self.mapping_degree = m
        return self

    # ------------------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return len(self.sizes)

    @property
    def U(self) -> int:
        """Integer extent of the mesh per axis (1/U is the coordinate unit)."""
        return self.nbase * (1 << self.max_level)

    @property
    def is_uniform(self) -> bool:
        return bool(np.all(self.sizes == self.sizes[0]))

    # ------------------------------------------------------------------
    @classmethod
    def hyper_cube(
        cls,
        dim: int,
        refinements: int = 0,
        lower: float | Sequence[float] = 0.0,
        upper: float | Sequence[float] = 1.0,
        nbase: int = 1,
    ) -> "Mesh":
        """Uniformly refined cube — GridGenerator::hyper_cube +
        refine_global(refinements) (SURVEY.md §3.1)."""
        n = nbase * (1 << refinements)
        axes = [np.arange(n, dtype=np.int64)] * dim
        grids = np.meshgrid(*axes, indexing="ij")
        # x fastest in cell ordering (matches dof/qpoint lexicographic rule)
        origins = np.stack([g.ravel(order="F") for g in grids], axis=-1)
        sizes = np.ones(n**dim, dtype=np.int64)
        if np.isscalar(lower):
            lower = [float(lower)] * dim
        if np.isscalar(upper):
            upper = [float(upper)] * dim
        return cls(dim, nbase, refinements, origins, sizes, lower, upper)

    @classmethod
    def hyper_shell_2d(
        cls,
        refinements: int = 0,
        r_inner: float = 0.5,
        r_outer: float = 1.0,
        wedge: float = 0.5 * np.pi,
    ) -> "Mesh":
        """Annulus wedge (polar map of the unit square) — the reference's
        GridGenerator::hyper_shell analogue (SURVEY.md §3.1), exercising
        the curved/general metric path.  logical (s, t) -> physical
        (r cos(theta), r sin(theta)) with r = r_inner + s (r_outer-r_inner),
        theta = t * wedge."""

        def polar(x):
            r = r_inner + x[:, 0] * (r_outer - r_inner)
            th = x[:, 1] * wedge
            return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)

        m = cls.hyper_cube(2, refinements)
        m.transform = polar

        def polar_jac(x):
            r = r_inner + x[:, 0] * (r_outer - r_inner)
            th = x[:, 1] * wedge
            dr_ = r_outer - r_inner
            J = np.empty(x.shape[:1] + (2, 2))
            J[:, 0, 0] = dr_ * np.cos(th)
            J[:, 1, 0] = dr_ * np.sin(th)
            J[:, 0, 1] = -wedge * r * np.sin(th)
            J[:, 1, 1] = wedge * r * np.cos(th)
            return J

        m.transform_jac = polar_jac
        # polar coords are orthogonal: the Laplace weak-form weights
        # factor exactly per term (|J| = dr*w*r; G = diag(1/dr^2,
        # 1/(w r)^2)) — the separable tier assembles from these
        dr = r_outer - r_inner

        def _r(s):
            return r_inner + s * dr

        m.separable_metric = [
            [lambda s: (wedge / dr) * _r(s), None],  # K_s weight
            [lambda s: (dr / wedge) / _r(s), None],  # M_s weight, K_t = 1
        ]
        return m

    @classmethod
    def hyper_shell_3d(
        cls,
        refinements: int = 0,
        r_inner: float = 0.5,
        r_outer: float = 1.0,
        polar: tuple = (0.25 * np.pi, 0.75 * np.pi),
        wedge_azim: float = 0.5 * np.pi,
    ) -> "Mesh":
        """3D spherical-shell wedge (spherical map of the unit cube) —
        the 3D form of the reference's GridGenerator::hyper_shell
        geometry (SURVEY.md §3.1).  logical (s, t, u) ->
        (r sin(th) cos(ph), r sin(th) sin(ph), r cos(th)) with
        r = r_inner + s dr, th in [polar[0], polar[1]], ph = u*wedge_azim.
        The polar range stays inside (0, pi) to keep the map bijective."""

        def spherical(x):
            r = r_inner + x[:, 0] * (r_outer - r_inner)
            th = polar[0] + x[:, 1] * (polar[1] - polar[0])
            ph = x[:, 2] * wedge_azim
            st = np.sin(th)
            return np.stack(
                [r * st * np.cos(ph), r * st * np.sin(ph), r * np.cos(th)],
                axis=-1,
            )

        m = cls.hyper_cube(3, refinements)
        m.transform = spherical

        def spherical_jac(x):
            dr_ = r_outer - r_inner
            dth_ = polar[1] - polar[0]
            r = r_inner + x[:, 0] * dr_
            th = polar[0] + x[:, 1] * dth_
            ph = x[:, 2] * wedge_azim
            st, ct = np.sin(th), np.cos(th)
            sp, cp = np.sin(ph), np.cos(ph)
            J = np.empty(x.shape[:1] + (3, 3))
            J[:, 0, 0] = dr_ * st * cp
            J[:, 1, 0] = dr_ * st * sp
            J[:, 2, 0] = dr_ * ct
            J[:, 0, 1] = dth_ * r * ct * cp
            J[:, 1, 1] = dth_ * r * ct * sp
            J[:, 2, 1] = -dth_ * r * st
            J[:, 0, 2] = -wedge_azim * r * st * sp
            J[:, 1, 2] = wedge_azim * r * st * cp
            J[:, 2, 2] = 0.0
            return J

        m.transform_jac = spherical_jac
        # spherical coords are orthogonal with scale factors
        # (dr, r dth, r sin(th) dph): every weak-form term weight
        # factors into 1D functions of (s, t, u) — see hyper_shell_2d
        dr = r_outer - r_inner
        dth = polar[1] - polar[0]
        dph = wedge_azim

        def _r(s):
            return r_inner + s * dr

        def _st(t):
            return np.sin(polar[0] + t * dth)

        m.separable_metric = [
            [lambda s: (dth * dph / dr) * _r(s) ** 2, _st, None],
            [lambda s: np.full_like(s, dr * dph / dth), _st, None],
            [lambda s: np.full_like(s, dr * dth / dph),
             lambda t: 1.0 / _st(t), None],
        ]
        return m

    # ------------------------------------------------------------------
    def cell_vertices_logical(self) -> np.ndarray:
        """(ncells, 2**dim, dim) logical coords of cell corner vertices,
        corner ordering lexicographic (x fastest)."""
        d, U = self.dim, self.U
        corners = _corner_offsets(d)  # (2^d, d) in {0,1}
        pts = self.origins[:, None, :] + self.sizes[:, None, None] * corners[None]
        return pts.astype(np.float64) / U

    def cell_vertices(self) -> np.ndarray:
        """(ncells, 2**dim, dim) physical coords of cell corner vertices."""
        return self.to_physical(self.cell_vertices_logical())

    def to_physical(self, logical: np.ndarray) -> np.ndarray:
        phys = self.lower + (self.upper - self.lower) * logical
        if self.transform is not None:
            shape = phys.shape
            phys = self.transform(phys.reshape(-1, self.dim)).reshape(shape)
        return phys

    # ------------------------------------------------------------------
    def refine(self, flags: np.ndarray) -> "Mesh":
        """Isotropically refine flagged cells and re-establish 2:1 balance.

        Reference analogue: adaptive ``triangulation.refine`` producing
        hanging nodes (SURVEY.md §3.1 adaptive variant).
        """
        flags = np.asarray(flags, dtype=bool)
        if flags.shape != (self.n_cells,):
            raise ValueError("flags must have one entry per cell")
        d = self.dim
        # Represent with one extra level of resolution available.
        origins = self.origins * 2
        sizes = self.sizes * 2
        max_level = self.max_level + 1

        new_origins = [origins[~flags]]
        new_sizes = [sizes[~flags]]
        if flags.any():
            par_o = origins[flags]
            par_s = sizes[flags]
            child = _corner_offsets(d)  # (2^d, d)
            ch_o = (par_o[:, None, :] + (par_s[:, None, None] // 2) * child[None])
            new_origins.append(ch_o.reshape(-1, d))
            new_sizes.append(np.repeat(par_s // 2, 2**d))
        origins = np.concatenate(new_origins, axis=0)
        sizes = np.concatenate(new_sizes, axis=0)
        m = self._like(origins, sizes, max_level)
        return m._balance()._normalized()

    def coarsen(self, flags: np.ndarray) -> "Mesh":
        """Merge flagged sibling groups back into their parents.

        deal.II ``coarsen_flag`` semantics (execute_coarsening): a group
        of 2^dim same-size siblings merges only if EVERY sibling is
        flagged; merges that would violate 2:1 balance are undone by the
        balance pass (net effect: vetoed).  Cells can coarsen at most
        one level per call.
        """
        flags = np.asarray(flags, dtype=bool)
        if flags.shape != (self.n_cells,):
            raise ValueError("flags must have one entry per cell")
        d = self.dim
        base = 1 << self.max_level  # base-cell edge in units
        s2 = 2 * self.sizes
        eligible = flags & (s2 <= base)
        # group by (parent origin, parent size); a parent region holds at
        # most 2^d same-size children, so count==2^d <=> complete group
        par_o = (self.origins // s2[:, None]) * s2[:, None]
        lev = np.log2(self.sizes).astype(np.int64)  # sizes are powers of 2
        key = _pack_coords(par_o, self.U + 1) * (self.max_level + 2) + lev
        uk, inv = np.unique(key, return_inverse=True)
        counts = np.bincount(inv, weights=eligible.astype(np.int64))
        merged = counts[inv] == 2**d  # all 2^d siblings flagged
        if not merged.any():
            return self
        keep_o = [self.origins[~merged]]
        keep_s = [self.sizes[~merged]]
        # one parent per merged group
        gk, first = np.unique(inv[merged], return_index=True)
        keep_o.append(par_o[merged][first])
        keep_s.append(s2[merged][first])
        m = self._like(np.concatenate(keep_o), np.concatenate(keep_s),
                       self.max_level)
        return m._balance()._normalized()

    def _balance(self) -> "Mesh":
        """Enforce 2:1 size balance between face-or-corner neighbors by
        refining too-coarse cells until fixed point."""
        m = self
        while True:
            flags = m._unbalanced_cells()
            if not flags.any():
                return m
            m = m._refine_no_balance(flags)

    def _refine_no_balance(self, flags: np.ndarray) -> "Mesh":
        d = self.dim
        need_split = self.sizes[flags]
        if np.any(need_split == 1):
            origins = self.origins * 2
            sizes = self.sizes * 2
            max_level = self.max_level + 1
        else:
            origins, sizes, max_level = self.origins, self.sizes, self.max_level
        new_o = [origins[~flags]]
        new_s = [sizes[~flags]]
        par_o, par_s = origins[flags], sizes[flags]
        child = _corner_offsets(d)
        ch_o = par_o[:, None, :] + (par_s[:, None, None] // 2) * child[None]
        new_o.append(ch_o.reshape(-1, d))
        new_s.append(np.repeat(par_s // 2, 2**d))
        return self._like(np.concatenate(new_o), np.concatenate(new_s),
                          max_level)

    def _unbalanced_cells(self) -> np.ndarray:
        """Cells with a (closed-bbox-)touching neighbor more than 2x smaller.

        Exact integer test exploiting octree alignment: every cell of size S
        has origin on the S-grid, so adjacency of a size-s cell to size-S
        leaves reduces to membership tests in a hash set of S-grid indices.
        Vertex-touching balance (stricter than face balance) keeps the
        hanging-node constraint structure one-level-deep everywhere.
        """
        nc = self.n_cells
        flags = np.zeros(nc, dtype=bool)
        sizes_present = np.unique(self.sizes)
        d = self.dim
        # index of coarse cells of size S by their S-grid coordinates
        by_size: dict[int, tuple[dict[int, int], np.ndarray]] = {}
        for S in sizes_present.tolist():
            sel = np.nonzero(self.sizes == S)[0]
            grid_idx = self.origins[sel] // S
            keys = _pack_coords(grid_idx, self.U // S + 1)
            by_size[S] = (dict(zip(keys.tolist(), sel.tolist())), sel)
        for S in sizes_present.tolist():
            coarse_map, _ = by_size[S]
            for s in sizes_present.tolist():
                if S < 4 * s:
                    continue
                fine_sel = np.nonzero(self.sizes == s)[0]
                of = self.origins[fine_sel]
                i_min = (of + S - 1) // S - 1
                i_max = (of + s) // S
                np.clip(i_min, 0, self.U // S - 1, out=i_min)
                np.clip(i_max, 0, self.U // S - 1, out=i_max)
                for box in range(2**d):
                    off = np.stack(
                        [(box >> a) & 1 for a in range(d)], axis=-1
                    ).astype(np.int64)
                    probe = np.minimum(i_min + off, i_max)
                    keys = _pack_coords(probe, self.U // S + 1)
                    for k in keys.tolist():
                        c = coarse_map.get(k)
                        if c is not None:
                            flags[c] = True
        return flags

    def _normalized(self) -> "Mesh":
        """Reduce max_level if all sizes are even (keeps ints small), and
        sort cells by (size desc, origin lexicographic) for determinism."""
        origins, sizes, max_level = self.origins, self.sizes, self.max_level
        while max_level > 0 and np.all(sizes % 2 == 0) and np.all(origins % 2 == 0):
            origins = origins // 2
            sizes = sizes // 2
            max_level -= 1
        key = _pack_coords(origins, self.nbase * (1 << max_level) + 1)
        order = np.lexsort((key, -sizes))
        return self._like(origins[order], sizes[order], max_level)


def _corner_offsets(dim: int) -> np.ndarray:
    """(2^dim, dim) corner offsets in {0,1}, x fastest."""
    idx = np.arange(2**dim)
    return np.stack([(idx >> a) & 1 for a in range(dim)], axis=-1).astype(np.int64)


def _pack_coords(coords: np.ndarray, base: int) -> np.ndarray:
    """Pack integer coordinate rows into single int64 keys (collision-free
    for coordinates in [0, base))."""
    coords = np.asarray(coords, dtype=np.int64)
    key = np.zeros(len(coords), dtype=np.int64)
    b = np.int64(base + 1)
    for a in range(coords.shape[1]):
        key = key * b + coords[:, a]
    return key

"""Q_p degree-of-freedom enumeration on structured (possibly adaptive) meshes.

Reference analogue: deal.II ``DoFHandler::distribute_dofs(FE_Q<dim>(p))`` as
consumed by the reference's setup path (SURVEY.md §3.1, §3.2).  The key
product is the SoA cell-to-global-DoF map the reference bakes into
``GpuData.local_to_global`` (SURVEY.md §2 "MatrixFreeGpu").

DoF identification is *entity based*, exactly deal.II's model: a DoF lives on
a vertex, an edge, a face (3D) or a cell interior, and is shared between cells
iff they share that entity (same integer endpoints AND same size).  A fine
edge that covers half of a coarse edge is a different entity — its DoFs are
separate (and hanging, to be constrained; see tpufem.fem.constraints).  This
is what makes adaptive meshes with GLL support points correct: lattice
hashing of node positions would spuriously unify fine node i with coarse node
i/2 even though their physical GLL positions differ.

Local DoF ordering within a cell is lexicographic with x fastest over the
(p+1)^dim node lattice — the ordering all sum-factorization kernels assume.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.fem.mesh import Mesh, _pack_coords
from tpufem_torch.fem.shapes import support_points_1d


class DoFHandler:
    """Enumerates global DoFs and builds the cell→DoF map.

    Attributes:
      n_dofs:         total number of global DoFs
      cell_dofs:      (ncells, (p+1)^dim) int32 global DoF per local node
      dof_coords:     (n_dofs, dim) float64 physical support-point coords
      boundary_mask:  (n_dofs,) bool — DoF on the domain boundary
    """

    def __init__(self, mesh: Mesh, degree: int):
        self.mesh = mesh
        self.degree = degree
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        mesh, p = self.mesh, self.degree
        d = mesh.dim
        n1 = p + 1
        nc = mesh.n_cells
        U = mesh.U
        if mesh.is_uniform:
            self._build_uniform()
            return

        # local node lattice (x fastest): node j has per-axis index i_a
        node_idx = np.arange(n1**d)
        I = np.stack([(node_idx // n1**a) % n1 for a in range(d)], axis=-1)
        # (n_nodes, d) int
        nn = n1**d

        o = mesh.origins  # (nc, d)
        s = mesh.sizes  # (nc,)

        # --- entity key per (cell, node):  per axis 3 ints + 1 size int ----
        # boundary axis (i in {0,p}):   (0, vertex_coord, 0)
        # interior axis (0 < i < p):    (1, origin_a,     i)
        # plus s_eff = cell size if any axis interior else 0
        # Packed IN PLACE into one (nc, nn) int64 — the column-stacked
        # form materialized ~10 full-size temporaries and dominated setup
        # (measured 50 s of a 68 s build at 3.3M DoFs).
        interior = (I > 0) & (I < p)  # (n_nodes, d)
        packed = np.zeros((nc, nn), dtype=np.int64)
        bits = 0
        for a in range(d):
            ia = I[:, a]  # (nn,)
            int_a = interior[:, a]  # (nn,)
            packed <<= 1
            packed += int_a[None, :]
            packed *= np.int64(U + 1)
            # interior nodes have ia != p, so the s-term vanishes there
            # and the branchless form IS the keyed coordinate (a broadcast
            # np.where here cost 4 s of the 25 s build at 10M DoFs)
            packed += o[:, a, None] + s[:, None] * (ia == p)[None, :]
            packed *= np.int64(n1)
            packed += np.where(int_a, ia, 0)[None, :]
            bits += 1 + int(U + 1).bit_length() + int(n1).bit_length()
        any_int = interior.any(axis=1)  # (nn,)
        packed *= np.int64(U + 1)
        packed += s[:, None] * any_int[None, :]
        bits += int(U + 1).bit_length()
        if bits >= 63:
            raise OverflowError(
                f"entity key needs {bits} bits; refine less or shard"
            )

        flat = packed.reshape(-1)
        order = np.argsort(flat, kind="stable")
        sp = flat[order]
        new = np.empty(len(sp), dtype=bool)
        new[0] = True
        np.not_equal(sp[1:], sp[:-1], out=new[1:])
        self.n_dofs = int(new.sum())
        # dtype=int32 keeps cumsum on the fast path (bool/int64 cumsum is
        # 30x slower in this numpy — 3.1 s vs 0.09 s at 18M keys, measured)
        gid_sorted = np.cumsum(new, dtype=np.int32) - 1
        inv = np.empty(len(sp), dtype=np.int32)
        inv[order] = gid_sorted
        self.cell_dofs = inv.reshape(nc, nn)

        # --- support points + boundary: ONE representative copy per DoF ---
        # (mapping all nc*nn points cost 7 s of the old build; this host
        # is single-core at ~150 MB/s so bytes touched IS the build time —
        # gathers run in int32 and dof_coords is materialized lazily)
        rep = order[np.nonzero(new)[0]]  # flat (cell, node) per DoF
        self._rep_cell = (rep // nn).astype(np.int32)
        self._rep_node = (rep % nn).astype(np.int32)
        self._dof_coords = None

        # boundary: exact integer test on the representative (a node
        # coordinate hits 0/U along an axis iff EVERY copy has I==0 with
        # o==0, resp. I==p with o+s==U, there — so the representative
        # decides exactly; the old all-(cell,node) test built nc*nn masks
        # and a full-size scatter)
        Ia = I[self._rep_node]  # (n_dofs, d)
        o32 = o.astype(np.int32)
        oc = o32[self._rep_cell]
        sc = s.astype(np.int32)[self._rep_cell, None]
        self.boundary_mask = (
            ((Ia == 0) & (oc == 0)) | ((Ia == p) & (oc + sc == U))
        ).any(axis=1)

    @property
    def dof_coords(self):
        """(n_dofs, dim) float64 physical support-point coordinates,
        materialized on first access (apply/solve hot paths never touch
        them; RHS assembly and boundary-value evaluation do)."""
        if self._dof_coords is None:
            if self.mesh.is_uniform:
                raise AssertionError("uniform build sets coords eagerly")
            mesh, p, d = self.mesh, self.degree, self.mesh.dim
            n1 = p + 1
            node_idx = np.arange(n1**d)
            I = np.stack(
                [(node_idx // n1**a) % n1 for a in range(d)], axis=-1)
            gll = support_points_1d(p)
            frac = gll[I[self._rep_node]]  # (n_dofs, d)
            o = mesh.origins[self._rep_cell]
            s = mesh.sizes[self._rep_cell, None]
            self._dof_coords = mesh.to_physical((o + s * frac) / mesh.U)
        return self._dof_coords

    @dof_coords.setter
    def dof_coords(self, val):
        self._dof_coords = val

    # ------------------------------------------------------------------
    def _build_uniform(self):
        """Uniform-mesh fast path: global lexicographic tensor numbering on
        the (p*n+1)^dim node grid — no hashing, O(ncells * nn) arithmetic.

        This is the SoA local_to_global layout the reference precomputes in
        MatrixFreeGpu::reinit (SURVEY.md §3.2), built in closed form.
        """
        mesh, p = self.mesh, self.degree
        d = mesh.dim
        n1 = p + 1
        nc = mesh.n_cells
        s = int(mesh.sizes[0])
        n = mesh.U // s  # cells per axis
        npts = n * p + 1  # global nodes per axis

        node_idx = np.arange(n1**d)
        I = np.stack([(node_idx // n1**a) % n1 for a in range(d)], axis=-1)
        cell_idx = mesh.origins // s  # (nc, d)
        # global per-axis node index: cell_idx*p + i
        g = cell_idx[:, None, :] * p + I[None, :, :]  # (nc, nn, d)
        # x fastest: dof = gx + npts*gy + npts^2*gz
        dof = np.zeros((nc, n1**d), dtype=np.int64)
        for a in range(d):
            dof += g[:, :, a] * npts**a
        self.n_dofs = npts**d
        self.cell_dofs = dof.astype(np.int32)

        gll = support_points_1d(p)
        # coordinates of global node grid: per axis, node k = cell k//p,
        # offset gll[k%p] (and the last node is the far endpoint)
        axis_coord = np.empty(npts)
        k = np.arange(npts)
        cell_of = np.minimum(k // p, n - 1)
        off = k - cell_of * p
        axis_coord = (cell_of + gll[off]) / n
        di = np.arange(self.n_dofs)
        logical = np.stack(
            [axis_coord[(di // npts**a) % npts] for a in range(d)], axis=-1
        )
        self.dof_coords = mesh.to_physical(logical)
        gi = np.stack([(di // npts**a) % npts for a in range(d)], axis=-1)
        self.boundary_mask = ((gi == 0) | (gi == npts - 1)).any(axis=1)

    # ------------------------------------------------------------------
    def face_local_dofs(self, axis: int, side: int) -> np.ndarray:
        """Local indices of the nodes on cell face (axis, side in {0,1}),
        ordered lexicographically in the remaining axes (x-like fastest).

        Used by hanging-node constraint setup (tpufem.fem.constraints)."""
        p, d = self.degree, self.mesh.dim
        n1 = p + 1
        node_idx = np.arange(n1**d)
        I = np.stack([(node_idx // n1**a) % n1 for a in range(d)], axis=-1)
        sel = I[:, axis] == (p if side else 0)
        face_nodes = node_idx[sel]
        # sort by remaining axes, lower axis fastest
        rem = [a for a in range(d) if a != axis]
        sort_key = np.zeros(len(face_nodes), dtype=np.int64)
        for a in reversed(rem):
            sort_key = sort_key * n1 + I[sel][:, a]
        return face_nodes[np.argsort(sort_key, kind="stable")]

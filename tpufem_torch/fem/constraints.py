"""Affine constraints: hanging nodes + Dirichlet, with device application.

The port's copy of ``tpufem/fem/constraints.py`` (only the imports
differ).  Reference analogue: deal.II ``AffineConstraints`` built from
``DoFTools::make_hanging_node_constraints`` + boundary values, consumed by
the reference in two places (SURVEY.md §2):
- ``hanging_nodes.cuh``: per-cell constraint masks resolved in-kernel by 1D
  interpolation before evaluate / after integrate;
- ``constraint_handler_gpu.h``: constrained-DoF index list with
  save/zero/restore around vmult.

Device application: a hanging DoF's value is an interpolation of its
masters, so the constrained operator is C^T A C with identity on
constrained rows.  ``distribute`` (x -> C x) and ``distribute_transpose``
(y -> C^T y) are padded gathers/scatters over the (small, surface-sized)
constrained set, fused into the operator apply.  The in-kernel mask
variant of the reference is algebraically identical; C-application keeps
the core cell loop scheme-independent.

Hanging-node detection is exact integer geometry on the 2:1-balanced
forest (tpufem_torch.fem.mesh): a fine cell face/edge hangs iff a double-size
neighbor's face/edge contains it; interpolation weights are tensor
products of the 1D subface matrices (tpufem_torch.fem.shapes).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh, _pack_coords
from tpufem_torch.fem.shapes import subface_interpolation_1d


class AffineConstraints:
    """Map: constrained dof -> [(master dof, weight)], + inhomogeneity."""

    def __init__(self, n_dofs: int):
        self.n_dofs = n_dofs
        self.lines: dict[int, list[tuple[int, float]]] = {}
        self.inhom: dict[int, float] = {}
        self._closed = False

    def add_line(self, dof: int):
        self.lines.setdefault(int(dof), [])

    def add_entry(self, dof: int, master: int, weight: float):
        self.lines.setdefault(int(dof), []).append((int(master), float(weight)))

    def set_inhomogeneity(self, dof: int, value: float):
        self.add_line(dof)
        self.inhom[int(dof)] = float(value)

    def is_constrained(self, dof: int) -> bool:
        return int(dof) in self.lines

    # ------------------------------------------------------------------
    def close(self, drop_tol: float = 1e-14):
        """Resolve chains: masters that are themselves constrained are
        substituted until a fixed point (deal.II ``close()``)."""
        for _ in range(64):
            changed = False
            for dof, ents in list(self.lines.items()):
                if any(m in self.lines for m, _ in ents):
                    new: dict[int, float] = {}
                    extra_inhom = 0.0
                    for m, w in ents:
                        if m in self.lines:
                            for mm, ww in self.lines[m]:
                                new[mm] = new.get(mm, 0.0) + w * ww
                            extra_inhom += w * self.inhom.get(m, 0.0)
                        else:
                            new[m] = new.get(m, 0.0) + w
                    self.lines[dof] = [
                        (m, w) for m, w in new.items() if abs(w) > drop_tol
                    ]
                    if extra_inhom:
                        self.inhom[dof] = self.inhom.get(dof, 0.0) + extra_inhom
                    changed = True
            if not changed:
                break
        else:
            raise RuntimeError("constraint chain did not close (cycle?)")
        self._closed = True

    # ------------------------------------------------------------------
    def padded_arrays(self, dtype=np.float64):
        """(con_dofs, masters, weights, inhom) padded device arrays.

        masters is (ncon, K) int32 padded with 0 and weight 0.
        """
        assert self._closed or not self.lines
        con = np.array(sorted(self.lines), dtype=np.int32)
        K = max((len(self.lines[d]) for d in con), default=0)
        K = max(K, 1)
        masters = np.zeros((len(con), K), dtype=np.int32)
        weights = np.zeros((len(con), K), dtype=dtype)
        inhom = np.zeros(len(con), dtype=dtype)
        for i, d in enumerate(con):
            for j, (m, w) in enumerate(self.lines[int(d)]):
                masters[i, j] = m
                weights[i, j] = w
            inhom[i] = self.inhom.get(int(d), 0.0)
        return con, masters, weights, inhom

    def constrained_mask(self) -> np.ndarray:
        mask = np.zeros(self.n_dofs, dtype=bool)
        mask[list(self.lines)] = True
        return mask

    # ------------------------------------------------------------------
    # host-side reference application (oracle / setup use)
    def distribute(self, u: np.ndarray) -> np.ndarray:
        out = u.copy()
        for d, ents in self.lines.items():
            out[d] = sum(w * u[m] for m, w in ents) + self.inhom.get(d, 0.0)
        return out

    def distribute_transpose(self, y: np.ndarray) -> np.ndarray:
        out = y.copy()
        for d, ents in self.lines.items():
            for m, w in ents:
                out[m] += w * y[d]
            out[d] = 0.0
        return out

    def condense_matrix(self, K):
        """C^T K C + identity on constrained rows (scipy, oracle use)."""
        import scipy.sparse as sp

        n = self.n_dofs
        rows, cols, vals = [], [], []
        for i in range(n):
            if i in self.lines:
                for m, w in self.lines[i]:
                    rows.append(i)
                    cols.append(m)
                    vals.append(w)
            else:
                rows.append(i)
                cols.append(i)
                vals.append(1.0)
        C = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        Kc = C.T @ K @ C
        # identity rows AND columns on constrained DoFs
        Kc = Kc.tolil()
        for d in self.lines:
            Kc.rows[d] = [d]
            Kc.data[d] = [1.0]
        Kc = Kc.tocsr().T.tolil()
        for d in self.lines:
            Kc.rows[d] = [d]
            Kc.data[d] = [1.0]
        return Kc.tocsr().T.tocsr()


# ----------------------------------------------------------------------
def make_hanging_node_constraints(dofs: DoFHandler) -> AffineConstraints:
    """Build hanging-node constraints on a 2:1-balanced adaptive mesh."""
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    ac = AffineConstraints(dofs.n_dofs)
    if mesh.is_uniform:
        ac.close()
        return ac

    # hash leaves by (size, grid index)
    by_size: dict[int, dict[int, int]] = {}
    for S in np.unique(mesh.sizes).tolist():
        sel = np.nonzero(mesh.sizes == S)[0]
        keys = _pack_coords(mesh.origins[sel] // S, mesh.U // S + 1)
        by_size[S] = dict(zip(keys.tolist(), sel.tolist()))

    C_sub = [subface_interpolation_1d(p, 0), subface_interpolation_1d(p, 1)]

    # ---- native (C++) fast path: identical triplets in identical order ---
    ac_native = _native_hanging_constraints(dofs, C_sub)
    if ac_native is not None:
        return ac_native

    def coarse_at(S: int, grid_idx: np.ndarray) -> int | None:
        if S not in by_size:
            return None
        if np.any(grid_idx < 0) or np.any(grid_idx >= mesh.U // S):
            return None
        return by_size[S].get(int(_pack_coords(grid_idx[None], mesh.U // S + 1)[0]))

    n1 = p + 1
    # ---- face constraints (2D: the only kind; 3D: face interiors+edges) --
    # coarse-neighbor table from the native setup runtime (C++ w/ fallback)
    from tpufem_torch.utils.native import coarse_face_neighbors

    face_nbr = coarse_face_neighbors(mesh.origins, mesh.sizes, mesh.U)
    for c in range(mesh.n_cells):
        s = int(mesh.sizes[c])
        o = mesh.origins[c]
        S = 2 * s
        for axis in range(d):
            for side in (0, 1):
                cc = int(face_nbr[c, axis, side])
                if cc < 0:
                    continue
                co = mesh.origins[cc]
                # fine face nodes constrained to coarse face nodes
                fine_local = dofs.face_local_dofs(axis, side)
                coarse_local = dofs.face_local_dofs(axis, 1 - side)
                F = dofs.cell_dofs[c, fine_local]
                M = dofs.cell_dofs[cc, coarse_local]
                # transverse axes in increasing order = face ordering
                trans = [a for a in range(d) if a != axis]
                bits = [int((o[t] - co[t]) // s) for t in trans]
                # weight tensor: fine index (i_t1 fast) x coarse (j_t1 fast)
                Wt = C_sub[bits[0]]
                if d == 3:
                    Wt = np.kron(C_sub[bits[1]], C_sub[bits[0]])
                for fi in range(len(F)):
                    fd = int(F[fi])
                    row = Wt[fi]
                    nz = np.nonzero(np.abs(row) > 1e-14)[0]
                    if len(nz) == 1 and int(M[nz[0]]) == fd:
                        continue  # coincides with a coarse dof (corner)
                    if ac.is_constrained(fd):
                        continue  # already constrained via another face
                    for j in nz:
                        ac.add_entry(fd, int(M[j]), float(row[j]))

    # ---- 3D edge constraints (fine edge on a coarse edge, no common
    # hanging face) --------------------------------------------------------
    if d == 3:
        for c in range(mesh.n_cells):
            s = int(mesh.sizes[c])
            o = mesh.origins[c]
            S = 2 * s
            for axis in range(3):  # edge direction
                t1, t2 = [a for a in range(3) if a != axis]
                for b1 in (0, 1):
                    for b2 in (0, 1):
                        # edge at transverse corner (b1, b2)
                        w1 = int(o[t1]) + s * b1
                        w2 = int(o[t2]) + s * b2
                        # find a coarse cell owning a covering edge: any
                        # leaf of size S whose edge [eo, eo+S] along axis
                        # at transverse coords (w1, w2) contains our edge
                        eo = (int(o[axis]) // S) * S
                        found = None
                        for dt1 in (0, -1):
                            for dt2 in (0, -1):
                                co = np.array(
                                    [0, 0, 0], dtype=np.int64
                                )
                                co[axis] = eo
                                co[t1] = w1 + dt1 * S
                                co[t2] = w2 + dt2 * S
                                # candidate must be an S-aligned leaf whose
                                # edge at (w1, w2) exists, i.e. transverse
                                # origins S-aligned and touching the corner
                                if co[t1] % S != 0 or co[t2] % S != 0:
                                    continue
                                if co[t1] < 0 or co[t2] < 0:
                                    continue
                                cc = coarse_at(S, co // S)
                                if cc is not None:
                                    found = (cc, co)
                                    break
                            if found:
                                break
                        if found is None:
                            continue
                        cc, co = found
                        # local edge dofs of fine cell along axis at corner
                        F = _edge_dofs(dofs, c, axis, b1, b2)
                        # coarse edge dofs: the coarse cell's edge at the
                        # matching transverse corner
                        cb1 = int((w1 - co[t1]) // S)
                        cb2 = int((w2 - co[t2]) // S)
                        M = _edge_dofs(dofs, cc, axis, cb1, cb2)
                        sub = int((int(o[axis]) - co[axis]) // s)
                        W = C_sub[sub]
                        for fi in range(n1):
                            fd = int(F[fi])
                            row = W[fi]
                            nz = np.nonzero(np.abs(row) > 1e-14)[0]
                            if len(nz) == 1 and int(M[nz[0]]) == fd:
                                continue
                            if ac.is_constrained(fd):
                                continue
                            for j in nz:
                                ac.add_entry(fd, int(M[j]), float(row[j]))

    ac.close()
    return ac


def _edge_dofs(dofs: DoFHandler, cell: int, axis: int, b1: int, b2: int):
    """Global dofs on the cell edge along `axis` at transverse corner
    (b1, b2) (transverse axes in increasing order), ordered along +axis."""
    p = dofs.degree
    d = dofs.mesh.dim
    n1 = p + 1
    t1, t2 = [a for a in range(3) if a != axis]
    idx = np.arange(n1**d)
    I = np.stack([(idx // n1**a) % n1 for a in range(d)], axis=-1)
    sel = (I[:, t1] == b1 * p) & (I[:, t2] == b2 * p)
    nodes = idx[sel]
    order = np.argsort(I[sel][:, axis], kind="stable")
    return dofs.cell_dofs[cell, nodes[order]]


def _native_hanging_constraints(dofs: DoFHandler, C_sub):
    """Hanging-node constraints via the C++ setup runtime (csrc/)
    (reference: deal.II's compiled DoFTools::make_hanging_node_constraints
    doing this work for the reference, SURVEY.md §3.1).  Emits the exact triplets of the Python
    path (parity-tested bit-for-bit); returns None when the library is
    unavailable so the Python path runs instead."""
    from tpufem_torch.utils.native import (
        available,
        coarse_face_neighbors,
        hanging_edge_constraints,
        hanging_face_constraints,
    )

    if not available():
        return None
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    n1 = p + 1
    nf = n1 ** (d - 1)

    face_nbr = coarse_face_neighbors(mesh.origins, mesh.sizes, mesh.U)
    face_local = np.stack([
        [dofs.face_local_dofs(a, s) for s in (0, 1)] for a in range(d)
    ]).astype(np.int32)  # (d, 2, nf)
    if d == 2:
        Wt = np.stack([C_sub[0], C_sub[1]])  # cfg = transverse bit
    else:
        # cfg = bit_t1 + 2*bit_t2;  weights = kron(C[bit_t2], C[bit_t1])
        # (t1 fastest — the Python path's face ordering)
        Wt = np.stack([
            np.kron(C_sub[cfg // 2], C_sub[cfg % 2]) for cfg in range(4)
        ])
    marks = np.zeros(dofs.n_dofs, dtype=np.uint8)
    res = hanging_face_constraints(
        mesh.origins, mesh.sizes, dofs.cell_dofs, face_nbr,
        face_local, face_local, Wt, marks,
    )
    if res is None:
        return None
    ac = AffineConstraints(dofs.n_dofs)
    f_dof, f_mast, f_w = res
    for i in range(len(f_dof)):
        ac.add_entry(int(f_dof[i]), int(f_mast[i]), float(f_w[i]))

    if d == 3:
        idx = np.arange(n1**3)
        I = np.stack([(idx // n1**a) % n1 for a in range(3)], axis=-1)
        edge_local = np.zeros((3, 2, 2, n1), dtype=np.int32)
        for axis in range(3):
            t1, t2 = [a for a in range(3) if a != axis]
            for b1 in (0, 1):
                for b2 in (0, 1):
                    sel = (I[:, t1] == b1 * p) & (I[:, t2] == b2 * p)
                    nodes = idx[sel]
                    order = np.argsort(I[sel][:, axis], kind="stable")
                    edge_local[axis, b1, b2] = nodes[order]
        Wsub = np.stack([C_sub[0], C_sub[1]])
        res_e = hanging_edge_constraints(
            mesh.origins, mesh.sizes, mesh.U, dofs.cell_dofs,
            edge_local, Wsub, marks,
        )
        if res_e is None:
            return None
        e_dof, e_mast, e_w = res_e
        for i in range(len(e_dof)):
            ac.add_entry(int(e_dof[i]), int(e_mast[i]), float(e_w[i]))

    ac.close()
    return ac

"""Kelly-type a-posteriori error estimator for adaptive refinement.

The port's copy of ``tpufem/fem/estimator.py`` (only the imports differ).
The deal.II ``KellyErrorEstimator`` analogue: per-cell indicator

    eta_K^2 = sum_{faces f of K, interior}  h_f / (4 p)  *
              int_f [ du_h/dn ]^2 ds

([.] = jump across the face; the 1/2 per-side split makes the sum over
both adjacent cells carry each face once with weight h_f/(2p)).  The
reference repo itself refines by a fixed geometric criterion
(SURVEY.md §3.1 "adaptive variant"); this module adds the standard
solve -> estimate -> mark -> refine loop a deal.II user expects
(step-6), driving ``Mesh.refine`` with solution-derived flags.

Everything runs host-side in f64 numpy (marking is setup work, not the
device hot path).  Works on the 2:1 forest meshes including hanging
nodes (pass the constraint-DISTRIBUTED solution so values are
continuous) and on curved meshes with an analytic ``transform_jac``
(physical normals/areas from the map's Jacobian).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import _pack_coords
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.fem.shapes import (
    lagrange_derivatives,
    lagrange_values,
    support_points_1d,
)


def _eval_dedup(fn, nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Evaluate fn(nodes, x) rows at the unique values of x only.

    Face quad points take a handful of distinct per-axis reference
    coordinates (0, 1, the Gauss points, and their 2:1 subface images),
    so this turns an O(npts) Python loop inside ``fn`` into O(#unique).
    """
    uv, inv = np.unique(np.round(x, 12), return_inverse=True)
    return fn(nodes, uv)[inv]


def _eval_phys_gradient(dofs: DoFHandler, u: np.ndarray, cells: np.ndarray,
                        ref: np.ndarray) -> np.ndarray:
    """Physical gradient of u_h at scattered points.

    cells: (npts,) cell index per point; ref: (npts, d) reference
    coordinates in [0,1]^d within that cell.  Returns (npts, d).
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    n1 = p + 1
    nodes = support_points_1d(p)
    nn = n1**d
    I = np.stack([(np.arange(nn) // n1**a) % n1 for a in range(d)],
                 axis=-1)  # (nn, d) local node multi-index
    V = [_eval_dedup(lagrange_values, nodes, ref[:, a])
         for a in range(d)]  # (npts, n1)
    D = [_eval_dedup(lagrange_derivatives, nodes, ref[:, a])
         for a in range(d)]
    u_loc = u[dofs.cell_dofs[cells]]  # (npts, nn)
    # d/d(ref) -> d/d(logical): ref = (U x_log - o)/s
    scale = mesh.U / mesh.sizes[cells].astype(np.float64)  # (npts,)
    g_log = np.empty((len(cells), d))
    for b in range(d):
        B = np.ones((len(cells), nn))
        for a in range(d):
            M = D[a] if a == b else V[a]
            B *= M[:, I[:, a]]
        g_log[:, b] = np.einsum("qj,qj->q", u_loc, B) * scale
    if mesh.transform_jac is None:
        return g_log
    # x_log of the points, J = d x_phys / d x_log; g_phys = J^-T g_log
    o = mesh.origins[cells]
    s = mesh.sizes[cells, None]
    x_log = (o + s * ref) / mesh.U
    J = mesh.transform_jac(x_log)  # (npts, d, d)
    return np.linalg.solve(np.swapaxes(J, 1, 2), g_log[..., None])[..., 0]


def _locate_cells(mesh, pts_unit: np.ndarray) -> np.ndarray:
    """Containing cell index for each point (unit integer coords).

    Vectorized: per size class, pack candidate origins into int64 keys
    and binary-search the (sorted) keys of that class's cells.  Smallest
    size first, so points at 2:1 interfaces resolve to the fine cell.
    """
    fl = np.floor(pts_unit).astype(np.int64)
    out = np.full(len(pts_unit), -1, dtype=np.int64)
    base = int(mesh.U) + 1
    for s in np.unique(mesh.sizes):
        todo = np.flatnonzero(out < 0)
        if len(todo) == 0:
            break
        sel = np.flatnonzero(mesh.sizes == s)
        keys = _pack_coords(mesh.origins[sel], base)
        order = np.argsort(keys)
        keys_sorted = keys[order]
        cand = _pack_coords((fl[todo] // s) * s, base)
        pos = np.minimum(np.searchsorted(keys_sorted, cand),
                         len(keys_sorted) - 1)
        hit = keys_sorted[pos] == cand
        out[todo[hit]] = sel[order[pos[hit]]]
    if np.any(out < 0):
        raise ValueError("point-location failed (outside the domain?)")
    return out


def kelly_estimate(dofs: DoFHandler, u: np.ndarray) -> np.ndarray:
    """Per-cell Kelly indicators eta_K (NOT squared), shape (n_cells,).

    u: the constraint-distributed solution vector (n_dofs,).
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    U = mesh.U
    quad = Quadrature.gauss(p + 1)
    xq, wq = quad.points_1d, quad.weights_1d  # (q1,)
    q1 = len(xq)
    nqf = q1 ** (d - 1)
    # tensor face-quad grid over the d-1 tangential axes
    qi = np.arange(nqf)
    QI = np.stack([(qi // q1**a) % q1 for a in range(d - 1)], axis=-1)
    w_face = np.prod(wq[QI], axis=-1)  # (nqf,)

    eta2 = np.zeros(mesh.n_cells)
    eps = 1e-6
    for axis in range(d):
        tang = [a for a in range(d) if a != axis]
        for side in (0, 1):
            o = mesh.origins.astype(np.float64)
            s = mesh.sizes.astype(np.float64)
            plane = o[:, axis] + side * s  # (nc,)
            interior = (plane > 0) & (plane < U)
            cells = np.flatnonzero(interior)
            if len(cells) == 0:
                continue
            nc = len(cells)
            # face quad points in unit integer coords: (nc, nqf, d)
            pts = np.empty((nc, nqf, d))
            pts[:, :, axis] = plane[cells, None]
            for k, a in enumerate(tang):
                pts[:, :, a] = (o[cells, a, None]
                                + s[cells, None] * xq[QI[:, k]][None, :])
            own = np.repeat(cells, nqf)
            flat = pts.reshape(-1, d)
            # reference coords within the own cell
            ref_own = (flat - o[own]) / s[own, None]
            # neighbor: nudge across the face (sign of the outward normal)
            sign = 1.0 if side == 1 else -1.0
            probe = flat.copy()
            probe[:, axis] += sign * eps * s[own]
            nb = _locate_cells(mesh, probe)
            ref_nb = (flat - o[nb]) / s[nb, None]
            np.clip(ref_nb, 0.0, 1.0, out=ref_nb)

            g_own = _eval_phys_gradient(dofs, u, own, ref_own)
            g_nb = _eval_phys_gradient(dofs, u, nb, ref_nb)

            # physical normal and area element
            if mesh.transform_jac is None:
                jump = (g_own[:, axis] - g_nb[:, axis]) ** 2
                h_t = s[own] / U  # uniform-box tangential extents
                ds = h_t ** (d - 1)  # per unit quad weight
                h_f = s[own] / U
            else:
                J = mesh.transform_jac(flat / U)  # (np, d, d)
                n_log = np.zeros((len(flat), d))
                n_log[:, axis] = sign
                n_phys = np.linalg.solve(np.swapaxes(J, 1, 2),
                                         n_log[..., None])[..., 0]
                n_phys /= np.linalg.norm(n_phys, axis=1, keepdims=True)
                jump = np.einsum("qa,qa->q", g_own - g_nb, n_phys) ** 2
                # area element: tangent columns of J scaled by h_t
                h_t = (s[own] / U)
                if d == 2:
                    t0 = J[:, :, tang[0]] * h_t[:, None]
                    ds = np.linalg.norm(t0, axis=1)
                else:
                    t0 = J[:, :, tang[0]] * h_t[:, None]
                    t1 = J[:, :, tang[1]] * h_t[:, None]
                    ds = np.linalg.norm(np.cross(t0, t1), axis=1)
                h_f = ds ** (1.0 / (d - 1))
            w = np.tile(w_face, nc)
            contrib = (h_f / (4.0 * p)) * jump * ds * w
            np.add.at(eta2, own, contrib)
    return np.sqrt(eta2)


def mark_fixed_fraction(eta: np.ndarray, fraction: float = 0.3
                        ) -> np.ndarray:
    """Refine flags for the cells carrying the top ``fraction`` of the
    count, ordered by indicator (GridRefinement::refine_and_coarsen_
    fixed_number analogue, refinement only)."""
    n = max(1, int(np.ceil(fraction * len(eta))))
    thresh = np.partition(eta, -n)[-n]
    return eta >= max(thresh, 1e-300)


def mark_refine_and_coarsen(eta: np.ndarray, refine_fraction: float = 0.3,
                            coarsen_fraction: float = 0.0
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(refine_flags, coarsen_flags): top ``refine_fraction`` of cells by
    indicator refined, bottom ``coarsen_fraction`` coarsened — the full
    GridRefinement::refine_and_coarsen_fixed_number analogue.  Coarsen
    flags are wishes: Mesh.coarsen merges only complete sibling groups."""
    refine = mark_fixed_fraction(eta, refine_fraction)
    coarsen = np.zeros(len(eta), dtype=bool)
    if coarsen_fraction > 0.0:
        n = int(coarsen_fraction * len(eta))
        if n > 0:
            thresh = np.partition(eta, n - 1)[n - 1]
            coarsen = (eta <= thresh) & ~refine
    return refine, coarsen

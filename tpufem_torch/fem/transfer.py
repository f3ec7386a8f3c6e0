"""Solution transfer between meshes of the same forest.

The port's copy of ``tpufem/fem/transfer.py`` (only the imports differ).

The deal.II ``SolutionTransfer`` analogue (step-26 workflow): after
``Mesh.refine`` / ``Mesh.coarsen``, interpolate a solution vector from
the old DoFHandler onto the new one.  Exact (to roundoff) wherever the
new space contains the old one — i.e. on every cell that was kept or
refined; on coarsened cells it is the pointwise interpolant at the new
support points (deal.II's behavior as well).

Works in LOGICAL coordinates, so the transfer is independent of any
curved ``transform`` — the FE fields live on the logical forest.

Everything is host-side f64 numpy: mesh adaptation is setup work
between device solves, not the hot path.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.estimator import _eval_dedup, _locate_cells
from tpufem_torch.fem.shapes import lagrange_values, support_points_1d


def _dof_logical_coords(dofs: DoFHandler) -> np.ndarray:
    """(n_dofs, dim) support-point coordinates in the logical unit cube,
    from one representative (cell, node) copy per DoF."""
    mesh, p, d = dofs.mesh, dofs.degree, dofs.mesh.dim
    n1 = p + 1
    node_idx = np.arange(n1**d)
    I = np.stack([(node_idx // n1**a) % n1 for a in range(d)], axis=-1)
    gll = support_points_1d(p)
    rep_cell, rep_node = _rep_copies(dofs)
    frac = gll[I[rep_node]]  # (n_dofs, d)
    o = mesh.origins[rep_cell]
    s = mesh.sizes[rep_cell, None]
    return (o + s * frac) / mesh.U


def _rep_copies(dofs: DoFHandler):
    """One (cell, local node) copy per DoF.

    The adaptive build caches representatives; the uniform build does
    not — recover them from cell_dofs with a first-hit scan.
    """
    if getattr(dofs, "_rep_cell", None) is not None:
        return dofs._rep_cell, dofs._rep_node
    cd = dofs.cell_dofs  # (nc, nn)
    nn = cd.shape[1]
    flat = cd.ravel()
    first = np.full(dofs.n_dofs, -1, dtype=np.int64)
    # reversed so the FIRST copy wins
    first[flat[::-1]] = np.arange(flat.size - 1, -1, -1)
    return (first // nn).astype(np.int32), (first % nn).astype(np.int32)


def interpolate_solution(old_dofs: DoFHandler, u: np.ndarray,
                         new_dofs: DoFHandler) -> np.ndarray:
    """Interpolate ``u`` (on old_dofs, constraint-distributed so it is a
    continuous field) onto new_dofs' support points.

    Returns the new vector; apply the new mesh's hanging-node
    ``constraints.distribute`` afterwards if the new mesh has any (the
    interpolant already satisfies them to roundoff on refined regions,
    but coarsened regions need the projection).
    """
    old_mesh, new_mesh = old_dofs.mesh, new_dofs.mesh
    if old_mesh.dim != new_mesh.dim or old_dofs.degree != new_dofs.degree:
        raise ValueError("transfer requires matching dim and degree")
    d = old_mesh.dim
    p = old_dofs.degree
    pts = _dof_logical_coords(new_dofs) * old_mesh.U  # old unit coords
    # locate with a clipped copy (points exactly at the domain max would
    # floor out of the last cell); evaluate at the EXACT coordinates
    cells = _locate_cells(
        old_mesh, np.clip(pts, 0.0, old_mesh.U * (1.0 - 1e-12)))
    o = old_mesh.origins[cells]
    s = old_mesh.sizes[cells].astype(np.float64)
    ref = (pts - o) / s[:, None]
    np.clip(ref, 0.0, 1.0, out=ref)
    nodes = support_points_1d(p)
    n1 = p + 1
    nn = n1**d
    I = np.stack([(np.arange(nn) // n1**a) % n1 for a in range(d)], axis=-1)
    V = [_eval_dedup(lagrange_values, nodes, ref[:, a]) for a in range(d)]
    B = np.ones((len(cells), nn))
    for a in range(d):
        B *= V[a][:, I[:, a]]
    u_loc = np.asarray(u, dtype=np.float64)[old_dofs.cell_dofs[cells]]
    return np.einsum("qj,qj->q", u_loc, B)

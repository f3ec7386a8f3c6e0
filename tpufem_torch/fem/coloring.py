"""Graph coloring of cells so no two same-color cells share a DoF.

The port's copy of ``tpufem/fem/coloring.py`` (only the imports differ).
Reference analogue: ``coloring.h`` wrapping deal.II
``GraphColoring::make_graph_coloring`` with conflict indicator = the cell's
DoF set; cells within a color share no DoFs, making the scatter in
``distribute_local_to_global`` race-free without atomics (SURVEY.md §2
"Graph coloring", §2 parallelism item 4).  On the card the same structure
makes each color's scatter an add into distinct indices: free of conflicts
within a launch, so the same from run to run.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.fem.mesh import Mesh


def color_cells(mesh: Mesh, cell_dofs: np.ndarray) -> list[np.ndarray]:
    """Partition cells into colors; returns list of cell-index arrays.

    Uniform structured meshes use the exact 2^dim parity coloring (cells
    sharing any DoF differ by <= 1 in each axis index).  General (adaptive)
    meshes use greedy first-fit over the DoF-conflict graph.
    """
    if mesh.is_uniform:
        s = int(mesh.sizes[0])
        idx = mesh.origins // s  # (nc, d) cell lattice index
        color = np.zeros(mesh.n_cells, dtype=np.int64)
        for a in range(mesh.dim):
            color |= (idx[:, a] % 2) << a
        return [np.nonzero(color == c)[0].astype(np.int32)
                for c in range(2**mesh.dim) if np.any(color == c)]

    from tpufem_torch.utils.native import greedy_color

    n_dofs = int(cell_dofs.max()) + 1
    colors = greedy_color(cell_dofs, n_dofs)  # C++ with numpy fallback
    ncol = int(colors.max()) + 1
    return [np.nonzero(colors == c)[0].astype(np.int32) for c in range(ncol)]


def verify_coloring(colors: list[np.ndarray], cell_dofs: np.ndarray) -> None:
    """Assert no two same-color cells share a DoF (the race-detection test
    the reference lacks — SURVEY.md §5 'Race detection')."""
    for cells in colors:
        d = cell_dofs[cells].ravel()
        if len(np.unique(d)) != len(d):
            raise AssertionError("coloring invalid: shared DoF within a color")

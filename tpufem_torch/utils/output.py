"""Solution output (VTU) and checkpoint/resume.

Reference analogue: ``DataOut`` VTK/VTU visualization output in poisson.cu
(SURVEY.md §5 "Checkpoint / resume" row: solutions optionally written as
VTK/VTU).  Checkpointing itself is absent in the reference (research
code); here long solves can save/restore solution + CG state as .npz.
"""

from __future__ import annotations

import base64
import struct

import numpy as np

from tpufem_torch.fem.dof_handler import DoFHandler


def write_vtu(path: str, dofs: DoFHandler, fields: dict[str, np.ndarray]):
    """Write the mesh (as linear quads/hexes on the Q_p node lattice) and
    nodal fields to a VTK XML unstructured grid file.

    Each Q_p cell is subdivided into p^dim linear sub-cells through its
    node lattice, so high-order solutions render faithfully.
    """
    mesh, p = dofs.mesh, dofs.degree
    d = mesh.dim
    n1 = p + 1
    points = np.zeros((dofs.n_dofs, 3))
    points[:, :d] = dofs.dof_coords

    # sub-cell connectivity through each cell's lattice
    conn = []

    # lattice index helper: local node given as (ix, iy[, iz]) ->
    # lexicographic id (x fastest)
    def lid(*idx):
        out = 0
        for a, i in enumerate(idx):
            out += i * n1**a
        return out

    for c in range(mesh.n_cells):
        cd = dofs.cell_dofs[c]
        if d == 2:
            for j in range(p):
                for i in range(p):
                    quad = [lid(i, j), lid(i + 1, j),
                            lid(i + 1, j + 1), lid(i, j + 1)]
                    conn.append(cd[quad])
        else:
            for k in range(p):
                for j in range(p):
                    for i in range(p):
                        hexa = [
                            lid(i, j, k), lid(i + 1, j, k),
                            lid(i + 1, j + 1, k), lid(i, j + 1, k),
                            lid(i, j, k + 1), lid(i + 1, j, k + 1),
                            lid(i + 1, j + 1, k + 1), lid(i, j + 1, k + 1),
                        ]
                        conn.append(cd[hexa])
    conn = np.asarray(conn, dtype=np.int64)
    n_cells = len(conn)
    nverts = conn.shape[1]
    cell_type = 9 if d == 2 else 12  # VTK_QUAD / VTK_HEXAHEDRON

    def da(name, arr, ncomp=1, dtype="Float64"):
        vals = np.asarray(arr).ravel()
        if dtype in ("Int64", "UInt8"):
            text = " ".join(str(int(v)) for v in vals)
        else:
            text = " ".join(f"{float(v):.16g}" for v in vals)
        return (
            f'<DataArray type="{dtype}" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">{text}</DataArray>'
        )

    pieces = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{dofs.n_dofs}" NumberOfCells="{n_cells}">',
        "<Points>", da("Points", points, 3), "</Points>",
        "<Cells>",
        da("connectivity", conn, dtype="Int64"),
        da("offsets", np.arange(1, n_cells + 1) * nverts, dtype="Int64"),
        da("types", np.full(n_cells, cell_type), dtype="UInt8"),
        "</Cells>",
        "<PointData>",
    ]
    for name, arr in fields.items():
        pieces.append(da(name, np.asarray(arr, dtype=np.float64)))
    pieces += ["</PointData>", "</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as f:
        f.write("\n".join(pieces))


def save_checkpoint(path: str, **arrays):
    """Save solution/solver state (npz)."""
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_checkpoint(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}

"""Slab-decomposition partitioner for uniform tensor grids.

Port of ``tpufem/parallel/partitioner.py``, the counterpart of the
reference's ``GpuPartitioner`` + ``MultiGpuVector`` (SURVEY.md §2, §3.6):
the mesh is cut into slabs of cells along the slowest grid axis (z); each
shard stores the node planes of its own cells including both interface
planes, so the one shared interface plane is duplicated on the two
neighbouring shards and the invariant between operations is that the
copies hold identical values.

- ``update_ghost_values``: free — duplicates are maintained by compress.
- ``compress_add``: each shard's first/last plane holds a partial sum
  after a cell loop; one exchange in each direction adds the neighbour's
  partial plane, so both copies hold the full sum.
- dots: each shard reduces its owned planes (all but the last, except on
  the last shard) and ``psum``s in fixed shard order.

The distributed vector is a ``Sharded`` value of (local_npts_z, npts, ...)
blocks; the collectives take the ``ShardMesh`` they run on
(``device_mesh()``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.parallel.mesh import Sharded, ShardMesh


def _neighbour_plane(mesh: ShardMesh, plane: Sharded, axis: str, ns: int,
                     delta: int, use_ppermute) -> Sharded:
    """The plane of the shard at (my axis index + delta) along ``axis``,
    zeros at the ends: a single-neighbour ``ppermute`` (the default), or
    with ``use_ppermute=False`` an all_gather of every plane and a select
    (identical values; the JAX package keeps it for comparison)."""
    want = True if use_ppermute is None else use_ppermute
    if want:
        if delta == 1:
            perm = [(k, k - 1) for k in range(1, ns)]
        else:
            perm = [(k, k + 1) for k in range(ns - 1)]
        return mesh.ppermute(plane, axis, perm)
    g = mesh.all_gather(plane, axis)  # (ns, ...)
    out = []
    for s, idx in enumerate(mesh.axis_index(axis)):
        src = idx + delta
        ok = 0 <= src < ns
        out.append(g.parts[s][min(max(src, 0), ns - 1)] if ok
                   else torch.zeros_like(plane.parts[s]))
    return Sharded(out)


def _add_planes(y: Sharded, from_next: Sharded, from_prev: Sharded,
                dim0: int) -> Sharded:
    """y with ``from_next`` added to its last plane along ``dim0`` and
    ``from_prev`` to its first (new tensors)."""
    out = []
    for t, fn, fp in zip(y.parts, from_next.parts, from_prev.parts):
        t, fn, fp = (torch.movedim(a, dim0, 0) for a in (t, fn, fp))
        n = t.shape[0]
        t = torch.cat([t[:1] + fp, t[1 : n - 1], t[n - 1 :] + fn])
        out.append(torch.movedim(t, 0, dim0))
    return Sharded(out)


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """Static description of the slab decomposition."""

    dim: int
    n: int  # cells per axis (global)
    p: int  # polynomial degree
    n_shards: int
    axis_name: str = "shard"
    # ghost-exchange primitive: None or True = single-neighbour
    # ppermute, False = the all_gather + select rig
    use_ppermute: bool | None = None

    def __post_init__(self):
        if self.n % self.n_shards != 0:
            raise ValueError(
                f"cells per axis ({self.n}) must be divisible by the shard "
                f"count ({self.n_shards})"
            )

    @property
    def npts(self) -> int:
        return self.n * self.p + 1

    @property
    def local_cells_z(self) -> int:
        return self.n // self.n_shards

    @property
    def local_npts_z(self) -> int:
        """Node planes per shard, including both interface planes."""
        return self.local_cells_z * self.p + 1

    @property
    def local_shape(self) -> tuple[int, ...]:
        return (self.local_npts_z,) + (self.npts,) * (self.dim - 1)

    @property
    def global_shape(self) -> tuple[int, ...]:
        return (self.n_shards,) + self.local_shape

    # ------------------------------------------------------------------
    def device_mesh(self, devices=None,
                    device: torch.device | str = "cuda") -> ShardMesh:
        return ShardMesh((self.n_shards,), (self.axis_name,),
                         devices=devices, device=device)

    # ------------------------------------------------------------------
    def to_local(self, u_global: np.ndarray) -> np.ndarray:
        """(npts**dim,) -> (n_shards, local_npts_z, npts, ...) with the
        interface planes duplicated (ghost import)."""
        g = np.asarray(u_global).reshape((self.npts,) * self.dim)
        lz = self.local_npts_z
        out = np.empty(self.global_shape, dtype=g.dtype)
        for k in range(self.n_shards):
            z0 = k * self.local_cells_z * self.p
            out[k] = g[z0 : z0 + lz]
        return out

    def to_global(self, u_local) -> np.ndarray:
        """Inverse of to_local (uses the owner copy of each plane); takes
        the stacked host array or a ``Sharded`` value."""
        if isinstance(u_local, Sharded):
            u_local = ShardMesh.stack(u_local)
        u_local = np.asarray(u_local)
        g = np.empty((self.npts,) + (self.npts,) * (self.dim - 1),
                     dtype=u_local.dtype)
        for k in range(self.n_shards):
            z0 = k * self.local_cells_z * self.p
            g[z0 : z0 + self.local_npts_z] = u_local[k]
        return g.reshape(-1)

    # ------------------------------------------------------------------
    # collectives on the shard mesh
    def _plane_from(self, mesh: ShardMesh, plane: Sharded, delta: int):
        """The neighbour plane from shard (my_index + delta), zeros at the
        ends."""
        return _neighbour_plane(mesh, plane, self.axis_name, self.n_shards,
                                delta, self.use_ppermute)

    def compress_add(self, y_local: Sharded, mesh: ShardMesh) -> Sharded:
        """Sum duplicated interface planes across neighbours: each block's
        first/last plane holds a partial sum; the result has the full sums
        on both interface planes (SURVEY.md §3.6 compress(add))."""
        if self.n_shards == 1:
            return y_local
        # my last plane needs the first plane of shard (idx+1);
        # my first plane needs the last plane of shard (idx-1)
        from_next = self._plane_from(
            mesh, Sharded(t[:1] for t in y_local.parts), +1)
        from_prev = self._plane_from(
            mesh, Sharded(t[-1:] for t in y_local.parts), -1)
        return _add_planes(y_local, from_next, from_prev, 0)

    def dot(self, a_local: Sharded, b_local: Sharded,
            mesh: ShardMesh) -> Sharded:
        """Deterministic global dot: owned planes (drop the duplicated last
        plane except on the last shard), then psum."""
        local = []
        for s, (a, b) in enumerate(zip(a_local.parts, b_local.parts)):
            full = torch.sum(a * b)
            dup = torch.sum(a[-1] * b[-1])
            is_last = mesh.axis_index(self.axis_name)[s] == self.n_shards - 1
            local.append(full - (torch.zeros_like(dup) if is_last else dup))
        return mesh.psum(Sharded(local), self.axis_name)


@dataclasses.dataclass(frozen=True)
class Partitioner2D:
    """Two-axis slab decomposition: z sharded over axis 'sz', y over 'sy'.

    Ghost semantics per axis are Partitioner's; ``compress_add`` applies
    the z exchange THEN the y exchange: after the z pass the y-interface
    rows already contain full z-sums, so the sequential composition also
    resolves the four corner lines exactly."""

    dim: int
    n: int
    p: int
    shards_z: int
    shards_y: int
    axis_z: str = "sz"
    axis_y: str = "sy"
    use_ppermute: bool | None = None  # see Partitioner.use_ppermute

    def __post_init__(self):
        if self.n % self.shards_z or self.n % self.shards_y:
            raise ValueError("cells per axis must divide both shard counts")
        if self.dim < 2:
            raise ValueError("Partitioner2D needs dim >= 2")

    @property
    def npts(self) -> int:
        return self.n * self.p + 1

    @property
    def local_shape(self) -> tuple[int, ...]:
        lz = (self.n // self.shards_z) * self.p + 1
        ly = (self.n // self.shards_y) * self.p + 1
        return (lz, ly) + (self.npts,) * (self.dim - 2)

    @property
    def local_cells(self) -> tuple[int, ...]:
        return (self.n // self.shards_z, self.n // self.shards_y) + (
            (self.n,) * (self.dim - 2)
        )

    def device_mesh(self, devices=None,
                    device: torch.device | str = "cuda") -> ShardMesh:
        return ShardMesh((self.shards_z, self.shards_y),
                         (self.axis_z, self.axis_y), devices=devices,
                         device=device)

    # ------------------------------------------------------------------
    def to_local(self, u_global: np.ndarray) -> np.ndarray:
        """(npts**dim,) -> (sz, sy, lz, ly, ...) ghosted local blocks."""
        g = np.asarray(u_global).reshape((self.npts,) * self.dim)
        lz, ly = self.local_shape[:2]
        cz = (self.n // self.shards_z) * self.p
        cy = (self.n // self.shards_y) * self.p
        out = np.empty(
            (self.shards_z, self.shards_y) + self.local_shape, dtype=g.dtype
        )
        for i in range(self.shards_z):
            for j in range(self.shards_y):
                out[i, j] = g[i * cz : i * cz + lz, j * cy : j * cy + ly]
        return out

    def to_global(self, u_local) -> np.ndarray:
        """Inverse of to_local; takes the (sz, sy, ...) host array or a
        ``Sharded`` value (row-major shards)."""
        if isinstance(u_local, Sharded):
            u_local = ShardMesh.stack(u_local).reshape(
                (self.shards_z, self.shards_y) + self.local_shape)
        u_local = np.asarray(u_local)
        g = np.empty((self.npts,) * self.dim, dtype=u_local.dtype)
        lz, ly = self.local_shape[:2]
        cz = (self.n // self.shards_z) * self.p
        cy = (self.n // self.shards_y) * self.p
        for i in range(self.shards_z):
            for j in range(self.shards_y):
                g[i * cz : i * cz + lz, j * cy : j * cy + ly] = u_local[i, j]
        return g.reshape(-1)

    # ------------------------------------------------------------------
    def _exchange(self, mesh: ShardMesh, y_local: Sharded, axis_name: str,
                  n_shards: int, dim0: int) -> Sharded:
        """Add the neighbour's partial interface plane along tensor dim0."""
        if n_shards == 1:
            return y_local
        first = _neighbour_plane(
            mesh, Sharded(t.narrow(dim0, 0, 1) for t in y_local.parts),
            axis_name, n_shards, +1, self.use_ppermute)
        last = _neighbour_plane(
            mesh, Sharded(t.narrow(dim0, t.shape[dim0] - 1, 1)
                          for t in y_local.parts),
            axis_name, n_shards, -1, self.use_ppermute)
        return _add_planes(y_local, first, last, dim0)

    def compress_add(self, y_local: Sharded, mesh: ShardMesh) -> Sharded:
        y_local = self._exchange(mesh, y_local, self.axis_z, self.shards_z,
                                 0)
        return self._exchange(mesh, y_local, self.axis_y, self.shards_y, 1)

    def dot(self, a_local: Sharded, b_local: Sharded,
            mesh: ShardMesh) -> Sharded:
        """Owned-region dot: drop the duplicated last plane along each
        sharded axis (except on that axis's last shard), then psum over
        both mesh axes (z, then y)."""
        iz = mesh.axis_index(self.axis_z)
        iy = mesh.axis_index(self.axis_y)
        local = []
        for s, (a, b) in enumerate(zip(a_local.parts, b_local.parts)):
            prod = a * b
            full = torch.sum(prod)
            dup_z = torch.sum(prod[-1])
            dup_y = torch.sum(prod[:, -1])
            dup_zy = torch.sum(prod[-1, -1])  # subtracted twice: add back
            last_z = iz[s] == self.shards_z - 1
            last_y = iy[s] == self.shards_y - 1
            zero = torch.zeros_like(full)
            local.append(full - (zero if last_z else dup_z)
                         - (zero if last_y else dup_y)
                         + (zero if (last_z or last_y) else dup_zy))
        return mesh.psum(mesh.psum(Sharded(local), self.axis_z),
                         self.axis_y)

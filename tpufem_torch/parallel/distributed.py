"""Distributed operator apply and CG on a slab-decomposed shard mesh.

Port of ``tpufem/parallel/distributed.py``, the reference's multi-GPU
vmult path (SURVEY.md §3.6): ``src.update_ghost_values()`` -> per-device
cell loop -> ``dst.compress(add)`` -> per-device dots + a sum.  Each
shard runs the structured tier's cell loop (``ops.structured.
laplace_apply_structured``) on its ghosted slab, one plane exchange in
each direction completes the interface sums, and the dots are per-shard
owned-plane reductions summed by ``psum``.  The JAX package runs the
whole CG as one ``shard_map`` program; here the CG is the port's own
``cg_solve`` on ``Sharded`` vectors.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpufem_torch.ops.structured import laplace_apply_structured
from tpufem_torch.parallel.mesh import Sharded, ShardMesh, smap
from tpufem_torch.parallel.partitioner import Partitioner, Partitioner2D
from tpufem_torch.solvers.cg import cg_solve


def _per_shard(mesh: ShardMesh, v) -> Sharded:
    """A tensor replicated on every shard, or a Sharded value as it is."""
    return v if isinstance(v, Sharded) else mesh.replicate(v)


def _local_apply(part, mesh, S, D_col, scale, w_block, ns_local) -> Callable:
    """Per-shard raw vmult on the local slab plus the interface
    compress."""
    S, D_col = mesh.replicate(S), mesh.replicate(D_col)
    scale, w = mesh.replicate(scale), _per_shard(mesh, w_block)

    def vmult_local(x: Sharded) -> Sharded:
        y = smap(lambda xb, S_, D_, sc, wb: laplace_apply_structured(
            xb, part.dim, ns_local, part.p, S_, D_, sc, wb).reshape(
                part.local_shape), x, S, D_col, scale, w)
        return part.compress_add(y, mesh)

    return vmult_local


def make_local_laplace(part: Partitioner, S, D_col, scale, w_block,
                       mesh: ShardMesh) -> Callable:
    """Sharded raw vmult on the local slabs (+ interface compress): maps
    ghosted (local_npts_z, npts, ...) blocks to the same shape with full
    sums on every plane.  ``w_block``: one weight block for every shard,
    or a Sharded one (a variable coefficient's z-cells)."""
    ns_local = (part.local_cells_z,) + (part.n,) * (part.dim - 1)
    return _local_apply(part, mesh, S, D_col, scale, w_block, ns_local)


def make_local_laplace_2d(part: Partitioner2D, S, D_col, scale, w_block,
                          mesh: ShardMesh) -> Callable:
    """Sharded raw vmult on a 2-axis (z, y) slab decomposition: local
    structured apply + sequential z/y interface compress."""
    return _local_apply(part, mesh, S, D_col, scale, w_block,
                        part.local_cells)


def make_constrained(vmult_local: Callable, mask_blk: Sharded) -> Callable:
    """Wrap a raw local vmult with constrained-DoF identity semantics
    (the mask algebra of ``operators.laplace``)."""

    def vmult(x_blk: Sharded) -> Sharded:
        y = vmult_local(mask_blk * x_blk)
        return mask_blk * y + (1.0 - mask_blk) * x_blk

    return vmult


def _jacobi_cg(part, mesh, A, put, diag, b, x0, rtol, maxiter):
    """Jacobi-CG on the shards from global host vectors; (x_global,
    iterations, residual)."""
    b_l, diag_l = put(b), put(diag)
    x0_l = put(x0) if x0 is not None else torch.zeros_like(b_l)
    inv_diag = 1.0 / diag_l
    res = cg_solve(A, b_l, M_inv=lambda r: inv_diag * r, x0=x0_l,
                   rtol=rtol, maxiter=maxiter,
                   dot=lambda u, v: part.dot(u, v, mesh))
    return part.to_global(res.x), int(res.iterations), float(res.residual)


def distributed_cg_solve(
    part: Partitioner,
    S,
    D_col,
    scale,
    w_block,
    mask: np.ndarray,
    diag: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    rtol: float = 1e-10,
    maxiter: int = 10000,
    device_mesh: ShardMesh | None = None,
):
    """Distributed Jacobi-CG: shards the problem over the partitioner's
    mesh (on S's device type unless ``device_mesh`` is given), runs the
    CG on the shards, returns (x_global, iterations, residual).

    mask/diag/b/x0 are global (npts**dim,) host arrays; the solve's dtype
    follows S's."""
    mesh = (device_mesh if device_mesh is not None
            else part.device_mesh(device=S.device))
    put = lambda g: mesh.put(part.to_local(np.asarray(g, np.float64)),
                             dtype=S.dtype)
    # variable-coefficient weight blocks carry a real z-cell dim: shard it
    # along the slab axis like every other field (SURVEY.md §3.6)
    w = w_block
    if w.shape[0] > 1:
        cz = part.local_cells_z
        w = Sharded(w[k * cz : (k + 1) * cz].to(mesh.devices[k])
                    for k in range(part.n_shards))
    A = make_constrained(make_local_laplace(part, S, D_col, scale, w, mesh),
                         put(mask))
    return _jacobi_cg(part, mesh, A, put, diag, b, x0, rtol, maxiter)


def distributed_cg_solve_2d(
    part: Partitioner2D,
    S,
    D_col,
    scale,
    w_block,
    mask: np.ndarray,
    diag: np.ndarray,
    b: np.ndarray,
    rtol: float = 1e-10,
    maxiter: int = 10000,
    device_mesh: ShardMesh | None = None,
):
    """Jacobi-CG over a two-axis (z, y) shard mesh (Partitioner2D)."""
    mesh = (device_mesh if device_mesh is not None
            else part.device_mesh(device=S.device))
    put = lambda g: mesh.put(part.to_local(np.asarray(g, np.float64))
                             .reshape((-1,) + part.local_shape),
                             dtype=S.dtype)
    A = make_constrained(
        make_local_laplace_2d(part, S, D_col, scale, w_block, mesh),
        put(mask))
    return _jacobi_cg(part, mesh, A, put, diag, b, None, rtol, maxiter)

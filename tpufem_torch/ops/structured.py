"""Gather-free cell loop on uniform tensor-product grids.

Port of ``tpufem/ops/structured.py``.  On a *uniform* hyper_cube grid the
cell->DoF map is affine, so

- ``read_dof_values`` = extracting overlapping (p+1)-point patches with
  stride p along each axis: views, slices and one concatenation per axis
  ("blocking"), no gather;
- ``distribute_local_to_global`` = the transposed overlap-add: one copy
  and one strided add per axis, no scatter.  No index repeats within an
  add, so the result is the same from run to run on the card.

Blocked layout after blocking all axes (3D): (nz, pz, ny, py, nx, px) —
spatial axis a (0 = x innermost) has its cell dim at 2*(dim-1-a) and its
local dim at 2*(dim-1-a)+1.  On the uniform grid the Cartesian metric is
constant across cells, so the quadrature-point scaling is a broadcast of
a (q1,)*dim weight block.

The global quadrature-grid form (``laplace_apply_global_general``) runs
each axis pass as one matmul with a banded (n q1, n p + 1) operator.  f32
runs true f32 (TF32 off, ``tpufem_torch.utils.precision``); the JAX
package runs these products at bf16x3 on its TPU's matrix unit.
"""

from __future__ import annotations

import numpy as np
import torch


def _block_axis(t: torch.Tensor, axis: int, n: int, p: int) -> torch.Tensor:
    """Split grid axis ``axis`` (length n*p+1) into overlapping cell
    patches (n, p+1) in place of it."""
    sh = t.shape
    main = t.narrow(axis, 0, n * p).reshape(sh[:axis] + (n, p)
                                            + sh[axis + 1:])
    idx = [slice(None)] * t.dim()
    idx[axis] = slice(p, None, p)
    last = t[tuple(idx)].unsqueeze(axis + 1)
    return torch.cat([main, last], dim=axis + 1)


def _unblock_axis_add(t: torch.Tensor, axis: int, n: int,
                      p: int) -> torch.Tensor:
    """Transpose of _block_axis: (..., n, p+1, ...) at (axis, axis+1) ->
    (..., n*p+1, ...) with overlap-add: each patch's first p points land
    at their place, its last point is added to the next patch's first."""
    sh = t.shape
    pre, post = sh[:axis], sh[axis + 2:]
    out = t.new_zeros(pre + (n * p + 1,) + post)
    out.narrow(axis, 0, n * p).copy_(
        t.narrow(axis + 1, 0, p).reshape(pre + (n * p,) + post))
    idx = [slice(None)] * out.dim()
    idx[axis] = slice(p, None, p)
    out[tuple(idx)] += t.select(axis + 1, p)
    return out


def block_all(u: torch.Tensor, dim: int, ns, p: int) -> torch.Tensor:
    """Grid vector/array -> blocked layout (nz,pz,ny,py,nx,px).

    ns: cells per grid axis in (z, y, x) order.  u may be flat
    (prod(npts)) or grid-shaped.
    """
    t = u.reshape(tuple(n * p + 1 for n in ns))
    # axis k's grid dim sits at position 2k after blocking axes 0..k-1
    for k in range(dim):
        t = _block_axis(t, 2 * k, ns[k], p)
    return t


def unblock_all_add(t: torch.Tensor, dim: int, ns, p: int) -> torch.Tensor:
    """Inverse (transpose) of block_all: blocked -> flat grid vector."""
    for k in reversed(range(dim)):
        t = _unblock_axis_add(t, 2 * k, ns[k], p)
    return t.reshape(-1)


def contract_local(t: torch.Tensor, M: torch.Tensor, a: int,
                   dim: int) -> torch.Tensor:
    """Contract blocked local dim of spatial axis a (0 = x) with M (q, m)."""
    pos = 2 * (dim - 1 - a) + 1
    out = torch.movedim(t, pos, -1) @ M.T
    return torch.movedim(out, -1, pos)


def sym_metric_components(inv_jac, jxw) -> np.ndarray:
    """Per-qpoint symmetric metric tensor, packed upper triangle.

    G = jxw * (J^-1 @ J^-T) collapses the two d x d rotations of the
    general-metric pointwise stage into ONE symmetric contraction:
      gb[b] = sum_c G[b,c] g[c]  ==  invJ (jxw invJ^T g).
    Returns (..., d*(d+1)/2) with components ordered (xx, xy[, xz], yy
    [, yz, zz]): 6 metric fields per qpoint in 3D instead of the 10 of
    J^-1 and JxW.  Computed in f64 on the host (numpy in, numpy out).
    """
    inv_jac = np.asarray(inv_jac, np.float64)
    jxw = np.asarray(jxw, np.float64)
    d = inv_jac.shape[-1]
    G = jxw[..., None, None] * np.einsum(
        "...ba,...ca->...bc", inv_jac, inv_jac)
    comps = [G[..., b, c] for b in range(d) for c in range(b, d)]
    return np.stack(comps, axis=-1)


def _sym_index(d: int) -> dict:
    """(b, c) -> packed index map for the upper-triangle layout."""
    idx = {}
    k = 0
    for b in range(d):
        for c in range(b, d):
            idx[(b, c)] = idx[(c, b)] = k
            k += 1
    return idx


def global_interp_matrices(p: int, n: int, S, D_col):
    """Global nodal-grid -> quadrature-grid operators for one axis (f64
    numpy).

    E (n*q1, n*p+1): value interpolation — rows of cell c are S placed at
    columns c*p (the assembled tensor-product factor of read_dof_values +
    evaluate).  Gd: the direct nodal -> d/dx-at-qpoints map, D_col @ S.
    Banded (bandwidth p+1), rows periodic with period q1, used as dense
    matmul operands.
    """
    S = np.asarray(S, np.float64)
    D = np.asarray(D_col, np.float64)
    q1 = S.shape[0]
    E = np.zeros((n * q1, n * p + 1))
    Gd = np.zeros((n * q1, n * p + 1))
    DS = D @ S
    for c in range(n):
        E[c * q1:(c + 1) * q1, c * p:c * p + p + 1] = S
        Gd[c * q1:(c + 1) * q1, c * p:c * p + p + 1] = DS
    return E, Gd


def _axis_mm(M: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract grid axis ``axis`` of t with M (out, in), one matmul."""
    out = torch.movedim(t, axis, -1) @ M.T
    return torch.movedim(out, -1, axis)


def laplace_apply_global_general(u, dim: int, ns, p: int, E_list, G_list,
                                 gsym_q):
    """General-metric cell loop as global quadrature-grid operators:

        y = sum_b C_b^T [ sum_c G[b,c] g_c ] ,   G = jxw * J^-1 J^-T,
        g_b = C_b u,   C_b = (x) over axes: Gd on axis b, E elsewhere.

    E_list, G_list: per-axis (z..x) global value- and derivative-interp
    operators (tensors).  gsym_q: (d(d+1)/2, nq_z[, nq_y], nq_x), the
    packed jxw * J^-1 J^-T component-major (the JAX package keeps the
    components last; here each component is one contiguous field, which
    the elementwise stage reads whole).  Shared partial chains keep it at
    8 forward + 8 transpose axis passes in 3D.
    """
    if isinstance(ns, int):
        ns = (ns,) * dim
    t = u.reshape(tuple(n * p + 1 for n in ns))
    si = _sym_index(dim)
    if dim == 2:
        # axes: 0=z(row), 1=x(col); spatial component a: 0=x maps to
        # tensor axis dim-1-a
        Ez, Ex = E_list
        Gz, Gx = G_list
        g_x = _axis_mm(Gx, _axis_mm(Ez, t, 0), 1)  # spatial x derivative
        g_z = _axis_mm(Ex, _axis_mm(Gz, t, 0), 1)
        g = [g_x, g_z]  # spatial order (x, y=z-axis)
        gb = [sum(gsym_q[si[b, c]] * g[c] for c in range(dim))
              for b in range(dim)]
        out = _axis_mm(Ez.T, _axis_mm(Gx.T, gb[0], 1), 0)
        out = out + _axis_mm(Gz.T, _axis_mm(Ex.T, gb[1], 1), 0)
        return out.reshape(-1)
    Ez, Ey, Ex = E_list
    Gz, Gy, Gx = G_list
    # forward with shared partials (8 axis passes)
    a0 = _axis_mm(Ez, t, 0)                 # Ez u
    a1 = _axis_mm(Ey, a0, 1)                # Ey Ez u
    g_x = _axis_mm(Gx, a1, 2)
    g_y = _axis_mm(Ex, _axis_mm(Gy, a0, 1), 2)
    g_z = _axis_mm(Ex, _axis_mm(Ey, _axis_mm(Gz, t, 0), 1), 2)
    g = [g_x, g_y, g_z]  # spatial (x, y, z)
    gb = [sum(gsym_q[si[b, c]] * g[c] for c in range(dim))
          for b in range(dim)]
    # transpose with shared partials (8 axis passes)
    tx = _axis_mm(Gx.T, gb[0], 2)           # -> nodal x, q y/z
    ty = _axis_mm(Ex.T, _axis_mm(Gy.T, gb[1], 1), 2)
    txy = _axis_mm(Ey.T, tx, 1) + ty        # nodal x/y, q z
    out = _axis_mm(Ez.T, txy, 0)
    out = out + _axis_mm(
        Gz.T, _axis_mm(Ey.T, _axis_mm(Ex.T, gb[2], 2), 1), 0)
    return out.reshape(-1)


def laplace_apply_global_diag(u, dim: int, ns, p: int, E_list, G_list,
                              scale, wb):
    """Diagonal-metric (axis-aligned Cartesian) cell loop as global
    quadrature-grid matmuls: the pointwise stage is gb[a] = scale[a] * wb *
    g[a], ``scale`` (d,) spatial-axis scales inv_h^2 * det (x first), ``wb``
    the blocked-layout broadcastable weights ([nz,qz,]ny,qy,nx,qx)."""
    if isinstance(ns, int):
        ns = (ns,) * dim
    q1 = E_list[0].shape[0] // ns[0]
    blk = tuple(int(v) for v in np.ravel([(n, q1) for n in ns]))
    t = u.reshape(tuple(n * p + 1 for n in ns))

    def pointwise(g, a):
        return (g.reshape(blk) * wb * scale[a]).reshape(g.shape)

    if dim == 2:
        Ez, Ex = E_list
        Gz, Gx = G_list
        gb_x = pointwise(_axis_mm(Gx, _axis_mm(Ez, t, 0), 1), 0)
        gb_z = pointwise(_axis_mm(Ex, _axis_mm(Gz, t, 0), 1), 1)
        out = _axis_mm(Ez.T, _axis_mm(Gx.T, gb_x, 1), 0)
        out = out + _axis_mm(Gz.T, _axis_mm(Ex.T, gb_z, 1), 0)
        return out.reshape(-1)
    Ez, Ey, Ex = E_list
    Gz, Gy, Gx = G_list
    a0 = _axis_mm(Ez, t, 0)
    a1 = _axis_mm(Ey, a0, 1)
    gb_x = pointwise(_axis_mm(Gx, a1, 2), 0)
    gb_y = pointwise(_axis_mm(Ex, _axis_mm(Gy, a0, 1), 2), 1)
    gb_z = pointwise(
        _axis_mm(Ex, _axis_mm(Ey, _axis_mm(Gz, t, 0), 1), 2), 2)
    tx = _axis_mm(Gx.T, gb_x, 2)
    ty = _axis_mm(Ex.T, _axis_mm(Gy.T, gb_y, 1), 2)
    txy = _axis_mm(Ey.T, tx, 1) + ty
    out = _axis_mm(Ez.T, txy, 0)
    out = out + _axis_mm(
        Gz.T, _axis_mm(Ey.T, _axis_mm(Ex.T, gb_z, 2), 1), 0)
    return out.reshape(-1)


def laplace_apply_structured(u, dim: int, ns, p: int, S, D_col, scale,
                             w_block):
    """Full Laplace vmult on the uniform grid: block -> S-transform ->
    collocation gradients -> metric scale -> transpose -> overlap-add.

    scale: (dim,) tensor inv_h[a]^2 * det (uniform Cartesian metric, x
    first); w_block: the quadrature weight block, (q1,)*dim interleaved
    with ones, or with a coefficient the full blocked
    ([nz,qz,]ny,qy,nx,qx).
    """
    if isinstance(ns, int):
        ns = (ns,) * dim
    t = block_all(u, dim, ns, p)
    # values at quadrature points: contract every local dim with S
    for a in range(dim):
        t = contract_local(t, S, a, dim)
    # gradient components + metric + accumulate transposed application
    acc = None
    for a in range(dim):
        g = contract_local(t, D_col, a, dim)
        g = g * (scale[a] * w_block)
        g = contract_local(g, D_col.T, a, dim)
        acc = g if acc is None else acc + g
    for a in range(dim):
        acc = contract_local(acc, S.T, a, dim)
    return unblock_all_add(acc, dim, ns, p)

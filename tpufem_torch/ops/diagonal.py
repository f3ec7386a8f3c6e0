"""Device-side operator diagonal, including hanging nodes x coefficient.

Port of ``tpufem/ops/diagonal.py`` (the reference's
``LaplaceOperatorGpu::compute_diagonal()`` via the unit-basis trick): the
per-cell quadratic forms in closed form on the device.

- cells WITHOUT hanging-constrained local DoFs contribute
  ``diag_e[c, j] = sum_q w |J^-T grad phi_j|^2`` (coefficient folded into
  ``w``), summed per DoF through the incidence map;
- cells WITH hanging locals contribute through the exact pair expansion
  of ``diag(C^T A C)``: with per-local resolution lists
  ``C e_j = sum_a W[j,a] e_{T[j,a]}`` (identity for unconstrained locals,
  master/weight lists for hanging ones), the total into target i from
  cell c is ``B_i^T A^c B_i`` with ``B_i[j] = sum_{a: T[j,a]=i} W[j,a]``.

Index bookkeeping is host numpy over the hanging cells; the arithmetic
(local matrices, quadratic forms) runs on the device.  Where the reference
accumulates with scatter-adds over repeated indices, this port writes B
once per entry (within a cell and local, the genuine entries have
distinct targets) and sums the per-cell results into the diagonal by a
host-built transpose table (``matrix_free.transpose_table``): one write
per index, the same from run to run on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.assemble import cell_basis_gradients
from tpufem_torch.ops.matrix_free import transpose_table

# cells per chunk of the per-cell work times its largest per-cell array
# (elements): bounds the device memory of the quadratic forms
_CHUNK_ELEMS = 1 << 25


def _basis_gradients(mf) -> torch.Tensor:
    """(nq, nn, d) reference-cell basis gradients in the config dtype."""
    return torch.as_tensor(
        cell_basis_gradients(mf.config.degree, mf.config.dim, mf.quad),
        dtype=mf.interior_mask.dtype, device=mf.device)


def _quad_weights(mf, cells: torch.Tensor) -> torch.Tensor:
    """(len(cells), nq) total quadrature weights w = JxW * coef."""
    if mf.metric_kind == "cartesian":
        w = mf.det[cells][:, None] * mf.w_q[None, :]
    else:
        w = mf.jxw[cells]
    if mf.coef_dev is not None:
        w = w * mf.coef_dev[cells]
    return w


def _chunks(nc: int, per_cell: int):
    step = max(1, _CHUNK_ELEMS // max(1, per_cell))
    for c0 in range(0, nc, step):
        yield c0, min(nc, c0 + step)


def cell_diag_entries(mf) -> torch.Tensor:
    """(nc, nn) unconstrained local diagonals on the device."""
    mf.cell_data()
    G = _basis_gradients(mf)  # (nq, nn, d)
    nq, nn, d = G.shape
    nc = mf.dofs.cell_dofs.shape[0]
    out = torch.empty((nc, nn), dtype=G.dtype, device=mf.device)
    per_cell = nq * nn * d if mf.metric_kind == "general" else nq + nn
    for c0, c1 in _chunks(nc, per_cell):
        cells = torch.arange(c0, c1, device=mf.device)
        w = _quad_weights(mf, cells)  # (c, nq)
        if mf.metric_kind == "cartesian":
            s = mf.inv_h[cells] ** 2  # (c, d)
            out[c0:c1] = sum((w * s[:, a:a + 1]) @ G[:, :, a] ** 2
                             for a in range(d))
        else:
            Gp = torch.einsum("cqba,qjb->cqja", mf.inv_jac[cells], G)
            out[c0:c1] = ((Gp**2).sum(-1) * w[:, :, None]).sum(1)
    return out


def local_matrices(mf, cells: torch.Tensor) -> torch.Tensor:
    """(len(cells), nn, nn) local stiffness matrices on the device."""
    mf.cell_data()
    G = _basis_gradients(mf)
    nq, nn, d = G.shape
    w = _quad_weights(mf, cells)
    if mf.metric_kind == "cartesian":
        s = mf.inv_h[cells] ** 2  # (c, d)
        return sum(((w * s[:, a:a + 1])[:, None, :] * G[:, :, a].T)
                   @ G[:, :, a] for a in range(d))
    Gp = torch.einsum("cqba,qjb->cqja", mf.inv_jac[cells], G)  # (c,q,j,a)
    lhs = (Gp * w[:, :, None, None]).permute(0, 2, 1, 3).reshape(
        len(cells), nn, nq * d)
    return lhs @ Gp.permute(0, 1, 3, 2).reshape(len(cells), nq * d, nn)


def diagonal_device(mf) -> torch.Tensor:
    """Unconstrained-operator diagonal diag(A), on the device."""
    return mf.scatter_incidence(cell_diag_entries(mf))


def diagonal_device_hanging(mf) -> torch.Tensor:
    """diag(C^T A C) on the device (C = hanging-node resolution), without
    the identity rows of constrained DoFs (the caller's mask algebra)."""
    assert mf.has_hanging
    cd = mf.dofs.cell_dofs
    nn = cd.shape[1]
    con, masters, weights = mf.con_host
    K = masters.shape[1]

    r_of = np.full(mf.n_dofs, -1, dtype=np.int64)
    r_of[con] = np.arange(len(con))
    rh = r_of[cd]  # (nc, nn), -1 = unconstrained local
    has_h = (rh >= 0).any(axis=1)
    hsel = np.nonzero(has_h)[0]

    # ---- plain cells: local diagonals, hanging cells masked out --------
    de = cell_diag_entries(mf)
    plain = torch.as_tensor(~has_h, dtype=de.dtype, device=mf.device)
    diag = mf.scatter_incidence(de * plain[:, None])
    if len(hsel) == 0:
        return diag

    # ---- hanging cells: exact pair expansion ---------------------------
    # per-local resolution lists, padded to Kc = K + 1:
    #   unconstrained j: [(dof_j, 1)]; hanging j: [(master_a, w_a)...]
    Kc = K + 1
    nh = len(hsel)
    rhs_ = rh[hsel]
    un = rhs_ < 0
    safe = np.where(un, 0, rhs_)
    T = np.zeros((nh, nn, Kc), dtype=np.int64)
    W = np.zeros((nh, nn, Kc))
    T[:, :, 0] = np.where(un, cd[hsel], 0)
    W[:, :, 0] = un
    T[:, :, 1:] = np.where(un[:, :, None], 0, masters[safe])
    W[:, :, 1:] = np.where(un[:, :, None], 0.0, weights[safe])
    # per-cell compact ids of the distinct targets (vectorized row-sort +
    # rank inversion), as the reference
    F = nn * Kc
    Tf = T.reshape(nh, F)
    Wf = W.reshape(nh, F)
    jf = np.broadcast_to(np.arange(nn)[:, None], (nn, Kc)).reshape(F)
    order = np.argsort(Tf, axis=1, kind="stable")
    Ts = np.take_along_axis(Tf, order, axis=1)
    new_t = np.concatenate(
        [np.ones((nh, 1), bool), Ts[:, 1:] != Ts[:, :-1]], axis=1)
    rank_sorted = np.cumsum(new_t, axis=1) - 1
    M = int(rank_sorted[:, -1].max()) + 1
    rank = np.empty_like(rank_sorted)
    np.put_along_axis(rank, order, rank_sorted, axis=1)
    # only genuine entries (W != 0) enter B; for one cell and local their
    # targets are distinct, so each B entry is written once
    genuine = Wf != 0.0
    gc, gf = np.nonzero(genuine)
    grank = rank[gc, gf]
    # the genuine (cell, slot) pairs and their targets
    slot = np.zeros((nh, M), dtype=bool)
    slot[gc, grank] = True
    tgt = np.zeros((nh, M), dtype=np.int64)
    tgt[gc, grank] = Tf[gc, gf]

    dt = de.dtype
    vals = torch.zeros((nh, M), dtype=dt, device=mf.device)
    hsel_d = torch.as_tensor(hsel, device=mf.device)
    for c0, c1 in _chunks(nh, M * nn + nn * nn):
        sel = (gc >= c0) & (gc < c1)
        flat = ((gc[sel] - c0) * M + grank[sel]) * nn + jf[gf[sel]]
        B = torch.zeros((c1 - c0) * M * nn, dtype=dt, device=mf.device)
        B[torch.as_tensor(flat, device=mf.device)] = torch.as_tensor(
            Wf[gc[sel], gf[sel]], dtype=dt, device=mf.device)
        B = B.reshape(c1 - c0, M, nn)
        A = local_matrices(mf, hsel_d[c0:c1])  # (c, nn, nn)
        vals[c0:c1] = ((B @ A) * B).sum(-1)
    # diag[tgt] += vals over the genuine slots, as a gather-sum
    sc, sm = np.nonzero(slot)
    tc, tr, tv = transpose_table(sc * M + sm, tgt[sc, sm],
                                 np.ones(len(sc)), nh * M)
    vflat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
    tc = torch.as_tensor(tc, device=mf.device)
    diag[tc] = diag[tc] + vflat[torch.as_tensor(tr, device=mf.device)].sum(1)
    return diag

"""The band ring's 2D plan (K3), compiled for the CPU with g++
(tests/test_torch_kernel_host.py's shim: one host thread a block, the TMA
mover a copy with zero fill) and held against the plain PyTorch versions in
f64, into NaN-filled outputs, at 1-4 segments of x on grids whose last
chunk holds one column; the segment chooser's rule.
"""

import numpy as np
import pytest
import torch

from test_torch_kernel_host import (
    CODES,
    TOL,
    _mask,
    _nonsym,
    _ring_apply,
    build_ring,
    ring_counts,
)
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops.separable import laplace_apply_separable_terms
from torch_threads import one_torch_thread  # noqa: F401

SEGMENTS = (1, 2, 3, 4)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_ring(tmp_path_factory, "ring2d", ("2d",))


def ragged_npts(mode, chunks=4):
    """A grid whose last of ``chunks`` chunks holds one column."""
    return (chunks - 1) * tks.ring_xc(CODES[mode][1], 2) + 1


def _terms_ref(terms, x, dirichlet):
    npts = terms[0][0].shape[0]
    A = lambda v: laplace_apply_separable_terms(
        v, 2, npts, [[torch.as_tensor(X) for X in t] for t in terms])
    if not dirichlet:
        return A(x)
    m = _mask(npts, 2)
    return m * A(m * x) + (1.0 - m) * x


@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("dirichlet", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("mode", ["f64", "f32", "bf16s"])
def test_ring2d_terms_plan_matches_plain(lib, mode, p, dirichlet, T):
    """K3: T random non-symmetric banded terms (a swapped axis or term, a
    transposed band, a boundary-row error shows), with and without the
    fused mask (a boundary point stores its input, bit for bit), at 1-4
    segments of x and at sub-tiles (1, 16) and (1, 32) (ragged rows)."""
    npts = ragged_npts(mode)
    rng = np.random.default_rng(npts * 10 + p + T)
    terms = [[_nonsym(rng, npts, p) for _ in range(2)] for _ in range(T)]
    u = torch.as_tensor(rng.standard_normal(npts**2))
    for seg, ty in zip(SEGMENTS, (16, 32, 16, 32)):
        y, x, _ = _ring_apply(lib, 1, [X for t in terms for X in t], p, mode,
                              u, dirichlet, (1, ty, seg), dim=2)
        ref = _terms_ref(terms, x, dirichlet)
        err = (y - ref).abs().max() / ref.abs().max()
        assert err <= TOL[mode], (seg, err)
        if dirichlet:
            bnd = _mask(npts, 2) == 0
            assert torch.equal(y[bnd], x[bnd])


@pytest.mark.parametrize("mode,group", [("f64", 1), ("f64", 3), ("f32", 2),
                                        ("bf16s", 3)])
def test_ring2d_cp_terms_take_passes(lib, mode, group):
    """A CP coefficient's term count (rank 4: 8 terms) in groups of 1-3
    (passes over each segment, partial sums in the compute type) with the
    fused mask, at 1-4 segments: the sum in term order within the class."""
    p, T = 2, 8
    npts = ragged_npts(mode)
    rng = np.random.default_rng(group)
    terms = [[_nonsym(rng, npts, p) for _ in range(2)] for _ in range(T)]
    u = torch.as_tensor(rng.standard_normal(npts**2))
    for seg in SEGMENTS:
        y, x, _ = _ring_apply(lib, 1, [X for t in terms for X in t], p, mode,
                              u, True, (1, 16, seg), group=group, dim=2)
        ref = _terms_ref(terms, x, True)
        assert (y - ref).abs().max() <= TOL[mode] * ref.abs().max(), seg


@pytest.mark.parametrize("case", ["k3-f64", "k3-f32", "k3-bf16s"])
def test_ring2d_copy_ablation_returns_its_input(lib, case):
    """K3's copy ablation (the TMA mover and the stores alone) stores each
    point it loaded, bit for bit, pad columns zero, at every segment
    count."""
    mode = case.split("-")[1]
    npts = ragged_npts(mode)
    rng = np.random.default_rng(npts)
    mats = [_nonsym(rng, npts, 2) for _ in range(4)]
    u = torch.as_tensor(rng.standard_normal(npts**2))
    for seg in SEGMENTS:
        _, x, y = _ring_apply(lib, 1, mats, 2, mode, u, tile=(1, 16, seg),
                              ablation=tks.RING_ABLATIONS["copy"], dim=2)
        assert torch.equal(y[..., :npts].reshape(-1).to(torch.float64), x), \
            seg


@pytest.mark.parametrize("T", [1, 2, 5])
def test_ring2d_bands_ablation_matches_its_plain_version(lib, T):
    """K3's "bands" ablation (the y stage, the windows summed at x, no x
    band) against the wrapper's plain version of its function (each term
    with the identity along x), 5 terms in passes too."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms2D

    p = 2
    npts = ragged_npts("f64")
    rng = np.random.default_rng(T)
    terms = [[_nonsym(rng, npts, p) for _ in range(2)] for _ in range(T)]
    u = torch.as_tensor(rng.standard_normal(npts**2))
    ref = laplace_apply_separable_terms(
        u, 2, npts, tks.ablation_terms(
            [[torch.as_tensor(X) for X in t] for t in terms], npts,
            torch.float64, "cpu"))
    for seg in SEGMENTS:
        y, _, _ = _ring_apply(lib, 1, [X for t in terms for X in t], p, "f64",
                              u, tile=(1, 16, seg), group=min(T, 2),
                              ablation=tks.RING_ABLATIONS["bands"], dim=2)
        assert (y - ref).abs().max() <= 1e-13 * ref.abs().max(), seg
    k = ResidentTerms2D(npts, p, terms, torch.float32, mode="bands",
                        device="cpu")
    yk = k.unpad(k.plain(k.pad(u))).to(torch.float64)
    assert (yk - ref).abs().max() <= 1e-6 * ref.abs().max()


def test_ring_refuses_what_it_cannot_run(lib):
    """The launcher's argument check (ring_args_ok): more segments than
    chunks, the Laplace plan in 2D, a 2D sub-tile with TZ > 1, a mask on an
    ablation, an output on the input; the shim returns 4 for a refusal."""
    npts, p = 65, 2
    X = tks.resident_x(npts, torch.float32, 2)  # 96: three chunks
    u = torch.zeros((npts, X))
    y = torch.zeros_like(u)
    t = torch.zeros((2, 2, npts, 8))
    call = lambda plan, code, tz, ty, nseg, mode=0, d=0, out=y: \
        lib.host_ring_apply(plan, 2, code, p, npts, X, 2, 2, tz, ty, nseg,
                            mode, d, u.data_ptr(), out.data_ptr(), None,
                            t.data_ptr())
    assert call(1, 1, 1, 16, 3) == 0
    assert call(1, 1, 1, 16, 4) == 4
    assert call(0, 1, 1, 16, 1) == 4
    assert call(1, 1, 2, 16, 1) == 4
    assert call(1, 1, 1, 16, 1, mode=1, d=1) == 4
    assert call(1, 1, 1, 16, 1, out=u) == 4


def test_segment_chooser_rule():
    """choose_segments: the s minimising rounds(s) (ceil(nchunk / s) +
    min(s - 1, 2)), rounds(s) = ceil(rows s / slots), fewest among equals;
    pinned at the shapes the main path launches (132 SMs)."""
    rule = lambda rows, nchunk, slots, s: -(-rows * s // slots) * (
        -(-nchunk // s) + min(s - 1, 2))
    for rows, nchunk, slots in ((17, 33, 264), (65, 129, 264), (289, 9, 264),
                                (17, 9, 264), (4, 3, 264), (1, 1, 132)):
        s = tks.choose_segments(rows, nchunk, slots)
        costs = [rule(rows, nchunk, slots, k) for k in range(1, nchunk + 1)]
        assert rule(rows, nchunk, slots, s) == min(costs)
        assert s == 1 + costs.index(min(costs))
    # 2D refine 8 (npts 1025: 17 rows of (1, 64), 33 chunks of 32 f32
    # columns) on 132 SMs at two blocks an SM: 11 segments, one round
    assert tks.choose_segments(17, 33, 2 * 132) == 11
    # 2D refine 10 (npts 4097: 65 rows, 129 chunks); two or three an SM
    assert tks.choose_segments(65, 129, 2 * 132) == 4
    assert tks.choose_segments(65, 129, 3 * 132) == 6
    # 3D refine 5 at (8, 8): 289 rows fill 264 slots; one segment ties two
    # (two rounds of 9 chunks, three of 5 + 1) and the fewer wins
    assert tks.choose_segments(289, 9, 2 * 132) == 1
    # a grid of few rows takes a segment a chunk
    assert tks.choose_segments(17, 9, 2 * 132) == 9


def test_ring2d_chooser_takes_2d_subtiles(lib):
    """K3's chooser in 2D: the first (1, TY) of RING_TILES_2D whose block
    with all T windows fits two an SM, for two, three and six terms in f32
    and bf16s ((1, 64) for the Laplace's two terms in f32); the 2D block
    holds no z buffers and no z halo (its smem is the 3D sub-tile's minus
    both)."""
    smem, takes = ring_counts(lib, 2)
    tiles = tks.RING_TILES_2D
    for code in (1, 2):
        for nt in (2, 3, 6):
            tile, g = tks.choose_ring_tile(4, code, nt, smem, takes, tiles)
            assert tile[0] == 1 and g == nt
            assert smem(4, code, nt, *tile) <= tks.RING_TWO_BLOCKS
            assert all(smem(4, code, nt, *t) > tks.RING_TWO_BLOCKS
                       for t in tiles[:tiles.index(tile)])
    assert tks.choose_ring_tile(4, 1, 2, smem, takes, tiles)[0] == (1, 64)
    assert not takes(4, 2, 64) and takes(4, 1, 64) and not takes(4, 1, 8)
    assert smem(4, 1, 2, 1, 64) < ring_counts(lib, 3)[0](4, 1, 2, 1, 64)

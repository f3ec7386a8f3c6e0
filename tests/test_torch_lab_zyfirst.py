"""The K2 kernel lab's z/y-first half (L2b: v13, v14, v15, v16, vcopy, vband)
on the CPU: the port's plain version against the Pallas kernels of
``scripts/kernel_lab.py`` in interpret mode (through the ``klab`` fixture of
test_torch_lab_separable.py; nothing in ``scripts/`` changes), the layouts,
the refusal without a card, the routine's shared-memory count, the
emulation's classes, the bounds at the lab's flagship, and a g++ build of the
CUDA routine (tpufem_torch/csrc/lab_zyfirst.cuh, on lab_resident.cuh's
device functions) against the plain version and against Pallas.

The host build runs one thread per block with the WMMA stub of
test_torch_lab.py (one host thread stands for a warp); ``cp.async`` is a
plain copy there.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_host import STUBS, _build
from test_torch_lab import WMMA_STUBS
from test_torch_lab_separable import MODES, _max_rel, klab  # noqa: F401

from tpufem_torch.lab import kernel_lab, separable_lab
from tpufem_torch.lab.separable_lab import NO_MMA, ZY_ARGS, ZYFIRST, LabKernel
from tpufem_torch.ops.separable import global_1d_matrices

ZY_SHIM = STUBS + WMMA_STUBS + r"""
#define __grid_constant__
#include "lab_zyfirst.cuh"

template <int P, int XP>
static int run(int mode, int two, int nu, tpufem::LabGeo g, const void* u,
               void* y, const void* tab, const void* xk, const void* xkl) {
  using C = typename tpufem::LabMma<XP>::C;
  const long long bytes =
      tpufem::zy_smem_bytes(mode, P, XP, nu, g.tz, g.ty, g.X);
  const int NT = g.sz - 2 * P, xc = tpufem::ring_xc(sizeof(C));
  const tpufem::RingPieces pc = tpufem::ring_pieces(g.tz, g.ty);
  tpufem::HopMap in_map, out_map;  // the launcher's two maps
  const long long in_dim[3] = {g.X, g.sy, g.sz}, out_dim[3] = {g.X, NT, NT};
  const int in_box[3] = {xc, g.ty + 2 * P, g.tz + 2 * P};
  const int out_box[3] = {xc, pc.by, pc.bz};
  tpufem::hop_map_3d(&in_map, (void*)u, sizeof(C), in_dim, in_box);
  tpufem::hop_map_3d(&out_map, y, sizeof(C), out_dim, out_box);
  if (mode != tpufem::kFull && !tpufem::zy_ring_takes(P, g.tz, g.ty)) return 3;
  for (int bz = 0; bz < g.ntz; ++bz)
    for (int by = 0; by < g.nty; ++by) {
      std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
      blockIdx = Dim3{by, bz, 0};
      if (mode == tpufem::kFull)
        tpufem::zy_kernel<P, XP>((const C*)u, (C*)y, (const C*)tab, xk, xkl,
                                 g, two, nu);
      else if constexpr (XP == tpufem::kX3TF32 || XP == tpufem::kXF64)
        tpufem::zy_ring_kernel<P, C>(in_map, out_map, (const C*)tab, g, mode);
      for (long long i = bytes; i < bytes + 4096; ++i)
        if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
    }
  return 0;
}

template <int XP>
static int by_p(int p, int mode, int two, int nu, tpufem::LabGeo g,
                const void* u, void* y, const void* t, const void* xk,
                const void* xkl) {
  switch (p) {
    case 1: return run<1, XP>(mode, two, nu, g, u, y, t, xk, xkl);
    case 2: return run<2, XP>(mode, two, nu, g, u, y, t, xk, xkl);
    case 4: return run<4, XP>(mode, two, nu, g, u, y, t, xk, xkl);
    case 7: return run<7, XP>(mode, two, nu, g, u, y, t, xk, xkl);
  }
  return 2;
}

extern "C" int host_zy_apply(int mode, int two, int nu, int xp, int p,
                             int npts, int size, int X, int tz, int ty,
                             const void* u, void* y, const void* t,
                             const void* xk, const void* xkl) {
  const int NT = size - 2 * p;
  const tpufem::LabGeo g{npts, size, size, X, tz, ty, (NT + tz - 1) / tz,
                         (NT + ty - 1) / ty};
  switch (xp) {
    case 0: return by_p<0>(p, mode, two, nu, g, u, y, t, xk, xkl);
    case 1: return by_p<1>(p, mode, two, nu, g, u, y, t, xk, xkl);
    case 2: return by_p<2>(p, mode, two, nu, g, u, y, t, xk, xkl);
    case 3: return by_p<3>(p, mode, two, nu, g, u, y, t, xk, xkl);
    case 4: return by_p<4>(p, mode, two, nu, g, u, y, t, xk, xkl);
  }
  return 2;
}

extern "C" long long host_zy_smem_bytes(int mode, int p, int xp, int nu,
                                        int tz, int ty, int X) {
  return tpufem::zy_smem_bytes(mode, p, xp, nu, tz, ty, X);
}
"""

TOL, EMU_TOL = separable_lab.TOL, separable_lab.EMU_TOL
MMA_VARIANTS = [v for v in ZYFIRST if v not in NO_MMA]  # v13, v14, v15


def _kernel(v, p, n, mode, b=None, h=(1.0, 1.3, 0.7)):
    K1, M1 = global_1d_matrices(p, n, p + 1)
    dtype, prec = MODES[mode]
    return LabKernel(v, n * p + 1, p, K1, M1, [x / n for x in h], b=b,
                     prec=prec, dtype=dtype, device="cpu")


def _pallas(klab, v, npts, p, K1, M1, h, b, u):  # noqa: F811
    """The Pallas LabKernel's output in interpret mode, x64 off as where
    the script runs: its 1D-grid kernels mix ``program_id`` (int32) with
    Python ints, which the test process's x64 mode would make int64."""
    with jax.enable_x64(False):
        return np.asarray(klab.LabKernel(v, npts, p, K1, M1, h, b=b)(
            jnp.asarray(u)))


def _periodic_corners(M1, p):
    """M1 with its two corner entries replaced by the centre tap of an
    interior vertex row: the operator the Pallas kernels' periodic tables
    stand for when the deficit corrections are left out (vband)."""
    g0 = p * ((p + M1.shape[0] // 2) // p)
    out = M1.copy()
    out[0, 0] = out[-1, -1] = M1[g0, g0]
    return out


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("v", ZYFIRST)
def test_plain_matches_pallas(klab, v, p, b):  # noqa: F811
    """The port's plain version of each variant against the Pallas
    LabKernel in interpret mode (f32, n = 8), same numpy-seeded input: 1e-6
    relative; vcopy exactly equal.  The Pallas vband applies its periodic
    tables without the corrections of rows 0 and npts - 1, so it is held
    over the whole grid to the port's vband of the matrices with those two
    corner entries replaced (``_periodic_corners``), and the port's vband of
    the true matrices must differ from that one only on those rows."""
    n = 8
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n, 1.3 / n, 0.7 / n])
    u = np.random.default_rng(10 * p + b).standard_normal(npts**3).astype(
        np.float32)
    y_j = _pallas(klab, v, npts, p, K1, M1, h, b, u)
    k = LabKernel(v, npts, p, K1, M1, h, b=b, device="cpu")
    y_t = k(torch.as_tensor(u)).numpy()
    assert np.linalg.norm(y_j) > 0
    if v == "vcopy":
        assert np.array_equal(y_t, y_j) and np.array_equal(y_t, u)
        return
    if v == "vband":
        kc = LabKernel(v, npts, p, _periodic_corners(K1, p),
                       _periodic_corners(M1, p), h, b=b, device="cpu")
        y_c = kc(torch.as_tensor(u)).numpy()
        inner = np.zeros((npts,) * 3, bool)
        inner[1:-1, 1:-1] = True  # z and y rows 1 .. npts - 2
        assert np.array_equal(y_c.reshape(inner.shape)[inner],
                              y_t.reshape(inner.shape)[inner])
        assert not np.array_equal(y_c, y_t)
        y_t = y_c
    y_j, y_t = y_j.astype(np.float64), y_t.astype(np.float64)
    assert np.linalg.norm(y_t - y_j) <= 1e-6 * np.linalg.norm(y_j)


def test_layout_and_own_functions():
    """The layouts are L2a's; vcopy is the identity on the data; vband is
    q1 + q2 + q3 of the band stages; every variant's plain version leaves
    the padding zero."""
    p, n = 2, 3
    npts = n * p + 1
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(npts**3))
    for v in ZYFIRST:
        k = _kernel(v, p, n, "f64", b=4)
        assert k.zy and k.flags is None
        gp = k.pad(u)
        assert gp.shape == (k.nt * 4 + 2 * p,) * 2 + (16,)
        y = k.plain(gp)
        assert y.shape == (k.nt * 4, k.nt * 4, 16)
        assert not y[npts:].any() and not y[:, npts:].any() \
            and not y[..., npts:].any()
        before = dict(LabKernel.launches)
        assert torch.equal(k.raw(gp), y)  # a CPU tensor: the plain version
        assert LabKernel.launches == before
    kc, kb = _kernel("vcopy", p, n, "f64", b=4), _kernel("vband", p, n,
                                                         "f64", b=4)
    assert torch.equal(kc(u), u)
    g = u.reshape(npts, npts, npts)
    My, Ky, Mz, Kz = (torch.as_tensor(M) for M in (kb.Ms[1], kb.Ks[1],
                                                   kb.Ms[2], kb.Ks[2]))
    s = torch.einsum("az,zyx->ayx", Mz, g)
    t = torch.einsum("az,zyx->ayx", Kz, g)
    q = (torch.einsum("by,zyx->zbx", My + Ky, s)
         + torch.einsum("by,zyx->zbx", My, t))
    assert torch.allclose(kb(u), q.reshape(-1), rtol=0,
                          atol=1e-13 * float(q.abs().max()))


@pytest.mark.parametrize("v", ["vcopy", "vx"])
def test_one_call_equivalents(v):
    """vcopy's function is one slice of the input layout made contiguous,
    vx's one matmul of its first (nt b)^2 rows with (Mx + Kx)^T padded to
    X: the single PyTorch calls the GPU smoke test times beside the two
    kernels.  Every other variant sums several Kronecker applies."""
    p, n, b = 2, 3, 4
    npts = n * p + 1
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(npts**3))
    k = _kernel(v, p, n, "f64", b=b)
    gp, NT = k.pad(u), k.nt * b
    if v == "vcopy":
        assert torch.equal(gp[p:p + NT, p:p + NT].contiguous(), k.plain(gp))
        return
    w = torch.zeros((k.X, k.X), dtype=torch.float64)
    w[:npts, :npts] = torch.as_tensor((k.Ms[0] + k.Ks[0]).T)
    y, ref = torch.matmul(gp[:NT, :NT], w), k.plain(gp)
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_lab_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K1, M1 = global_1d_matrices(2, 4, 3)
    for v in ZYFIRST:
        with pytest.raises(RuntimeError, match="CUDA"):
            LabKernel(v, 9, 2, K1, M1, [0.25] * 3)  # the card is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_lab.main(["--refine", "1", "--p", "1", "--variants",
                         "v13-highest", "v14", "v15", "v16", "vcopy",
                         "vband"])
    with pytest.raises(ValueError, match="exact dense stages"):
        LabKernel("v15", 9, 2, K1, M1, [0.25] * 3, prec="default",
                  dtype=torch.float64, device="cpu")
    # no tensor-core stage: prec is moot, f64 storage is taken
    k = LabKernel("v16", 9, 2, K1, M1, [0.25] * 3, prec="default",
                  dtype=torch.float64, device="cpu")
    assert k.prec == "highest" and k.xp == separable_lab.XF64
    with pytest.raises(ValueError, match="tensor-core stage"):
        LabKernel("vband", 9, 2, K1, M1, [0.25] * 3, device="cpu").emulate(
            torch.zeros(1))
    assert kernel_lab.l2_variant("v15-default") == ("v15", "default")
    assert kernel_lab.l2_variant("vcopy") == ("vcopy", "highest")
    assert kernel_lab.l2_variant("v17") is None


@pytest.fixture(scope="module")
def zy_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "zy_host", ZY_SHIM)
    lib.host_zy_apply.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 5
    lib.host_zy_apply.restype = ctypes.c_int
    lib.host_zy_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.host_zy_smem_bytes.restype = ctypes.c_longlong
    return lib


def _host(lib, k, gp, tile=None):
    mode, _, nu = ZY_ARGS[k.variant]
    tile = tile or separable_lab.choose_zy_tile(k.p, k.xp, nu, k.X,
                                                lib.host_zy_smem_bytes, mode)
    NT = k.nt * k.b
    y = torch.full((NT, NT, k.X), float("nan"), dtype=k.dt)  # all written
    lo = k.xk.data_ptr() + k.xk_lo * k.xk.element_size()
    rc = lib.host_zy_apply(*ZY_ARGS[k.variant], k.xp, k.p, k.npts, k.size,
                           k.X, *tile, gp.data_ptr(), y.data_ptr(),
                           k.tables.data_ptr(), k.xk.data_ptr(), lo)
    assert rc == 0, "kernel wrote beyond its shared memory"
    return y


HOST_CASES = (
    [(v, p, "f64", None, None) for v in ZYFIRST for p in (1, 2, 4, 7)]
    + [(v, 4, "f32", None, None) for v in ZYFIRST]
    + [(v, 4, m, None, None) for m in ("f32h", "bf16", "bf16d")
       for v in MMA_VARIANTS]
    # several layout tiles; sub-tiles ragged against the layout ((1, 16)
    # and (2, 8) on 12 rows, (4, 12) dividing them), every u-slot count
    + [(v, 2, m, 4, t) for v in ("v13", "v15", "v16", "vband")
       for m, t in (("f64", (1, 16)), ("f32", (2, 8)))]
    + [("v14", 2, "f32", 6, (4, 12)), ("vcopy", 1, "f32", 5, (1, 16)),
       ("v15", 7, "f64", 8, (1, 8)), ("v15", 1, "bf16", 24, (2, 8))])


@pytest.mark.parametrize("v,p,mode,b,tile", HOST_CASES)
def test_host_build_matches_plain(zy_lib, v, p, mode, b, tile):
    """Each L2b kernel in each arithmetic it takes against the plain
    version in f64 on the same (storage-rounded) input, every output point
    written (the output starts as NaN); vcopy exactly; the split
    arithmetics also against ``emulate``."""
    n = 2 if p > 2 else 9 // p
    k = _kernel(v, p, n, mode, b)
    u = torch.as_tensor(np.random.default_rng(n * p + 3).standard_normal(
        (n * p + 1)**3))
    gp = k.pad(u)
    y = _host(zy_lib, k, gp, tile)
    assert torch.isfinite(y).all()
    ref = k.plain(gp.to(torch.float64))
    err = _max_rel(y, ref)
    assert err <= kernel_lab.L2_OWN_TOL.get(v, TOL[k.xp]), err
    if mode != "f64" and v not in NO_MMA:
        ye = k.emulate(gp).to(torch.float64)
        emu, apart = _max_rel(ye, ref), float(
            (y.to(torch.float64) - ye).abs().max() / ref.abs().max())
        print(f"{v} {mode} p={p} b={k.b}: host stub {err:.3e}, emulation "
              f"{emu:.3e}, apart {apart:.3e}")
        assert apart <= EMU_TOL[k.xp], (apart, err, emu)


RING_VARIANTS = ("vcopy", "vband", "v16")


@pytest.mark.parametrize("mode", ["f32", "f64"])
@pytest.mark.parametrize("tile", separable_lab.ZY_RING_TILES
                         + ((8, 16), (16, 8), (16, 16)))
@pytest.mark.parametrize("v", RING_VARIANTS)
def test_ring_tiles_and_ragged_edges(zy_lib, v, tile, mode):
    """The all-band routine (TMA boxes as loop copies with zero fill and
    clipping, one host thread running the producer, then each of the eight
    warps' pieces, in turn) at every sub-tile the chooser can pick and at
    larger ones, on an output layout of 12 rows that no sub-tile but (4, .)
    and (2, .), (1, .) divides: every point of the NaN-filled output is
    written; vcopy equals the slice of the input layout bit for bit (0),
    vband and v16 stay in their classes against the f64 plain version
    (1e-6 for vband's f32 sums, the storage's class for v16)."""
    p, n, b = 2, 5, 6
    k = _kernel(v, p, n, mode, b)
    NT = k.nt * b
    assert NT == 12 and (NT % tile[0] or NT % tile[1] or tile[0] <= 4)
    gp = k.pad(torch.as_tensor(np.random.default_rng(2).standard_normal(
        (n * p + 1)**3)))
    y = _host(zy_lib, k, gp, tile)
    assert torch.isfinite(y).all()
    if v == "vcopy":
        assert torch.equal(y, gp[p:p + NT, p:p + NT].contiguous())
        return
    ref = k.plain(gp.to(torch.float64))
    tol = kernel_lab.L2_OWN_TOL.get(v, TOL[k.xp]) if mode == "f32" else 1e-12
    assert _max_rel(y, ref) <= tol


def test_ring_takes_and_window(zy_lib):
    """The sub-tiles the all-band routine takes: eight warps share (TZ, TY)
    in pieces of an even number of rows, so (1, 8) and (3, 8) are refused
    (the host build returns 3 before it runs), every ZY_RING_TILES entry is
    taken at every degree, and its count of shared memory does not depend
    on X (a window of q1/q23, not all of x)."""
    k = _kernel("vcopy", 2, 3, "f32", b=4)
    gp = k.pad(torch.zeros(7**3))
    for tile in ((1, 8), (3, 8), (8, 3)):
        y = torch.zeros((k.nt * 4,) * 2 + (k.X,))
        rc = zy_lib.host_zy_apply(*ZY_ARGS["vcopy"], k.xp, 2, k.npts, k.size,
                                  k.X, *tile, gp.data_ptr(), y.data_ptr(),
                                  k.tables.data_ptr(), 0, 0)
        assert rc == 3
    count = zy_lib.host_zy_smem_bytes
    for tz, ty in separable_lab.ZY_RING_TILES:
        for p in range(1, separable_lab.MAX_DEGREE + 1):
            assert count(1, p, 0, 2, tz, ty, 272) == \
                count(4, p, 0, 1, tz, ty, 4112)
    # (8, 8), p = 4, f32: 3 u slots of (16, 16, 16), s and t (2, 8, 16, 16),
    # two windows (64, 48), two output slots (64, 16), tables, barriers
    assert count(1, 4, 0, 2, 8, 8, 272) == (
        128 + 1280 + 3 * 16384 + 16384 + 24576 + 2 * 4096)


def test_two_products_and_one_stacked_sum_in_other_orders(zy_lib):
    """v13/v14 (a k step of q1 @ Kx^T, then one of q23 @ Mx^T, in turn) and
    v15 (K = 2X in one sweep) agree to their class, not bitwise; v13 and
    v14 differ only in how the u chunk travels, so they agree bitwise."""
    k = {v: _kernel(v, 4, 2, "f32") for v in MMA_VARIANTS}
    gp = k["v13"].pad(torch.as_tensor(
        np.random.default_rng(1).standard_normal(9**3)))
    y = {v: _host(zy_lib, k[v], gp) for v in MMA_VARIANTS}
    assert torch.equal(y["v13"], y["v14"])
    assert not torch.equal(y["v13"], y["v15"])
    assert _max_rel(y["v13"], y["v15"].double()) <= 2 * TOL[k["v15"].xp]


@pytest.mark.parametrize("v", ZYFIRST)
def test_host_build_matches_pallas(klab, zy_lib, v):  # noqa: F811
    """The g++ build of each kernel in f32 directly against the Pallas
    kernel in interpret mode on the same input (p = 2, n = 8, b = 8); vband
    on the z and y rows 1 .. npts - 2, where the Pallas tables are the
    exact ones."""
    p, n, b = 2, 8, 8
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n, 1.3 / n, 0.7 / n])
    u = np.random.default_rng(7).standard_normal(npts**3).astype(np.float32)
    y_j = _pallas(klab, v, npts, p, K1, M1, h, b, u).astype(
        np.float64).reshape((npts,) * 3)
    k = LabKernel(v, npts, p, K1, M1, h, b=b, device="cpu")
    y_h = k.unpad(_host(zy_lib, k, k.pad(torch.as_tensor(u)))).numpy()
    y_h = y_h.astype(np.float64).reshape((npts,) * 3)
    if v == "vcopy":
        assert np.array_equal(y_h, y_j)
        return
    if v == "vband":
        y_j, y_h = y_j[1:-1, 1:-1], y_h[1:-1, 1:-1]
    assert np.linalg.norm(y_h - y_j) <= 2e-6 * np.linalg.norm(y_j)


def test_smem_fits(zy_lib):
    """The chosen sub-tile of every degree, arithmetic, u-slot count and
    routine fits a block's shared memory by the routine's own count, at the
    flagship's X and at p = 8, refine 6 (X = 528).  At the flagship (p = 4,
    f32) v13-v15 keep (2, 8) with both u slots in two blocks an SM; the
    all-band routine (vcopy, vband, v16), whose shared memory does not grow
    with X, takes (8, 8), a 4x halo re-read, in two blocks an SM."""
    count = zy_lib.host_zy_smem_bytes
    for X in (272, 528):
        for p in range(1, separable_lab.MAX_DEGREE + 1):
            for xp in TOL:
                for nu in (1, 2):
                    tz, ty = separable_lab.choose_zy_tile(p, xp, nu, X, count)
                    assert (tz * ty) % (8 if xp == separable_lab.XF64
                                        else 16) == 0
                    assert count(0, p, xp, nu, tz, ty, X) <= \
                        separable_lab.SMEM_BUDGET < 227 * 1024
            for xp in (separable_lab.X3TF32, separable_lab.XF64):
                for mode in (1, 2, 4):
                    tz, ty = separable_lab.choose_zy_tile(p, xp, 2, X, count,
                                                          mode)
                    assert (tz, ty) in separable_lab.ZY_RING_TILES
                    assert count(mode, p, xp, 2, tz, ty, X) <= \
                        separable_lab.ZY_TWO_BLOCKS
    assert separable_lab.choose_zy_tile(4, separable_lab.X3TF32, 2, 272,
                                        count) == (2, 8)
    assert count(0, 4, separable_lab.X3TF32, 2, 2, 8, 272) == 93056 <= \
        separable_lab.ZY_TWO_BLOCKS
    for mode in (1, 2, 4):  # one count for the three modes, whatever X
        assert separable_lab.choose_zy_tile(4, separable_lab.X3TF32, 2, 272,
                                            count, mode) == (8, 8)
        assert count(mode, 4, separable_lab.X3TF32, 2, 8, 8, 272) == \
            count(1, 4, separable_lab.X3TF32, 1, 8, 8, 528) <= \
            separable_lab.ZY_TWO_BLOCKS
    halo = lambda tz, ty, p=4: (tz + 2 * p) * (ty + 2 * p) / (tz * ty)
    assert halo(8, 8) == 4.0 and halo(2, 8) == 10.0 and halo(4, 16) == 4.5


def test_emulated_classes():
    """Each split arithmetic's x stage, emulated in plain PyTorch on the
    grids of chip_smoke's phase 5 (p = 1, 2, 4, 7, 8; npts ~ 25), stays in
    its class; ``-s`` prints the worst per arithmetic."""
    worst = {}
    rng = np.random.default_rng(5)
    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        u = torch.as_tensor(rng.standard_normal((n * p + 1)**3),
                            dtype=torch.float32)
        for mode in ("f32", "f32h", "bf16", "bf16d"):
            k = _kernel("v15", p, n, mode)
            gp = k.pad(u)
            err = _max_rel(k.emulate(gp), k.plain(gp.to(torch.float64)))
            worst[k.xp] = max(worst.get(k.xp, 0.0), err)
    print("emulated L2b worst max rel err by precision code: "
          + ", ".join(f"{m} {e:.3e}" for m, e in worst.items()))
    assert all(worst[m] <= TOL[m] for m in worst), worst


def test_bounds_at_the_flagship():
    """At 3D Q4 refine 6 (npts 257, b = 24, X = 272, f32): v13-v16 have K2's
    bound, 0.0405 ms (bytes); vcopy the same bytes; vband 4 band outputs a
    DoF, bytes-bound too.  The design bound of v13-v15 is the x product
    over the 264^2 rows of the output layout, 20.6 GFLOP a pass, three
    passes in 3xTF32; v16's and the ablations' are the layouts' bytes."""
    from tpufem_torch.lab.resident_lab import operator_bound

    K1, M1 = global_1d_matrices(4, 64, 5)
    ks = {v: LabKernel(v, 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
          for v in ZYFIRST}
    k = ks["v15"]
    assert (k.b, k.nt, k.size, k.X) == (24, 11, 272, 272)
    bands = {"vcopy": 0, "vband": 4}
    for v, kv in ks.items():
        assert kv.bound() == operator_bound(257, 4, bands.get(v, 7))
        assert kv.bound()[1] == "bytes"
        assert abs(kv.bound()[0] - 2 * 4 * 257**3 / 3.35e9) < 1e-12
        assert kv.design_bound()[0] >= kv.bound()[0]
    flop = 2 * 264**2 * 544 * 272
    assert abs(flop - 20.6e9) < 0.05e9
    layouts_ms = (272**2 + 264**2) * 272 * 4 / 3.35e9
    for v in ("v13", "v14", "v15"):
        assert ks[v].design_bound() == (3 * flop / 495e12 * 1e3, "operations")
    for v in ("v16", "vcopy", "vband"):
        ms, by = ks[v].design_bound()
        assert by == "bytes" and abs(ms - layouts_ms) < 1e-12
    high = LabKernel("v15", 257, 4, K1, M1, [1 / 64] * 3, prec="high",
                     device="cpu")
    assert high.design_bound() == (layouts_ms, "bytes")  # one TF32 pass

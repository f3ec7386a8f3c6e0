"""The two toolchain probes (P1, P2) on the CPU: the port's plain versions
against the Pallas kernels of ``scripts/toolchain_probe.py`` in interpret
mode, a g++ build of the CUDA kernels (tpufem_torch/csrc/toolchain_probe.cuh:
P1 on both routines and P2's earlier routine one host thread a block, P2's
cluster chain one host thread a cluster) against the plain versions, the
closed form of the probe's own inputs, P1's ring plan and P2's routine
table, and the entry points' refusal without a card.

``scripts/toolchain_probe.py`` is imported by path (nothing in ``scripts/``
changes) and given its own ``pl`` whose ``pallas_call`` records ``(kernel,
kwargs)`` and returns the interpret-mode call.  P2's three kernels declare
their refs as ``(a_ref, w_ref, o_ref, v_ref, vo_ref)`` while the call has
three inputs and two outputs, so through ``pallas_call`` ``o_ref`` binds to
the input ``v`` and ``v_ref`` to the first output
(``test_co_scheduling_refs_bind_out_of_order`` pins it); the port computes
what the probe's docstring says, and the kernel bodies are held to it with
stand-in refs bound in the order of their signatures.
"""

import ctypes
import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_host import STUBS, _build
from test_torch_lab import WMMA_STUBS

from tpufem_torch.lab import toolchain_probe as tp
from tpufem_torch.lab.separable_lab import EMU_TOL, PRECS, TOL
from torch_threads import one_torch_thread  # noqa: F401

PROBE_SHIM = STUBS + WMMA_STUBS + r"""
#include <vector>

#define __grid_constant__
#include "toolchain_probe.cuh"

// P1 on wgmma: one host thread a block (hopper.cuh's host forms: a TMA box
// a loop copy with zero fill, in the 128-byte swizzle for A), each block's
// shared memory NaN-filled first (a read of what no stage wrote shows in the
// output) and checked for writes beyond it; a ring of `stages` stages (0:
// the launcher's, p1w_stages)
template <int XP, int NB>
static int mw(int n, int stages, const float* a, const float* b, float* c) {
  using namespace tpufem;
  if (stages == 0) stages = p1w_stages(XP, NB, n);
  const long long bytes = p1w_smem(XP, NB, stages).total;
  HopMap am{}, bm{};
  if (bytes > kPcSmemMax || p1w_maps(&am, &bm, a, b, n, NB)) return 3;
  for (int by = 0; by * kHopM < n; ++by)
    for (int bx = 0; bx * NB < n; ++bx) {
      std::memset(smem_raw, 0xFF, bytes);
      std::memset(smem_raw + bytes, 0xAB, 4096);
      blockIdx = Dim3{bx, by, 0};
      probe_wgmma_kernel<XP, NB>(am, bm, c, n, stages);
      for (long long i = bytes; i < bytes + 4096; ++i)
        if (smem_raw[i] != 0xAB) return 1;  // beyond its smem
    }
  return 0;
}

// the library's width, kP1wColumns
extern "C" int host_probe_matmul_wgmma(int xp, int n, int stages,
                                       const float* a, const float* b,
                                       float* c) {
  constexpr int NB = tpufem::kP1wColumns;
  switch (xp) {
    case 0: return mw<0, NB>(n, stages, a, b, c);
    case 1: return mw<1, NB>(n, stages, a, b, c);
    case 2: return mw<2, NB>(n, stages, a, b, c);
    case 4: return mw<4, NB>(n, stages, a, b, c);
  }
  return 2;
}

extern "C" int host_probe_wgmma_columns() { return tpufem::kP1wColumns; }

extern "C" int host_probe_wgmma_stages(int xp, int n) {
  return tpufem::p1w_stages(xp, tpufem::kP1wColumns, n);
}

extern "C" long long host_probe_wgmma_smem(int xp, int n) {
  constexpr int NB = tpufem::kP1wColumns;
  return tpufem::p1w_smem(xp, NB, tpufem::p1w_stages(xp, NB, n)).total;
}

template <int XP>
static int mm(int n, const float* a, const float* b, float* c) {
  const int tiles = (n / tpufem::kPT) * (n / tpufem::kPT);
  for (int blk = 0; blk * tpufem::kP1Warps < tiles; ++blk) {
    blockIdx = Dim3{blk, 0, 0};
    tpufem::probe_matmul_kernel<XP>(a, b, c, n);
  }
  return 0;
}

template <int XP, int MODE>
static int ch(int m, int n_iter, int fpp, float c1, float c2, const float* a,
              const void* w, long long w_lo, const float* v, float* o,
              float* vo) {
  using E = typename tpufem::LabMma<XP>::E;
  const long long bytes = tpufem::probe_chain_smem(m);
  for (int blk = 0; blk < m / tpufem::kP2Rows; ++blk) {
    std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
    blockIdx = Dim3{blk, 0, 0};
    tpufem::probe_chain_kernel<XP, MODE>(a, (const E*)w, w_lo, v, o, vo, m,
                                         n_iter, fpp, c1, c2);
    for (long long i = bytes; i < bytes + 4096; ++i)
      if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
  }
  return 0;
}

template <int XP>
static int ch_mode(int mode, int m, int n_iter, int fpp, float c1, float c2,
                   const float* a, const void* w, long long w_lo,
                   const float* v, float* o, float* vo) {
  switch (mode) {
    case 0: return ch<XP, 0>(m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
    case 1: return ch<XP, 1>(m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
    case 2: return ch<XP, 2>(m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
  }
  return 2;
}

// P2's cluster chain: each cluster's ranks in one host thread, each with its
// own shared-memory array (checked for overrun), hopper.cuh's host forms
// mapping a peer's address to the same offset in its array; each product's
// multiplications for every rank, then its sends (or last, its stores)
template <int XP, int MODE, int NT>
static int cl(int m, int C, int nbuf, int n_iter, int fpp, float c1, float c2,
              const float* a, const unsigned char* w, const float* v,
              float* o, float* vo) {
  using namespace tpufem;
  const PcSmem s = pc_smem(XP, m, C, nbuf);
  std::vector<std::vector<unsigned char>> sm(C);
  std::vector<PcMma<XP, NT>> mm(C);
  for (int k = 0; k < m / kPcRows; ++k) {
    for (int r = 0; r < C; ++r) {
      sm[r].assign(s.total + 4096, 0xAB);
      hop_host_cluster[r] = sm[r].data();
    }
    auto geo = [&](int r) {
      hop_host_rank = r;
      blockIdx = Dim3{k * C + r, 0, 0};
      return PcGeo{m, C, nbuf, k, r};
    };
    if (MODE == kProbeFma) {
      for (int r = 0; r < C; ++r)
        pc_fma<NT, false>(a, o, geo(r), 0, c1, c2, 0, 1);
    } else {
      for (int r = 0; r < C; ++r)
        pc_start<XP, NT>(sm[r].data(), geo(r), a, w, 0, 1);
      for (int it = 0; it < n_iter; ++it) {
        for (int r = 0; r < C; ++r) {
          const PcGeo g = geo(r);
          pc_multiply(mm[r], sm[r].data(), s, g, it, 0, 0, 0);
        }
        for (int r = 0; r < C; ++r) {
          const PcGeo g = geo(r);
          if (it == n_iter - 1)
            pc_store(mm[r], g, o, 0, 0);
          else
            pc_send(mm[r], sm[r].data(), s, g, it, 0, 0, 0);
        }
      }
    }
    for (int r = 0; r < C; ++r)
      pc_fma<NT, MODE != kProbeMma>(v, vo, geo(r), n_iter * fpp, c1, c2, 0,
                                    1);
    for (int r = 0; r < C; ++r)
      for (long long i = s.total; i < s.total + 4096; ++i)
        if (sm[r][i] != 0xAB) return 1;  // beyond its smem
  }
  return 0;
}

template <int XP, int MODE>
static int cl_tiles(int m, int C, int nbuf, int n_iter, int fpp, float c1,
                    float c2, const float* a, const unsigned char* w,
                    const float* v, float* o, float* vo) {
  switch (m / (32 * C)) {
    case 1: return cl<XP, MODE, 1>(m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 2: return cl<XP, MODE, 2>(m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
  }
  return 2;
}

template <int XP>
static int cl_mode(int mode, int m, int C, int nbuf, int n_iter, int fpp,
                   float c1, float c2, const float* a,
                   const unsigned char* w, const float* v, float* o,
                   float* vo) {
  switch (mode) {
    case 0: return cl_tiles<XP, 0>(m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 1: return cl_tiles<XP, 1>(m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 2: return cl_tiles<XP, 2>(m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
  }
  return 2;
}

// as tpufem_probe_cluster_chain: 3 where the routine does not take the plan
extern "C" int host_probe_cluster_chain(int mode, int xp, int m, int C,
                                        int nbuf, int n_iter, int fpp,
                                        float c1, float c2, const float* a,
                                        const unsigned char* w,
                                        const float* v, float* o, float* vo) {
  if (!tpufem::pc_takes(xp, m, C, nbuf)) return 3;
  switch (xp) {
    case 0: return cl_mode<0>(mode, m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 1: return cl_mode<1>(mode, m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 2: return cl_mode<2>(mode, m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
    case 4: return cl_mode<4>(mode, m, C, nbuf, n_iter, fpp, c1, c2, a, w, v, o, vo);
  }
  return 2;
}

extern "C" long long host_probe_cluster_smem(int xp, int m, int C, int nbuf) {
  if (!tpufem::pc_geometry(xp, m, C, nbuf)) return -1;
  return tpufem::pc_smem(xp, m, C, nbuf).total;
}

extern "C" int host_probe_matmul(int xp, int n, const float* a,
                                 const float* b, float* c) {
  switch (xp) {
    case 0: return mm<0>(n, a, b, c);
    case 1: return mm<1>(n, a, b, c);
    case 2: return mm<2>(n, a, b, c);
    case 4: return mm<4>(n, a, b, c);
  }
  return 2;
}

extern "C" int host_probe_chain(int mode, int xp, int m, int n_iter, int fpp,
                                float c1, float c2, const float* a,
                                const void* w, long long w_lo, const float* v,
                                float* o, float* vo) {
  switch (xp) {
    case 0: return ch_mode<0>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
    case 1: return ch_mode<1>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
    case 2: return ch_mode<2>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
    case 4: return ch_mode<4>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, vo);
  }
  return 2;
}
"""


@pytest.fixture(scope="module")
def jprobe():
    """``scripts/toolchain_probe.py`` with a recording, interpret-mode
    ``pallas_call`` (``mod.calls``: the (kernel, kwargs) of each call;
    ``mod.interpret``: the real call in interpret mode); the process's JAX
    cache setting and environment are put back after its import, which
    calls ``enable_persistent_cache()``."""
    env = dict(os.environ)
    cache = jax.config.jax_compilation_cache_dir
    min_s = jax.config.jax_persistent_cache_min_compile_time_secs
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "toolchain_probe.py")
    spec = importlib.util.spec_from_file_location("_pallas_toolchain_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
        os.environ.clear()
        os.environ.update(env)
    real = mod.pl.pallas_call
    mod.calls = []
    mod.interpret = lambda kernel, **kw: real(kernel, interpret=True, **kw)

    def recording(kernel, **kw):
        mod.calls.append((kernel, kw))
        return mod.interpret(kernel, **kw)

    # the script's own view of pallas, so the process's pl.pallas_call stays
    mod.pl = types.SimpleNamespace(**vars(mod.pl))
    mod.pl.pallas_call = recording
    return mod


class Ref:
    """A stand-in for a Pallas ref: ``ref[...]`` gets and sets an array."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        assert idx is Ellipsis
        return self.value

    def __setitem__(self, idx, value):
        assert idx is Ellipsis
        self.value = value


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def _seeded(m, seed):
    """a, w, v: (m, m) f32 from numpy; w scaled so a chain neither grows
    nor dies."""
    rng = np.random.default_rng(seed)
    a, w, v = (rng.standard_normal((m, m)).astype(np.float32)
               for _ in range(3))
    return a, (w / np.sqrt(m)).astype(np.float32), v


def test_high_precision_kernel_matches_plain(jprobe):
    """P1: the JAX probe lowers in interpret mode and reports support; its
    recorded kernel on a seeded (256, 256) pair against the port's plain
    version, f32 on both sides, 1e-5 relative."""
    jprobe.calls.clear()
    out = jprobe.probe_high_precision()
    assert out["supported"] is True, out
    (kernel, kw), = jprobe.calls
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((256, 256)).astype(np.float32)
            for _ in range(2))
    c_j = np.asarray(jprobe.interpret(kernel, **kw)(jnp.asarray(a),
                                                   jnp.asarray(b)))
    before = dict(tp.launches)
    c_t = tp.matmul(torch.as_tensor(a), torch.as_tensor(b))
    assert tp.launches == before  # CPU tensors: the plain version
    assert c_j.dtype == np.float32 and c_t.dtype == torch.float32
    assert _rel(c_t.numpy(), c_j) <= 1e-5
    ours = tp.probe_high_precision(device="cpu")
    assert ours["supported"] is True and ours["probe"] == "mma_precision_high"
    assert set(ours["max_rel_err"]) == set(tp.ARITHMETICS)


@pytest.fixture(scope="module")
def co_kernels(jprobe):
    """The JAX co-scheduling probe run once in interpret mode at (n_iter,
    m) = (3, 128); its three recorded (kernel, kwargs), in the order
    k_mxu, k_vpu, k_both."""
    jprobe.calls.clear()
    out = jprobe.probe_co_scheduling(n_iter=3, m=128)
    assert {"t_mxu_ms", "t_vpu_ms", "t_both_ms", "overlap_fraction",
            "co_scheduled"} <= set(out)
    calls = list(jprobe.calls)
    assert [k.__name__ for k, _ in calls] == ["k_mxu", "k_vpu", "k_both"]
    return calls


@pytest.mark.parametrize("i,mode", [(0, "mma"), (1, "fma"), (2, "both")])
def test_co_scheduling_bodies_match_plain(co_kernels, i, mode):
    """P2: each JAX kernel body, its refs bound in the order of its
    signature (the binding the probe's docstring means), against the
    port's plain version on the same seeded a, w, v: 1e-5 relative."""
    kernel, _ = co_kernels[i]
    a, w, v = _seeded(128, 3)
    o, vo = Ref(), Ref()
    kernel(Ref(jnp.asarray(a)), Ref(jnp.asarray(w)), o, Ref(jnp.asarray(v)),
           vo)
    before = dict(tp.launches)
    o_t, vo_t = tp.chain(mode, *(torch.as_tensor(t) for t in (a, w, v)), 3)
    assert tp.launches == before
    assert _rel(o_t.numpy(), o.value) <= 1e-5
    assert _rel(vo_t.numpy(), vo.value) <= 1e-5
    if mode == "mma":
        assert np.array_equal(vo_t.numpy(), v)
    if mode == "fma":
        assert np.array_equal(o_t.numpy(), a)


def test_co_scheduling_refs_bind_out_of_order(jprobe, co_kernels):
    """An observation about the reference: called as the script calls it
    (three inputs, two outputs), ``o_ref`` is the input ``v`` and ``v_ref``
    the first output, so neither output is ever finite.  The probe only
    times, so it does not notice."""
    a, w, v = (jnp.asarray(t) for t in _seeded(128, 3))
    for kernel, kw in co_kernels:
        o, vo = jprobe.interpret(kernel, **kw)(a, w, v)
        assert not np.isfinite(np.asarray(o)).all()
        assert not np.isfinite(np.asarray(vo)).all()


def test_closed_form_of_the_probe_inputs():
    """w = 0.999 I, a = 1e-3, v = 1: o = 1e-3 0.999^n_iter; vo follows the
    linear recurrence's closed form.  In one bf16 product 0.999 rounds to
    1, so that chain stands still at bf16(1e-3)."""
    m, n_iter = 32, 256
    a = torch.full((m, m), 1e-3, dtype=torch.float64)
    w = torch.eye(m, dtype=torch.float64) * 0.999
    v = torch.ones((m, m), dtype=torch.float64)
    o, vo = tp.chain_plain("both", a, w, v, n_iter)
    assert abs(float(o[0, 0]) / (1e-3 * 0.999**n_iter) - 1) < 1e-12
    steps = 4 * n_iter
    exact = tp.C1**steps + tp.C2 * (tp.C1**steps - 1) / (tp.C1 - 1)
    assert abs(float(vo[3, 5]) / exact - 1) < 1e-12
    o32, vo32 = tp.chain("both", a.float(), w.float(), v.float(), n_iter)
    assert _rel(o32.numpy(), o.numpy()) <= 1e-5
    assert _rel(vo32.numpy(), vo.numpy()) <= 1e-4  # 1024 f32 roundings
    for arithmetic, tol in (("highest", 1e-4), ("bf16x3", 1e-3)):
        oe, _ = tp.chain_plain("mma", a.float(), w.float(), v.float(),
                               n_iter, arithmetic=arithmetic)
        assert _rel(oe.numpy(), o.numpy()) <= tol
    od, _ = tp.chain_plain("mma", a.float(), w.float(), v.float(), n_iter,
                           arithmetic="default")
    assert torch.equal(od, a.float().bfloat16().float())


def test_probes_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.probe_high_precision()  # the card is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.probe_co_scheduling(n_iter=2, m=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.main()
    a = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="arithmetic"):
        tp.matmul(a, a, "fp8")
    with pytest.raises(ValueError, match="multiple of 16"):
        tp.matmul(torch.zeros((8, 8)), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="float32"):
        tp.chain("mma", a.double(), a, a, 1)
    with pytest.raises(ValueError, match="mode"):
        tp.chain("vpu", a, a, a, 1)


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "probe_host", PROBE_SHIM)
    lib.host_probe_matmul.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.host_probe_matmul.restype = ctypes.c_int
    lib.host_probe_chain.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong] + [ctypes.c_void_p] * 3)
    lib.host_probe_chain.restype = ctypes.c_int
    lib.host_probe_cluster_chain.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5)
    lib.host_probe_cluster_chain.restype = ctypes.c_int
    lib.host_probe_cluster_smem.argtypes = [ctypes.c_int] * 4
    lib.host_probe_cluster_smem.restype = ctypes.c_longlong
    lib.host_probe_matmul_wgmma.argtypes = ([ctypes.c_int] * 3
                                            + [ctypes.c_void_p] * 3)
    lib.host_probe_matmul_wgmma.restype = ctypes.c_int
    lib.host_probe_wgmma_columns.argtypes = []
    lib.host_probe_wgmma_columns.restype = ctypes.c_int
    lib.host_probe_wgmma_stages.argtypes = [ctypes.c_int] * 2
    lib.host_probe_wgmma_stages.restype = ctypes.c_int
    lib.host_probe_wgmma_smem.argtypes = [ctypes.c_int] * 2
    lib.host_probe_wgmma_smem.restype = ctypes.c_longlong
    return lib


def _product_host(lib, routine, xp, a, b, stages=0):
    """P1's product in the host build into a NaN-filled output with two
    guard rows (the wgmma routine on a ring of ``stages``, 0: its plan's);
    (the kernel's rc, c, the guard rows)."""
    n = a.shape[0]
    buf = torch.full(((n + 2) * n,), float("nan"))
    if routine == "earlier":
        rc = lib.host_probe_matmul(xp, n, a.data_ptr(), b.data_ptr(),
                                   buf.data_ptr())
    else:
        rc = lib.host_probe_matmul_wgmma(xp, n, stages, a.data_ptr(),
                                         b.data_ptr(), buf.data_ptr())
    return rc, buf[:n * n].view(n, n), buf[n * n:]


def _off_plain_tol(routine, xp):
    """The bound on max |c - plain| / max |c|: the wgmma routine's own
    (``P1_PLAIN_TOL``, or EMU_TOL where smaller), the earlier routine's
    EMU_TOL."""
    if routine == "earlier":
        return EMU_TOL[xp]
    return min(EMU_TOL[xp], tp.P1_PLAIN_TOL)


@pytest.mark.parametrize("arithmetic", tp.ARITHMETICS)
@pytest.mark.parametrize("n", [48, 64, 144])
@pytest.mark.parametrize("routine", tp.P1_ROUTINES)
def test_host_build_of_the_product_matches_plain(probe_lib, routine, n,
                                                 arithmetic):
    """P1's kernel (g++ build) on each routine in each arithmetic: the
    earlier one (WMMA stub) and the wgmma tile (hopper.cuh's host forms,
    one host thread a block, its shared memory NaN-filled and checked for
    overrun) at n = 48 (a partial 64-row tile, one chunk of k with zeros
    past n), 64 and 144 (three chunks, partial tiles both ways), against
    the f64 product (its class) and the plain version in that arithmetic
    (the wgmma tile within ``P1_PLAIN_TOL``); every output point written
    and none past n; ones give n exactly."""
    xp = PRECS[arithmetic]
    a, b, _ = (torch.as_tensor(t) for t in _seeded(n, 11))
    rc, c, guard = _product_host(probe_lib, routine, xp, a, b)
    assert rc == 0, "a block wrote beyond its shared memory"
    assert torch.isnan(guard).all()
    ref = a.double() @ b.double()
    assert _rel(c.numpy(), ref.numpy()) <= TOL[xp]
    emu = tp.matmul_plain(a, b, arithmetic)
    assert float((c - emu).abs().max() / ref.abs().max()) <= \
        _off_plain_tol(routine, xp)
    ones = torch.ones((n, n))
    rc, c, _ = _product_host(probe_lib, routine, xp, ones, ones)
    assert rc == 0
    assert torch.equal(c, torch.full((n, n), float(n)))


@pytest.mark.parametrize("arithmetic", tp.ARITHMETICS)
@pytest.mark.parametrize("n,stages", [(144, 2), (208, 2), (208, 3)])
def test_host_build_of_the_wgmma_ring_reuses_stages(probe_lib, n, stages,
                                                    arithmetic):
    """The wgmma routine on a ring of fewer stages than chunks of k (on the
    card 3xTF32 from n = 576 on, every arithmetic from n = 704): a stage refilled once the
    products of its chunk are done, against the f64 product and the plain
    version in that arithmetic, and bit for bit the routine's own ring."""
    xp = PRECS[arithmetic]
    a, b, _ = (torch.as_tensor(t) for t in _seeded(n, 17))
    rc, c, guard = _product_host(probe_lib, "wgmma", xp, a, b, stages)
    assert rc == 0 and torch.isnan(guard).all()
    ref = a.double() @ b.double()
    assert _rel(c.numpy(), ref.numpy()) <= TOL[xp]
    emu = tp.matmul_plain(a, b, arithmetic)
    assert float((c - emu).abs().max() / ref.abs().max()) <= \
        _off_plain_tol("wgmma", xp)
    _, own, _ = _product_host(probe_lib, "wgmma", xp, a, b)
    assert torch.equal(c, own)


def test_wgmma_product_plan(probe_lib):
    """The wgmma routine's ring at every n from 16 to 2048 in each
    arithmetic: a block within 227 KB, every chunk of 64 k in flight at
    once to n = 512 and at least three stages past it; its width the
    header's; its design bound at n = 256, one block's bytes at the card's
    memory rate and its dependent wgmmas at one SM's share of the
    tensor-core peak."""
    assert probe_lib.host_probe_wgmma_columns() == tp.P1_COLUMNS
    stages, smem = probe_lib.host_probe_wgmma_stages, \
        probe_lib.host_probe_wgmma_smem
    for arithmetic in tp.ARITHMETICS:
        xp = PRECS[arithmetic]
        for n in range(16, 2049, 16):
            chunks, s = -(-n // 64), stages(xp, n)
            assert s == chunks or (n > 512 and 3 <= s < chunks), \
                (arithmetic, n)
            assert 0 < smem(xp, n) <= tp.SMEM_LIMIT
    # bf16x3: 24 KB a stage (A 16, B 4, its two bf16 parts 2 each), four
    # stages and 1 KB each of alignment and barriers
    assert smem(PRECS["bf16x3"], 256) == 4 * 24576 + 1024 + 128
    peak = {"bf16": 989e12, "tf32": 495e12}
    for arithmetic, mma, passes in (("bf16x3", "bf16", 3),
                                    ("highest", "tf32", 3),
                                    ("high", "tf32", 1),
                                    ("default", "bf16", 1)):
        nbytes = 4 * (64 * 256 + 256 * 16 + 64 * 16)
        chain = passes * 2.0 * 64 * 16 * 256 * 132 / peak[mma]
        want = 1e3 * (nbytes / 3.35e12 + chain)
        assert abs(tp.p1_design_bound(256, arithmetic) - want) < 1e-12
    assert abs(tp.p1_design_bound(256, "bf16x3") - 0.000236) < 1e-6


def test_product_routines_on_the_cpu():
    """``matmul`` takes routine "wgmma" (the default) or "earlier", refuses
    any other, and on CPU tensors runs the plain version whichever is
    named, its launch count untouched."""
    import inspect

    params = inspect.signature(tp.matmul).parameters
    assert params["routine"].default == "wgmma" == tp.P1_ROUTINES[0]
    a, b, _ = (torch.as_tensor(t) for t in _seeded(48, 13))
    before = dict(tp.launches)
    ref = tp.matmul_plain(a, b)
    for routine in tp.P1_ROUTINES:
        for arithmetic in tp.ARITHMETICS:
            c = tp.matmul(a, b, arithmetic, routine=routine)
            assert torch.equal(c, ref)
    assert tp.launches == before
    with pytest.raises(ValueError, match="routine"):
        tp.matmul(a, b, routine="wmma")


@pytest.mark.parametrize("arithmetic", tp.ARITHMETICS)
@pytest.mark.parametrize("mode", list(tp.MODES))
def test_host_build_of_the_chains_matches_plain(probe_lib, mode, arithmetic):
    """P2's three kernels (g++ build: one host thread plays both warp
    teams) in each arithmetic at (n_iter, m, fpp) = (3, 32, 5): the product
    chain against the f64 chain (n_iter times its class) and against the
    plain version in that arithmetic; the multiply-add chain against f64;
    the stream a kernel does not run is copied through exactly."""
    m, n_iter, fpp, xp = 32, 3, 5, PRECS[arithmetic]
    a, w, v = (torch.as_tensor(t) for t in _seeded(m, 5))
    w_op, w_lo = tp.w_operand(w, arithmetic)
    o, vo = (torch.full((m, m), float("nan")) for _ in range(2))
    rc = probe_lib.host_probe_chain(
        tp.MODES[mode], xp, m, n_iter, fpp, tp.C1, tp.C2, a.data_ptr(),
        w_op.data_ptr(), w_lo, v.data_ptr(), o.data_ptr(), vo.data_ptr())
    assert rc == 0, "kernel wrote beyond its shared memory"
    o64, vo64 = tp.chain_plain(mode, a.double(), w.double(), v.double(),
                               n_iter, fpp)
    if mode == "fma":
        assert torch.equal(o, a)
    else:
        assert _rel(o.numpy(), o64.numpy()) <= n_iter * TOL[xp]
        oe, _ = tp.chain_plain("mma", a, w, v, n_iter, arithmetic=arithmetic)
        assert float((o - oe).abs().max() / o64.abs().max()) <= \
            n_iter * EMU_TOL[xp]
    if mode == "mma":
        assert torch.equal(vo, v)
    else:
        # each step: one f32 rounding, and the constants rounded to f32
        assert _rel(vo.numpy(), vo64.numpy()) <= n_iter * fpp * 2.0**-23


def test_host_build_closed_form(probe_lib):
    """The probe's own inputs through the g++ build of ``both`` in 3xTF32:
    o = 1e-3 0.999^n_iter to 1e-4 over 64 products."""
    m, n_iter = 16, 64
    a = torch.full((m, m), 1e-3)
    w = torch.eye(m) * 0.999
    v = torch.ones((m, m))
    o, vo = torch.empty((m, m)), torch.empty((m, m))
    assert probe_lib.host_probe_chain(
        2, PRECS["highest"], m, n_iter, 4, tp.C1, tp.C2, a.data_ptr(),
        w.data_ptr(), 0, v.data_ptr(), o.data_ptr(), vo.data_ptr()) == 0
    assert _rel(o.numpy(), np.full((m, m), 1e-3 * 0.999**n_iter)) <= 1e-4
    steps = 4 * n_iter
    exact = tp.C1**steps + tp.C2 * (tp.C1**steps - 1) / (tp.C1 - 1)
    assert _rel(vo.numpy(), np.full((m, m), exact)) <= 1e-4


CLUSTER_CASES = [(m, C, nbuf, n_iter) for m, C in ((64, 2), (128, 4))
                 for nbuf in (2, 1) for n_iter in (1, 3)]


def _cluster_host(lib, mode, arithmetic, a, w, v, n_iter, C, nbuf, fpp=5):
    """P2's cluster chain in the host build into NaN-filled outputs; the
    kernel's rc (1: a rank wrote beyond its shared memory)."""
    m = a.shape[0]
    w_op, _ = tp.w_operand(w, arithmetic, C)
    o, vo = (torch.full((m, m), float("nan")) for _ in range(2))
    rc = lib.host_probe_cluster_chain(
        tp.MODES[mode], PRECS[arithmetic], m, C, nbuf, n_iter, fpp, tp.C1,
        tp.C2, a.data_ptr(), w_op.data_ptr(), v.data_ptr(), o.data_ptr(),
        vo.data_ptr())
    return rc, o, vo


@pytest.mark.parametrize("arithmetic", tp.ARITHMETICS)
@pytest.mark.parametrize("mode", list(tp.MODES))
@pytest.mark.parametrize("m,C,nbuf,n_iter", CLUSTER_CASES)
def test_host_build_of_the_cluster_chain_matches_plain(probe_lib, m, C, nbuf,
                                                      n_iter, mode,
                                                      arithmetic):
    """P2's cluster chain (g++ build: a cluster's ranks in one host thread,
    each product's multiplications for every rank before its sends, a
    remote write a copy into the peer's array) at m = 64 on clusters of 2
    and m = 128 on clusters of 4, with two stripe buffers and with one,
    after 1 and 3 products, in each arithmetic: as the earlier routine's
    host test holds it (the product chain against the f64 chain and the
    plain version in its arithmetic, n_iter times their classes; the
    multiply-adds against f64; the other stream copied through exactly),
    every output point written, no rank beyond its shared memory."""
    fpp, xp = 5, PRECS[arithmetic]
    a, w, v = (torch.as_tensor(t) for t in _seeded(m, 5))
    rc, o, vo = _cluster_host(probe_lib, mode, arithmetic, a, w, v, n_iter,
                              C, nbuf, fpp)
    assert rc == 0, "a rank wrote beyond its shared memory"
    o64, vo64 = tp.chain_plain(mode, a.double(), w.double(), v.double(),
                               n_iter, fpp)
    if mode == "fma":
        assert torch.equal(o, a)
    else:
        assert _rel(o.numpy(), o64.numpy()) <= n_iter * TOL[xp]
        oe, _ = tp.chain_plain("mma", a, w, v, n_iter, arithmetic=arithmetic)
        assert float((o - oe).abs().max() / o64.abs().max()) <= \
            n_iter * EMU_TOL[xp]
    if mode == "mma":
        assert torch.equal(vo, v)
    else:
        assert _rel(vo.numpy(), vo64.numpy()) <= n_iter * fpp * 2.0**-23


@pytest.mark.parametrize("m,C", [(64, 2), (128, 4)])
def test_host_build_cluster_closed_form(probe_lib, m, C):
    """The probe's own inputs through the cluster chain's host build in
    3xTF32 (one stripe buffer: the plan at m = 512 in the split
    arithmetics): o = 1e-3 0.999^n_iter to 1e-4 over 64 products, vo its
    closed form; mma copies v through and fma a, bit for bit; no rank beyond
    its shared memory."""
    n_iter = 64
    a = torch.full((m, m), 1e-3)
    w = torch.eye(m) * 0.999
    v = torch.ones((m, m))
    out = {mode: _cluster_host(probe_lib, mode, "highest", a, w, v, n_iter,
                               C, 1, 4) for mode in tp.MODES}
    assert all(rc == 0 for rc, _, _ in out.values())
    _, o, vo = out["both"]
    assert _rel(o.numpy(), np.full((m, m), 1e-3 * 0.999**n_iter)) <= 1e-4
    steps = 4 * n_iter
    exact = tp.C1**steps + tp.C2 * (tp.C1**steps - 1) / (tp.C1 - 1)
    assert _rel(vo.numpy(), np.full((m, m), exact)) <= 1e-4
    assert torch.equal(out["mma"][2], v) and torch.equal(out["fma"][1], a)
    assert torch.equal(out["mma"][1], o) and torch.equal(out["fma"][2], vo)


def test_routine_table(probe_lib):
    """Which (arithmetic, m) runs which routine: ``chain_routine``'s table
    against the plans the cluster chain's own count allows at every m from
    16 to 1040; at m = 512 one bf16 pass on clusters of 8 with two stripe
    buffers, 1xTF32 and bf16x3 on clusters of 16 with one, every one of
    them 196,736 bytes a block, and 3xTF32 on the earlier routine (262,272
    bytes at C = 16); the card's active clusters move a plan to the next C
    only where the first leaves a cluster for a second wave."""
    count = probe_lib.host_probe_cluster_smem
    for arithmetic in tp.ARITHMETICS:
        for m in range(16, 1041, 16):
            plan = tp.cluster_plan(arithmetic, m, count)
            assert tp.chain_routine(arithmetic, m) == (
                "earlier" if plan is None else "cluster"), (arithmetic, m)
    plans = {x: tp.cluster_plan(x, 512, count) for x in tp.ARITHMETICS}
    assert plans == {"default": (8, 2), "high": (16, 1), "bf16x3": (16, 1),
                     "highest": None}
    for x, plan in plans.items():
        if plan is not None:
            assert count(PRECS[x], 512, *plan) == 196736 <= tp.SMEM_LIMIT
    assert count(PRECS["highest"], 512, 16, 1) == 262272 > tp.SMEM_LIMIT
    assert [tp.chain_routine("highest", m) for m in (256, 512)] == \
        ["cluster", "earlier"]
    assert tp.chain_routine("default", 96) == "earlier"
    assert tp.chain_routine("default", 1024) == "earlier"
    assert count(PRECS["default"], 96, 2, 2) == -1  # no geometry
    assert count(PRECS["default"], 64, 1, 2) == -1  # clusters of 2 and up
    few = lambda C, nbuf: 7 if C == 8 else 8
    assert tp.cluster_plan("default", 512, count, few) == (16, 2)
    assert tp.cluster_plan("bf16x3", 512, count, few) == (16, 1)
    assert tp.cluster_plan("high", 512, count, lambda C, nbuf: 6) == (16, 1)


def test_routines_on_the_cpu(monkeypatch):
    """``chain`` takes routine "cluster" or "earlier" (None: the table's),
    refuses any other, and on CPU tensors runs the plain version whichever
    is named, its launch counters untouched; the cluster layout of w holds
    each block's columns in wgmma's K-major B operand."""
    a, w, v = (torch.as_tensor(t) for t in _seeded(64, 7))
    before = dict(tp.launches)
    ref = tp.chain_plain("both", a, w, v, 2)
    for routine in (None, "cluster", "earlier"):
        o, vo = tp.chain("both", a, w, v, 2, routine=routine)
        assert torch.equal(o, ref[0]) and torch.equal(vo, ref[1])
    assert tp.launches == before
    with pytest.raises(ValueError, match="routine"):
        tp.chain("mma", a, w, v, 1, routine="tile")
    # the design bound: the products on the grid's blocks, 68.7 GFLOP at
    # (256, 512) in one bf16 pass, 0.143 ms on 64 SMs and 0.072 on 128; a
    # grid of 128 blocks in two waves (7 clusters of 16 at once) takes as
    # long as 64 blocks in one
    flop = 2.0 * 256 * 512**3
    assert abs(flop - 68.7e9) < 0.05e9
    for sms in (64, 128):
        ms, by = tp.design_bound(256, 512, 4, "default", sms)
        assert by == "operations"
        assert abs(ms - flop * 132 / sms / 989e12 * 1e3) < 1e-12
    assert abs(tp.design_bound(256, 512, 4, "bf16x3", 128)[0]
               - 3 * flop * 132 / 128 / 989e12 * 1e3) < 1e-12
    assert abs(tp.design_bound(256, 512, 4, "bf16x3", 128, 2)[0]
               - 3 * flop * 132 / 64 / 989e12 * 1e3) < 1e-12
    # w in the cluster layout: block r's columns r m/C .., K-major core
    # matrices of 8 columns by 16 bytes of k (hopper.cuh's hop_b_offset)
    m, C = 64, 2
    for arithmetic, esize in (("default", 2), ("high", 4)):
        op, lo = tp.w_operand(w, arithmetic, C)
        assert lo == 0 and op.numel() == m * m
        raw = op.view(torch.uint8).numpy()
        kbytes, ncb = m * esize, m // C
        ref = w.to(torch.bfloat16) if esize == 2 else tp.w_operand(
            w, "high")[0]
        for r, n, k in ((0, 0, 0), (1, 5, 17), (1, 31, 63), (0, 9, 40)):
            kb = k * esize
            off = (r * ncb * kbytes + ((n >> 3) * (kbytes >> 4) + (kb >> 4))
                   * 128 + (n & 7) * 16 + (kb & 15))
            got = torch.from_numpy(raw[off:off + esize].copy()).view(
                ref.dtype)
            want = ref[k, r * ncb + n]
            if esize == 4:  # 1xTF32: w rounded to TF32 on the host
                from tpufem_torch.lab.resident_lab import tf32
                want = tf32(want.reshape(1))[0]
            assert got.item() == want.item()


def test_probe_sweep_edits_and_refusal(monkeypatch):
    """The probe sweep's ablations still find their text in the sources,
    once each (``build.edited_csrc`` raises otherwise), change only
    toolchain_probe.cuh, and the sweep raises without a card."""
    from tpufem_torch.lab import probe_sweep
    from tpufem_torch.utils.build import CSRC, edited_csrc

    for name, edits in probe_sweep.VARIANTS.items():
        src = edited_csrc(edits, name)
        for fname, text in src.items():
            same = text == (CSRC / fname).read_text()
            assert same == (fname not in edits), (name, fname)
    with pytest.raises(RuntimeError, match="once"):
        edited_csrc({"toolchain_probe.cuh": [("no such text", "")]}, "gone")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_sweep.main()


@pytest.mark.parametrize("m, C, active, sms, waves", [
    (512, 8, 16, 64, 1),    # one bf16 pass: all 8 stripes at once
    (512, 16, 7, 112, 2),   # 1xTF32, bf16x3 on an H100: 7 of 8 at once
    (256, 4, 33, 16, 1),
    (512, 16, 3, 48, 3),
])
def test_cluster_waves(m, C, active, sms, waves):
    """The cluster chain's SMs at once and waves from the clusters the card
    holds; a card that holds none is refused."""
    assert tp.cluster_waves(m, C, active) == (sms, waves)
    with pytest.raises(ValueError, match="no cluster"):
        tp.cluster_waves(m, C, 0)

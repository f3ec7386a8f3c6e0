"""Builds the port's CUDA kernels with ``nvcc`` and loads them via ctypes.

The sources under ``tpufem_torch/csrc`` have a plain C interface, so they
compile in seconds without PyTorch's headers, one library per ``.cu``, all
at the same time:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 -ldl \
         -o build/tpufem_torch/tpufem_torch_<name>_<hash>.so csrc/<name>.cu

The build runs at first use, into ``build/tpufem_torch/`` beside the
package, each library keyed on a hash of its source, the headers it
includes and the flags, so an unchanged checkout reuses its libraries and
an edited source rebuilds only the libraries that include it.  ``nvcc`` is
found through ``CUDA_HOME`` (PyTorch's lookup).  A build or load that fails
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpufem_torch"
# one shared library per source, built side by side: name -> (source,
# the csrc/ headers it includes, which enter its hash)
SOURCES = {
    "separable_apply": ("separable_apply.cu",  # K2: z-march, tile routine
                        ("common.cuh", "separable_apply.cuh")),
    # K1, K3 and K4 on the TMA ring
    "resident_ring": ("resident_ring.cu",
                      ("band_ring.cuh", "common.cuh", "hopper.cuh",
                       "resident_ring.cuh")),
    # the K1 kernel lab (L1: v17-v20, on the ring routines and the tile
    # routine)
    "lab_resident": ("lab_resident.cu",
                     ("common.cuh", "hopper.cuh", "lab_mma.cuh",
                      "lab_resident.cuh", "lab_resident_ring.cuh")),
    # the K2 kernel lab's x-first half (L2a: v2, v3, v6, v8, v9, v12, vx,
    # vxy; v3's earlier schedule)
    "lab_separable": ("lab_separable.cu",
                      ("common.cuh", "hopper.cuh", "lab_mma.cuh",
                       "lab_separable.cuh")),
    # its v3 on the TMA ring with wgmma y/z products, vxy's dense x ring
    # feeding wgmma y products and v2's (v6's, v8's) feeding v3's y and z
    # products down a z segment (their default routines)
    "lab_separable_ring": ("lab_separable_ring.cu",
                           ("common.cuh", "hopper.cuh", "lab_mma.cuh",
                            "lab_separable_ring.cuh")),
    # its v12 on v2's dense x ring feeding band y and z stages (its default
    # routine): a library of its own, built beside lab_separable_ring's
    "lab_separable_band": ("lab_separable_band.cu",
                           ("common.cuh", "hopper.cuh", "lab_mma.cuh",
                            "lab_separable_ring.cuh")),
    # its z/y-first half (L2b: v13, v14, v15, v16, vcopy, vband), on L1's
    # device functions and ring routines
    "lab_zyfirst": ("lab_zyfirst.cu",
                    ("band_ring.cuh", "common.cuh", "hopper.cuh",
                     "lab_mma.cuh", "lab_resident.cuh",
                     "lab_resident_ring.cuh", "lab_zyfirst.cuh")),
    # the toolchain probes (P1, P2: the cluster chain and its earlier
    # routine)
    "toolchain_probe": ("toolchain_probe.cu",
                        ("hopper.cuh", "lab_mma.cuh", "toolchain_probe.cuh")),
}
# --split-compile=0 spreads nvcc's optimisation passes over every core of
# the host (the lab libraries' instances are the longest builds)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0", "-ldl")
# ctypes signatures of each library's C entries: name -> (argtypes, restype)
_I, _P, _LL, _F = (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_float)
_ENTRIES = {
    "separable_apply": {
        "tpufem_separable_march": ([_I] * 7 + [_P] * 4, _I),
        "tpufem_march_blocks_per_sm": ([_I] * 5, _I),
        "tpufem_march_cols": ([_I] * 3, _I),
        "tpufem_march_smem_elems": ([_I] * 4, _LL),
        "tpufem_separable_apply": ([_I] * 7 + [_P] * 4, _I),
        "tpufem_smem_elems": ([_I] * 5, _LL)},
    "resident_ring": {
        "tpufem_ring_apply": ([_I] * 13 + [_P] * 5, _I),
        "tpufem_ring_blocks_per_sm": ([_I] * 7, _I),
        "tpufem_ring_smem_bytes": ([_I] * 6, _LL),
        "tpufem_ring_takes": ([_I] * 4, _I)},
    "lab_resident": {
        "tpufem_lab_apply": ([_I] * 11 + [_P] * 7, _I),
        "tpufem_lab_smem_bytes": ([_I] * 6, _LL),
        "tpufem_lab_ring_apply": ([_I] * 16 + [_P] * 6, _I),
        "tpufem_lab_ring_blocks_per_sm": ([_I] * 9, _I),
        "tpufem_lab_ring_smem_bytes": ([_I] * 8, _LL),
        "tpufem_lab_window_smem_bytes": ([_I] * 6, _LL)},
    "lab_separable": {
        "tpufem_l2_apply": ([_I] * 8 + [_P] * 3 + [_LL, _P, _LL, _P, _LL, _P,
                                                   _P], _I),
        "tpufem_l2_smem_bytes": ([_I] * 4, _LL)},
    "lab_separable_ring": {
        "tpufem_l2_ring_apply": ([_I] * 8 + [_P] * 5, _I),
        "tpufem_l2_ring_smem_bytes": ([_I] * 3, _LL),
        "tpufem_l2_ring_k": ([_I] * 2, _I),
        "tpufem_l2_ring_xy_apply": ([_I] * 7 + [_P] * 3 + [_LL] + [_P] * 2,
                                    _I),
        "tpufem_l2_ring_xy_smem_bytes": ([_I] * 2, _LL),
        "tpufem_l2_ring_xyz_apply": ([_I] * 8 + [_P] * 3 + [_LL] + [_P] * 2,
                                     _I),
        "tpufem_l2_ring_xyz_smem_bytes": ([_I] * 2, _LL)},
    "lab_separable_band": {
        "tpufem_l2_ring_xyzb_apply": ([_I] * 8 + [_P] * 3 + [_LL] + [_P] * 2,
                                      _I),
        "tpufem_l2_ring_xyzb_smem_bytes": ([_I] * 2, _LL),
        "tpufem_l2_ring_xyzb_k": ([_I], _I),
        "tpufem_l2_ring_xyzb_window_regs": ([_I] * 2, _I)},
    "lab_zyfirst": {
        "tpufem_zy_apply": ([_I] * 10 + [_P] * 6, _I),
        "tpufem_zy_smem_bytes": ([_I] * 7, _LL),
        "tpufem_zy_ring_takes": ([_I] * 3, _I),
        "tpufem_zy_lr_apply": ([_I] * 14 + [_P] * 6, _I),
        "tpufem_zy_lr_blocks_per_sm": ([_I] * 9, _I),
        "tpufem_zy_lr_smem_bytes": ([_I] * 8, _LL)},
    "toolchain_probe": {
        "tpufem_probe_matmul": ([_I] * 2 + [_P] * 4, _I),
        "tpufem_probe_matmul_wgmma": ([_I] * 2 + [_P] * 4, _I),
        "tpufem_probe_wgmma_columns": ([], _I),
        "tpufem_probe_wgmma_stages": ([_I] * 2, _I),
        "tpufem_probe_wgmma_smem": ([_I] * 2, _LL),
        "tpufem_probe_chain": ([_I] * 5 + [_F] * 2 + [_P] * 2 + [_LL]
                               + [_P] * 4, _I),
        "tpufem_probe_cluster_active": ([_I] * 5, _I),
        "tpufem_probe_cluster_chain": ([_I] * 7 + [_F] * 2 + [_P] * 6, _I),
        "tpufem_probe_cluster_smem": ([_I] * 4, _LL)},
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    compiler_log: str  # nvcc/ptxas output (registers, spills per kernel)

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry returned a non-zero ``cudaError_t``."""
        if code != 0:
            msg = self.lib.tpufem_cuda_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def ptxas_lines(log: str, key: str) -> list[str]:
    """'<kernel>: N registers, S bytes spill stores' for each kernel of a
    build's ptxas log (``KernelLibrary.compiler_log``) whose mangled name
    holds ``key``, and each warning that ptxas serialised a ``wgmma``."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and key in name:
            out.append(f"{name}: {m.group(1)} registers, {spills} bytes "
                       "spill stores")
        if "wgmma" in line and ("C7520" in line or "serializ" in line):
            out.append(line.strip())
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the tpufem_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest(source: str, headers: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(jobs: dict) -> dict[object, tuple[str, float]]:
    """Run one ``nvcc`` for each ``{key: (source .cu, output .so)}``, all
    at the same time; {key: (compiler log, seconds)}.  Raises if one fails,
    and leaves no compiler running when a build or a wait fails."""
    if not jobs:
        return {}
    nvcc = _nvcc()
    procs, done = {}, {}
    t0 = time.perf_counter()
    try:
        for key, (src, out) in jobs.items():
            Path(out).parent.mkdir(parents=True, exist_ok=True)
            procs[key] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, proc in procs.items():
            done[key] = (proc.communicate()[0], time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for key, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {jobs[key][0]} failed "
                               f"({proc.returncode}):\n{done[key][0]}")
    return done


def _bind(name: str, path: Path, seconds: float, log: str) -> KernelLibrary:
    """Load the library ``path`` built from ``SOURCES[name]``'s source and
    give its C entries their ctypes signatures."""
    lib = ctypes.CDLL(str(path))
    for entry, (argtypes, restype) in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, seconds, log)


@functools.cache
def load_kernels() -> dict[str, KernelLibrary]:
    """Build (if needed) and load every kernel library, by name of
    ``SOURCES``; the missing ones compile at the same time, one ``nvcc``
    each.  Cached for the life of the process."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tpufem_torch kernels need a CUDA device")
    outs = {name: BUILD_DIR / f"tpufem_torch_{name}_{_digest(*src)}.so"
            for name, src in SOURCES.items()}
    # built under a name of this process's, then moved into place
    # atomically: concurrent builders never see half a library
    tmps = {name: out.with_suffix(f".{os.getpid()}.tmp")
            for name, out in outs.items() if not out.exists()}
    done = _compile({name: (CSRC / SOURCES[name][0], tmp)
                     for name, tmp in tmps.items()})
    for name, tmp in tmps.items():
        os.replace(tmp, outs[name])
    libs = {}
    for name, out in outs.items():
        log, seconds = done.get(name, ("", 0.0))
        libs[name] = _bind(name, out, seconds, log)
    return libs


def edited_csrc(edits: dict, what: str) -> dict[str, str]:
    """{file: text} of every source under ``CSRC`` with ``edits`` ({file:
    [(text, replacement), ...]}) applied; each text must occur exactly
    once in its file, else it raises, naming ``what``."""
    out = {}
    for path in CSRC.iterdir():
        text = path.read_text()
        for old, new in edits.get(path.name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"{what}: {path.name} holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        out[path.name] = text
    return out


def build_copies(copies: dict) -> dict[Path, dict[str, KernelLibrary]]:
    """Build edited copies of the sources, a sweep's variants, all at the
    same time: ``{directory (Path): ({file: text}, library names)}`` writes
    each directory afresh and builds its libraries (names of ``SOURCES``) there;
    returns {directory: {name: KernelLibrary}}."""
    jobs = {}
    for d, (sources, names) in copies.items():
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in sources.items():
            (d / fname).write_text(text)
        for name in names:
            jobs[d, name] = (d / SOURCES[name][0], d / f"{name}.so")
    done = _compile(jobs)
    return {d: {name: _bind(name, d / f"{name}.so", 0.0, done[d, name][0])
                for name in names}
            for d, (_, names) in copies.items()}

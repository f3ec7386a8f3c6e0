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
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpufem_torch"
# one shared library per source, built side by side: name -> (source,
# the csrc/ headers it includes, which enter its hash)
SOURCES = {
    "separable_apply": ("separable_apply.cu",  # K2
                        ("common.cuh", "separable_apply.cuh")),
    "terms_apply": ("terms_apply.cu",  # K3
                    ("common.cuh", "terms_apply.cuh")),
    # K1 and K4 on the TMA ring
    "resident_ring": ("resident_ring.cu",
                      ("band_ring.cuh", "common.cuh", "hopper.cuh",
                       "resident_ring.cuh")),
    "lab_resident": ("lab_resident.cu",  # the K1 kernel lab (L1: v17-v20)
                     ("common.cuh", "lab_mma.cuh", "lab_resident.cuh")),
    # the K2 kernel lab's x-first half (L2a: v2, v3, v6, v8, v9, v12, vx,
    # vxy)
    "lab_separable": ("lab_separable.cu",
                      ("common.cuh", "hopper.cuh", "lab_mma.cuh",
                       "lab_separable.cuh")),
    # its z/y-first half (L2b: v13, v14, v15, v16, vcopy, vband), on L1's
    # device functions
    "lab_zyfirst": ("lab_zyfirst.cu",
                    ("band_ring.cuh", "common.cuh", "hopper.cuh",
                     "lab_mma.cuh", "lab_resident.cuh", "lab_zyfirst.cuh")),
    # the toolchain probes (P1, P2)
    "toolchain_probe": ("toolchain_probe.cu",
                        ("lab_mma.cuh", "toolchain_probe.cuh")),
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
        "tpufem_separable_apply": ([_I] * 7 + [_P] * 4, _I),
        "tpufem_smem_elems": ([_I] * 5, _LL)},
    "terms_apply": {
        "tpufem_terms_apply": ([_I] * 6 + [_P] * 4, _I),
        "tpufem_terms_smem_elems": ([_I] * 4, _LL)},
    "resident_ring": {
        "tpufem_resident_apply": ([_I] * 11 + [_P] * 5, _I),
        "tpufem_resident_smem_bytes": ([_I] * 5, _LL),
        "tpufem_resident_takes": ([_I] * 3, _I)},
    "lab_resident": {
        "tpufem_lab_apply": ([_I] * 11 + [_P] * 7, _I),
        "tpufem_lab_smem_bytes": ([_I] * 6, _LL)},
    "lab_separable": {
        "tpufem_l2_apply": ([_I] * 8 + [_P] * 3 + [_LL, _P, _LL, _P, _LL, _P,
                                                   _P], _I),
        "tpufem_l2_smem_bytes": ([_I] * 4, _LL)},
    "lab_zyfirst": {
        "tpufem_zy_apply": ([_I] * 10 + [_P] * 6, _I),
        "tpufem_zy_smem_bytes": ([_I] * 7, _LL),
        "tpufem_zy_ring_takes": ([_I] * 3, _I)},
    "toolchain_probe": {
        "tpufem_probe_matmul": ([_I] * 2 + [_P] * 4, _I),
        "tpufem_probe_chain": ([_I] * 5 + [_F] * 2 + [_P] * 2 + [_LL]
                               + [_P] * 4, _I)},
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


@functools.cache
def load_kernels() -> dict[str, KernelLibrary]:
    """Build (if needed) and load every kernel library, by name of
    ``SOURCES``; the missing ones compile at the same time, one ``nvcc``
    each.  Cached for the life of the process."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tpufem_torch kernels need a CUDA device")
    outs = {name: BUILD_DIR / f"tpufem_torch_{name}_{_digest(*src)}.so"
            for name, src in SOURCES.items()}
    todo = [name for name, out in outs.items() if not out.exists()]
    nvcc = _nvcc() if todo else None
    builds, logs, seconds = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for name in todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = outs[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name][0])]
            builds[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (tmp, proc) in builds.items():
            logs[name] = proc.communicate()[0]
            seconds[name] = time.perf_counter() - t0
    finally:  # leave no compiler running when a build or a wait fails
        for _, proc in builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (tmp, proc) in builds.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCES[name][0]} failed "
                               f"({proc.returncode}):\n{logs[name]}")
        # atomic: concurrent builders never see half a library
        os.replace(tmp, outs[name])
    libs = {}
    for name, out in outs.items():
        lib = ctypes.CDLL(str(out))
        for entry, (argtypes, restype) in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = KernelLibrary(lib, out, seconds.get(name, 0.0),
                                   logs.get(name, ""))
    return libs

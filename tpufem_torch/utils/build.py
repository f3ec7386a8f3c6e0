"""Builds the port's CUDA kernels with ``nvcc`` and loads them via ctypes.

The sources under ``tpufem_torch/csrc`` have a plain C interface, so they
compile in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/tpufem_torch/<name>_<hash>.so csrc/*.cu

The build runs at first use, into ``build/tpufem_torch/`` beside the
package, keyed on a hash of the sources and flags, so an unchanged
checkout reuses its library and an edited source rebuilds.  ``nvcc`` is
found through ``CUDA_HOME`` (PyTorch's lookup).  A build or load that
fails raises.
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
SOURCES = ("separable_apply.cu", "separable_apply.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_kernels() -> KernelLibrary:
    """Build (if needed) and load ``libtpufem_torch_kernels``; cached for
    the life of the process."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tpufem_torch kernels need a CUDA device")
    out = BUILD_DIR / f"tpufem_torch_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / "separable_apply.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    lib = ctypes.CDLL(str(out))
    fn = lib.tpufem_separable_apply
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    lib.tpufem_smem_elems.argtypes = [ctypes.c_int] * 5
    lib.tpufem_smem_elems.restype = ctypes.c_longlong
    lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, out, seconds, log)

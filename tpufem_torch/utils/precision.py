"""Numerics settings of the port, set once when ``tpufem_torch`` is imported.

The port's form of the JAX package's rule "always pin
``Precision.HIGHEST``": an f32 path runs true f32 (no TF32 in matmuls or
cuDNN), and every operation is deterministic, so that CG iteration counts
and solutions are bitwise equal from run to run.
"""

from __future__ import annotations

import os

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """The torch dtype for a tpufem dtype name ("float64", "float32") or a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[dtype]


def configure_precision() -> None:
    """Disable TF32, pin f32 matmuls to "highest", turn on deterministic
    algorithms.

    cuBLAS is deterministic only with a fixed workspace, which it reads
    from ``CUBLAS_WORKSPACE_CONFIG`` at its first call; without it,
    deterministic mode raises on the first cuBLAS call.

    Deterministic mode would also fill every ``torch.empty`` with NaN, an
    extra pass over each output; the port's kernels write every element
    of the outputs they allocate, so that fill is switched off.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

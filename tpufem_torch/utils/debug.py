"""Debug guards: NaN/Inf detection around device computations.

Port of ``tpufem/utils/debug.py`` (the reference's fail-fast
``AssertCuda``-style error macros, SURVEY.md §5 "Failure detection").  The
failure mode that matters is silent NaN/Inf propagation (a CG breakdown,
bad metric terms), so the guard checks for it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterator

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    pass


def check_finite(x, what: str = "array"):
    """Host-side check (one device->host sync; use outside hot loops)."""
    t = torch.as_tensor(x)
    n_bad = int((~torch.isfinite(t)).sum())
    if n_bad:
        raise NonFiniteError(
            f"{what}: {n_bad}/{t.numel()} non-finite values detected"
        )
    return x


def _arrays(out) -> Iterator:
    """The tensors, numpy arrays and floats in ``out``, through tuples,
    lists, dicts and dataclasses (the leaves the reference's
    ``jax.tree_util.tree_leaves`` reaches); other leaves are skipped."""
    if isinstance(out, (torch.Tensor, np.ndarray, float)):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _arrays(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _arrays(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _arrays(getattr(out, f.name))


def nan_guard(fn: Callable, what: str | None = None) -> Callable:
    """Wrap a device function; raises NonFiniteError if its output contains
    NaN/Inf.  Adds one device->host sync per array of the output —
    debugging tool, not for production hot loops."""
    name = what or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in _arrays(out):
            check_finite(leaf, f"{name} output")
        return out

    return wrapped

"""Wall-clock section timing and kernel timing with device synchronisation.

Port of ``tpufem/utils/timer.py``.  On a CUDA device, ``time_fn`` times
with CUDA events and ``Timer`` sections end with
``torch.cuda.synchronize``; on the CPU both use ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def synchronize(device: torch.device | str) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating section timer (TimerOutput analogue): ``totals[name]``
    holds the seconds spent in ``section(name)``, device work included."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def section(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0


def time_fn(fn, x: torch.Tensor, reps: int = 30, warmup: int = 2) -> float:
    """Mean seconds per apply over a chain ``x = fn(x)`` of ``reps``
    applies (bench.py's chained-apply protocol), after ``warmup`` applies.

    On x's CUDA device: one pair of CUDA events around the chain, read
    after a synchronise.  On the CPU: ``time.perf_counter``.
    """
    y = x
    for _ in range(warmup):
        y = fn(y)
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        y = x
        for _ in range(reps):
            y = fn(y)
        return (time.perf_counter() - t0) / reps
    synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y = x
    for _ in range(reps):
        y = fn(y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps

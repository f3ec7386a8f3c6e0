"""Structured metrics emission (stdout JSON lines + JSONL file) and traces.

Port of ``tpufem/utils/metrics.py``: ``emit`` prints one JSON line per
record and appends it to a file (``path``, else ``$TPUFEM_METRICS``), as
the reference's benchmarks do; ``profile_trace`` is a ``torch.profiler``
context that writes a Chrome trace (the reference's ``jax.profiler``
trace).  CUPTI records the kernels that the port's ctypes libraries
launch, though a ``record_function`` range does not collect them.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any

import torch


def emit(record: dict[str, Any], path: str | None = None) -> None:
    """Print one JSON line; append to `path` (or $TPUFEM_METRICS) if set."""
    record = dict(record)
    record.setdefault("ts", time.time())
    line = json.dumps(record)
    print(line)
    path = path or os.environ.get("TPUFEM_METRICS")
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


@contextlib.contextmanager
def profile_trace(path: str | None = None):
    """Context manager: a ``torch.profiler`` run over its body (CPU
    activity, and CUDA activity where a card is present), written on exit
    as a Chrome trace ``tpufem_torch.<pid>.<ms>.trace.json`` in the
    directory ``path`` (default: ``tpufem_torch_trace`` in the temporary
    directory).  Yields the profiler, whose ``key_averages()`` hold the
    per-op split; the written file is its ``trace_path``."""
    out = Path(path or os.path.join(tempfile.gettempdir(),
                                    "tpufem_torch_trace"))
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = str(
        out / f"tpufem_torch.{os.getpid()}.{int(time.time() * 1e3)}"
              ".trace.json")
    prof.export_chrome_trace(prof.trace_path)

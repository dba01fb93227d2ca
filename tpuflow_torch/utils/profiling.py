"""Profiling hooks (the port of tpuflow/utils/profiling.py): a device trace
around a block, written as a Chrome trace (open it in Perfetto or
chrome://tracing), beside the per-level ``LevelTrace`` records of
``compute_flow(..., collect_trace=True)``.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU and CUDA trace around a block:

        with profiling.trace("out/mytrace"):
            compute_flow(f0, f1, device="cuda")

    writes ``<log_dir>/trace.json``. It measures the card: without CUDA it
    raises (the JAX version degrades to a no-op with a warning).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("profiling.trace records device time and needs CUDA")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))

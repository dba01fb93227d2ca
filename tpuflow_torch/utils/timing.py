"""Timing helpers (the port of tpuflow/utils/timing.py).

``Timer`` is a host wall clock: around CUDA work it measures the enqueue
unless the timed code ends in a synchronisation or a copy to the host, as
``compute_flow`` does. ``format_level_table`` renders the per-level
records of ``compute_flow(..., collect_trace=True)``.
"""

from __future__ import annotations

import time


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def format_level_table(levels) -> str:
    """Render per-level traces (``tpuflow_torch.solver.flow2d.LevelTrace``)
    as the per-level timing table, in the JAX package's text."""
    lines = [f"{'level':>5} {'size':>12} {'seconds':>9} {'Mpix/s':>8}"]
    for lt in levels:
        mpix = lt.width * lt.height / max(lt.seconds, 1e-12) / 1e6
        lines.append(
            f"{lt.level:>5} {lt.width:>5}x{lt.height:<6} {lt.seconds:>9.4f} {mpix:>8.2f}"
        )
    return "\n".join(lines)

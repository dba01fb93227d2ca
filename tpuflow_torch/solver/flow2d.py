"""The public front door: ``compute_flow``, ``FlowResult``, ``LevelTrace``,
``endpoint_error`` (the port of tpuflow/solver/flow2d.py:33-60, :99, :354).

One pair per call, with the data constancy of ``cfg.data_constancy``
(grey, gradient or log-derivative). The device is explicit:
``device="cuda"`` runs the CUDA kernels and raises on a machine without
CUDA; it never falls back to the CPU. ``device="cpu"`` runs the kernels'
plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.solver.level import solve
from tpuflow_torch.utils.timing import Timer


@dataclasses.dataclass
class LevelTrace:
    """One pyramid level's record of ``compute_flow(..., collect_trace=True)``:
    its index, size and seconds (resample and level step)."""

    level: int
    width: int
    height: int
    seconds: float


@dataclasses.dataclass
class FlowResult:
    """Final flow in original-pixel units, on the host (numpy).
    ``seconds`` covers upload, the solve and the download; ``levels`` holds
    the per-level records when a trace was asked for."""

    u: np.ndarray
    v: np.ndarray
    seconds: float
    levels: List[LevelTrace] = dataclasses.field(default_factory=list)

    @property
    def megapixels_per_second(self) -> float:
        h, w = self.u.shape
        return (w * h) / self.seconds / 1e6


@contextlib.contextmanager
def _full_float32():
    """TF32 off for matmuls and cuDNN inside; the caller's flags after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compute_flow(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *,
                 collect_trace: bool = False, device="cuda", _relax_for=None) -> FlowResult:
    """Dense 2D optical flow from frame_0 to frame_1, two (H, W) frames of
    any real dtype; computation is float32 on ``device``.

    ``collect_trace`` fills ``FlowResult.levels`` with one ``LevelTrace``
    per level, timed by CUDA events on the card and by the host clock on
    the CPU; the flow is the same with or without it.

    It switches TF32 off for matmuls and cuDNN for the solve (the smoothing
    and resample matmuls must be full float32, as the JAX package's are,
    Precision.HIGHEST) and gives both process-wide flags back as the caller
    set them, also when the solve raises. ``_relax_for`` is ``solve``'s
    per-level relaxation, for ``compute_flow_sharded``.
    """
    cfg = cfg or FlowConfig()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not available")
    f0 = np.asarray(frame_0, dtype=np.float32)
    f1 = np.asarray(frame_1, dtype=np.float32)
    if f0.shape != f1.shape or f0.ndim != 2:
        raise ValueError(f"expected two equal (H, W) frames, got {f0.shape} {f1.shape}")
    guard = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    trace = [] if collect_trace else None
    with _full_float32(), guard, Timer() as timer:
        uv = solve(torch.from_numpy(f0).to(device), torch.from_numpy(f1).to(device), cfg,
                   trace=trace, relax_for=_relax_for)
        uv = uv.cpu().numpy()
    return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds,
                      levels=[LevelTrace(*t) for t in trace or ()])


def endpoint_error(u_a, v_a, u_b, v_b) -> float:
    """Mean endpoint error between two flow fields (the parity metric)."""
    u_a, v_a = np.asarray(u_a), np.asarray(v_a)
    u_b, v_b = np.asarray(u_b), np.asarray(v_b)
    return float(np.mean(np.sqrt((u_a - u_b) ** 2 + (v_a - v_b) ** 2)))

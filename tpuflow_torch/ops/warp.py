"""Backward bilinear warp (reference: src/kernels/registration_2d.cu:48-72).

Rules (tpuflow/ops/warp.py:30-65, tpuflow/solver/bucketed.py:182-222):
``x_f = x + u * inv_hx`` with the host-rounded ``inv_hx`` (flow is in
original-pixel units); a target outside ``[0, w-1] x [0, h-1]`` or NaN
copies frame_0; the ``+1`` taps clamp at ``w-1`` / ``h-1``. The taps are
summed as ``(w00 f00 + w01 f01) + (w10 f10 + w11 f11)``, the association of
the TPU's in-kernel shift-sum (tpuflow/ops/pallas/level_fused.py:225-243).

``warp`` launches the CUDA kernel ``tf_warp`` (csrc/level.cu) for CUDA
tensors and runs ``warp_plain`` for CPU tensors. On the TPU this step was
the shift-sum inside ``level_fused_whole`` plus an XLA widened tier and
gather for larger motion; one exact gather covers all of them here.

``rows`` = (lo, hi) warps output rows lo .. hi - 1 alone, reading f0 and uv
at those rows and f1 at any row, into the whole-size output (``out``, or a
new one); each row is bitwise the whole call's.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuflow_torch.ops.cuda_lib import launch, on_cuda
from tpuflow_torch.ops.solver_ops import placed, row_range


def warp_plain(f0: torch.Tensor, f1: torch.Tensor, uv: torch.Tensor,
               inv_hx: float, inv_hy: float, rows=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the warp: f0, f1 (h, w); uv (2, h, w); over
    ``rows`` (module docstring), a new output NaN outside them."""
    h, w = f0.shape
    lo, hi = row_range(rows, h)
    dev = f0.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(hi - lo, w)
    ys = torch.arange(lo, hi, dtype=torch.float32, device=dev)[:, None].expand(hi - lo, w)
    x_f = xs + uv[0, lo:hi] * inv_hx
    y_f = ys + uv[1, lo:hi] * inv_hy
    invalid = (
        (x_f < 0.0) | (x_f > w - 1) | (y_f < 0.0) | (y_f > h - 1)
        | torch.isnan(x_f) | torch.isnan(y_f)
    )
    safe_x = torch.where(invalid, xs, x_f)
    safe_y = torch.where(invalid, ys, y_f)
    x0f = torch.floor(safe_x)
    y0f = torch.floor(safe_y)
    dx = safe_x - x0f
    dy = safe_y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    w00 = (1.0 - dx) * (1.0 - dy)
    w01 = dx * (1.0 - dy)
    w10 = (1.0 - dx) * dy
    w11 = dx * dy
    flat = f1.reshape(-1)

    def at(yy, xx):
        return flat[yy * w + xx]

    value = (w00 * at(y0, x0) + w01 * at(y0, x1)) + (w10 * at(y1, x0) + w11 * at(y1, x1))
    return placed(torch.where(invalid, f0[lo:hi], value), (h, w), lo, hi, out)


def warp(f0: torch.Tensor, f1: torch.Tensor, uv: torch.Tensor,
         inv_hx: float, inv_hy: float, rows=None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f1 warped back onto f0's grid by the flow ``uv`` (2, h, w), over
    ``rows`` (module docstring); ``warp.rows`` counts the rows computed."""
    h, w = f0.shape
    if f1.shape != (h, w) or uv.shape != (2, h, w):
        raise ValueError(f"shape mismatch: {f0.shape} {f1.shape} {uv.shape}")
    lo, hi = row_range(rows, h)
    warp.rows += hi - lo
    if not on_cuda(f0, f1, uv, *(() if out is None else (out,))):
        return warp_plain(f0, f1, uv, inv_hx, inv_hy, rows, out)
    if out is None:
        out = torch.empty_like(f0)
    elif out.shape != (h, w):
        raise ValueError(f"out: expected {(h, w)}, got {tuple(out.shape)}")
    launch("tf_warp", f0.data_ptr(), f1.data_ptr(), uv.data_ptr(), out.data_ptr(),
           h, w, lo, hi, float(inv_hx), float(inv_hy))
    warp.launches += 1
    return out


warp.launches = 0
warp.rows = 0

"""Stencil pieces of the solver in plain PyTorch: mirror shifts, the
free-boundary edge weights (tpuflow/ops/solver_ops.py:178-191) and phi/ksi
(tpuflow/ops/solver_ops.py:194-224, in the T-iterate form the level kernels
use, tpuflow/ops/pallas/level_fused.py:343-393).

Fields are exact-size (..., h, w) tensors; the mirror boundary is reflect
indexing, so neighbour -1 reads index 1 and neighbour n reads n-2.
"""

from __future__ import annotations

import torch


def shifts(a: torch.Tensor):
    """(center, x+1, x-1, y+1, y-1) of the last two dims, reflect boundary."""
    xp = torch.cat([a[..., :, 1:], a[..., :, -2:-1]], dim=-1)
    xm = torch.cat([a[..., :, 1:2], a[..., :, :-1]], dim=-1)
    yp = torch.cat([a[..., 1:, :], a[..., -2:-1, :]], dim=-2)
    ym = torch.cat([a[..., 1:2, :], a[..., :-1, :]], dim=-2)
    return a, xp, xm, yp, ym


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` as an IEEE division. PyTorch's CUDA ``div`` by a host
    scalar multiplies by its reciprocal instead, which rounds differently
    from the kernels and the JAX package."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def recip_twice_sqrt(a: torch.Tensor) -> torch.Tensor:
    """1 / (2 sqrt(a)), the phi/ksi form."""
    return torch.reciprocal(2.0 * torch.sqrt(a))


def edge_weights(h: int, w: int, alpha_hx2: float, alpha_hy2: float,
                 device) -> tuple:
    """alpha/h^2 neighbour weights, zero at the image border (free boundary,
    reference: solve_2d.cu:333-340); broadcastable (1, w) and (h, 1) rows."""
    xs = torch.arange(w, device=device)[None, :]
    ys = torch.arange(h, device=device)[:, None]
    ax = torch.tensor(alpha_hx2, dtype=torch.float32, device=device)
    ay = torch.tensor(alpha_hy2, dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    xp = torch.where(xs < w - 1, ax, zero)
    xm = torch.where(xs > 0, ax, zero)
    yp = torch.where(ys < h - 1, ay, zero)
    ym = torch.where(ys > 0, ay, zero)
    return xp, xm, yp, ym


def phi_from_T(tu, tv, div2hx: float, div2hy: float, e_s2: float):
    """Flow-driven diffusivity 1/(2 sqrt(|grad T|^2 + e_s^2)) of the
    combined iterate T = flow + d (level_fused.py:348-353)."""
    _, tu_xp, tu_xm, tu_yp, tu_ym = shifts(tu)
    _, tv_xp, tv_xm, tv_yp, tv_ym = shifts(tv)
    dux = div_scalar(tu_xp - tu_xm, div2hx)
    duy = div_scalar(tu_yp - tu_ym, div2hy)
    dvx = div_scalar(tv_xp - tv_xm, div2hx)
    dvy = div_scalar(tv_yp - tv_ym, div2hy)
    return recip_twice_sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2)


def ksi_grey(fx, fy, ft, du_c, dv_c, e_d2: float):
    """Data-term penalizer 1/(2 sqrt(max(s, 0) + e_d^2)) from the GREY motion
    tensor, in the level kernels' association (level_fused.py:373-378)."""
    sq = (
        (fx * fx * du_c + fx * fy * dv_c + fx * ft) * du_c
        + (fx * fy * du_c + fy * fy * dv_c + fy * ft) * dv_c
        + (fx * ft * du_c + fy * ft * dv_c + ft * ft)
    )
    return recip_twice_sqrt(torch.clamp_min(sq, 0.0) + e_d2)

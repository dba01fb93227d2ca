"""Stencil pieces of the solver in plain PyTorch: mirror shifts, the
free-boundary edge weights (tpuflow/ops/solver_ops.py:178-191), phi/ksi
(tpuflow/ops/solver_ops.py:194-224, in the T-iterate form the level kernels
use, tpuflow/ops/pallas/level_fused.py:343-393) and the motion tensors of
the three data constancies (tpuflow/solver/bucketed.py:389-445).

Fields are exact-size (..., h, w) tensors. The mirror boundary is reflect
indexing, so neighbour -1 reads index 1 and neighbour n reads n-2; only the
second-order tensor's stencil over derivative fields replicates instead
(neighbour -1 reads 0, neighbour n reads n-1).
"""

from __future__ import annotations

import torch

from tpuflow_torch.config import DataConstancy


def shifts(a: torch.Tensor):
    """(center, x+1, x-1, y+1, y-1) of the last two dims, reflect boundary."""
    xp = torch.cat([a[..., :, 1:], a[..., :, -2:-1]], dim=-1)
    xm = torch.cat([a[..., :, 1:2], a[..., :, :-1]], dim=-1)
    yp = torch.cat([a[..., 1:, :], a[..., -2:-1, :]], dim=-2)
    ym = torch.cat([a[..., 1:2, :], a[..., :-1, :]], dim=-2)
    return a, xp, xm, yp, ym


def shifts_edge(a: torch.Tensor):
    """(x+1, x-1, y+1, y-1) of the last two dims, replicate boundary
    (tpuflow/ops/solver_ops.py:46-52)."""
    xp = torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)
    xm = torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1)
    yp = torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    ym = torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)
    return xp, xm, yp, ym


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` as an IEEE division. PyTorch's CUDA ``div`` by a host
    scalar multiplies by its reciprocal instead, which rounds differently
    from the kernels and the JAX package."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def recip_twice_sqrt(a: torch.Tensor) -> torch.Tensor:
    """1 / (2 sqrt(a)), the phi/ksi form."""
    return torch.reciprocal(2.0 * torch.sqrt(a))


def edge_weights(h: int, w: int, alpha_hx2: float, alpha_hy2: float,
                 device, row0: int = 0, height: int | None = None) -> tuple:
    """alpha/h^2 neighbour weights, zero at the image border (free boundary,
    reference: solve_2d.cu:333-340); broadcastable (1, w) and (h, 1) rows.

    For a block of h rows of a taller level (a shard's padded rows),
    ``row0`` is the block's first global row and ``height`` the level's
    height: the weights are those of the global rows (halo.py:163-173)."""
    height = h if height is None else height
    xs = torch.arange(w, device=device)[None, :]
    ys = torch.arange(row0, row0 + h, device=device)[:, None]
    ax = torch.tensor(alpha_hx2, dtype=torch.float32, device=device)
    ay = torch.tensor(alpha_hy2, dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    xp = torch.where(xs < w - 1, ax, zero)
    xm = torch.where(xs > 0, ax, zero)
    yp = torch.where(ys < height - 1, ay, zero)
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


def first_derivs(a, b, div4hx: float, div4hy: float) -> torch.Tensor:
    """(3, h, w) fx, fy, ft of a frame pair: x and y differences averaged
    over both frames (/4h), ft = b - a (tpuflow/solver/bucketed.py:406-412)."""
    a_c, a_xp, a_xm, a_yp, a_ym = shifts(a)
    b_c, b_xp, b_xm, b_yp, b_ym = shifts(b)
    fx = div_scalar(a_xp - a_xm + b_xp - b_xm, div4hx)
    fy = div_scalar(a_yp - a_ym + b_yp - b_ym, div4hy)
    return torch.stack([fx, fy, b_c - a_c])


def second_order_tensor(gx, gy, gt, hx_1: float, hy_1: float) -> torch.Tensor:
    """(5, h, w) J11, J22, J12, J13, J23 of the gradient-constancy data term
    from first-derivative fields (tpuflow/ops/solver_ops.py:122-144). The
    stencil replicates at the border, and multiplies by the host-rounded
    ``hx_1 = f32(1/(2h))`` (bucketed.py:431-444); it never divides."""
    gx_xp, gx_xm, gx_yp, gx_ym = shifts_edge(gx)
    gy_xp, gy_xm, gy_yp, gy_ym = shifts_edge(gy)
    gt_xp, gt_xm, gt_yp, gt_ym = shifts_edge(gt)
    fxx = (gx_xp - gx_xm) * hx_1
    fxy = (gx_yp - gx_ym) * hy_1
    fyy = (gy_yp - gy_ym) * hy_1
    fxt = (gt_xp - gt_xm) * hx_1
    fyt = (gt_yp - gt_ym) * hy_1
    return torch.stack([
        fxx * fxx + fxy * fxy,
        fxy * fxy + fyy * fyy,
        fxx * fxy + fxy * fyy,
        fxx * fxt + fxy * fyt,
        fxy * fxt + fyy * fyt,
    ])


def derivative_tensor(f0_l, f1_w, fxyz, sc, log: bool) -> torch.Tensor:
    """The gradient (``log=False``) or log-derivative (``log=True``) motion
    tensor (5, h, w) of a level. Gradient takes the grey derivatives
    ``fxyz``; log takes those of ``log1p`` of the frames, with the same
    reflect stencil (reference: solve_2d.cu:508-524)."""
    g = first_derivs(torch.log1p(f0_l), torch.log1p(f1_w), sc.div4hx, sc.div4hy) if log else fxyz
    return second_order_tensor(g[0], g[1], g[2], sc.hx_1, sc.hy_1)


def motion_tensor(f0_l, f1_w, sc, constancy: DataConstancy):
    """(fxyz, J): the grey first derivatives (3, h, w), from which ksi always
    comes, and the motion tensor J (5, h, w) of ``constancy`` that the solve
    update uses. The plain counterpart of ``bucketed.level_constants``."""
    fxyz = first_derivs(f0_l, f1_w, sc.div4hx, sc.div4hy)
    if constancy == DataConstancy.GREY:
        fx, fy, ft = fxyz
        return fxyz, torch.stack([fx * fx, fy * fy, fx * fy, fx * ft, fy * ft])
    return fxyz, derivative_tensor(f0_l, f1_w, fxyz, sc,
                                   constancy == DataConstancy.LOG_DERIVATIVES)

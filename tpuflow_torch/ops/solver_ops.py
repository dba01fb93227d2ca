"""Stencil pieces of the solver in plain PyTorch: mirror shifts, the
free-boundary edge weights (tpuflow/ops/solver_ops.py:178-191), phi/ksi
(tpuflow/ops/solver_ops.py:194-224, in the T-iterate form the level kernels
use, tpuflow/ops/pallas/level_fused.py:343-393) and the motion tensors of
the three data constancies (tpuflow/solver/bucketed.py:389-445).

Fields are exact-size (..., h, w) tensors. The mirror boundary is reflect
indexing, so neighbour -1 reads index 1 and neighbour n reads n-2; only the
second-order tensor's stencil over derivative fields replicates instead
(neighbour -1 reads 0, neighbour n reads n-1). ``refl`` and ``clamp`` are
those two rules as the kernels write them.

The derivatives and tensors take ``rows`` = (lo, hi): they compute output
rows lo .. hi - 1 alone, reading their inputs by the level's own rows and
height, so each row is bitwise the whole call's; the other rows of the
whole-size result are NaN, or ``out``'s (``placed``). Every row stage
counts the rows it computed (``count_rows``), in all and by lane.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from tpuflow_torch.config import DataConstancy


# The lane whose rows the row stages count: the level driver sets it around
# each card's stages on a one-process row over several cards
# (solver/level.py::solve); lane 0 everywhere else.
_LANE = [0]


@contextlib.contextmanager
def row_lane(lane: int):
    """Count the row stages' rows under ``lane`` inside the block."""
    before, _LANE[0] = _LANE[0], int(lane)
    try:
        yield
    finally:
        _LANE[0] = before


def count_rows(stage, n: int) -> None:
    """Add n output rows to a row stage's counts: ``stage.rows``, and the
    current lane's entry of ``stage.lane_rows``."""
    stage.rows += n
    stage.lane_rows[_LANE[0]] = stage.lane_rows.get(_LANE[0], 0) + n


def refl(i, n: int):
    """The reference mirror of index i (an array) in [0, n): -i below 0,
    2n - i - 2 from n (csrc/level_body.cuh: refl)."""
    where = torch.where if isinstance(i, torch.Tensor) else np.where
    return where(i < 0, -i, where(i >= n, 2 * n - i - 2, i))


def clamp(i, n: int):
    """The replicate rule of index i (an array) in [0, n) (csrc/level.cu:
    clamp_idx)."""
    return i.clip(0, n - 1)


def row_range(rows, h: int) -> tuple:
    """``rows`` as (lo, hi) with 0 <= lo < hi <= h; None is every row."""
    lo, hi = (0, h) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo < hi <= h:
        raise ValueError(f"rows {lo}..{hi - 1} are not a range of a level's {h} rows")
    return lo, hi


def placed(values: torch.Tensor, shape: tuple, lo: int, hi: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``values`` (..., hi - lo, w) as rows lo .. hi - 1 of a whole-size
    (..., h, w) result of ``shape``: ``out`` with those rows written, else
    ``values`` itself where they are every row, else a new tensor whose
    other rows are NaN."""
    if out is None:
        if (lo, hi) == (0, shape[-2]):
            return values
        out = torch.full(shape, float("nan"), dtype=values.dtype, device=values.device)
    elif tuple(out.shape) != tuple(shape):
        raise ValueError(f"out: expected {tuple(shape)}, got {tuple(out.shape)}")
    out[..., lo:hi, :] = values
    return out


def row_shifts(a: torch.Tensor, lo: int, hi: int, edge: bool = False):
    """(center, x+1, x-1, y+1, y-1) of rows lo .. hi - 1 of the last two dims
    of ``a``: the mirror (``refl``), or with ``edge`` the replicate rule
    (``clamp``), at the level's own edges."""
    h = a.shape[-2]
    c = a[..., lo:hi, :]
    if edge:
        xp = torch.cat([c[..., :, 1:], c[..., :, -1:]], dim=-1)
        xm = torch.cat([c[..., :, :1], c[..., :, :-1]], dim=-1)
    else:
        xp = torch.cat([c[..., :, 1:], c[..., :, -2:-1]], dim=-1)
        xm = torch.cat([c[..., :, 1:2], c[..., :, :-1]], dim=-1)
    rule = clamp if edge else refl
    ys = torch.arange(lo, hi, device=a.device)
    return c, xp, xm, a.index_select(-2, rule(ys + 1, h)), a.index_select(-2, rule(ys - 1, h))


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


def first_derivs(a, b, div4hx: float, div4hy: float, rows=None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3, h, w) fx, fy, ft of a frame pair: x and y differences averaged
    over both frames (/4h), ft = b - a (tpuflow/solver/bucketed.py:406-412);
    over ``rows`` (module docstring)."""
    h, w = a.shape[-2:]
    lo, hi = row_range(rows, h)
    a_c, a_xp, a_xm, a_yp, a_ym = row_shifts(a, lo, hi)
    b_c, b_xp, b_xm, b_yp, b_ym = row_shifts(b, lo, hi)
    fx = div_scalar(a_xp - a_xm + b_xp - b_xm, div4hx)
    fy = div_scalar(a_yp - a_ym + b_yp - b_ym, div4hy)
    return placed(torch.stack([fx, fy, b_c - a_c]), (3, h, w), lo, hi, out)


def second_order_tensor(gx, gy, gt, hx_1: float, hy_1: float, rows=None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(5, h, w) J11, J22, J12, J13, J23 of the gradient-constancy data term
    from first-derivative fields (tpuflow/ops/solver_ops.py:122-144). The
    stencil replicates at the border, and multiplies by the host-rounded
    ``hx_1 = f32(1/(2h))`` (bucketed.py:431-444); it never divides. Over
    ``rows`` (module docstring)."""
    h, w = gx.shape[-2:]
    lo, hi = row_range(rows, h)
    _, gx_xp, gx_xm, gx_yp, gx_ym = row_shifts(gx, lo, hi, edge=True)
    _, gy_xp, gy_xm, gy_yp, gy_ym = row_shifts(gy, lo, hi, edge=True)
    _, gt_xp, gt_xm, gt_yp, gt_ym = row_shifts(gt, lo, hi, edge=True)
    fxx = (gx_xp - gx_xm) * hx_1
    fxy = (gx_yp - gx_ym) * hy_1
    fyy = (gy_yp - gy_ym) * hy_1
    fxt = (gt_xp - gt_xm) * hx_1
    fyt = (gt_yp - gt_ym) * hy_1
    return placed(torch.stack([
        fxx * fxx + fxy * fxy,
        fxy * fxy + fyy * fyy,
        fxx * fxy + fxy * fyy,
        fxx * fxt + fxy * fyt,
        fxy * fxt + fyy * fyt,
    ]), (5, h, w), lo, hi, out)


def derivative_tensor(f0_l, f1_w, fxyz, sc, log: bool, rows=None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gradient (``log=False``) or log-derivative (``log=True``) motion
    tensor (5, h, w) of a level. Gradient takes the grey derivatives
    ``fxyz``; log takes those of ``log1p`` of the frames, with the same
    reflect stencil (reference: solve_2d.cu:508-524). Over ``rows`` (module
    docstring): the log tensor takes log1p of the frames' rows that its
    derivatives read, and those derivatives at the rows its stencil reads."""
    h, w = f0_l.shape
    lo, hi = row_range(rows, h)
    g = fxyz
    if log:
        g_lo, g_hi = max(0, lo - 1), min(h, hi + 1)    # clamp(y -+ 1)
        f_lo, f_hi = max(0, g_lo - 1), min(h, g_hi + 1)  # refl(y -+ 1) of those
        logs = [placed(torch.log1p(f[f_lo:f_hi]), (h, w), f_lo, f_hi) for f in (f0_l, f1_w)]
        g = first_derivs(*logs, sc.div4hx, sc.div4hy, rows=(g_lo, g_hi))
    return second_order_tensor(g[0], g[1], g[2], sc.hx_1, sc.hy_1, rows=(lo, hi), out=out)


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

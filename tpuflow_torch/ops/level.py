"""The level kernels: derivatives, the motion tensor of the gradient and
log constancies, the per-outer prologue, the coupled Jacobi sweeps of one
outer iteration, and add + median. Each is a CUDA kernel (csrc/level.cu)
with its plain PyTorch version beside it. The one-sweep kernel
``jacobi_sweep`` is the twin that ``jacobi_sweeps`` is held against.

Together with the warp (ops/warp.py) they compute one pyramid level, for
all three data constancies: the function of the TPU's five level kernels

  * ``level_fused_whole`` (tpuflow/ops/pallas/level_fused.py:526) and
    ``level_fused`` (:472): warp, derivatives, the gradient/log tensor
    (:291-322), outer x (phi/ksi + inner sweeps), add, median;
  * ``_relax_bucket_full`` (tpuflow/ops/pallas/relax_bucket.py:400),
    ``_relax_bucket_chunked`` (:176), ``_relax_du_full``
    (tpuflow/ops/pallas/relax_du.py:241), ``_relax_du_chunked`` (:457) and
    ``_relax_du_streamed`` (:874): the outer x inner relaxation alone, with
    the tensor through their ``tensor=`` argument.

A wrapper runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in a plain
integer attribute, ``<wrapper>.launches``; ``outer_prologue`` with a tensor
counts under ``outer_prologue_tensor``.

``level_derivs``, ``level_tensor`` and ``add_median`` (and the warp) take
``rows`` = (lo, hi): they compute output rows lo .. hi - 1 alone into the
whole-size output (``out``, or a new one; on the card its other rows are
not written, in the plain version's new output they are NaN), reading
their inputs by the level's own rows and height, so each row is bitwise
the whole call's. The default is every row, one launch over the level as
before. Each counts the rows it computed in ``<wrapper>.rows`` and, by
lane, in ``<wrapper>.lane_rows`` (``row_counts``), on either device.

Packed layouts (contiguous float32 stacks of (h, w) planes):
  fxyz  (3, h, w)  fx, fy, ft (grey, always: ksi comes from them)
  J     (5, h, w)  J11, J22, J12, J13, J23 of the gradient or log tensor
  T     (2, h, w)  the combined iterates Tu = u + du, Tv = v + dv
  uv    (2, h, w)  the flow the level started from
  hoist (9, h, w)  pw_xp, pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuflow_torch.ops.cuda_lib import launch, on_cuda
from tpuflow_torch.ops.gaussian import gaussian_smooth
from tpuflow_torch.ops.median import effective_radius, median_plain
from tpuflow_torch.ops.resample import resample
from tpuflow_torch.ops.solver_ops import (
    count_rows, derivative_tensor, edge_weights, first_derivs, ksi_grey, phi_from_T, placed,
    row_range, shifts,
)
from tpuflow_torch.ops.sweep_core import sweep_update_T
from tpuflow_torch.ops.warp import warp

N_HOIST = 9
N_TENSOR = 5


def _check_planes(h: int, w: int, **stacks: tuple) -> None:
    """Each stack is (tensor, planes); it must have shape (planes, h, w)."""
    for name, (t, planes) in stacks.items():
        if t.shape != (planes, h, w):
            raise ValueError(f"{name}: expected {(planes, h, w)}, got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# level_derivs: fx, fy, ft once per level (level_fused.py:285-289)
# ---------------------------------------------------------------------------


level_derivs_plain = first_derivs


def _out(out, shape, like: torch.Tensor) -> torch.Tensor:
    """A wrapper's whole-size output: ``out`` (checked), else a new one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=like.device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"out: expected {tuple(shape)}, got {tuple(out.shape)}")
    return out


def _given(out) -> tuple:
    return () if out is None else (out,)


def level_derivs(f0, f1w, div4hx: float, div4hy: float, rows=None,
                 out=None) -> torch.Tensor:
    """(3, h, w) grey first derivatives of the level frame and warped frame,
    over ``rows`` (module docstring)."""
    h, w = f0.shape
    if f1w.shape != (h, w):
        raise ValueError(f"shape mismatch: {f0.shape} {f1w.shape}")
    lo, hi = row_range(rows, h)
    count_rows(level_derivs, hi - lo)
    if not on_cuda(f0, f1w, *_given(out)):
        return level_derivs_plain(f0, f1w, div4hx, div4hy, rows, out)
    fxyz = _out(out, (3, h, w), f0)
    launch("tf_level_derivs", f0.data_ptr(), f1w.data_ptr(), fxyz.data_ptr(),
           h, w, lo, hi, float(div4hx), float(div4hy))
    level_derivs.launches += 1
    return fxyz


# ---------------------------------------------------------------------------
# level_tensor: the gradient/log motion tensor once per level
# (level_fused.py:291-322, bucketed.py:422-444)
# ---------------------------------------------------------------------------


level_tensor_plain = derivative_tensor


def level_tensor(f0_l, f1_w, fxyz, sc, log: bool, rows=None, out=None) -> torch.Tensor:
    """(5, h, w) J11, J22, J12, J13, J23 of the gradient (``log=False``,
    from the grey ``fxyz``) or log-derivative (``log=True``, from log1p of
    the frames) data term, over ``rows`` (module docstring). ``sc`` is the
    level's ``LevelScalars``."""
    h, w = f0_l.shape
    if f1_w.shape != (h, w):
        raise ValueError(f"shape mismatch: {f0_l.shape} {f1_w.shape}")
    _check_planes(h, w, fxyz=(fxyz, 3))
    lo, hi = row_range(rows, h)
    count_rows(level_tensor, hi - lo)
    if not on_cuda(f0_l, f1_w, fxyz, *_given(out)):
        return level_tensor_plain(f0_l, f1_w, fxyz, sc, log, rows, out)
    if log and min(h, w) < 2:
        raise ValueError(f"the log tensor's reflect stencil needs a level of at least 2x2, "
                         f"got {h}x{w}")
    J = _out(out, (N_TENSOR, h, w), f0_l)
    launch("tf_level_tensor", f0_l.data_ptr(), f1_w.data_ptr(), fxyz.data_ptr(),
           J.data_ptr(), h, w, lo, hi, float(sc.div4hx), float(sc.div4hy), float(sc.hx_1),
           float(sc.hy_1), int(log))
    level_tensor.launches += 1
    return J


# ---------------------------------------------------------------------------
# outer_prologue: phi/ksi + per-outer hoists (level_fused.py:343-393)
# ---------------------------------------------------------------------------


def outer_prologue_plain(T, uv, fxyz, div2hx, div2hy, alpha_hx2, alpha_hy2,
                         e_s2, e_d2, J=None, row0: int = 0, height=None) -> torch.Tensor:
    """The hoists of a block of rows; ``row0`` and ``height`` place the
    block in a taller level for the free-boundary weights (a shard's
    padded rows; ``edge_weights``). The defaults are the whole level."""
    _, h, w = T.shape
    tu, tv = T[0], T[1]
    phi = phi_from_T(tu, tv, div2hx, div2hy, e_s2)
    phi_c, phi_xp, phi_xm, phi_yp, phi_ym = shifts(phi)
    xp_w, xm_w, yp_w, ym_w = edge_weights(h, w, alpha_hx2, alpha_hy2, T.device, row0, height)
    pw_xp = (phi_xp + phi_c) * 0.5 * xp_w
    pw_xm = (phi_xm + phi_c) * 0.5 * xm_w
    pw_yp = (phi_yp + phi_c) * 0.5 * yp_w
    pw_ym = (phi_ym + phi_c) * 0.5 * ym_w
    sum_h = pw_xp + pw_xm + pw_yp + pw_ym
    fx, fy, ft = fxyz[0], fxyz[1], fxyz[2]
    # ksi is grey for every constancy (reference quirk: bucketed.py:393-396).
    ksi = ksi_grey(fx, fy, ft, tu - uv[0], tv - uv[1], e_d2)
    if J is None:
        J11, J22, J12, J13, J23 = fx * fx, fy * fy, fx * fy, fx * ft, fy * ft
    else:
        J11, J22, J12, J13, J23 = J[0], J[1], J[2], J[3], J[4]
    return torch.stack([
        pw_xp, pw_xm, pw_yp, pw_ym,
        ksi * J12, ksi * J13, ksi * J23,
        ksi * J11 + sum_h, ksi * J22 + sum_h,
    ])


# The prologue kernel's tile: PROLOGUE_TW x PROLOGUE_TH pixels, one thread
# each (csrc/level.cu: PRO_TW; csrc/level_body.cuh: PRO_TH).
PROLOGUE_TW = 32
PROLOGUE_TH = 8


def prologue_tiles(h: int, w: int, tw: int = PROLOGUE_TW):
    """The tiles of one prologue launch on an (h, w) level, or of one pass of
    the sharded kernel's tw-wide tiles over a shard's padded rows, as
    ((y0, y1, x0, x1) of T staged, (y0, y1, x0, x1) of the tile): half-open
    image ranges clipped to the image. T is staged over the tile plus a
    2-pixel ring."""
    for y0 in range(0, h, PROLOGUE_TH):
        for x0 in range(0, w, tw):
            y1, x1 = min(h, y0 + PROLOGUE_TH), min(w, x0 + tw)
            yield ((max(0, y0 - 2), min(h, y1 + 2), max(0, x0 - 2), min(w, x1 + 2)),
                   (y0, y1, x0, x1))


def outer_prologue(T, uv, fxyz, div2hx, div2hy, alpha_hx2, alpha_hy2,
                   e_s2, e_d2, J=None, row0: int = 0, height=None) -> torch.Tensor:
    """(9, h, w) per-outer hoists from the current iterate T; with the
    gradient/log tensor ``J`` (5, h, w), the tensor hoists read it.
    ``row0`` and ``height`` place the h rows in a taller level, as in
    ``outer_prologue_plain`` (a shard's padded block); the defaults are the
    whole level."""
    _, h, w = T.shape
    height = h if height is None else height
    _check_planes(h, w, T=(T, 2), uv=(uv, 2), fxyz=(fxyz, 3))
    if row0 < 0 or row0 + h > height:
        raise ValueError(f"rows {row0}..{row0 + h - 1} are not rows of a level {height} high")
    args = (div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2)
    if J is not None:
        _check_planes(h, w, J=(J, N_TENSOR))
    if not on_cuda(T, uv, fxyz, *(() if J is None else (J,))):
        return outer_prologue_plain(T, uv, fxyz, *args, J=J, row0=row0, height=height)
    hoist = torch.empty((N_HOIST, h, w), dtype=torch.float32, device=T.device)
    if J is None:
        launch("tf_outer_prologue", T.data_ptr(), uv.data_ptr(), fxyz.data_ptr(),
               hoist.data_ptr(), h, w, row0, height, *map(float, args))
        outer_prologue.launches += 1
    else:
        launch("tf_outer_prologue_tensor", T.data_ptr(), uv.data_ptr(), fxyz.data_ptr(),
               J.data_ptr(), hoist.data_ptr(), h, w, row0, height, *map(float, args))
        outer_prologue.tensor_launches += 1
    return hoist


# ---------------------------------------------------------------------------
# jacobi_sweep: one coupled T-form sweep (sweep_core.py, level_fused.py:328-341)
# ---------------------------------------------------------------------------


def jacobi_sweep_plain(T, uv, hoist) -> torch.Tensor:
    tu, tv = T[0], T[1]
    u_c, v_c = uv[0], uv[1]
    _, tu_xp, tu_xm, tu_yp, tu_ym = shifts(tu)
    _, tv_xp, tv_xm, tv_yp, tv_ym = shifts(tv)
    pw = (hoist[0], hoist[1], hoist[2], hoist[3])
    new_du, new_dv = sweep_update_T(
        (tu_xp, tu_xm, tu_yp, tu_ym), (tv_xp, tv_xm, tv_yp, tv_ym),
        u_c, v_c, tv - v_c, pw, hoist[4], hoist[5], hoist[6], hoist[7], hoist[8],
    )
    return torch.stack([u_c + new_du, v_c + new_dv])


def jacobi_sweep(T, uv, hoist) -> torch.Tensor:
    """The next iterate T' (2, h, w) after one sweep (a new buffer)."""
    _, h, w = T.shape
    _check_planes(h, w, T=(T, 2), uv=(uv, 2), hoist=(hoist, N_HOIST))
    if not on_cuda(T, uv, hoist):
        return jacobi_sweep_plain(T, uv, hoist)
    out = torch.empty_like(T)
    launch("tf_jacobi_sweep", T.data_ptr(), uv.data_ptr(), hoist.data_ptr(),
           out.data_ptr(), h, w)
    # Off the main path, this kernel runs where the relaxation is differenced
    # in CUDA graphs (tools/roofline.py): a captured call records the launch
    # and makes none, and the replays launch it without this wrapper.
    if not torch.cuda.is_current_stream_capturing():
        jacobi_sweep.launches += 1
    return out


# ---------------------------------------------------------------------------
# jacobi_sweeps: the inner loop of one outer iteration (level_fused.py:328-341
# run ``inner`` times; the k-sweep wavefront of relax_du.py:457)
# ---------------------------------------------------------------------------

# Sweeps per launch of jacobi_sweeps_kernel, and its region of KSWEEP_RW x
# KSWEEP_RH pixels: a (KSWEEP_RW - 2k) x (KSWEEP_RH - 2k) output tile and a
# k-pixel ring (csrc/level_body.cuh: KS_KMAX, KS_RW, KS_RH).
KMAX = 5
KSWEEP_RW = 64
KSWEEP_RH = 32


def jacobi_sweeps_plain(T, uv, hoist, inner: int) -> torch.Tensor:
    """``inner`` sweeps of fixed ``uv`` and ``hoist`` from T."""
    for _ in range(inner):
        T = jacobi_sweep_plain(T, uv, hoist)
    return T


def jacobi_sweep_chain(T, uv, hoist, inner: int) -> torch.Tensor:
    """``inner`` chained launches of the one-sweep kernel: what
    ``jacobi_sweeps`` computes, one launch per sweep (its twin on the card,
    and the main path's inner loop before the k-sweep kernel)."""
    for _ in range(inner):
        T = jacobi_sweep(T, uv, hoist)
    return T


def ksweep_tiles(h: int, w: int, k: int):
    """The blocks of one jacobi_sweeps launch of ``k`` sweeps on an (h, w)
    level, as (region, tile) pairs of (y0, y1, x0, x1) half-open image
    ranges, both clipped to the image. The region is the tile plus a k-pixel
    ring: what the block reads of T."""
    tw, th = KSWEEP_RW - 2 * k, KSWEEP_RH - 2 * k
    for ty in range(-(-h // th)):
        for tx in range(-(-w // tw)):
            y0, x0 = ty * th, tx * tw
            yield ((max(0, y0 - k), min(h, y0 + th + k), max(0, x0 - k), min(w, x0 + tw + k)),
                   (y0, min(h, y0 + th), x0, min(w, x0 + tw)))


def jacobi_sweeps(T, uv, hoist, inner: int) -> torch.Tensor:
    """The iterate (2, h, w) after ``inner`` sweeps of fixed ``uv`` and
    ``hoist`` from T: ceil(inner / KMAX) launches of the k-sweep kernel on
    the card, each a new buffer; T itself for ``inner`` = 0."""
    _, h, w = T.shape
    _check_planes(h, w, T=(T, 2), uv=(uv, 2), hoist=(hoist, N_HOIST))
    if inner < 0:
        raise ValueError(f"inner must be >= 0, got {inner}")
    if not on_cuda(T, uv, hoist):
        return jacobi_sweeps_plain(T, uv, hoist, inner)
    if min(h, w) < 2:
        raise ValueError(f"the mirror boundary needs a level of at least 2x2, got {h}x{w}")
    for done in range(0, inner, KMAX):
        k = min(KMAX, inner - done)
        out = torch.empty_like(T)
        launch("tf_jacobi_sweeps", T.data_ptr(), uv.data_ptr(), hoist.data_ptr(),
               out.data_ptr(), h, w, k)
        jacobi_sweeps.launches += 1
        T = out
    return T


# ---------------------------------------------------------------------------
# add_median: u + (T - u), then the window median (level_fused.py:432-469)
# ---------------------------------------------------------------------------


def add_median_plain(T, uv, radius: int, rows=None, out=None) -> torch.Tensor:
    """The median of ``uv + (T - uv)`` over ``rows``, the sum taken at the
    rows their windows read."""
    _, h, w = T.shape
    lo, hi = row_range(rows, h)
    r2 = effective_radius(radius) // 2
    # rows lo - r2 .. hi - 1 + r2 reflected once (h > r2) fall in this range
    s_lo, s_hi = max(0, lo - r2), min(h, hi + r2)
    total = placed(uv[:, s_lo:s_hi] + (T[:, s_lo:s_hi] - uv[:, s_lo:s_hi]), (2, h, w),
                   s_lo, s_hi)
    return placed(median_plain(total, radius, lo, hi), (2, h, w), lo, hi, out)


def add_median(T, uv, radius: int, rows=None, out=None) -> torch.Tensor:
    """The level's output flow (2, h, w): the median-filtered ``u + du``,
    over ``rows`` (module docstring)."""
    _, h, w = T.shape
    _check_planes(h, w, T=(T, 2), uv=(uv, 2))
    r = effective_radius(radius)
    lo, hi = row_range(rows, h)
    count_rows(add_median, hi - lo)
    if not on_cuda(T, uv, *_given(out)):
        return add_median_plain(T, uv, r, rows, out)
    if min(h, w) <= r // 2:
        raise ValueError(f"a {r}x{r} reflected window needs a level larger than {r // 2} "
                         f"on each side, got {h}x{w}")
    out = _out(out, (2, h, w), T)
    launch("tf_add_median", T.data_ptr(), uv.data_ptr(), out.data_ptr(), h, w, lo, hi, r)
    add_median.launches += 1
    return out


for _fn in (level_derivs, level_tensor, outer_prologue, jacobi_sweep, jacobi_sweeps,
            add_median):
    _fn.launches = 0
outer_prologue.tensor_launches = 0
for _fn in (level_derivs, level_tensor, add_median):
    _fn.rows, _fn.lane_rows = 0, {}

# Every kernel of the solve's path by name, as (wrapper, its counter attribute):
# the banded kernels under their two wrappers, then the level kernels.
KERNELS = {
    "gaussian_smooth": (gaussian_smooth, "launches"),
    "resample": (resample, "launches"),
    "warp": (warp, "launches"),
    "level_derivs": (level_derivs, "launches"),
    "level_tensor": (level_tensor, "launches"),
    "outer_prologue": (outer_prologue, "launches"),
    "outer_prologue_tensor": (outer_prologue, "tensor_launches"),
    "jacobi_sweep": (jacobi_sweep, "launches"),
    "jacobi_sweeps": (jacobi_sweeps, "launches"),
    "add_median": (add_median, "launches"),
}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


# The whole-field stages that take output rows, by name: the flow's
# resample, the warp, the derivatives, the tensor and add + median.
ROW_STAGES = {name: KERNELS[name][0] for name in
              ("resample", "warp", "level_derivs", "level_tensor", "add_median")}


def reset_row_counts() -> None:
    for fn in ROW_STAGES.values():
        fn.rows, fn.lane_rows = 0, {}


def row_counts(lane: Optional[int] = None) -> dict:
    """The output rows each row stage computed since ``reset_row_counts``:
    in all, or those of one lane (a card of a one-process row over several
    cards, in ``Mesh.row_groups`` order; ``solver_ops.row_lane``)."""
    if lane is None:
        return {name: fn.rows for name, fn in ROW_STAGES.items()}
    return {name: fn.lane_rows.get(lane, 0) for name, fn in ROW_STAGES.items()}

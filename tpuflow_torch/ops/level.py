"""The level kernels: derivatives, the per-outer prologue, the coupled
Jacobi sweep, and add + median — each a CUDA kernel (csrc/level.cu) with
its plain PyTorch version beside it.

Together with the warp (ops/warp.py) they compute one pyramid level, the
function of the TPU's four level kernels:

  * ``level_fused_whole`` (tpuflow/ops/pallas/level_fused.py:526) and
    ``level_fused`` (:472): warp, derivatives, outer x (phi/ksi + inner
    sweeps), add, median;
  * ``_relax_bucket_full`` (tpuflow/ops/pallas/relax_bucket.py:400) and
    ``_relax_du_chunked`` (tpuflow/ops/pallas/relax_du.py:457): the
    outer x inner relaxation alone.

A wrapper runs its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in a plain
integer attribute, ``<wrapper>.launches``.

Packed layouts (contiguous float32 stacks of (h, w) planes):
  fxyz  (3, h, w)  fx, fy, ft
  T     (2, h, w)  the combined iterates Tu = u + du, Tv = v + dv
  uv    (2, h, w)  the flow the level started from
  hoist (9, h, w)  pw_xp, pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv
"""

from __future__ import annotations

import torch

from tpuflow_torch.ops.cuda_lib import launch, on_cuda
from tpuflow_torch.ops.median import effective_radius, median_plain
from tpuflow_torch.ops.solver_ops import (
    div_scalar, edge_weights, ksi_grey, phi_from_T, shifts,
)
from tpuflow_torch.ops.sweep_core import sweep_update_T
from tpuflow_torch.ops.warp import warp

N_HOIST = 9


def _check_planes(h: int, w: int, **stacks: tuple) -> None:
    """Each stack is (tensor, planes); it must have shape (planes, h, w)."""
    for name, (t, planes) in stacks.items():
        if t.shape != (planes, h, w):
            raise ValueError(f"{name}: expected {(planes, h, w)}, got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# level_derivs: fx, fy, ft once per level (level_fused.py:285-289)
# ---------------------------------------------------------------------------


def level_derivs_plain(f0, f1w, div4hx: float, div4hy: float) -> torch.Tensor:
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = shifts(f1w)
    fx = div_scalar(f0_xp - f0_xm + f1_xp - f1_xm, div4hx)
    fy = div_scalar(f0_yp - f0_ym + f1_yp - f1_ym, div4hy)
    return torch.stack([fx, fy, f1_c - f0_c])


def level_derivs(f0, f1w, div4hx: float, div4hy: float) -> torch.Tensor:
    """(3, h, w) grey first derivatives of the level frame and warped frame."""
    h, w = f0.shape
    if f1w.shape != (h, w):
        raise ValueError(f"shape mismatch: {f0.shape} {f1w.shape}")
    if not on_cuda(f0, f1w):
        return level_derivs_plain(f0, f1w, div4hx, div4hy)
    fxyz = torch.empty((3, h, w), dtype=torch.float32, device=f0.device)
    launch("tf_level_derivs", f0.data_ptr(), f1w.data_ptr(), fxyz.data_ptr(),
           h, w, float(div4hx), float(div4hy))
    level_derivs.launches += 1
    return fxyz


# ---------------------------------------------------------------------------
# outer_prologue: phi/ksi + per-outer hoists (level_fused.py:343-393)
# ---------------------------------------------------------------------------


def outer_prologue_plain(T, uv, fxyz, div2hx, div2hy, alpha_hx2, alpha_hy2,
                         e_s2, e_d2) -> torch.Tensor:
    _, h, w = T.shape
    tu, tv = T[0], T[1]
    phi = phi_from_T(tu, tv, div2hx, div2hy, e_s2)
    phi_c, phi_xp, phi_xm, phi_yp, phi_ym = shifts(phi)
    xp_w, xm_w, yp_w, ym_w = edge_weights(h, w, alpha_hx2, alpha_hy2, T.device)
    pw_xp = (phi_xp + phi_c) * 0.5 * xp_w
    pw_xm = (phi_xm + phi_c) * 0.5 * xm_w
    pw_yp = (phi_yp + phi_c) * 0.5 * yp_w
    pw_ym = (phi_ym + phi_c) * 0.5 * ym_w
    sum_h = pw_xp + pw_xm + pw_yp + pw_ym
    fx, fy, ft = fxyz[0], fxyz[1], fxyz[2]
    ksi = ksi_grey(fx, fy, ft, tu - uv[0], tv - uv[1], e_d2)
    return torch.stack([
        pw_xp, pw_xm, pw_yp, pw_ym,
        ksi * (fx * fy), ksi * (fx * ft), ksi * (fy * ft),
        ksi * (fx * fx) + sum_h, ksi * (fy * fy) + sum_h,
    ])


def outer_prologue(T, uv, fxyz, div2hx, div2hy, alpha_hx2, alpha_hy2,
                   e_s2, e_d2) -> torch.Tensor:
    """(9, h, w) per-outer hoists from the current iterate T."""
    _, h, w = T.shape
    _check_planes(h, w, T=(T, 2), uv=(uv, 2), fxyz=(fxyz, 3))
    args = (div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2)
    if not on_cuda(T, uv, fxyz):
        return outer_prologue_plain(T, uv, fxyz, *args)
    hoist = torch.empty((N_HOIST, h, w), dtype=torch.float32, device=T.device)
    launch("tf_outer_prologue", T.data_ptr(), uv.data_ptr(), fxyz.data_ptr(),
           hoist.data_ptr(), h, w, *map(float, args))
    outer_prologue.launches += 1
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
    jacobi_sweep.launches += 1
    return out


# ---------------------------------------------------------------------------
# add_median: u + (T - u), then the window median (level_fused.py:432-469)
# ---------------------------------------------------------------------------


def add_median_plain(T, uv, radius: int) -> torch.Tensor:
    return median_plain(uv + (T - uv), radius)


def add_median(T, uv, radius: int) -> torch.Tensor:
    """The level's output flow (2, h, w): the median-filtered ``u + du``."""
    _, h, w = T.shape
    _check_planes(h, w, T=(T, 2), uv=(uv, 2))
    r = effective_radius(radius)
    if not on_cuda(T, uv):
        return add_median_plain(T, uv, r)
    out = torch.empty_like(T)
    launch("tf_add_median", T.data_ptr(), uv.data_ptr(), out.data_ptr(), h, w, r)
    add_median.launches += 1
    return out


for _fn in (level_derivs, outer_prologue, jacobi_sweep, add_median):
    _fn.launches = 0

# Every kernel wrapper of the level path, by kernel name.
KERNELS = {
    "warp": warp,
    "level_derivs": level_derivs,
    "outer_prologue": outer_prologue,
    "jacobi_sweep": jacobi_sweep,
    "add_median": add_median,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}

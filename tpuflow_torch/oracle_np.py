"""NumPy oracle: float32 transliteration of the reference kernel math.

A copy of ``tpuflow/oracle.py`` whose only change is that it reads
``level_schedule`` from ``tpuflow_torch.pyramid``: importing anything under
``tpuflow`` imports JAX, and the port's GPU checks run where JAX is absent.
A test holds the two bitwise equal.

This module is the permanent ground truth for the test pyramid (the reference
has no tests of its own). Every function mirrors the corresponding CUDA
kernel's arithmetic in float32 with the same per-pixel expression order, so
the JAX/Pallas implementations can be validated against it numerically.

NOT part of the production path — tests and EPE harnesses only.

Kernel sources transliterated (all under the reference's src/kernels/):
  add_2d.cu, registration_2d.cu, resample_2d.cu, convolution_2d.cu,
  median_2d.cu, solve_2d.cu — plus the host-side orchestration in
  src/optical_flow/optical_flow_2d.cpp:142-569 and the Gaussian tap
  computation in src/cuda_operations/2d/cuda_operation_convolution_2d.cpp:83-112.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

F = np.float32


def _reflect_pad(a: np.ndarray, pad: int) -> np.ndarray:
    """Mirror boundary used by all stencil kernels: x<0 -> -x, x>=w -> 2w-x-2
    (reference: solve_2d.cu:75-76, median_2d.cu:107-108). Equals numpy
    'reflect' mode."""
    return np.pad(a, pad, mode="reflect")


# ---------------------------------------------------------------------------
# add_2d.cu
# ---------------------------------------------------------------------------


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """operand_0 += operand_1 (reference: add_2d.cu:42-45)."""
    return (a.astype(F) + b.astype(F)).astype(F)


# ---------------------------------------------------------------------------
# Gaussian presmoothing (convolution_2d.cu + host tap computation)
# ---------------------------------------------------------------------------


def gaussian_kernel(sigma: float, precision: int = 3, pixel_size: float = 1.0) -> np.ndarray:
    """Normalized Gaussian taps, radius = floor(precision * sigma / pixel).

    Reference: src/cuda_operations/2d/cuda_operation_convolution_2d.cpp:83-112.
    """
    radius = int(precision * sigma / pixel_size)
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = (
        1.0 / (sigma * np.sqrt(2.0 * 3.1415926))
        * np.exp(-(i * i * pixel_size * pixel_size) / (2.0 * sigma * sigma))
    ).astype(F)
    total = F(0.0)
    for t in taps:
        total = F(total + t)
    return (taps / total).astype(F)


def convolve_separable(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable 2D convolution with ZERO padding, rows then columns.

    Reference: convolution_2d.cu:74-261 (zero outside the image at :110,:118)
    driven rows-first (cuda_operation_convolution_2d.cpp:169-173).
    """
    img = img.astype(F)
    radius = (len(taps) - 1) // 2

    def conv1d_rows(a: np.ndarray) -> np.ndarray:
        rows, cols = a.shape
        padded = np.zeros((rows, cols + 2 * radius), dtype=F)
        padded[:, radius : radius + cols] = a
        out = np.zeros_like(a)
        for j in range(-radius, radius + 1):
            out = (
                out + taps[radius - j] * padded[:, radius + j : radius + j + cols]
            ).astype(F)
        return out

    tmp = conv1d_rows(img)
    return np.ascontiguousarray(conv1d_rows(np.ascontiguousarray(tmp.T)).T).astype(F)


# ---------------------------------------------------------------------------
# resample_2d.cu — area/box separable resampling
# ---------------------------------------------------------------------------


def _resample_axis_weights(in_n: int, out_n: int) -> list:
    """Per-output-cell (start_index, fraction list), transliterated from
    resample_2d.cu:44-74. Fractions in float32."""
    delta = F(F(in_n) / F(out_n))
    cells = []
    for o in range(out_n):
        left_f = F(F(o) * delta)
        right_f = F(F(o + 1) * delta)
        left_i = int(math.floor(left_f))
        right_i = min(in_n, int(math.ceil(right_f)))
        fracs = []
        n = right_i - left_i
        for j in range(n):
            frac = F(1.0)
            if j == 0:
                frac = F(F(left_i + 1) - left_f)
            if j == n - 1:
                frac = F(right_f - F(left_i + j))
            if n == 1:
                frac = delta
            fracs.append(frac)
        cells.append((left_i, fracs))
    return cells


def resample_x(img: np.ndarray, out_w: int) -> np.ndarray:
    """Resample along x (reference: resample_2d.cu:34-75)."""
    img = img.astype(F)
    h, in_w = img.shape
    norm = F(F(out_w) / F(in_w))
    out = np.zeros((h, out_w), dtype=F)
    for o, (left_i, fracs) in enumerate(_resample_axis_weights(in_w, out_w)):
        value = np.zeros((h,), dtype=F)
        for j, frac in enumerate(fracs):
            value = (value + img[:, left_i + j] * frac).astype(F)
        out[:, o] = (value * norm).astype(F)
    return out


def resample_y(img: np.ndarray, out_h: int) -> np.ndarray:
    """Resample along y (reference: resample_2d.cu:77-118)."""
    img = img.astype(F)
    in_h, w = img.shape
    norm = F(F(out_h) / F(in_h))
    out = np.zeros((out_h, w), dtype=F)
    for o, (left_i, fracs) in enumerate(_resample_axis_weights(in_h, out_h)):
        value = np.zeros((w,), dtype=F)
        for j, frac in enumerate(fracs):
            value = (value + img[left_i + j, :] * frac).astype(F)
        out[o, :] = (value * norm).astype(F)
    return out


def resample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """X then Y, as the host wrapper sequences it
    (reference: cuda_operation_resample_2d.cpp:99-106)."""
    return resample_y(resample_x(img, out_w), out_h)


# ---------------------------------------------------------------------------
# registration_2d.cu — backward warping
# ---------------------------------------------------------------------------


def warp(
    frame_0: np.ndarray,
    frame_1: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    hx: float,
    hy: float,
) -> np.ndarray:
    """Backward-warp frame_1 by (u, v); out-of-range or NaN targets copy
    frame_0 (zeroing the time derivative there).

    Reference: registration_2d.cu:48-72. Flow is stored in ORIGINAL-pixel
    units; kernels convert via 1/hx (registration_2d.cu:49-50).
    """
    frame_0 = frame_0.astype(F)
    frame_1 = frame_1.astype(F)
    h, w = frame_0.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=F), np.arange(w, dtype=F), indexing="ij")
    x_f = (xs + u.astype(F) * F(F(1.0) / F(hx))).astype(F)
    y_f = (ys + v.astype(F) * F(F(1.0) / F(hy))).astype(F)

    invalid = (
        (x_f < 0.0)
        | (x_f > F(w - 1))
        | (y_f < 0.0)
        | (y_f > F(h - 1))
        | np.isnan(x_f)
        | np.isnan(y_f)
    )

    x0 = np.floor(np.where(invalid, 0.0, x_f)).astype(np.int64)
    y0 = np.floor(np.where(invalid, 0.0, y_f)).astype(np.int64)
    dx = (x_f - x0.astype(F)).astype(F)
    dy = (y_f - y0.astype(F)).astype(F)
    x1 = np.minimum(w - 1, x0 + 1)
    y1 = np.minimum(h - 1, y0 + 1)

    one = F(1.0)
    value = (
        ((one - dx) * (one - dy)).astype(F) * frame_1[y0, x0]
        + (dx * (one - dy)).astype(F) * frame_1[y0, x1]
        + ((one - dx) * dy).astype(F) * frame_1[y1, x0]
        + (dx * dy).astype(F) * frame_1[y1, x1]
    ).astype(F)

    return np.where(invalid, frame_0, value).astype(F)


# ---------------------------------------------------------------------------
# median_2d.cu — window median with mirror boundary
# ---------------------------------------------------------------------------


def median(img: np.ndarray, radius: int) -> np.ndarray:
    """Median over a (radius x radius) window, mirror boundary.

    ``radius`` is the window SIDE (3/5/7). Host-wrapper guards replicated:
    radius 1 -> copy, even radius decremented
    (reference: cuda_operation_median_2d.cpp:100-109), > 7 rejected (:152-154).
    Kernel: median_2d.cu:87-299 (the 180-degree rotated gather at :284-286 is
    irrelevant to a median).
    """
    if radius > 7:
        raise ValueError("median radius > 7 not supported (reference parity)")
    if radius % 2 == 0:
        radius -= 1
    if radius <= 1:
        return img.astype(F).copy()
    img = img.astype(F)
    r2 = radius // 2
    padded = _reflect_pad(img, r2)
    h, w = img.shape
    stack = np.stack(
        [
            padded[iy : iy + h, ix : ix + w]
            for iy in range(radius)
            for ix in range(radius)
        ],
        axis=-1,
    )
    stack.sort(axis=-1)
    return stack[..., (radius * radius) // 2].astype(F)


# ---------------------------------------------------------------------------
# solve_2d.cu — phi/ksi (lagged nonlinearity) and Jacobi sweeps
# ---------------------------------------------------------------------------


def _shifts(a: np.ndarray):
    """(center, x+1, x-1, y+1, y-1) views with reflect boundary."""
    p = _reflect_pad(a.astype(F), 1)
    c = p[1:-1, 1:-1]
    xp = p[1:-1, 2:]
    xm = p[1:-1, :-2]
    yp = p[2:, 1:-1]
    ym = p[:-2, 1:-1]
    return c, xp, xm, yp, ym


def compute_phi_ksi(
    f0, f1, u, v, du, dv, hx, hy, e_smooth, e_data
) -> Tuple[np.ndarray, np.ndarray]:
    """Flow-driven diffusivity phi and data-term penalizer ksi.

    Reference: solve_2d.cu:43-198. Note ksi always uses the GREY motion
    tensor even for gradient/log solvers (only one compute_phi_ksi exists,
    cuda_operation_solve_2d.cpp:84).
    """
    hx, hy = F(hx), F(hy)
    e_smooth, e_data = F(e_smooth), F(e_data)

    _, u_xp, u_xm, u_yp, u_ym = _shifts(u)
    _, v_xp, v_xm, v_yp, v_ym = _shifts(v)
    du_c, du_xp, du_xm, du_yp, du_ym = _shifts(du)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = _shifts(dv)
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _shifts(f1)

    dux = ((u_xp - u_xm + du_xp - du_xm) / (F(2.0) * hx)).astype(F)
    duy = ((u_yp - u_ym + du_yp - du_ym) / (F(2.0) * hy)).astype(F)
    dvx = ((v_xp - v_xm + dv_xp - dv_xm) / (F(2.0) * hx)).astype(F)
    dvy = ((v_yp - v_ym + dv_yp - dv_ym) / (F(2.0) * hy)).astype(F)

    phi = (
        F(1.0)
        / (F(2.0) * np.sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_smooth * e_smooth))
    ).astype(F)

    fx = ((f0_xp - f0_xm + f1_xp - f1_xm) / (F(4.0) * hx)).astype(F)
    fy = ((f0_yp - f0_ym + f1_yp - f1_ym) / (F(4.0) * hy)).astype(F)
    ft = (f1_c - f0_c).astype(F)

    J11, J22, J33 = fx * fx, fy * fy, ft * ft
    J12, J13, J23 = fx * fy, fx * ft, fy * ft

    s = (
        (J11 * du_c + J12 * dv_c + J13) * du_c
        + (J12 * du_c + J22 * dv_c + J23) * dv_c
        + (J13 * du_c + J23 * dv_c + J33)
    ).astype(F)
    s = ((s > 0).astype(F) * s).astype(F)

    ksi = (F(1.0) / (F(2.0) * np.sqrt(s + e_data * e_data))).astype(F)
    return phi, ksi


def _edge_masks(h: int, w: int, hx: float, hy: float, alpha: float):
    """Free-boundary neighbor weights alpha/h^2, zeroed at image borders
    (reference: solve_2d.cu:333-340)."""
    hx_2 = F(F(alpha) / (F(hx) * F(hx)))
    hy_2 = F(F(alpha) / (F(hy) * F(hy)))
    xs = np.arange(w)
    ys = np.arange(h)
    xp = ((xs < w - 1).astype(F) * hx_2)[None, :] * np.ones((h, 1), F)
    xm = ((xs > 0).astype(F) * hx_2)[None, :] * np.ones((h, 1), F)
    yp = ((ys < h - 1).astype(F) * hy_2)[:, None] * np.ones((1, w), F)
    ym = ((ys > 0).astype(F) * hy_2)[:, None] * np.ones((1, w), F)
    return xp.astype(F), xm.astype(F), yp.astype(F), ym.astype(F)


# CUDA launch geometry of the reference solve kernels
# (cuda_operation_solve_2d.cpp: 16x8 blocks). Used only by the
# block-artifact emulation below.
BLOCK_X, BLOCK_Y = 16, 8


def _block_edge_masks(h: int, w: int):
    xs = np.arange(w)[None, :] * np.ones((h, 1), np.int64)
    ys = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    return (
        xs % BLOCK_X == BLOCK_X - 1,   # block-right edge
        xs % BLOCK_X == 0,             # block-left edge
        ys % BLOCK_Y == BLOCK_Y - 1,   # block-bottom edge
        ys % BLOCK_Y == 0,             # block-top edge
    )


def _shifts_log_bug(a: np.ndarray):
    """Shifts as the reference LOG kernel actually sees its input tiles:
    the halo loads are off by one (solve_2d.cu:449 `global_x - 1 + 1`,
    :463 `global_x + 1 - 1`, :476, :490), so at every 16x8 block border
    the halo slot holds the block's own edge cell (replicate) instead of
    the true neighbor. Interior and image-edge-through-out-of-grid-thread
    behavior is the normal mirror."""
    c, xp, xm, yp, ym = _shifts(a)
    bxp, bxm, byp, bym = _block_edge_masks(*a.shape)
    xp = np.where(bxp, c, xp).astype(F)
    xm = np.where(bxm, c, xm).astype(F)
    yp = np.where(byp, c, yp).astype(F)
    ym = np.where(bym, c, ym).astype(F)
    return c, xp, xm, yp, ym


def _shifts_block_replicate(a: np.ndarray):
    """Shifts of a derivative field staged with per-block REPLICATED halos
    (reference: solve_2d.cu:813-841 grad, :525-556 log): at block borders
    the halo holds the block's own edge cell. At partial edge blocks the
    reference reads UNINITIALIZED shared memory (out-of-grid threads never
    write their derivative slots) — unemulatable; modeled as replicate,
    which is also the clean-math image-edge rule."""
    p = np.pad(a.astype(F), 1, mode="edge")
    c = p[1:-1, 1:-1]
    xp = p[1:-1, 2:]
    xm = p[1:-1, :-2]
    yp = p[2:, 1:-1]
    ym = p[:-2, 1:-1]
    bxp, bxm, byp, bym = _block_edge_masks(*a.shape)
    xp = np.where(bxp, c, xp).astype(F)
    xm = np.where(bxm, c, xm).astype(F)
    yp = np.where(byp, c, yp).astype(F)
    ym = np.where(bym, c, ym).astype(F)
    return xp, xm, yp, ym


def _sweep_common(u, v, du, dv, phi, ksi, hx, hy, alpha, J11, J22, J12, J13, J23,
                  shifts=_shifts):
    """Shared Jacobi-sweep update given a motion tensor.

    Reference: solve_2d.cu:333-374 — arithmetic-mean half-point
    diffusivities, free-boundary masks, and the sequential du* -> dv*
    intra-pixel coupling (Gauss-Seidel in (u,v), Jacobi across pixels).

    ``shifts`` selects how neighbor values are read: the clean mirror
    (default) or the LOG kernel's buggy block-border tiles.
    """
    h, w = u.shape
    xp, xm, yp, ym = _edge_masks(h, w, hx, hy, alpha)

    phi_c, phi_xp_n, phi_xm_n, phi_yp_n, phi_ym_n = shifts(phi)
    u_c, u_xp, u_xm, u_yp, u_ym = shifts(u)
    v_c, v_xp, v_xm, v_yp, v_ym = shifts(v)
    du_c, du_xp, du_xm, du_yp, du_ym = shifts(du)
    dv_c, dv_xp, dv_xm, dv_yp, dv_ym = shifts(dv)
    ksi_c = ksi.astype(F)

    half = F(2.0)
    phi_xp = ((phi_xp_n + phi_c) / half).astype(F)
    phi_xm = ((phi_xm_n + phi_c) / half).astype(F)
    phi_yp = ((phi_yp_n + phi_c) / half).astype(F)
    phi_ym = ((phi_ym_n + phi_c) / half).astype(F)

    sumH = (xp * phi_xp + xm * phi_xm + yp * phi_yp + ym * phi_ym).astype(F)
    sumU = (
        phi_xp * xp * (u_xp + du_xp - u_c)
        + phi_xm * xm * (u_xm + du_xm - u_c)
        + phi_yp * yp * (u_yp + du_yp - u_c)
        + phi_ym * ym * (u_ym + du_ym - u_c)
    ).astype(F)
    sumV = (
        phi_xp * xp * (v_xp + dv_xp - v_c)
        + phi_xm * xm * (v_xm + dv_xm - v_c)
        + phi_yp * yp * (v_yp + dv_yp - v_c)
        + phi_ym * ym * (v_ym + dv_ym - v_c)
    ).astype(F)

    result_du = ((ksi_c * (-J13 - J12 * dv_c) + sumU) / (ksi_c * J11 + sumH)).astype(F)
    result_dv = ((ksi_c * (-J23 - J12 * result_du) + sumV) / (ksi_c * J22 + sumH)).astype(F)
    return result_du, result_dv


def solve_sweep_grey(f0, f1, u, v, du, dv, phi, ksi, hx, hy, alpha):
    """One Jacobi sweep, grey (brightness) constancy.

    Reference: solve_2d.cu:200-377 — the grey motion tensor is recomputed
    in-kernel from central differences averaged over both frames.
    """
    hx, hy = F(hx), F(hy)
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _shifts(f1)

    fx = ((f0_xp - f0_xm + f1_xp - f1_xm) / (F(4.0) * hx)).astype(F)
    fy = ((f0_yp - f0_ym + f1_yp - f1_ym) / (F(4.0) * hy)).astype(F)
    ft = (f1_c - f0_c).astype(F)

    J11, J22 = fx * fx, fy * fy
    J12, J13, J23 = fx * fy, fx * ft, fy * ft
    return _sweep_common(u, v, du, dv, phi, ksi, hx, hy, alpha, J11, J22, J12, J13, J23)


def _second_order_tensor(fx, fy, ft, hx, hy, block_emulation=False):
    """Second-order (gradient-constancy) motion tensor from first-derivative
    fields, using REPLICATE boundary for the derivative fields
    (reference: solve_2d.cu:813-841 replicates at tile borders; the clean
    global equivalent is edge replication).

    block_emulation=True reproduces the reference's per-16x8-CUDA-block
    replication (the halos replicate at EVERY block border, not just the
    image edge) — the blocking artifact quantified in BASELINE.md.

    Reference: solve_2d.cu:867-884.
    """
    hx_1 = F(np.float64(1.0) / (np.float64(2.0) * np.float64(hx)))
    hy_1 = F(np.float64(1.0) / (np.float64(2.0) * np.float64(hy)))

    def shifts_edge(a):
        if block_emulation:
            return _shifts_block_replicate(a)
        p = np.pad(a, 1, mode="edge")
        return p[1:-1, 2:], p[1:-1, :-2], p[2:, 1:-1], p[:-2, 1:-1]

    fx_xp, fx_xm, fx_yp, fx_ym = shifts_edge(fx)
    fy_xp, fy_xm, fy_yp, fy_ym = shifts_edge(fy)
    ft_xp, ft_xm, ft_yp, ft_ym = shifts_edge(ft)

    fxx = ((fx_xp - fx_xm) * hx_1).astype(F)
    fxy = ((fx_yp - fx_ym) * hy_1).astype(F)
    fyy = ((fy_yp - fy_ym) * hy_1).astype(F)
    fxt = ((ft_xp - ft_xm) * hx_1).astype(F)
    fyt = ((ft_yp - ft_ym) * hy_1).astype(F)

    J11 = (fxx * fxx + fxy * fxy).astype(F)
    J22 = (fxy * fxy + fyy * fyy).astype(F)
    J12 = (fxx * fxy + fxy * fyy).astype(F)
    J13 = (fxx * fxt + fxy * fyt).astype(F)
    J23 = (fxy * fxt + fyy * fyt).astype(F)
    return J11, J22, J12, J13, J23


def solve_sweep_grad(f0, f1, u, v, du, dv, phi, ksi, hx, hy, alpha,
                     block_emulation=False):
    """One Jacobi sweep, gradient constancy.

    Reference: solve_2d.cu:683-953. The reference's input tiles load TRUE
    mirror halos (:738-790), so only the derivative fields carry the
    per-CUDA-block replication artifact (:813-841). Default is the clean
    global stencil (edge replication at image borders — what the
    replication degenerates to for one image-wide block);
    block_emulation=True reproduces the 16x8 blocking in the tensor.
    """
    hx, hy = F(hx), F(hy)
    f0_c, f0_xp, f0_xm, f0_yp, f0_ym = _shifts(f0)
    f1_c, f1_xp, f1_xm, f1_yp, f1_ym = _shifts(f1)

    fx = ((f0_xp - f0_xm + f1_xp - f1_xm) / (F(4.0) * hx)).astype(F)
    fy = ((f0_yp - f0_ym + f1_yp - f1_ym) / (F(4.0) * hy)).astype(F)
    ft = (f1_c - f0_c).astype(F)

    J11, J22, J12, J13, J23 = _second_order_tensor(
        fx, fy, ft, hx, hy, block_emulation
    )
    return _sweep_common(u, v, du, dv, phi, ksi, hx, hy, alpha, J11, J22, J12, J13, J23)


def solve_sweep_log(f0, f1, u, v, du, dv, phi, ksi, hx, hy, alpha,
                    block_emulation=False):
    """One Jacobi sweep, log-derivative constancy.

    Reference: solve_2d.cu:391-669 — the gradient variant with derivatives
    of log(1 + I) (:508-524). Beyond the derivative-tile replication it
    shares with grad, the LOG kernel's input-tile halo loads are buggy
    (:449 `global_x - 1 + 1`, :463 `global_x + 1 - 1`, :476, :490): every
    16x8 block border sees the block's own edge cell for f0, f1, u, v,
    du, dv, phi — i.e. the bug distorts the first derivatives AND the
    smoothness sums, not just the tensor. Default is clean math;
    block_emulation=True reproduces both artifacts.
    """
    hx, hy = F(hx), F(hy)
    log0 = np.log1p(f0.astype(F)).astype(F)
    log1 = np.log1p(f1.astype(F)).astype(F)

    shifts = _shifts_log_bug if block_emulation else _shifts
    l0_c, l0_xp, l0_xm, l0_yp, l0_ym = shifts(log0)
    l1_c, l1_xp, l1_xm, l1_yp, l1_ym = shifts(log1)

    fx = ((l0_xp - l0_xm + l1_xp - l1_xm) / (F(4.0) * hx)).astype(F)
    fy = ((l0_yp - l0_ym + l1_yp - l1_ym) / (F(4.0) * hy)).astype(F)
    ft = (l1_c - l0_c).astype(F)

    J11, J22, J12, J13, J23 = _second_order_tensor(
        fx, fy, ft, hx, hy, block_emulation
    )
    return _sweep_common(u, v, du, dv, phi, ksi, hx, hy, alpha,
                         J11, J22, J12, J13, J23, shifts=shifts)


_SWEEPS = {
    "grey": solve_sweep_grey,
    "gradient": solve_sweep_grad,
    "log": solve_sweep_log,
}


# ---------------------------------------------------------------------------
# Full pipeline (optical_flow_2d.cpp ComputeFlow)
# ---------------------------------------------------------------------------


def compute_flow(
    frame_0: np.ndarray,
    frame_1: np.ndarray,
    *,
    warp_levels_count: int = 50,
    warp_scale_factor: float = 0.9,
    outer_iterations_count: int = 40,
    inner_iterations_count: int = 5,
    equation_alpha: float = 35.0,
    equation_smoothness: float = 0.001,
    equation_data: float = 0.001,
    median_radius: int = 5,
    gaussian_sigma: float = 1.5,
    data_constancy: str = "grey",
    block_emulation: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full coarse-to-fine solve, transliterating
    reference: src/optical_flow/optical_flow_2d.cpp:142-569.

    block_emulation=True reproduces the reference grad/log kernels'
    16x8-CUDA-block halo artifacts (see solve_sweep_grad/solve_sweep_log);
    no effect for grey constancy. Used to QUANTIFY the artifact: the
    measured clean-vs-block deviation on the rub pair is recorded in
    BASELINE.md."""
    from tpuflow_torch.pyramid import level_schedule

    frame_0 = frame_0.astype(F)
    frame_1 = frame_1.astype(F)
    orig_h, orig_w = frame_0.shape
    sweep = _SWEEPS[data_constancy]

    # Gaussian presmoothing, once, at full resolution (:218-260).
    if gaussian_sigma > 0.0:
        taps = gaussian_kernel(gaussian_sigma)
        frame_0 = convolve_separable(frame_0, taps)
        frame_1 = convolve_separable(frame_1, taps)

    u = v = None
    prev_w = prev_h = 0
    for spec in level_schedule(orig_w, orig_h, warp_levels_count, warp_scale_factor):
        cw, ch, hx, hy = spec.width, spec.height, spec.hx, spec.hy

        # Frames ALWAYS resampled from full-res smoothed frames (:283-304);
        # level 0 uses them directly (:280-282).
        if spec.level == 0:
            f0_l, f1_l = frame_0, frame_1
        else:
            f0_l = resample(frame_0, cw, ch)
            f1_l = resample(frame_1, cw, ch)

        # Flow prolongation (:309-340); flow is in original-pixel units so no
        # value rescale is needed.
        if u is None:
            u = np.zeros((ch, cw), dtype=F)
            v = np.zeros((ch, cw), dtype=F)
        else:
            u = resample(u[:prev_h, :prev_w], cw, ch)
            v = resample(v[:prev_h, :prev_w], cw, ch)

        # Backward registration (:343-363).
        f1_w = warp(f0_l, f1_l, u, v, hx, hy)

        # Relaxation: du,dv zero-init; outer x (1 phi_ksi + inner sweeps)
        # with ping-pong (cuda_operation_solve_2d.cpp:229-300).
        du = np.zeros((ch, cw), dtype=F)
        dv = np.zeros((ch, cw), dtype=F)
        for _ in range(outer_iterations_count):
            phi, ksi = compute_phi_ksi(
                f0_l, f1_w, u, v, du, dv, hx, hy, equation_smoothness, equation_data
            )
            for _ in range(inner_iterations_count):
                if data_constancy == "grey":
                    du, dv = sweep(
                        f0_l, f1_w, u, v, du, dv, phi, ksi, hx, hy, equation_alpha
                    )
                else:
                    du, dv = sweep(
                        f0_l, f1_w, u, v, du, dv, phi, ksi, hx, hy,
                        equation_alpha, block_emulation
                    )

        # Add increment (:409-421), then median filtering (:428-449).
        u = add(u, du)
        v = add(v, dv)
        u = median(u, median_radius)
        v = median(v, median_radius)

        prev_w, prev_h = cw, ch

    return u, v

"""tpuflow_torch's per-pixel and stencil ops (the plain versions the CPU
runs) against the JAX package and the NumPy oracle, on the same seeded
numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuflow.oracle as oracle
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.ops.gaussian import _conv_matrix as jconv_matrix
from tpuflow.ops.gaussian import gaussian_kernel_taps as jtaps
from tpuflow.ops.gaussian import gaussian_smooth as jgaussian_smooth
from tpuflow.ops.median import median as jmedian
from tpuflow.ops.resample import resample_weights as jresample_weights
from tpuflow.solver.bucketed import level_constants, warp_dyn, warp_gather
from tpuflow.solver.bucketed import LevelScalars as JLevelScalars

from tpuflow_torch.ops.gaussian import conv_matrix, gaussian_kernel_taps, gaussian_smooth
from tpuflow_torch.ops.level import jacobi_sweep, level_derivs
from tpuflow_torch.ops.median import median_plain
from tpuflow_torch.ops.resample import resample, resample_weights
from tpuflow_torch.ops.warp import warp
from tpuflow_torch.solver.level import LevelScalars

torch.set_num_threads(2)

T = torch.from_numpy


def frame(h, w, seed):
    return (np.random.default_rng(seed).random((h, w)) * 255).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.8, 1.5, 3.0])
def test_gaussian_taps_and_matrix_equal_jax(sigma):
    assert gaussian_kernel_taps(sigma).tobytes() == jtaps(sigma).tobytes()
    assert conv_matrix(37, sigma).tobytes() == jconv_matrix(37, sigma).tobytes()


@pytest.mark.parametrize("sigma,h,w", [(1.5, 48, 72), (0.8, 40, 33), (3.0, 61, 50)])
def test_gaussian_smooth_matches_jax_and_oracle(sigma, h, w):
    img = frame(h, w, seed=int(sigma * 10))
    got = gaussian_smooth(T(img), sigma).numpy()
    np.testing.assert_allclose(got, np.asarray(jgaussian_smooth(jnp.asarray(img), sigma)),
                               rtol=1e-5, atol=1e-4)
    want = oracle.convolve_separable(img, oracle.gaussian_kernel(sigma))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((48, 72), (33, 50)), ((388, 584), (350, 526)), ((24, 21), (36, 32)), ((5, 7), (4, 4)),
])
def test_resample_matches_oracle(in_hw, out_hw):
    (ih, iw), (oh, ow) = in_hw, out_hw
    assert resample_weights(iw, ow).tobytes() == jresample_weights(iw, ow).tobytes()
    img = frame(ih, iw, seed=ih)
    got = resample(T(np.stack([img, img[::-1].copy()])), ow, oh).numpy()
    np.testing.assert_allclose(got[0], oracle.resample(img, ow, oh), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1], oracle.resample(img[::-1], ow, oh),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("radius", [1, 3, 4, 5, 6, 7])
def test_median_equals_jax(radius):
    stack = np.stack([frame(23, 31, seed=radius), frame(23, 31, seed=radius + 10)])
    got = median_plain(T(stack), radius).numpy()
    for p in range(2):
        want = np.asarray(jmedian(jnp.asarray(stack[p]), radius))
        assert np.array_equal(got[p], want), radius
        assert np.array_equal(got[p], oracle.median(stack[p], radius))


def test_median_rejects_radius_above_7():
    with pytest.raises(ValueError):
        median_plain(torch.zeros(8, 8), 9)


def _warp_case(scale, seed=5, h=40, w=52, hx=1.3, hy=1.2):
    """Frames and a level-pixel flow of the given uniform scale, with a few
    out-of-bounds and NaN targets; flow is returned in original pixels."""
    rng = np.random.default_rng(seed)
    f0, f1 = frame(h, w, seed), frame(h, w, seed + 1)
    lvl = rng.uniform(-scale, scale, (2, h, w)).astype(np.float32)
    uv = np.stack([lvl[0] * np.float32(hx), lvl[1] * np.float32(hy)])
    uv[0, :, :2] = -60.0
    uv[1, -2:, :] = 60.0
    uv[0, 5, 7] = np.nan
    uv[1, 9, 11] = np.nan
    sc = JLevelScalars.make(w, h, hx, hy, 35.0, w, h, w, h)
    return f0, f1, uv, sc


def _tier(uv, sc):
    """The TPU warp tier warp_dyn takes: 0 (+-4), 1 (+-8) or 2 (gather)."""
    h, w = uv.shape[1:]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x_f = xs + uv[0] * sc.inv_hx
    y_f = ys + uv[1] * sc.inv_hy
    with np.errstate(invalid="ignore"):
        ok = (x_f >= 0) & (x_f <= sc.wlim) & (y_f >= 0) & (y_f <= sc.hlim)
    dq = np.maximum(np.abs(np.floor(x_f[ok]) - xs[ok]), np.abs(np.floor(y_f[ok]) - ys[ok]))
    m = dq.max()
    return 0 if m <= 4 else (1 if m <= 8 else 2)


@pytest.mark.parametrize("scale,tier", [(0.4, 0), (6.0, 1), (24.0, 2)])
def test_warp_matches_jax_tiers_and_oracle(scale, tier):
    f0, f1, uv, sc = _warp_case(scale)
    assert _tier(uv, sc) == tier
    h, w = f0.shape
    got = warp(T(f0), T(f1), T(uv), sc.inv_hx, sc.inv_hy).numpy()
    args = (jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(uv[0]), jnp.asarray(uv[1]),
            w, h, sc.inv_hx, sc.inv_hy, sc.wlim, sc.hlim)
    for want in (warp_dyn(*args), warp_gather(*args),
                 oracle.warp(f0, f1, uv[0], uv[1], 1.3, 1.2)):
        assert np.abs(got - np.asarray(want)).max() <= 1e-4


def test_warp_out_of_bounds_and_nan_copy_frame0():
    f0, f1, uv, sc = _warp_case(0.4)
    got = warp(T(f0), T(f1), T(uv), sc.inv_hx, sc.inv_hy).numpy()
    assert np.array_equal(got[:, :2], f0[:, :2])
    assert np.array_equal(got[-2:, :], f0[-2:, :])
    assert got[5, 7] == f0[5, 7] and got[9, 11] == f0[9, 11]


def test_level_derivs_match_level_constants():
    h, w = 37, 45
    f0, f1 = frame(h, w, 1), frame(h, w, 2)
    jsc = JLevelScalars.make(w, h, 1.3, 1.2, 35.0, w, h, w, h)
    sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
    fx, fy, ft, _ = level_constants(jnp.asarray(f0), jnp.asarray(f1), jsc.tree(), JFlowConfig())
    got = level_derivs(T(f0), T(f1), sc.div4hx, sc.div4hy).numpy()
    for g, want in zip(got, (fx, fy, ft)):
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_wrappers_reject_what_the_kernels_cannot_take():
    a = torch.zeros(8, 9)
    uv = torch.zeros(2, 8, 9)
    with pytest.raises(TypeError):
        warp(a.double(), a.double(), uv.double(), 1.0, 1.0)
    with pytest.raises(ValueError):
        warp(a, a, torch.zeros(2, 9, 8).transpose(1, 2), 1.0, 1.0)
    with pytest.raises(ValueError):
        jacobi_sweep(uv, uv, torch.zeros(8, 8, 9))

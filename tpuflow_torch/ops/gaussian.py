"""Gaussian presmoothing: separable zero-padded convolution as two matmuls.

Taps follow the reference host computation (tpuflow/ops/gaussian.py:30-49,
reference: src/cuda_operations/2d/cuda_operation_convolution_2d.cpp:83-112);
the zero-padded 1-D convolutions are banded Toeplitz matrices
(tpuflow/ops/gaussian.py:74-89) applied rows first, then columns
(tpuflow/ops/gaussian.py:114-118). It runs once per frame pair, outside
any kernel, as in the JAX package; the matmuls are float32 (TF32 is
switched off by ``compute_flow``). The matrices are built on the host and
kept on the device per (n, sigma, device): an upload from pageable memory
on every call would wait for all the work queued before it. Every stream of
the device reads them (``ops/device_cache.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from tpuflow_torch.ops.device_cache import device_cached

MAX_TAPS = 51  # same cap as the reference __constant__ c_Kernel[51]


@functools.lru_cache(maxsize=64)
def gaussian_kernel_taps(
    sigma: float, precision: int = 3, pixel_size: float = 1.0
) -> np.ndarray:
    """Normalized float32 Gaussian taps (host-side, cached)."""
    radius = int(precision * sigma / pixel_size)
    if 2 * radius + 1 > MAX_TAPS:
        raise ValueError(
            f"gaussian kernel length {2 * radius + 1} exceeds {MAX_TAPS} "
            "(reference parity limit)"
        )
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = (
        1.0
        / (sigma * np.sqrt(2.0 * 3.1415926))
        * np.exp(-(i * i * pixel_size * pixel_size) / (2.0 * sigma * sigma))
    ).astype(np.float32)
    total = np.float32(0.0)
    for t in taps:
        total = np.float32(total + t)
    return (taps / total).astype(np.float32)


@functools.lru_cache(maxsize=256)
def conv_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) float32 banded matrix of the zero-padded 1-D convolution:
    row i holds the taps centred at i, truncated at the edges."""
    taps = gaussian_kernel_taps(sigma)
    radius = (len(taps) - 1) // 2
    m = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo = max(0, i - radius)
        hi = min(n, i + radius + 1)
        m[i, lo:hi] = taps[lo - i + radius: hi - i + radius]
    return m


@device_cached(maxsize=64)
def _device_matrix(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(conv_matrix(n, sigma)).to(device)


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smooth the last two dims of ``img`` (rows, then columns).

    No-op when sigma <= 0 (reference: src/optical_flow/optical_flow_2d.cpp:218).
    """
    if sigma <= 0.0:
        return img
    h, w = img.shape[-2:]
    with record_function("gaussian"):  # the layer's range in a profile
        mx = _device_matrix(w, float(sigma), img.device)
        my = _device_matrix(h, float(sigma), img.device)
        return torch.matmul(my, torch.matmul(img, mx.T)).contiguous()

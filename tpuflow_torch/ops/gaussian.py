"""Gaussian presmoothing: separable zero-padded convolution, rows first,
then columns, each a banded pass (ops/banded.py).

Taps follow the reference host computation (tpuflow/ops/gaussian.py:30-49,
reference: src/cuda_operations/2d/cuda_operation_convolution_2d.cpp:83-112).
Each output sums its taps times the inputs in ascending input order, with
the window truncated at the edges: the zero padding's terms add +0 to a
sum that is never -0, so this is the reference's convolution
(convolution_2d.cu:74-261, transliterated in oracle_np.py:71-92) to the
bit. It runs once per frame pair. On the card it is two launches of the
banded kernels with a one-level plan, which replace the JAX package's two
banded Toeplitz matmuls (tpuflow/ops/gaussian.py:92);
``gaussian_smooth_plain`` is the same sum on any device. The windows are
built on the host once per shape and sigma and kept on the device
(``banded.plan_table``).

``conv_matrix`` is the dense Toeplitz matrix of the same taps, byte for
byte the JAX package's; the port's solve does not use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from tpuflow_torch.ops.banded import AXIS_X, AXIS_Y, Band, banded_levels, banded_plain
from tpuflow_torch.ops.cuda_lib import on_cuda

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
def gaussian_band(n: int, sigma: float) -> Band:
    """Output i reads inputs max(0, i - r) .. min(n, i + r + 1) - 1, input k
    with tap ``taps[r - (k - i)]``, as the reference indexes them."""
    taps = gaussian_kernel_taps(sigma)
    radius = (len(taps) - 1) // 2
    i = np.arange(n)
    first = np.maximum(0, i - radius)
    count = np.minimum(n, i + radius + 1) - first
    width = int(count.max())
    k = first[:, None] + np.arange(width)[None, :]
    weights = taps[np.clip(radius - (k - i[:, None]), 0, 2 * radius)]
    weights[np.arange(width)[None, :] >= count[:, None]] = 0.0
    return Band(first=first.astype(np.int32), count=count.astype(np.int32),
                weights=weights.astype(np.float32), norm=1.0)


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


def gaussian_smooth_plain(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """The kernel's two passes by gathers, on any device (sigma > 0)."""
    h, w = img.shape[-2:]
    tmp = banded_plain(img, gaussian_band(w, float(sigma)), AXIS_X)
    return banded_plain(tmp, gaussian_band(h, float(sigma)), AXIS_Y)


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smooth the last two dims of ``img`` (rows, then columns): on a CUDA
    tensor two launches of the banded kernels, counted in
    ``gaussian_smooth.launches``; on a CPU tensor ``gaussian_smooth_plain``.

    No-op when sigma <= 0 (reference: src/optical_flow/optical_flow_2d.cpp:218).
    """
    if sigma <= 0.0:
        return img
    h, w = img.shape[-2:]
    sigma = float(sigma)
    with record_function("gaussian"):  # the layer's range in a profile
        img = img.contiguous()
        if not on_cuda(img):
            return gaussian_smooth_plain(img, sigma)
        out = banded_levels(img, ((gaussian_band, w, sigma),),
                            ((gaussian_band, h, sigma),))[0]
        if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
            gaussian_smooth.launches += 2
        return out


gaussian_smooth.launches = 0

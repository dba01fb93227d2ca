"""Area (box) resampling as two matmuls, ``W_y @ (x @ W_x^T)``.

The weights transliterate the fraction logic of the reference kernel
(tpuflow/ops/resample.py:32-57, reference: src/kernels/resample_2d.cu:44-74)
with the ``out/in`` normalisation folded in; X is applied first, then Y
(reference: cuda_operation_resample_2d.cpp:99-106). Weights are built on
the host once per (in, out) pair and kept on the device, where every stream
reads them (``ops/device_cache.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.profiler import record_function

from tpuflow_torch.ops.device_cache import device_cached

F = np.float32


@functools.lru_cache(maxsize=1024)
def resample_weights(in_n: int, out_n: int) -> np.ndarray:
    """(out_n, in_n) float32 box-overlap weight matrix, normalisation folded in."""
    delta = F(F(in_n) / F(out_n))
    norm = F(F(out_n) / F(in_n))
    w = np.zeros((out_n, in_n), dtype=F)
    for o in range(out_n):
        left_f = F(F(o) * delta)
        right_f = F(F(o + 1) * delta)
        left_i = int(math.floor(left_f))
        right_i = min(in_n, int(math.ceil(right_f)))
        n = right_i - left_i
        for j in range(n):
            frac = F(1.0)
            if j == 0:
                frac = F(F(left_i + 1) - left_f)
            if j == n - 1:
                frac = F(right_f - F(left_i + j))
            if n == 1:
                frac = delta
            w[o, left_i + j] = F(frac * norm)
    return w


@device_cached(maxsize=1024)
def _device_weights(in_n: int, out_n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resample_weights(in_n, out_n)).to(device)


def resample(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Resample the last two dims of ``img`` to (out_h, out_w)."""
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    with record_function("resample"):  # the layer's range in a profile
        wx = _device_weights(in_w, out_w, img.device)  # (out_w, in_w)
        wy = _device_weights(in_h, out_h, img.device)  # (out_h, in_h)
        return torch.matmul(wy, torch.matmul(img, wx.T)).contiguous()

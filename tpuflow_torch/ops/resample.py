"""Area (box) resampling: X, then Y, each a banded pass (ops/banded.py).

Each output cell integrates the input cells that ``[o delta, (o + 1)
delta]`` overlaps, with fractional end weights, in ascending input order,
and multiplies the sum once by ``out/in`` (reference:
src/kernels/resample_2d.cu:44-74, transliterated in oracle_np.py:125-156);
X is applied first, then Y (reference: cuda_operation_resample_2d.cpp:99-106).
On the card that is two launches of the banded kernel, which replaces the
JAX package's block-banded matmuls (tpuflow/ops/resample.py:233, :252, via
tpuflow/solver/bucketed.py:903); ``resample_plain`` is the same sum on any
device, bitwise the oracle's. The windows are built on the host once per
(in, out) pair and kept on the device (``banded.band_table``).

``resample_weights`` is the dense (out, in) matrix of the same weights with
the normalisation folded in, byte for byte the JAX package's; the port's
solve does not use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from tpuflow_torch.ops.banded import AXIS_X, AXIS_Y, Band, band_table, banded_pass, banded_plain
from tpuflow_torch.ops.cuda_lib import on_cuda

F = np.float32


@functools.lru_cache(maxsize=1024)
def resample_band(in_n: int, out_n: int) -> Band:
    """Each output cell's window and fractions (resample_2d.cu:44-74): the
    first cell ``floor(o delta)``, the count up to ``ceil((o + 1) delta)``,
    1 inside, the overlaps at the two ends, ``delta`` for a window of one."""
    delta = F(F(in_n) / F(out_n))
    norm = F(F(out_n) / F(in_n))
    o = np.arange(out_n, dtype=F)
    left_f = o * delta
    right_f = (o + F(1.0)) * delta
    left_i = np.floor(left_f).astype(np.int64)
    right_i = np.minimum(in_n, np.ceil(right_f).astype(np.int64))
    count = right_i - left_i
    width = int(count.max())
    weights = np.ones((out_n, width), dtype=F)
    weights[np.arange(width)[None, :] >= count[:, None]] = 0.0
    rows = np.arange(out_n)
    weights[:, 0] = (left_i + 1).astype(F) - left_f
    weights[rows, count - 1] = right_f - (left_i + count - 1).astype(F)
    weights[count == 1, 0] = delta
    return Band(first=left_i.astype(np.int32), count=count.astype(np.int32), weights=weights,
                norm=float(norm))


@functools.lru_cache(maxsize=1024)
def resample_weights(in_n: int, out_n: int) -> np.ndarray:
    """(out_n, in_n) float32 box-overlap weight matrix, normalisation folded in."""
    band = resample_band(in_n, out_n)
    w = np.zeros((out_n, in_n), dtype=F)
    for o, (first, count) in enumerate(zip(band.first, band.count)):
        w[o, first:first + count] = band.weights[o, :count] * F(band.norm)
    return w


def resample_plain(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """The kernel's two passes by gathers, on any device."""
    in_h, in_w = img.shape[-2:]
    tmp = banded_plain(img, resample_band(in_w, out_w), AXIS_X)
    return banded_plain(tmp, resample_band(in_h, out_h), AXIS_Y)


def resample(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Resample the last two dims of ``img`` to (out_h, out_w): on a CUDA
    tensor two launches of the banded kernel (X, then Y), counted in
    ``resample.launches``; on a CPU tensor ``resample_plain``."""
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    with record_function("resample"):  # the layer's range in a profile
        img = img.contiguous()
        if not on_cuda(img):
            return resample_plain(img, out_w, out_h)
        dev = img.device
        tmp = banded_pass(img, band_table(resample_band, in_w, out_w, dev),
                          resample_band(in_w, out_w).norm, AXIS_X)
        out = banded_pass(tmp, band_table(resample_band, in_h, out_h, dev),
                          resample_band(in_h, out_h).norm, AXIS_Y)
        if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
            resample.launches += 2
        return out


resample.launches = 0

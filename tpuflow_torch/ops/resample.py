"""Area (box) resampling: X, then Y, each a banded pass (ops/banded.py).

Each output cell integrates the input cells that ``[o delta, (o + 1)
delta]`` overlaps, with fractional end weights, in ascending input order,
and multiplies the sum once by ``out/in`` (reference:
src/kernels/resample_2d.cu:44-74, transliterated in oracle_np.py:125-156);
X is applied first, then Y (reference: cuda_operation_resample_2d.cpp:99-106).
On the card that is two launches of the banded kernels, which replace the
JAX package's block-banded matmuls (tpuflow/ops/resample.py:233, :252, via
tpuflow/solver/bucketed.py:903): ``resample`` for one size, and
``resample_levels`` for many sizes of one image (every level's frames from
the smoothed pair) in the same two launches; ``resample_plain`` and
``resample_levels_plain`` are the same sums on any device, bitwise the
oracle's. The windows are built on the host once per shape and kept on the
device (``banded.plan_table``). ``resample(..., rows=(lo, hi))`` computes
output rows lo .. hi - 1 alone, each bitwise the whole call's, into a
whole-size output: the Y pass over those rows, the X pass over the input
rows their windows read (the flow over a process's rows, solver/bands.py).

``resample_weights`` is the dense (out, in) matrix of the same weights with
the normalisation folded in, byte for byte the JAX package's; the port's
solve does not use it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from tpuflow_torch.ops.banded import (
    AXIS_X, AXIS_Y, Band, band_span, banded_levels, banded_plain,
)
from tpuflow_torch.ops.cuda_lib import on_cuda
from tpuflow_torch.ops.solver_ops import placed, row_range

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


def sub_band(band: Band, lo: int, hi: int) -> Band:
    """Outputs lo .. hi - 1 of ``band``, their windows counted from the first
    input row they read (``band_span``)."""
    k0 = band_span(band, lo, hi)[0]
    return Band(first=band.first[lo:hi] - k0, count=band.count[lo:hi],
                weights=band.weights[lo:hi], norm=band.norm)


def resample_plain(img: torch.Tensor, out_w: int, out_h: int, rows=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's two passes by gathers, on any device. ``rows`` and
    ``out`` as in ``resample``; a row outside ``rows`` of a new output is
    NaN."""
    in_h, in_w = img.shape[-2:]
    lo, hi = row_range(rows, out_h)
    by = resample_band(in_h, out_h)
    k0, k1 = band_span(by, lo, hi)
    tmp = banded_plain(img[..., k0:k1, :], resample_band(in_w, out_w), AXIS_X)
    return placed(banded_plain(tmp, sub_band(by, lo, hi), AXIS_Y),
                  (*img.shape[:-2], out_h, out_w), lo, hi, out)


def resample_levels_plain(img: torch.Tensor, sizes, rows=None,
                          out: Optional[torch.Tensor] = None) -> list:
    """``resample_levels`` on any device: a loop of ``resample_plain``."""
    return [resample_plain(img, w, h, rows, out) for w, h in sizes]


def resample_levels(img: torch.Tensor, sizes, rows=None,
                    out: Optional[torch.Tensor] = None) -> list:
    """Resample the last two dims of ``img`` to each (w, h) of ``sizes``: on
    a CUDA tensor one X and one Y launch of the banded kernels for all of
    them (none for no sizes), counted in ``resample.launches``, the outputs
    contiguous views of one buffer; on a CPU tensor
    ``resample_levels_plain``. ``rows`` and ``out`` (one size alone) as in
    ``resample``."""
    in_h, in_w = img.shape[-2:]
    sizes = tuple((int(w), int(h)) for w, h in sizes)
    if (rows is not None or out is not None) and len(sizes) != 1:
        raise ValueError("output rows and an output buffer are for a resample to one size")
    with record_function("resample"):  # the layer's range in a profile
        img = img.contiguous()
        if not on_cuda(img, *(() if out is None else (out,))):
            return resample_levels_plain(img, sizes, rows, out)
        if not sizes:
            return []
        if rows is not None:
            rows = row_range(rows, sizes[0][1])
        if out is not None and out.shape != (*img.shape[:-2], sizes[0][1], sizes[0][0]):
            raise ValueError(f"out: expected {(*img.shape[:-2], sizes[0][1], sizes[0][0])}, "
                             f"got {tuple(out.shape)}")
        res = banded_levels(img, tuple((resample_band, in_w, w) for w, _ in sizes),
                            tuple((resample_band, in_h, h) for _, h in sizes), rows, out)
        if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
            resample.launches += 2
        return res if out is None else [out]


def resample(img: torch.Tensor, out_w: int, out_h: int, rows=None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resample the last two dims of ``img`` to (out_h, out_w): on a CUDA
    tensor two launches of the banded kernels (X, then Y; ``resample_levels``
    with one size), counted in ``resample.launches``; on a CPU tensor
    ``resample_plain``. The same size returns ``img``.

    ``rows`` = (lo, hi) computes output rows lo .. hi - 1 alone (the Y pass
    over them, the X pass over the input rows their windows read, which
    alone must hold values), into ``out`` where given (a contiguous
    whole-size buffer), else a new one; the other rows are not written.
    ``resample.rows`` counts the output rows computed."""
    in_h, in_w = img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    lo, hi = row_range(rows, out_h)
    resample.rows += hi - lo
    return resample_levels(img, ((out_w, out_h),), rows, out)[0]


resample.launches = 0
resample.rows = 0

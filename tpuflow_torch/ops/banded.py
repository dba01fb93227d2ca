"""The banded 1-D pass of the presmooth and the resample: each output a sum
over its own window of the input along x or y, in ascending input order,
scaled once (the CUDA kernel ``tf_banded``, csrc/banded.cu, and its plain
PyTorch version, ``banded_plain``):

    acc = 0;  for j in [0, count): acc = acc + x[first + j] * weight_j;  out = acc * norm

A ``Band`` is one axis's table: for each output the first input it reads,
how many, their weights, and ``norm`` (the resample's out/in; 1 for the
Gaussian, where the product by 1 is exact). ``band_table`` keeps it on the
device as one int32 tensor per device (``ops/device_cache.py``), so a
submission makes no upload from pageable memory once the shapes are warm.

``banded_pass`` launches the kernel on a CUDA tensor; ``banded_plain`` is
the same sum by gathers for any device. The wrappers that count launches
are ``ops.resample.resample`` and ``ops.gaussian.gaussian_smooth``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuflow_torch.ops.cuda_lib import launch
from tpuflow_torch.ops.device_cache import device_cached

AXIS_X, AXIS_Y = 0, 1    # along the last dim (columns), along the one before (rows)


@dataclasses.dataclass(frozen=True, eq=False)
class Band:
    """One axis's windows: ``first`` and ``count`` (out,) int32, ``weights``
    (out, width) float32 (zero beyond each output's count; width is the
    largest count), and ``norm``, a float32 value."""
    first: np.ndarray
    count: np.ndarray
    weights: np.ndarray
    norm: float

    def __post_init__(self):
        end = self.first + self.count
        # banded_x_kernel reads one span of the input per block of outputs
        if (np.diff(self.first) < 0).any() or (np.diff(end) < 0).any():
            raise ValueError("a band's windows must not move backwards")

    @property
    def out_n(self) -> int:
        return len(self.first)

    def packed(self) -> np.ndarray:
        """The kernel's table: int32 (out, 2 + width), rows [first, count,
        the weights' float32 bits]."""
        t = np.empty((self.out_n, 2 + self.weights.shape[1]), dtype=np.int32)
        t[:, 0] = self.first
        t[:, 1] = self.count
        t[:, 2:] = self.weights.view(np.int32)
        return t


@device_cached(maxsize=1024)
def band_table(build, n_in: int, arg, device: torch.device) -> torch.Tensor:
    """``build(n_in, arg)``'s packed table on ``device``."""
    return torch.from_numpy(build(n_in, arg).packed()).to(device)


def banded_pass(x: torch.Tensor, table: torch.Tensor, norm: float, axis: int) -> torch.Tensor:
    """One launch of the kernel over a contiguous float32 CUDA tensor x
    (..., h, w) along ``axis``; ``table`` is its band's ``band_table`` on
    x's device. The caller counts the launch."""
    h, w = x.shape[-2:]
    if table.device != x.device or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError(f"the band table must be contiguous int32 on {x.device}")
    out_n, stride = table.shape
    lead = x.shape[:-2]
    shape = (*lead, h, out_n) if axis == AXIS_X else (*lead, out_n, w)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    planes = x.numel() // (h * w)
    launch("tf_banded", x.data_ptr(), out.data_ptr(), table.data_ptr(), stride, axis, planes,
           h, w, out_n, float(norm))
    return out


def banded_plain(x: torch.Tensor, band: Band, axis: int) -> torch.Tensor:
    """The kernel's sum by gathers, on any device: the terms below each
    output's count only, added in ascending input order (a zero weight times
    a NaN would not be zero)."""
    if axis == AXIS_Y:
        return banded_plain(x.transpose(-1, -2), band, AXIS_X).transpose(-1, -2).contiguous()
    dev = x.device
    count = torch.from_numpy(band.count).to(dev)
    weights = torch.from_numpy(band.weights).to(dev)
    width = weights.shape[1]
    idx = torch.from_numpy(band.first).to(dev, torch.int64)[:, None] + torch.arange(width,
                                                                                     device=dev)
    idx = idx.clamp_(max=x.shape[-1] - 1)
    terms = x.index_select(-1, idx.reshape(-1)).unflatten(-1, idx.shape) * weights
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float32, device=dev)
    for j in range(width):
        acc = torch.where(j < count, acc + terms[..., j], acc)
    return acc * torch.tensor(band.norm, dtype=torch.float32, device=dev)

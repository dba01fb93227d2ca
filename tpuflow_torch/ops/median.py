"""Window median with the reference guards (tpuflow/ops/median.py:51-57).

``radius`` is the window SIDE (3/5/7); the reference host wrapper's guards
apply (reference: cuda_operation_median_2d.cpp:100-109,152-154): radius 1
copies, an even radius is decremented, above 7 is rejected. The boundary
is reflect padding (tpuflow/ops/median.py:60). ``median_plain`` is the plain
PyTorch version; the CUDA kernel is ``add_median`` in ops/level.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuflow_torch.ops.solver_ops import refl


def effective_radius(radius: int) -> int:
    """The window side the reference actually filters with (1 = copy)."""
    if radius > 7:
        raise ValueError("median radius > 7 not supported (reference parity)")
    if radius % 2 == 0:
        radius -= 1
    return max(radius, 1)


def median_plain(img: torch.Tensor, radius: int, lo: int = 0, hi=None) -> torch.Tensor:
    """Median over the last two dims of ``img`` (any leading dims), of
    output rows lo .. hi - 1 (every row by default): (..., hi - lo, w),
    reading ``img`` at the rows that their windows reflect to."""
    r = effective_radius(radius)
    h, w = img.shape[-2:]
    hi = h if hi is None else hi
    if r == 1:
        return img[..., lo:hi, :]
    r2 = r // 2
    n = hi - lo
    # the window rows of each output row, reflected at the level's edges
    ys = refl(torch.arange(lo - r2, hi + r2, device=img.device), h)
    flat = img.index_select(-2, ys).reshape(-1, n + 2 * r2, w)
    padded = F.pad(flat, (r2, r2), mode="reflect")
    windows = torch.stack(
        [padded[:, iy: iy + n, ix: ix + w] for iy in range(r) for ix in range(r)],
        dim=-1,
    )
    med = torch.sort(windows, dim=-1).values[..., (r * r) // 2]
    return med.reshape(*img.shape[:-2], n, w).contiguous()

"""Coarse-to-fine level scheduling.

Reproduces the reference's warp-level bookkeeping:
  * ``max_warp_level`` counts levels until either dimension shrinks below 4
    (reference: src/optical_flow/optical_flow_base_2d.cpp:36-59);
  * per-level size is ``ceil(orig * factor**level)`` with float32 pow, and the
    grid spacing is ``h = orig / current`` >= 1
    (reference: src/optical_flow/optical_flow_2d.cpp:268-272).

All sizes are computed host-side in float32 to match the reference binary
exactly (it uses ``std::pow(float, float)``).

A verbatim copy of ``tpuflow/pyramid.py`` (numpy only), so the port never
imports the JAX package; a test holds the two schedules equal.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def max_warp_level(width: int, height: int, scale_factor: float) -> int:
    """Maximum number of warp levels for an image size and scale factor.

    Transliterated semantics of
    reference: src/optical_flow/optical_flow_base_2d.cpp:36-59 — counts
    levels while both scaled dims stay >= 4, with an extra decrement if the
    last computed size collapsed to 1.
    """
    r_width, r_height = 1, 1
    level_counter = 1
    factor = np.float32(scale_factor)
    while factor < np.float32(1.0):
        scale = np.power(factor, np.float32(level_counter), dtype=np.float32)
        r_width = int(np.ceil(np.float32(width) * scale))
        r_height = int(np.ceil(np.float32(height) * scale))
        if r_width < 4 or r_height < 4:
            break
        level_counter += 1
    if r_width == 1 or r_height == 1:
        level_counter -= 1
    return level_counter


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One pyramid level: index, size and grid spacing."""

    level: int  # warp level index (0 = full resolution)
    width: int
    height: int
    hx: float  # orig_width / width  (>= 1)
    hy: float  # orig_height / height


def level_schedule(
    width: int, height: int, levels_count: int, scale_factor: float
) -> List[LevelSpec]:
    """The coarse-to-fine schedule, coarsest first.

    ``start_level = min(levels_count, max_warp_level) - 1`` down to level 0
    (reference: src/optical_flow/optical_flow_2d.cpp:188-189,267-272).
    """
    start = min(levels_count, max_warp_level(width, height, scale_factor)) - 1
    factor = np.float32(scale_factor)
    specs = []
    for level in range(start, -1, -1):
        scale = np.power(factor, np.float32(level), dtype=np.float32)
        w = int(np.ceil(np.float32(width) * scale))
        h = int(np.ceil(np.float32(height) * scale))
        specs.append(
            LevelSpec(
                level=level,
                width=w,
                height=h,
                hx=float(np.float32(width) / np.float32(w)),
                hy=float(np.float32(height) / np.float32(h)),
            )
        )
    return specs

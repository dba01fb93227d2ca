"""Flow-field visualisation: the Bruhn colour circle and the magnitude.

The numpy path of ``tpuflow.io.flow_viz`` (tpuflow/io/flow_viz.py:37-100),
which follows the reference (reference: src/utils/io_utils.cpp:35-114,140-225):
  * flow scaled by ``1 / flow_max_scale``, amplitude clipped at 1;
  * phase halved, then linear interpolation over six angular segments
    red -> blue -> green -> yellow -> red;
  * channel = ``floor(amp * lerp)`` clamped to [0, 255];
  * written as a binary "P6" PPM (the reference names it ``.pgm``);
  * magnitude written as per-pixel ``sqrt(u^2 + v^2)`` RAW float32.
"""

from __future__ import annotations

import numpy as np

# (start/pi, span/pi, rgb at start, rgb at end) of the halved phase
# (reference: src/utils/io_utils.cpp:168-216).
_SEGMENTS = (
    (0.000, 0.125, (255.0, 0.0, 0.0), (255.0, 0.0, 255.0)),
    (0.125, 0.125, (255.0, 0.0, 255.0), (64.0, 64.0, 255.0)),
    (0.250, 0.125, (64.0, 64.0, 255.0), (0.0, 255.0, 255.0)),
    (0.375, 0.125, (0.0, 255.0, 255.0), (0.0, 255.0, 0.0)),
    (0.500, 0.250, (0.0, 255.0, 0.0), (255.0, 255.0, 0.0)),
    (0.750, 0.250, (255.0, 255.0, 0.0), (255.0, 0.0, 0.0)),
)


def flow_to_rgb(u: np.ndarray, v: np.ndarray, flow_max_scale: float = 10.0) -> np.ndarray:
    """Convert a flow field to an (H, W, 3) uint8 colour-circle image."""
    x = np.asarray(u, dtype=np.float64) / flow_max_scale
    y = np.asarray(v, dtype=np.float64) / flow_max_scale
    amp = np.minimum(np.sqrt(x * x + y * y), 1.0)

    # Phase in [0, 2 pi): quadrant-aware atan (reference: io_utils.cpp:165-175).
    pi = np.pi
    with np.errstate(divide="ignore", invalid="ignore"):
        at = np.arctan(y / np.where(x == 0.0, 1.0, x))
    phi = np.where(
        x == 0.0,
        np.where(y >= 0.0, 0.5 * pi, 1.5 * pi),
        np.where(x > 0.0, np.where(y >= 0.0, at, 2.0 * pi + at), pi + at),
    )
    phi = phi / 2.0

    rgb = np.zeros(x.shape + (3,), dtype=np.float64)
    for start, span, c0, c1 in _SEGMENTS:
        lo, hi = start * pi, (start + span) * pi
        if start == 0.750:
            mask = (phi >= lo) & (phi <= pi)
        else:
            mask = (phi >= lo) & (phi < hi)
        beta = (phi - lo) / (span * pi)
        alpha = 1.0 - beta
        for c in range(3):
            val = np.floor(amp * (alpha * c0[c] + beta * c1[c]))
            rgb[..., c] = np.where(mask, val, rgb[..., c])
    return np.clip(rgb, 0.0, 255.0).astype(np.uint8)


def write_flow_image_rgb(u: np.ndarray, v: np.ndarray, flow_max_scale: float,
                         path: str) -> None:
    """Write the colour-circle image as a binary P6 PPM, with the
    reference's header bytes ``"P6 \\n<nx> <ny> \\n255\\n"``
    (reference: src/utils/io_utils.cpp:58-59)."""
    rgb = flow_to_rgb(u, v, flow_max_scale)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 \n{w} {h} \n255\n".encode("ascii"))
        f.write(rgb.tobytes())


def write_magnitude_f32(u: np.ndarray, v: np.ndarray, path: str) -> None:
    """Write the per-pixel flow magnitude as RAW float32."""
    u = np.asarray(u, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    np.sqrt(u * u + v * v).astype("<f4").tofile(path)

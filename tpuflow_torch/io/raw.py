"""RAW image file I/O (headerless binary frames), in numpy.

The same file semantics as ``tpuflow.io.raw`` and the reference host
containers (reference: src/data_types/data2d.cpp:98-231): row-major
``y*w + x`` layout, little-endian, u8 frames widened to float32 on read
(no rescale), float32 frames read and written verbatim, u8 writes clamped
to [0, 255] and truncated. The JAX package's optional native codec is not
used: these are its numpy paths.
"""

from __future__ import annotations

import os

import numpy as np


def _check_size(path: str, expected_bytes: int) -> None:
    actual = os.path.getsize(path)
    if actual < expected_bytes:
        raise ValueError(
            f"RAW file {path!r} too small: has {actual} bytes, expected {expected_bytes}")


def read_raw_u8(path: str, width: int, height: int) -> np.ndarray:
    """Read a headerless u8 frame and widen it to float32 (values 0..255)."""
    _check_size(path, width * height)
    data = np.fromfile(path, dtype=np.uint8, count=width * height)
    return data.reshape(height, width).astype(np.float32)


def read_raw_f32(path: str, width: int, height: int) -> np.ndarray:
    """Read a headerless little-endian float32 frame."""
    _check_size(path, width * height * 4)
    data = np.fromfile(path, dtype="<f4", count=width * height)
    return data.reshape(height, width).astype(np.float32)


def read_frame(path: str, width: int, height: int) -> np.ndarray:
    """Read a frame as u8 or f32, whichever the file size matches (the
    reference read its own u8 data with the f32 reader, src/main.cpp:175-183)."""
    size = os.path.getsize(path)
    if size == width * height * 4:
        return read_raw_f32(path, width, height)
    if size == width * height:
        return read_raw_u8(path, width, height)
    raise ValueError(
        f"RAW file {path!r} has {size} bytes; matches neither u8 "
        f"({width * height}) nor f32 ({width * height * 4}) for {width}x{height}")


def write_raw_u8(path: str, image: np.ndarray) -> None:
    """Write a float32 frame as u8, clamped to [0, 255] and truncated."""
    np.clip(np.asarray(image, dtype=np.float32), 0.0, 255.0).astype(np.uint8).tofile(path)


def write_raw_f32(path: str, image: np.ndarray) -> None:
    """Write a float32 frame verbatim (little-endian)."""
    np.asarray(image, dtype="<f4").tofile(path)

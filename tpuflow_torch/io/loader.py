"""Ordered frame loader for streaming sequences (the numpy path of
tpuflow/io/loader.py:47-116).

The JAX package's loader prefetches through an optional native C++ ring
(``tpuflow/_native``); the port reads each frame with ``io.read_frame`` when
it is asked for, which gives the same values. In ``process_sequence`` the
reads overlap the card's work anyway: the pairs before are queued on it.

Usage:
    with FrameLoader(paths, width, height) as loader:
        for _ in paths:
            frame = loader.next()   # float32 (height, width), file order
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpuflow_torch.io.raw import read_frame


class FrameLoader:
    """Ordered reader over a list of RAW frame files: u8 files widened to
    float32 (no rescale), f32 read verbatim, chosen per file by its size
    (reference semantics: src/data_types/data2d.cpp:98-178)."""

    def __init__(self, paths: Sequence[str], width: int, height: int):
        self._paths = list(paths)
        self._w, self._h = int(width), int(height)
        self._idx = 0

    def next(self) -> np.ndarray:
        """The next frame in file order. Raises IndexError when the list is
        exhausted (not StopIteration, which would silently end an enclosing
        generator)."""
        if self._idx >= len(self._paths):
            raise IndexError("FrameLoader exhausted: no more frames")
        path = self._paths[self._idx]
        self._idx += 1
        return read_frame(path, self._w, self._h)

    def close(self) -> None:
        self._idx = len(self._paths)

    def __enter__(self) -> "FrameLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

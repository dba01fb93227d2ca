"""The row mesh of the sharded solve (the port of tpuflow/parallel/mesh.py).

The JAX package lays a ``("data", "y")`` mesh over chips, and shards image
rows over ``y``. In the port a mesh is ``n_y`` row shards on one explicit
device: all shards of a level live on one card, and the sharded relaxation
kernel (csrc/sharded.cu) exchanges their halos inside one launch. A mesh
over several cards is not ported yet (ROADMAP Queue 1, multiple GPUs).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

# The sharded kernel's by-value shard struct holds at most this many shards
# (csrc/sharded.cu: MAX_SHARDS), the device count of the JAX tests' mesh.
MAX_SHARDS = 8

Device = Union[str, torch.device]


def _indexed(device: Device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without an index takes
    the current one's, where CUDA is available."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device: Device) -> torch.device:
    """``device`` as a torch.device with its index; ``"cuda"`` raises on a
    machine without CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for, but CUDA is not available")
    return _indexed(device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_y`` row shards, every one on ``device``."""

    n_y: int
    device: torch.device

    def __post_init__(self):
        if not 1 <= self.n_y <= MAX_SHARDS:
            raise ValueError(f"a mesh holds 1 to {MAX_SHARDS} row shards, got {self.n_y}")
        object.__setattr__(self, "device", _indexed(self.device))


def make_mesh(n_y: int, device: Union[Device, Sequence[Device]] = "cuda") -> Mesh:
    """A mesh of ``n_y`` row shards on ``device``: one device, or one per
    shard, which must then all be the same device. ``"cuda"`` raises on a
    machine without CUDA; several distinct devices raise
    NotImplementedError."""
    devices = [device] if isinstance(device, (str, torch.device)) else list(device)
    distinct = {torch.device(d) for d in devices}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a mesh over several devices ({sorted(map(str, distinct))}) is not ported yet: "
            "ROADMAP Queue 1, multiple GPUs (peer pointers in the shard struct, or the explicit "
            "exchange over torch.distributed)")
    if len(devices) > 1 and len(devices) != n_y:
        raise ValueError(f"{len(devices)} devices for {n_y} shards")
    (dev,) = distinct
    return Mesh(int(n_y), resolve_device(dev))

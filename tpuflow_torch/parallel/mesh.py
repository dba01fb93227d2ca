"""The ``("data", "y")`` mesh of the port (the port of tpuflow/parallel/mesh.py).

The JAX package lays a ``("data", "y")`` grid over chips: ``data`` deals
independent frame pairs, ``y`` shards image rows. In the port a mesh is a
grid of ``n_data x n_y`` positions, each a device, in row-major order (data
outer). Devices may repeat: four positions on ``cuda:0`` are four shards of
one card. Every position has a CUDA stream of its own, made on its device
when first asked for, so that positions which share a card still run as
separate queues, ordered only by the events the solver places between them.

The sharded kernel over several cards (parallel/halo_kernel.py) needs two
more things, kept per process: peer access between every two cards of a
row (``enable_peer_access``), and one stream a card (``card_stream``) on
which every such launch goes, so that the launches reach each card in the
order the host issued them. ``peer_copy`` moves a tensor between two
streams' cards and counts it.

Inside an initialised group of several processes (one process a card),
``make_mesh`` lays the positions over every process's device in rank
order, as ``jax.devices()`` orders the devices of all processes
(tpuflow/parallel/mesh.py:24): position p belongs to rank p. Each position
then carries its owning rank (``ranks``) and its card's UUID, so that two
processes on one card count as one card; ``local_positions()`` are this
process's. A device of another rank's position is that rank's own name for
it.
"""

from __future__ import annotations

import contextlib
import socket
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from tpuflow_torch.parallel.group import (
    check_p2p_cards, p2p_join, process_group, process_rank, shared_card,
)

# The sharded kernel's by-value shard struct holds at most this many shards
# (csrc/sharded.cu: MAX_SHARDS), the device count of the JAX tests' mesh.
MAX_SHARDS = 8

Device = Union[str, torch.device]
Shape = Union[int, Tuple[int, int]]


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


class Mesh:
    """``n_data x n_y`` positions. ``Mesh(n_y, device)`` is one row of
    ``n_y`` shards on one device; ``devices`` gives one device per
    position, row-major (data outer)."""

    def __init__(self, n_y: int, device: Optional[Device] = None, *, n_data: int = 1,
                 devices: Optional[Sequence[Device]] = None,
                 ranks: Optional[Sequence[int]] = None, uuids: Optional[Sequence[str]] = None):
        if not 1 <= n_y <= MAX_SHARDS:
            raise ValueError(f"a mesh holds 1 to {MAX_SHARDS} row shards, got {n_y}")
        if n_data < 1:
            raise ValueError(f"a mesh needs at least one data position, got {n_data}")
        if (device is None) == (devices is None):
            raise ValueError("give one device or one device per position")
        if devices is None:
            devices = [device] * (n_data * n_y)
        if len(devices) != n_data * n_y:
            raise ValueError(f"{len(devices)} devices for {n_data} x {n_y} positions")
        self.n_data, self.n_y = int(n_data), int(n_y)
        self.devices: Tuple[torch.device, ...] = tuple(_indexed(d) for d in devices)
        size = len(self.devices)
        # The owning rank of each position (this process's for a mesh of one
        # process) and, over processes, each position's card by UUID.
        self.ranks: Tuple[int, ...] = (tuple(int(r) for r in ranks) if ranks is not None
                                       else (process_rank()[0],) * size)
        self.uuids: Optional[Tuple[str, ...]] = None if uuids is None else tuple(uuids)
        if len(self.ranks) != size or (self.uuids is not None and len(self.uuids) != size):
            raise ValueError(f"{size} positions need {size} ranks and card UUIDs")
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @property
    def spans_processes(self) -> bool:
        """Whether the positions belong to more than one process."""
        return len(set(self.ranks)) > 1

    def _key(self):
        if self.spans_processes:
            return self.n_data, self.n_y, self.devices, self.ranks, self.uuids
        return self.n_data, self.n_y, self.devices

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        ranks = f", ranks={list(self.ranks)}" if self.spans_processes else ""
        return (f"Mesh(n_data={self.n_data}, n_y={self.n_y}, "
                f"devices={list(map(str, self.devices))}{ranks})")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "y": self.n_y}

    @property
    def size(self) -> int:
        return self.n_data * self.n_y

    def card(self, p: int):
        """Position ``p``'s card: its device, or over processes its UUID."""
        return self.devices[p] if self.uuids is None else self.uuids[p]

    @property
    def cards(self) -> int:
        """How many distinct devices the positions span: over processes,
        distinct cards by UUID (two processes on one card count once)."""
        return len({self.card(p) for p in range(self.size)})

    @property
    def device(self) -> torch.device:
        """The one device of a mesh whose positions all share it; raises for
        a mesh over several."""
        if self.cards != 1:
            raise ValueError(f"{self!r} spans {self.cards} devices, not one")
        return self.devices[0]

    def position(self, data: int, y: int) -> int:
        """The index of position (data, y)."""
        if not (0 <= data < self.n_data and 0 <= y < self.n_y):
            raise IndexError(f"position ({data}, {y}) outside a {self.n_data} x {self.n_y} mesh")
        return data * self.n_y + y

    def row(self, data: int = 0) -> Tuple[int, ...]:
        """The positions of one data row: the shards of one pair's rows."""
        return tuple(self.position(data, y) for y in range(self.n_y))

    def row_cards(self, data: int = 0) -> int:
        """How many distinct devices the shards of one data row span (by
        UUID over processes)."""
        return len({self.card(p) for p in self.row(data)})

    def row_ranks(self, data: int = 0) -> Tuple[int, ...]:
        """The owning rank of each position of one data row."""
        return tuple(self.ranks[p] for p in self.row(data))

    def row_spans_processes(self, data: int = 0) -> bool:
        """Whether one data row's positions belong to several processes."""
        return len(set(self.row_ranks(data))) > 1

    def local_positions(self) -> Tuple[int, ...]:
        """The positions this process owns."""
        me = process_rank()[0]
        return tuple(p for p in range(self.size) if self.ranks[p] == me)

    def local_row(self) -> int:
        """The data row of this process's positions on a mesh over processes
        (a process holds one position); 0 on a mesh of one process."""
        mine = self.local_positions()
        if not mine:
            raise ValueError(f"this process (rank {process_rank()[0]}) holds no position of {self!r}")
        return mine[0] // self.n_y if self.spans_processes else 0

    def row_groups(self, data: int = 0) -> List[Tuple[torch.device, Tuple[int, ...]]]:
        """The ``y`` indices of one data row grouped by device: (device,
        indices) per distinct device, in the order the row first meets
        them, so the row's first device comes first."""
        groups: Dict[torch.device, List[int]] = {}
        for y, p in enumerate(self.row(data)):
            groups.setdefault(self.devices[p], []).append(y)
        return [(dev, tuple(ys)) for dev, ys in groups.items()]

    @property
    def p2p_ok(self) -> bool:
        """Whether the default group can carry tensor messages between this
        mesh's processes: always in one process or over gloo, and over NCCL
        where no two processes share a card (``group.shared_card``)."""
        return not self.spans_processes or shared_card(
            self.ranks, [self.card(p) for p in range(self.size)]) is None

    def check_p2p(self, what: str) -> None:
        """Raise, before any message, where ``what`` would need a message
        that ``p2p_ok`` refuses (``group.check_p2p_cards``)."""
        if self.spans_processes:
            check_p2p_cards(self.ranks, [self.card(p) for p in range(self.size)], what)

    def stream(self, p: int) -> Optional[torch.cuda.Stream]:
        """Position ``p``'s CUDA stream, made on its device at first use;
        None for a CPU position."""
        dev = self.devices[p]
        if self.ranks[p] != process_rank()[0]:
            raise ValueError(f"position {p} belongs to rank {self.ranks[p]}, not this process")
        if dev.type != "cuda":
            return None
        if p not in self._streams:
            self._streams[p] = torch.cuda.Stream(dev)
        return self._streams[p]

    def on(self, p: int):
        """Position ``p``'s device and stream as the current ones (nothing
        for a CPU position)."""
        stream = self.stream(p)
        return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def device_uuid(device: torch.device) -> str:
    """The physical card behind ``device``: its UUID on the card; on the CPU
    the host's name, so that the CPU positions of one host are one card."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return f"{device.type}@{socket.gethostname()}"


_CARD_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_PEERS: Set[Tuple[torch.device, torch.device]] = set()


def card_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of ``device`` on which every launch of the sharded kernel
    over several cards goes, made at first use. Two such launches that
    share a card must start on every card in the same order, or each could
    hold one card while it waits for the other on the next."""
    if device not in _CARD_STREAMS:
        _CARD_STREAMS[device] = torch.cuda.Stream(device)
    return _CARD_STREAMS[device]


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let each of ``devices`` reach the memory of every other, once per
    pair and process; raises, naming both cards, where a pair cannot."""
    from tpuflow_torch.ops.cuda_lib import call

    for a in devices:
        for b in devices:
            if a == b or (a, b) in _PEERS:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(f"{a} cannot reach the memory of {b} (no peer access), so "
                                 "the sharded kernel cannot run a row over both")
            call("tf_enable_peer_access", a.index, b.index)
            _PEERS.add((a, b))


def peer_copy(dst: torch.Tensor, src: torch.Tensor, dst_stream=None, src_stream=None) -> None:
    """dst <- src, with each stream (None: the device's current one) the
    current one of its card. torch runs a copy between two cards on the
    source's current stream, fenced both ways with the destination's: it
    starts after the work queued so far on both streams, and work queued
    on either after it starts after it, so neither side frees or reuses the
    memory too early. Counted in ``peer_copy.messages`` and
    ``peer_copy.bytes``, on either device."""
    with contextlib.ExitStack() as stack:
        for stream in (src_stream, dst_stream):
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
        dst.copy_(src)
    peer_copy.messages += 1
    peer_copy.bytes += src.numel() * src.element_size()


peer_copy.messages = 0
peer_copy.bytes = 0


def default_shape(n: int) -> Tuple[int, int]:
    """The JAX package's layout over n devices (tpuflow/parallel/mesh.py:26-31):
    every device on ``y``, with one factor of 2 peeled off to ``data`` when
    there are at least 8."""
    return (2, n // 2) if n >= 8 and n % 2 == 0 else (1, n)


def _process_mesh(shape: Optional[Shape], device: torch.device) -> Mesh:
    """The mesh over every process of the group, each with ``device``, its
    one card: position p is rank p's (made by every process at once)."""
    world = process_rank()[1]
    cards: List = [None] * world
    torch.distributed.all_gather_object(cards, (str(device), device_uuid(device)),
                                        group=process_group())
    n_data, n_y = default_shape(world) if shape is None else (
        (1, shape) if isinstance(shape, int) else shape)
    if int(n_data) * int(n_y) != world:
        raise ValueError(f"a {n_data} x {n_y} mesh over {world} processes: a mesh over "
                         "processes has one position a process")
    mesh = Mesh(int(n_y), n_data=int(n_data), devices=[d for d, _ in cards],
                ranks=range(world), uuids=[u for _, u in cards])
    if mesh.p2p_ok:
        p2p_join(device)
    return mesh


def make_mesh(shape: Optional[Shape] = None,
              device: Union[Device, Sequence[Device]] = "cuda") -> Mesh:
    """A mesh of ``shape`` positions: ``n_y`` (one data row) or ``(n_data,
    n_y)``. ``device`` is one device for every position, or one per
    position, row-major. Without ``shape`` the mesh lays the JAX default
    over the given devices, or over every visible card when ``device`` is
    ``"cuda"``. ``"cuda"`` raises on a machine without CUDA.

    Inside an initialised group of several processes, one ``device`` (by
    default this process's card) makes the mesh over the processes: every
    process calls it at once, each with its own device, and the positions,
    one a process, go to the ranks in order (``shape`` defaults to the JAX
    layout over the world size). A list of devices makes a mesh of this
    process alone."""
    many = not isinstance(device, (str, torch.device))
    if not many and process_rank()[1] > 1:
        return _process_mesh(shape, resolve_device(device))
    if many:
        devices = [resolve_device(d) for d in device]
    elif shape is None and torch.device(device) == torch.device("cuda"):
        resolve_device(device)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(device)]
    if shape is None:
        shape = default_shape(len(devices))
    n_data, n_y = (1, shape) if isinstance(shape, int) else shape
    if len(devices) == 1:
        return Mesh(int(n_y), devices[0], n_data=int(n_data))
    return Mesh(int(n_y), n_data=int(n_data), devices=devices)

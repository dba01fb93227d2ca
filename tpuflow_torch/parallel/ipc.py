"""The arenas of a mesh row over processes: one block of device memory a
card, shared between the row's processes through CUDA IPC handles
(csrc/sharded.cu: ``tf_ipc_*``).

``relax_sharded_kernel`` on a row whose shards belong to several processes
(parallel/halo_kernel.py) stores halos, T and flags into the other
processes' cards, so each card's shard buffer, its T and its flags lie in
one ``cudaMalloc`` allocation of its process, whose IPC handle the other
processes open (an IPC handle names a whole allocation, so the arena is
allocated in the C library, not by torch's caching allocator). An arena is

    [MAX_CARDS int64 flags | T: 2 x h x w float32 | the shard's planes x padded rows x w]

each part at a 256-byte boundary, and a level uses a prefix of it. The
handles are exchanged once per (mesh row, arena size) over the gloo group
and cached: an exchange a level would cost a round of messages each time.
The arena is sized for the finest level the caller names, and grows
collectively: every process of the row runs the same levels with the same
gates, so all of them find the arena too small at the same call. A grow
settles this card, closes the peers' arenas, waits for the row, frees and
allocates (zeroed: the flags start again at epoch 0), exchanges the
handles, opens the peers', and waits for the row again, so that no card
starts spinning at a row barrier while a process still opens handles.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from tpuflow_torch.ops.cuda_lib import call
from tpuflow_torch.parallel.group import row_all_gather, row_barrier
from tpuflow_torch.parallel.halo_kernel import MAX_CARDS, RowFlags
from tpuflow_torch.parallel.mesh import device_uuid

ALIGN = 256
HANDLE_BYTES = 64
FLAGS_BYTES = -(-MAX_CARDS * 8 // ALIGN) * ALIGN


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def arena_layout(h: int, w: int, planes: int, padded: int) -> Tuple[int, int, int]:
    """(offset of T, offset of the shard buffer, bytes) of an arena for an
    (h, w) level whose largest shard has ``padded`` rows of ``planes``
    planes; the flags are at offset 0."""
    t_off = FLAGS_BYTES
    buf_off = t_off + _aligned(2 * h * w * 4)
    return t_off, buf_off, buf_off + planes * padded * w * 4


class _DeviceBytes:
    """``nbytes`` bytes of device memory at ``ptr`` as a CUDA array, for
    ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "strides": None, "version": 2}


def open_peer(handle: bytes, device: torch.device, rank: int, peer_rank: int,
              peer_card: str) -> int:
    """Map rank ``peer_rank``'s arena (its IPC handle) into this process on
    ``device``; raises, naming both ranks and cards, where it cannot."""
    buf = (ctypes.c_ubyte * HANDLE_BYTES).from_buffer_copy(handle)
    ptr = ctypes.c_void_p()
    try:
        call("tf_ipc_open_handle", buf, device.index, ctypes.byref(ptr))
    except RuntimeError as err:
        raise RuntimeError(f"rank {rank} on {device} ({device_uuid(device)}) could not open "
                           f"the arena of rank {peer_rank} on card {peer_card}: {err}") from err
    return ptr.value


def check_peer_path(device: torch.device, peer_card: str, rank: int, peer_rank: int) -> None:
    """Raise, naming both ranks and cards, where ``device`` cannot reach the
    card ``peer_card`` (a UUID) that it sees; the same card needs no path."""
    if device_uuid(device) == peer_card:
        return
    for i in range(torch.cuda.device_count()):
        if device_uuid(torch.device("cuda", i)) == peer_card:
            if not torch.cuda.can_device_access_peer(device, i):
                raise ValueError(f"rank {rank} on {device} cannot reach the memory of rank "
                                 f"{peer_rank}'s card cuda:{i} ({peer_card}): no peer access, "
                                 "so the sharded kernel cannot run a row over both")
            return


class RowArena:
    """This process's arena for one row of processes (``ranks``, one a
    card, ``cards`` their UUIDs) on ``device``, and every row member's
    arena pointer (``ptrs``, in the row's order: this process's own, the
    others opened from their handles). ``flags`` keeps the epoch of the
    row's flags, which every process advances by the same steps."""

    def __init__(self, ranks: Sequence[int], cards: Sequence[str], device: torch.device):
        self.ranks, self.cards, self.device = tuple(ranks), tuple(cards), device
        self.me = self.ranks.index(torch.distributed.get_rank())
        self.nbytes = 0
        self.ptrs: List[int] = []
        self.view = None
        self.flags = RowFlags(flags=[])

    def reserve(self, nbytes: int) -> None:
        """Make the arena hold at least ``nbytes`` (collective over the row
        when it grows)."""
        if nbytes > self.nbytes:
            self._grow(nbytes)

    def _release(self) -> None:
        for c, ptr in enumerate(self.ptrs):
            if c != self.me:
                call("tf_ipc_close_handle", self.device.index, ctypes.c_void_p(ptr))
        row_barrier(self.ranks)   # no process reads this card's arena any longer
        if self.ptrs:
            call("tf_ipc_free", self.device.index, ctypes.c_void_p(self.ptrs[self.me]))
        self.ptrs, self.view, self.nbytes = [], None, 0

    def _grow(self, nbytes: int) -> None:
        rank = self.ranks[self.me]
        torch.cuda.synchronize(self.device)   # this card's launches on the old arena are done
        self._release()
        ptr = ctypes.c_void_p()
        call("tf_ipc_alloc", self.device.index, nbytes, ctypes.byref(ptr))
        handle = (ctypes.c_ubyte * HANDLE_BYTES)()
        call("tf_ipc_get_handle", ptr, handle)
        handles = row_all_gather(torch.frombuffer(bytearray(handle), dtype=torch.uint8),
                                 self.ranks)
        ptrs = []
        for c, (peer, got) in enumerate(zip(self.ranks, handles)):
            if c == self.me:
                ptrs.append(ptr.value)
                continue
            check_peer_path(self.device, self.cards[c], rank, peer)
            ptrs.append(open_peer(got.numpy().tobytes(), self.device, rank, peer,
                                  self.cards[c]))
        self.ptrs, self.nbytes = ptrs, nbytes
        self.view = torch.as_tensor(_DeviceBytes(ptr.value, nbytes), device=self.device)
        self.flags = RowFlags(flags=[self.view[:MAX_CARDS * 8].view(torch.int64)])
        row_barrier(self.ranks)   # every process has opened every arena

    def T(self, h: int, w: int) -> torch.Tensor:
        """This card's T of an (h, w) level, a view of the arena."""
        t_off = FLAGS_BYTES
        return self.view[t_off:t_off + 2 * h * w * 4].view(torch.float32).view(2, h, w)


_ARENAS: Dict[Tuple[Tuple[int, ...], torch.device], RowArena] = {}


def row_arena(ranks: Sequence[int], cards: Sequence[str], device: torch.device) -> RowArena:
    """The arena of the row of processes ``ranks`` on this process's
    ``device``, made at first use (empty until ``reserve``)."""
    key = (tuple(ranks), device)
    if key not in _ARENAS:
        _ARENAS[key] = RowArena(ranks, cards, device)
    return _ARENAS[key]

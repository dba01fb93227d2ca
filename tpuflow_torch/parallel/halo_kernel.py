"""The row-sharded relaxation as one cooperative CUDA launch per card
(csrc/sharded.cu), the port of tpuflow/parallel/halo_kernel.py:70-422.

``relax_sharded_kernel`` is ``relax_sharded`` (parallel/halo.py) in one
launch per level on each card of a mesh row: each card's launch runs the
shards the row puts on it, its blocks split evenly over them. The halo
exchange is stores into the neighbour shards' halo rows (through peer
pointers where the neighbour is on another card), and the barrier between
phases is a grid-wide sync; over several cards the two syncs around each
push are row barriers, flags stored between the cards (``row_barriers``
says how many). Each outer runs the level kernels' tile bodies over every
shard's padded rows: prologue tiles, a sync, then ceil(inner / KMAX) passes
of k-sweep regions (``grid_syncs`` says how many syncs; the kernel counts
them, and its row barriers, on the card when given ``syncs`` and
``barriers``). On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises (a refused cooperative launch and
a pair of cards without peer access included). It counts its launches, one
a card, in ``relax_sharded_kernel.launches``.

Over several cards every card's launch goes on its ``mesh.card_stream``,
after an event of the caller's stream on the row's first card (the level's
fields are there), and the caller's stream waits for every card before it
reads T. Each card's flags (one a card of the row, in its own memory) are
kept per row of cards, with the epoch they hold, across launches
(``RowFlags``).

Given one field set a card (``uv``, ``fxyz`` and ``J`` as tuples in
``Mesh.row_groups`` order, each on its card: the level driver's lanes,
solver/level.py), the launch takes the form the process row below has:
each card's copy-in reads its own card's fields, the copy-out stores every
shard's owned rows into every card's T, and a last row barrier over all
the cards ends the launch, so each card's T is whole when its own launch
ends. Every card's launch waits for every card's current stream (each
card's fields and T are in, and no card stores into a T still in use),
and each card's current stream waits for its own card's launch alone.

On a row whose positions belong to several processes (one a card, or
several on one card), each process launches its own card alone, on its
``card_stream``, after an event of its caller's stream: the shard buffer,
its card's T and the flags lie in its row arena (parallel/ipc.py), which
the other processes have opened from its CUDA IPC handle. Each card's
copy-in reads its own process's fields, its copy-out stores its owned rows
into every card's T, and a last row barrier over all the row's cards ends
the launch (``row_barriers(..., processes=True)``). Every process advances
its arena's epoch by the same steps, since every process runs the same
levels through the same gates; the lock below orders a process's own
launches, and one position a process gives each process one launch a
level. Two risks, checked on the card (chip_smoke.py):
  * a process that never launches must still make its neighbours trap at
    the kernel's spin limit (``_skip_card`` names the card of the row that
    stays out, across processes too);
  * T is read from the arena on the caller's stream after this card's
    launch, and no peer stores into it again before this card's next
    launch has started: the next level's halo and T stores come after row
    barriers that need this card's next launch, which waits for the
    caller's stream, behind that read.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.cuda_lib import call, on_cuda
from tpuflow_torch.ops.level import KMAX, KSWEEP_RW
from tpuflow_torch.parallel.halo import (
    check_sharded_args, halo_applicable, relax_sharded, row_split,
)
from tpuflow_torch.parallel.mesh import MAX_SHARDS, Mesh, card_stream, enable_peer_access

F = np.float32
# Planes of a shard's buffer (csrc/sharded.cu): T twice (ping-pong), uv,
# fxyz, the 9 hoists, and J with the gradient/log tensor.
N_PLANES = 2 + 2 + 2 + 3 + 9
N_PLANES_TENSOR = N_PLANES + 5
# The kernel's prologue tiles are one block wide: a k-sweep region's width
# (csrc/sharded.cu: SH_PRO_TW = KS_RW), PROLOGUE_TH rows.
SHARDED_PROLOGUE_TW = KSWEEP_RW
# Flags a card keeps (csrc/sharded.cu: MAX_CARDS), one for each card of a row.
MAX_CARDS = MAX_SHARDS


def kernel_halo_applicable(h: int, n_y: int, cfg: FlowConfig, k_outer: int = 1) -> bool:
    """The kernel's gate (halo_kernel.py:79-97): at least one sweep per
    outer, and every shard owns at least max(halo, 16) rows. The halo is
    ``halo_rows``, k (inner + 1), without the TPU's rounding to 8 rows
    (halo_kernel.py:70-76), which only served its (8, 128) tiles. There is
    no fast-memory gate: the shards' buffers live in device memory."""
    return cfg.inner_iterations_count >= 1 and halo_applicable(h, n_y, cfg, k_outer)


def row_barriers(cfg: FlowConfig, n_y: int, cards: int = 1, k_outer: int = 1,
                 processes: bool = False) -> int:
    """The row barriers of one launch on each card (csrc/sharded.cu): two
    an exchange (before and after the push, every ``k_outer`` outers) where
    the row spans several cards; none on one card. With ``processes`` (each
    card its own fields and T: a row over processes, or one process giving
    each card its fields) one more ends the launch."""
    if cards < 2 or n_y < 2:
        return 0
    return 2 * -(-cfg.outer_iterations_count // k_outer) + int(processes)


def grid_syncs(cfg: FlowConfig, n_y: int, k_outer: int = 1, cards: int = 1,
               processes: bool = False) -> int:
    """The grid-wide syncs of one launch on each card (csrc/sharded.cu): per
    outer one at its top and one after the prologue tiles, one between two
    k-sweep passes, one after each halo push (every ``k_outer`` outers, with
    more than one shard), and one before the copy-out; over several cards a
    row barrier in a sync's place is two syncs around its flag step, so
    each adds one, and with ``processes`` (``row_barriers``) the last row
    barrier adds two."""
    outer, passes = cfg.outer_iterations_count, -(-cfg.inner_iterations_count // KMAX)
    pushes = -(-outer // k_outer) if n_y > 1 else 0
    last = int(processes and cards > 1 and n_y > 1)
    return (outer * (1 + passes) + pushes + 1
            + row_barriers(cfg, n_y, cards, k_outer, processes) + last)


@dataclasses.dataclass
class RowFlags:
    """One row of cards' flags: a (MAX_CARDS,) int64 tensor on each card,
    flag j of a card stored only by card j, and the epoch every flag that a
    launch stores has reached. Epochs only grow: a launch's barrier b
    (from 1) waits for ``epoch + b`` and ``advance`` adds the launch's
    barriers, so no flag of an earlier launch satisfies a later wait and
    no flag is ever reset."""

    flags: List[torch.Tensor]
    epoch: int = 0

    def advance(self, barriers: int) -> int:
        """The epoch a launch of ``barriers`` row barriers starts from; the
        next launch starts where this one ends."""
        start, self.epoch = self.epoch, self.epoch + barriers
        return start


_ROW_FLAGS: Dict[Tuple[torch.device, ...], RowFlags] = {}
# One host thread at a time issues a launch over several cards: two
# launches that interleave their cards could each hold one card while they
# wait for the other.
_LAUNCH_LOCK = threading.Lock()


def row_flags(cards: Tuple[torch.device, ...]) -> RowFlags:
    """The flags of a row over ``cards`` (in the row's order), zeroed and
    settled on every card before their first launch: a zeroing queued on
    one card's stream could wipe a flag another card has already stored."""
    if cards not in _ROW_FLAGS:
        flags = []
        for dev in cards:
            with torch.cuda.device(dev), torch.cuda.stream(card_stream(dev)):
                flags.append(torch.zeros(MAX_CARDS, dtype=torch.int64, device=dev))
            torch.cuda.synchronize(dev)
        _ROW_FLAGS[cards] = RowFlags(flags)
    return _ROW_FLAGS[cards]


def _check_counter(name: str, counter: Optional[torch.Tensor], n: int,
                   device: torch.device) -> None:
    if counter is not None and (counter.dtype != torch.int32 or counter.numel() != n
                                or counter.device != device):
        raise ValueError(f"{name} must be {n} int32 on {device} (one a card), got "
                         f"{counter.dtype} {tuple(counter.shape)} on {counter.device}")


def relax_sharded_kernel(fxyz: torch.Tensor, uv: torch.Tensor, sc, cfg: FlowConfig,
                         mesh: Mesh, k_outer: int = 1, J: Optional[torch.Tensor] = None,
                         syncs: Optional[torch.Tensor] = None,
                         barriers: Optional[torch.Tensor] = None, data: int = 0,
                         reserve: Optional[Tuple[int, int]] = None,
                         _skip_card: Optional[int] = None) -> torch.Tensor:
    """T (2, h, w) after outer x inner relaxation with rows sharded over data
    row ``data`` of ``mesh`` and halos exchanged once every ``k_outer``
    outers; ``T - uv`` is the (du, dv) of the TPU kernel. The other
    arguments are ``relax_sharded``'s. The fields lie on the row's first
    device, where T is returned. ``syncs`` and ``barriers``, int32 tensors
    there with one element a card of the row (``mesh.row_groups(data)``'s
    order), get each card's grid syncs and row barriers added to them (the
    plain version makes none and refuses them). The shards' buffers are not
    initialised: the kernel writes every row before it reads it.
    ``_skip_card`` leaves that card's launch out, so that its neighbours
    trap at the kernel's spin limit (a test of the limit; the process's
    CUDA context is then lost).

    Over a row of processes the fields and T lie on this process's card,
    ``syncs`` and ``barriers`` (one element a process of the row) get this
    card's counts, and ``reserve`` (h, w) sizes the row's arenas for the
    finest level to come (the pair's), so that they grow once.

    ``fxyz``, ``uv`` and ``J`` as tuples, one entry a card of a one-process
    row over several cards (``mesh.row_groups(data)``'s order, each on its
    card, each holding at least its card's shards' owned rows) return a
    tuple of T, one whole T a card, each on its card's current stream
    (module docstring). On CPU tensors the plain version relaxes the
    owned rows that each card's launch would copy in."""
    if cfg.inner_iterations_count < 1:
        raise ValueError("relax_sharded_kernel needs at least one inner sweep per outer")
    if isinstance(uv, (tuple, list)):
        return _relax_card_fields(tuple(fxyz), tuple(uv), sc, cfg, mesh, k_outer,
                                  None if J is None else tuple(J), syncs, barriers, data,
                                  _skip_card)
    halo = check_sharded_args(fxyz, uv, cfg, mesh, k_outer, J)
    if not on_cuda(fxyz, uv, *(() if J is None else (J,))):
        if syncs is not None or barriers is not None:
            raise ValueError("syncs and barriers count the kernel's grid syncs and row "
                             "barriers; the plain version has none")
        return relax_sharded(fxyz, uv, sc, cfg, mesh, k_outer, J, data)
    if mesh.row_spans_processes(data):
        return _relax_process_row(fxyz, uv, sc, cfg, mesh, k_outer, J, syncs, barriers, data,
                                  halo, reserve, _skip_card)
    groups = mesh.row_groups(data)
    cards = tuple(dev for dev, _ in groups)
    if uv.device != cards[0]:
        raise ValueError(f"tensors on {uv.device} for a mesh row whose first device is "
                         f"{cards[0]}")
    if any(dev.type != "cuda" for dev in cards):
        raise ValueError(f"a row over {[str(d) for d in cards]}: the kernel runs on cards only")
    _check_counter("syncs", syncs, len(cards), uv.device)
    _check_counter("barriers", barriers, len(cards), uv.device)
    _, h, w = uv.shape
    if w < 2:
        raise ValueError(f"the mirror boundary needs a level at least 2 wide, got {w}")
    several = len(cards) > 1
    if several:
        enable_peer_access(cards)
    shards = row_split(h, mesh.n_y, halo)
    planes = N_PLANES if J is None else N_PLANES_TENSOR
    caller = torch.cuda.current_stream()
    streams = [card_stream(dev) for dev in cards] if several else [caller]
    if several:
        ready = torch.cuda.Event()
        ready.record(caller)   # the level's fields are in
    bufs, shard_card = _shard_buffers(groups, streams, shards, planes, w,
                                      [ready] if several else [])
    T = torch.empty_like(uv)
    n, n_y = len(cards), mesh.n_y
    flags = row_flags(cards) if several else None
    launch = (1 << n) - 1 if _skip_card is None else ((1 << n) - 1) & ~(1 << _skip_card)
    with _LAUNCH_LOCK:
        epoch = 0 if flags is None else flags.advance(row_barriers(cfg, n_y, n, k_outer))
        _launch(n, [dev.index for dev in cards], [st.cuda_stream for st in streams],
                [b.data_ptr() for b in bufs], shard_card, shards, h,
                None if flags is None else [f.data_ptr() for f in flags.flags], epoch,
                [uv.data_ptr()] * n, [fxyz.data_ptr()] * n,
                None if J is None else [J.data_ptr()] * n, [T.data_ptr()], launch, syncs,
                barriers, w, halo, cfg, k_outer, sc)
    if several:
        for stream in streams:
            done = torch.cuda.Event()
            done.record(stream)
            caller.wait_event(done)   # T is in, and the fields are read
    relax_sharded_kernel.launches += n - (_skip_card is not None)
    return T


relax_sharded_kernel.launches = 0


def _shard_buffers(groups, streams, shards, planes: int, w: int, after) -> tuple:
    """Each shard's buffer on its card, and the card of each shard: a
    card's buffers on the stream of its launch, which alone uses them and
    first waits for the events ``after``."""
    bufs, shard_card = [None] * len(shards), [0] * len(shards)
    for c, ((dev, ys), stream) in enumerate(zip(groups, streams)):
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            for event in after:
                stream.wait_event(event)
            for y in ys:
                bufs[y] = torch.empty((planes, shards[y].padded, w), dtype=torch.float32,
                                      device=dev)
                shard_card[y] = c
    return bufs, shard_card


def owned_rows(fields: Tuple[torch.Tensor, ...], groups, shards) -> torch.Tensor:
    """One whole field from each card's copy of it: every shard's owned
    rows from its card's (``groups``: (device, shard indices) a card)."""
    whole = torch.empty_like(fields[0])
    for field, (_, ys) in zip(fields, groups):
        for y in ys:
            rows = slice(shards[y].row0, shards[y].row0 + shards[y].rows)
            whole[:, rows] = field[:, rows].to(whole.device)
    return whole


def _relax_card_fields(fxyz, uv, sc, cfg: FlowConfig, mesh: Mesh, k_outer: int, J, syncs,
                       barriers, data: int, skip: Optional[int]) -> Tuple[torch.Tensor, ...]:
    """``relax_sharded_kernel`` with one field set a card of a one-process
    row: one launch a card, each card's copy-in from its own fields, every
    card's T filled (module docstring)."""
    groups = mesh.row_groups(data)
    cards = tuple(dev for dev, _ in groups)
    n = len(cards)
    sets = [("uv", uv), ("fxyz", fxyz)] + ([] if J is None else [("J", J)])
    for name, fields in sets:
        if len(fields) != n or any(f.device != dev for f, dev in zip(fields, cards)):
            raise ValueError(f"{name}: one tensor a card of the row, on "
                             f"{[str(d) for d in cards]}, got "
                             f"{[str(f.device) for f in fields]}")
    halo = check_sharded_args(fxyz[0], uv[0], cfg, mesh, k_outer, None if J is None else J[0])
    _, h, w = uv[0].shape
    shards = row_split(h, mesh.n_y, halo)
    cuda = []
    for c, dev in enumerate(cards):   # each card's fields, with its card current
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            cuda.append(on_cuda(uv[c], fxyz[c], *(() if J is None else (J[c],))))
    if any(cuda) != all(cuda):
        raise ValueError("one field set a card: all on cards or all on the CPU")
    if not cuda[0]:
        if syncs is not None or barriers is not None:
            raise ValueError("syncs and barriers count the kernel's grid syncs and row "
                             "barriers; the plain version has none")
        T = relax_sharded(owned_rows(fxyz, groups, shards), owned_rows(uv, groups, shards), sc,
                          cfg, mesh, k_outer,
                          None if J is None else owned_rows(J, groups, shards), data)
        return tuple(T.to(dev, copy=True) for dev in cards)
    if n < 2:
        raise ValueError("one field set a card needs a row over at least two cards")
    if mesh.row_spans_processes(data):
        raise ValueError("a row over processes gives each process its own fields alone")
    _check_counter("syncs", syncs, n, cards[0])
    _check_counter("barriers", barriers, n, cards[0])
    if w < 2:
        raise ValueError(f"the mirror boundary needs a level at least 2 wide, got {w}")
    enable_peer_access(cards)
    planes = N_PLANES if J is None else N_PLANES_TENSOR
    callers = [torch.cuda.current_stream(dev) for dev in cards]
    Ts = []
    for dev, field in zip(cards, uv):
        with torch.cuda.device(dev):   # on the card's current stream
            Ts.append(torch.empty_like(field))
    ready = []
    for caller in callers:   # each card's fields and T are in
        ready.append(torch.cuda.Event())
        ready[-1].record(caller)
    streams = [card_stream(dev) for dev in cards]
    bufs, shard_card = _shard_buffers(groups, streams, shards, planes, w, ready)
    flags = row_flags(cards)
    launch = (1 << n) - 1 if skip is None else ((1 << n) - 1) & ~(1 << skip)
    with _LAUNCH_LOCK:
        epoch = flags.advance(row_barriers(cfg, mesh.n_y, n, k_outer, processes=True))
        _launch(n, [dev.index for dev in cards], [st.cuda_stream for st in streams],
                [b.data_ptr() for b in bufs], shard_card, shards, h,
                [f.data_ptr() for f in flags.flags], epoch, [t.data_ptr() for t in uv],
                [t.data_ptr() for t in fxyz], None if J is None else [t.data_ptr() for t in J],
                [T.data_ptr() for T in Ts], launch, syncs, barriers, w, halo, cfg, k_outer, sc)
    for stream, caller in zip(streams, callers):
        done = torch.cuda.Event()
        done.record(stream)
        caller.wait_event(done)   # this card's T is whole, its fields read
    relax_sharded_kernel.launches += n - (skip is not None)
    return tuple(Ts)


def _pointers(values) -> ctypes.Array:
    return (ctypes.c_void_p * len(values))(*values)


def _launch(n: int, devices: List[int], streams: List[int], bufs: List[int], shard_card,
            shards, h: int, flags: Optional[List[int]], epoch: int, uv: List[int],
            fxyz: List[int], J: Optional[List[int]], T: List[int], launch: int, syncs,
            barriers, w: int, halo: int, cfg: FlowConfig, k_outer: int, sc) -> None:
    """``tf_relax_sharded`` on the cards of ``launch`` (a bit a card)."""
    n_y = len(shards)
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    call("tf_relax_sharded", n, (ctypes.c_int * n)(*devices), _pointers(streams),
         _pointers(bufs), (ctypes.c_int * n_y)(*shard_card),
         (ctypes.c_int * (n_y + 1))(*[sh.row0 for sh in shards], h), n_y,
         None if flags is None else _pointers(flags), epoch, _pointers(uv), _pointers(fxyz),
         None if J is None else _pointers(J), _pointers(T), len(T), launch,
         None if syncs is None else syncs.data_ptr(),
         None if barriers is None else barriers.data_ptr(), h, w, halo,
         cfg.outer_iterations_count, cfg.inner_iterations_count, k_outer,
         *map(float, (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e_s2, e_d2)))


def _relax_process_row(fxyz, uv, sc, cfg: FlowConfig, mesh: Mesh, k_outer: int, J,
                       syncs, barriers, data: int, halo: int,
                       reserve: Optional[Tuple[int, int]], skip: Optional[int]) -> torch.Tensor:
    """``relax_sharded_kernel`` on a row of processes: this process's card
    alone, its shard, T and flags in its row arena (module docstring)."""
    from tpuflow_torch.parallel.ipc import arena_layout, row_arena

    ranks = mesh.row_ranks(data)
    positions = mesh.row(data)
    me = ranks.index(torch.distributed.get_rank())
    dev, n = mesh.devices[positions[me]], len(ranks)
    if uv.device != dev:
        raise ValueError(f"tensors on {uv.device} for this process's position of the row, "
                         f"on {dev}")
    _check_counter("syncs", syncs, n, dev)
    _check_counter("barriers", barriers, n, dev)
    _, h, w = uv.shape
    if w < 2:
        raise ValueError(f"the mirror boundary needs a level at least 2 wide, got {w}")
    shards = row_split(h, n, halo)
    planes = N_PLANES if J is None else N_PLANES_TENSOR
    t_off, buf_off, need = arena_layout(h, w, planes, max(sh.padded for sh in shards))
    if reserve is not None:
        # the largest shard any admitted k gives the finest level: halo <= its rows
        fh, fw = reserve
        need = max(need, arena_layout(fh, fw, N_PLANES_TENSOR, -(-fh // n) + 2 * (fh // n))[2])
    arena = row_arena(ranks, [mesh.uuids[p] for p in positions], dev)
    arena.reserve(need)
    caller = torch.cuda.current_stream(dev)
    stream = card_stream(dev)
    ready = torch.cuda.Event()
    ready.record(caller)   # the level's fields are in
    stream.wait_event(ready)
    base = arena.ptrs
    with _LAUNCH_LOCK:
        epoch = arena.flags.advance(row_barriers(cfg, n, n, k_outer, processes=True))
        launch = 0 if skip == me else 1 << me
        devices, streams, fields = [dev.index] * n, [None] * n, [None] * n
        streams[me] = stream.cuda_stream
        _launch(n, devices, streams, [b + buf_off for b in base], range(n), shards, h, base,
                epoch, [uv.data_ptr() if c == me else None for c in range(n)],
                [fxyz.data_ptr() if c == me else None for c in range(n)],
                None if J is None else [J.data_ptr() if c == me else None for c in range(n)],
                [b + t_off for b in base], launch, syncs, barriers, w, halo, cfg, k_outer, sc)
    done = torch.cuda.Event()
    done.record(stream)
    caller.wait_event(done)   # this card's T is whole, its fields read
    T = torch.empty_like(uv)
    T.copy_(arena.T(h, w))
    relax_sharded_kernel.launches += int(launch != 0)
    return T

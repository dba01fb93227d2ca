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
"""

from __future__ import annotations

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


def row_barriers(cfg: FlowConfig, n_y: int, cards: int = 1, k_outer: int = 1) -> int:
    """The row barriers of one launch on each card (csrc/sharded.cu): two
    an exchange (before and after the push, every ``k_outer`` outers) where
    the row spans several cards; none on one card."""
    if cards < 2 or n_y < 2:
        return 0
    return 2 * -(-cfg.outer_iterations_count // k_outer)


def grid_syncs(cfg: FlowConfig, n_y: int, k_outer: int = 1, cards: int = 1) -> int:
    """The grid-wide syncs of one launch on each card (csrc/sharded.cu): per
    outer one at its top and one after the prologue tiles, one between two
    k-sweep passes, one after each halo push (every ``k_outer`` outers, with
    more than one shard), and one before the copy-out; over several cards a
    row barrier is two syncs around its flag step, so each adds one."""
    outer, passes = cfg.outer_iterations_count, -(-cfg.inner_iterations_count // KMAX)
    pushes = -(-outer // k_outer) if n_y > 1 else 0
    return outer * (1 + passes) + pushes + 1 + row_barriers(cfg, n_y, cards, k_outer)


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
    CUDA context is then lost)."""
    if cfg.inner_iterations_count < 1:
        raise ValueError("relax_sharded_kernel needs at least one inner sweep per outer")
    halo = check_sharded_args(fxyz, uv, cfg, mesh, k_outer, J)
    if not on_cuda(fxyz, uv, *(() if J is None else (J,))):
        if syncs is not None or barriers is not None:
            raise ValueError("syncs and barriers count the kernel's grid syncs and row "
                             "barriers; the plain version has none")
        return relax_sharded(fxyz, uv, sc, cfg, mesh, k_outer, J)
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
    bufs, shard_card = [None] * mesh.n_y, [0] * mesh.n_y
    for c, ((dev, ys), stream) in enumerate(zip(groups, streams)):
        # a card's buffers on the stream of its launch, which alone uses them
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if several:
                stream.wait_event(ready)
            for y in ys:
                bufs[y] = torch.empty((planes, shards[y].padded, w), dtype=torch.float32,
                                      device=dev)
                shard_card[y] = c
    T = torch.empty_like(uv)
    n, n_y = len(cards), mesh.n_y
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    flags = row_flags(cards) if several else None
    with _LAUNCH_LOCK:
        epoch = 0 if flags is None else flags.advance(row_barriers(cfg, n_y, n, k_outer))
        call("tf_relax_sharded", n, (ctypes.c_int * n)(*(dev.index for dev in cards)),
             (ctypes.c_void_p * n)(*(st.cuda_stream for st in streams)),
             (ctypes.c_void_p * n_y)(*(b.data_ptr() for b in bufs)),
             (ctypes.c_int * n_y)(*shard_card),
             (ctypes.c_int * (n_y + 1))(*[sh.row0 for sh in shards], h), n_y,
             None if flags is None else (ctypes.c_void_p * n)(*(f.data_ptr()
                                                                for f in flags.flags)),
             epoch, uv.data_ptr(), fxyz.data_ptr(), None if J is None else J.data_ptr(),
             T.data_ptr(), None if syncs is None else syncs.data_ptr(),
             None if barriers is None else barriers.data_ptr(), h, w, halo,
             cfg.outer_iterations_count, cfg.inner_iterations_count, k_outer,
             *map(float, (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e_s2, e_d2)),
             -1 if _skip_card is None else _skip_card)
    if several:
        for stream in streams:
            done = torch.cuda.Event()
            done.record(stream)
            caller.wait_event(done)   # T is in, and the fields are read
    relax_sharded_kernel.launches += n - (_skip_card is not None)
    return T


relax_sharded_kernel.launches = 0

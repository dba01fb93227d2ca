"""The process group of a mesh over processes: one gloo group for host
objects, the collectives of one mesh row over it, and the row's tensor
messages between the processes' cards.

``initialize_distributed`` (parallel/multihost.py) joins a process to a
``torch.distributed`` group, over NCCL where CUDA is available. Everything
a mesh over processes exchanges on the host (the positions' cards, the
arenas' IPC handles, the plain twin's halo rows) goes over one gloo group
made beside it, once, so that no NCCL call is on that path: NCCL refuses
two ranks on one card, and moves only tensors on the card.

A row of a ``(data, y)`` mesh is a subset of the group, and two rows solve
different pairs at their own pace, so the row's collectives are
point-to-point messages between its ranks over the gloo group: a collective
over the whole group would tie the rows together. Every rank of a row makes
the same row collectives in the same order, so the messages between two
ranks match in order.

The tensors a row moves between its processes (the explicit route's halos
and owned rows, the hybrid's working sets) go as point-to-point messages on
the default group (``row_exchange``, ``row_send_recv``): NCCL between the
cards, gloo on the CPU. NCCL carries a batch of messages on a communicator
of the whole group, made at the first batch, in which every rank must take
part (``p2p_join``); and it refuses two ranks on one card at that point
("Duplicate GPU detected", ncclInvalidUsage, NCCL 2.28.9 on an H100).
``shared_card`` holds that rule, for ``Mesh.p2p_ok`` and ``check_p2p_cards``,
which raises before any message where ranks share a card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

_GLOO = None


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_group():
    """The gloo group over every process, made at first use. Making it is a
    collective of the whole group, which ``initialize_distributed`` does
    right after it joins; raises without an initialised group."""
    global _GLOO
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed group is initialised "
                           "(parallel.multihost.initialize_distributed)")
    if _GLOO is None:
        _GLOO = dist.new_group(backend="gloo")
    return _GLOO


def row_all_gather(x: torch.Tensor, ranks: Sequence[int],
                   shapes: Optional[Sequence[Tuple[int, ...]]] = None) -> List[torch.Tensor]:
    """Each rank of ``ranks``'s ``x`` (a CPU tensor), in the row's order,
    this rank's own included as given. ``shapes`` are the ranks' shapes
    where they differ (x's dtype). Point-to-point over the gloo group."""
    dist = torch.distributed
    me, group = dist.get_rank(), process_group()
    x = x.contiguous()
    out, pending = [], []
    for i, r in enumerate(ranks):
        if r == me:
            out.append(x)
            continue
        got = torch.empty(x.shape if shapes is None else shapes[i], dtype=x.dtype)
        pending.append(dist.isend(x, r, group=group))
        pending.append(dist.irecv(got, r, group=group))
        out.append(got)
    for req in pending:
        req.wait()
    return out


def row_barrier(ranks: Sequence[int]) -> None:
    """Return once every rank of ``ranks`` has come here."""
    row_all_gather(torch.zeros(1, dtype=torch.int32), ranks)


def exchange_with(sends: Sequence[Tuple[int, torch.Tensor]],
                  recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """Send each (rank, CPU tensor) of ``sends`` and fill each (rank, CPU
    tensor) of ``recvs`` from that rank, all at once: a halo exchange
    between neighbours."""
    dist = torch.distributed
    group = process_group()
    sends = [(r, t.contiguous()) for r, t in sends]   # alive until the waits
    pending = [dist.isend(t, r, group=group) for r, t in sends]
    pending += [dist.irecv(t, r, group=group) for r, t in recvs]
    for req in pending:
        req.wait()


def p2p_backend() -> Optional[str]:
    """The backend of the default group, which carries the rows' tensor
    messages: ``"nccl"`` on cards, ``"gloo"`` on the CPU; None before a
    group is made."""
    dist = torch.distributed
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def shared_card(ranks: Sequence[int], cards: Sequence) -> Optional[Tuple[int, int, object]]:
    """The one rule of where NCCL cannot carry the rows' messages: (rank a,
    rank b, card) for the first two of ``ranks`` (every rank of the group)
    that share a card (``cards``, one a rank, by UUID) where the default
    group is NCCL, which makes its communicator over every rank and refuses
    two on one card; else None. Over gloo any layout passes; without a
    group (a plan made before one is) the cards decide, as under NCCL."""
    if p2p_backend() not in ("nccl", None):
        return None
    owner = {}
    for rank, card in zip(ranks, cards):
        if owner.setdefault(card, rank) != rank:
            return owner[card], rank, card
    return None


def check_p2p_cards(ranks: Sequence[int], cards: Sequence, what: str) -> None:
    """Raise, before any message, where NCCL would carry ``what`` and two of
    ``ranks`` share a card (``shared_card``)."""
    clash = shared_card(ranks, cards)
    if clash is not None:
        a, b, card = clash
        raise RuntimeError(
            f"{what} moves tensors between processes by NCCL, which refuses two ranks on "
            f"one card: ranks {a} and {b} share card {card}; run one process a card")


def row_exchange(sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """Send each (rank, tensor) of ``sends`` and fill each (rank, tensor) of
    ``recvs`` from that rank, as one batch of point-to-point messages on the
    default group (``batch_isend_irecv``, the port's ``ppermute``). Two
    ranks match their messages in order: each must list its sends to the
    other in the order the other lists its receives from it.

    Tensors must be contiguous (a view of contiguous rows is). On the card
    the batch runs on NCCL's stream, which waits at issue for the caller's
    current stream; each ``Work.wait()`` then orders the current stream
    after it, without blocking the host, so the caller keeps its tensors
    alive and their memory is reused only after the messages, in that
    stream's order. Counts the sends in ``row_exchange.sends``."""
    for _, t in (*sends, *recvs):
        if not t.is_contiguous():
            raise ValueError(f"a point-to-point message needs a contiguous tensor, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    dist = torch.distributed
    ops = ([dist.P2POp(dist.isend, t, r) for r, t in sends]
           + [dist.P2POp(dist.irecv, t, r) for r, t in recvs])
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    row_exchange.sends += len(sends)


row_exchange.sends = 0


def row_send_recv(tensors: Sequence[torch.Tensor], owner: int, ranks: Sequence[int]) -> None:
    """``owner``'s ``tensors`` to every other rank of ``ranks``, which
    receive them into theirs (same shapes), in one batch; a rank that is
    neither does nothing."""
    me = torch.distributed.get_rank()
    if me == owner:
        row_exchange([(r, t) for r in ranks if r != owner for t in tensors], [])
    elif me in ranks:
        row_exchange([], [(owner, t) for t in tensors])


def p2p_join(device: torch.device) -> None:
    """One batch in which every rank of the group sends one value to each
    ring neighbour and receives theirs: NCCL makes its communicator of the
    default group at the first batch, in which every rank must take part,
    and connects each pair of peers at their first message. Every process
    calls it at once, each with its own card."""
    rank, world = process_rank()
    x = torch.zeros(2, dtype=torch.float32, device=device)
    got = torch.empty(2, dtype=torch.float32, device=device)
    ahead, behind = (rank + 1) % world, (rank - 1) % world
    row_exchange([(ahead, x[:1]), (behind, x[1:])], [(behind, got[:1]), (ahead, got[1:])])

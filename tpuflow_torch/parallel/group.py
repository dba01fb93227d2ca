"""The process group of a mesh over processes: one gloo group for host
objects, and the collectives of one mesh row over it.

``initialize_distributed`` (parallel/multihost.py) joins a process to a
``torch.distributed`` group, over NCCL where CUDA is available. Everything
a mesh over processes exchanges on the host (the positions' cards, the
arenas' IPC handles, the plain twin's halo rows) goes over one gloo group
made beside it, once, so that no NCCL collective is on that path: NCCL
refuses two ranks on one card, and moves only tensors on the card.

A row of a ``(data, y)`` mesh is a subset of the group, and two rows solve
different pairs at their own pace, so the row's collectives are
point-to-point messages between its ranks over the gloo group: a collective
over the whole group would tie the rows together. Every rank of a row makes
the same row collectives in the same order, so the messages between two
ranks match in order.
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

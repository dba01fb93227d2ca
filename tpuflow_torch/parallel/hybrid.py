"""The dp x sp hybrid: ``compute_flow_hybrid`` (the port of
tpuflow/parallel/hybrid.py:41-216).

Under row sharding the coarse levels, which the router replicates, are a
serial tail. Pairs are independent, so a stack of B pairs runs in two
phases:

  phase A  every level before ``split_level``, pair b on position
           b % mesh.size, each on its position's stream;
  phase B  the remaining levels pair by pair, pair b on the ``y``
           positions of data row b % n_data, each level's relaxation on the
           router's route (``solver.sharded``, ``halo="auto"``).

``split_level`` defaults to the router's first sharded level. Pairs need no
padding: a position simply takes fewer of them. Each pair's flow is
bitwise that of ``compute_flow`` on the pair alone.

Phase B is one ``solve`` of the levels from the split with
``solver.sharded.sharded_solve``'s keywords, found once for each data row:
the relaxation on the router's routes and, where the row spans several
cards of this process, the lanes (solver/level.py), which compute each
card's own rows of the whole-field stages over the schedule's suffix of
sharded levels. The pair and the flow of the last phase-A level come to
the row's first card; each other card then receives the smoothed pair
from it, and the rows of the flow its plan reads at the first banded
level from the split on (``max(split, start)``), and its owned rows of
the finest flow go back to the first card. The levels from the split to
the suffix, and a row on one card, run on the row's first card. A split
past the finest level solves nothing there, and gathers nothing.

On a mesh over processes (one position a process) every process calls it
with the whole stack. Phase A runs this process's pairs (b % mesh.size is
its position); then pair b's owner sends its working set (the smoothed
pair, and the flow of the last phase-A level) to the other processes of
data row b % n_data, point to point on the default group (NCCL between the
cards), every such transfer issued in pair order before any fine level, so
that no owner waits on a row busy with another pair; then the processes of
each row run its pairs' fine levels together, the relaxation on the
router's routes over the row, and over the levels of the schedule's
suffix of sharded levels each process only its own rows of the
whole-field stages (``solver.sharded.sharded_bands``; from the split on,
where the suffix starts earlier). Each process returns its row's pairs
(``FlowResult.pairs``), downloaded pinned.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.parallel.group import row_send_recv
from tpuflow_torch.parallel.halo import _copy, _event
from tpuflow_torch.parallel.mesh import Mesh, resolve_device
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.flow2d import (
    _DOWNLOAD_STREAMS, FlowResult, _frames, _full_float32, _on, _upload,
)
from tpuflow_torch.solver.level import smooth_pair, solve
from tpuflow_torch.solver.sharded import (
    row_device, sharded_plan, sharded_solve,
)
from tpuflow_torch.utils.timing import Timer


def hybrid_split_level(w: int, h: int, cfg: FlowConfig, mesh: Mesh) -> int:
    """The router's split of a w x h pair on ``mesh``: the position, in the
    coarse-to-fine schedule, of the first level that data row 0's
    ``"auto"`` router (``solver.sharded.level_route``, with the row's
    constants) shards over ``y``."""
    plan = sharded_plan(w, h, cfg, mesh, "auto")
    return next((i for i, (_, _, route, _) in enumerate(plan) if route != "replicated"),
                len(plan))


def _move(x: torch.Tensor, src: int, dst: int, mesh: Mesh) -> torch.Tensor:
    """x, made on position ``src``'s stream, as a tensor that position
    ``dst``'s stream may read: x itself on the same device, after dst's
    stream has waited for src's; else a copy on dst's device."""
    src_stream, stream = mesh.stream(src), mesh.stream(dst)
    if x.device == mesh.devices[dst]:
        if stream is not None:
            stream.wait_event(_event(src_stream))
            x.record_stream(stream)
        return x
    with mesh.on(dst):
        out = torch.empty(x.shape, dtype=x.dtype, device=mesh.devices[dst])
        _copy(out, x, stream, src_stream, _event(src_stream))
    return out


def compute_flow_hybrid(frames_0, frames_1, cfg: Optional[FlowConfig] = None, *,
                        mesh: Mesh, split_level: Optional[int] = None,
                        device="cuda") -> FlowResult:
    """The flows of a (B, H, W) stack of pairs with the two-phase schedule
    above; ``FlowResult`` holds (B, H, W) u and v on the host. ``device``
    must be the mesh's first device; on a mesh over processes, this
    process's card, and the result holds its row's pairs. Moving a pair
    between processes needs a card a process, and raises where two share
    one (NCCL refuses them)."""
    cfg = cfg or FlowConfig()
    f0, f1 = _frames(frames_0, frames_1, stacks=True)
    if f0.ndim != 3:
        raise ValueError(f"expected (B, H, W) stacks, got {f0.shape}")
    home = row_device(mesh, mesh.local_row())
    if resolve_device(device) != home:
        raise ValueError(f"device {str(device)!r} is not the mesh's device, {home}")
    b, h, w = f0.shape
    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    g0 = hybrid_split_level(w, h, cfg, mesh) if split_level is None else split_level
    if not 0 <= g0 <= n:
        raise ValueError(f"split_level {g0} outside the {n} levels of a {w}x{h} pair")
    if mesh.spans_processes:
        return _hybrid_processes(f0, f1, cfg, mesh, g0, n)
    sharded = [sharded_solve(cfg, mesh, (h, w), data=d) for d in range(mesh.n_data)]
    with _full_float32(), Timer() as timer:
        tails = []
        for i in range(b):                     # phase A
            p = i % mesh.size
            dev = mesh.devices[p]
            with _on(dev), mesh.on(p):
                frames = _upload(f0[i], f1[i], dev)
                smoothed = smooth_pair(frames[0], frames[1], cfg)
                uv = solve(smoothed[0], smoothed[1], cfg, levels=range(g0), smoothed=True)
            tails.append((p, smoothed, uv))
        flows = []
        for i, (p, smoothed, uv) in enumerate(tails):   # phase B
            data = i % mesh.n_data
            home = mesh.row(data)[0]
            if p != home:
                smoothed = _move(smoothed, p, home, mesh)
                uv = None if uv is None else _move(uv, p, home, mesh)
            with _on(mesh.devices[home]), mesh.on(home):
                flows.append((home, solve(smoothed[0], smoothed[1], cfg, levels=range(g0, n),
                                          uv=uv, smoothed=True, **sharded[data])))
        out = np.empty((2, b, h, w), dtype=np.float32)
        for i, (home, flow) in enumerate(flows):
            with mesh.on(home):
                out[:, i] = flow.cpu().numpy()
    return FlowResult(u=out[0], v=out[1], seconds=timer.seconds)


def hybrid_moves(b: int, mesh: Mesh):
    """Phase B's transfers of a stack of ``b`` pairs on a mesh over
    processes, in the order every process issues them: (pair, owner's
    position, the positions of its row that receive it)."""
    moves = []
    for i in range(b):
        owner = i % mesh.size
        to = tuple(p for p in mesh.row(i % mesh.n_data) if p != owner)
        if to:
            moves.append((i, owner, to))
    return moves


def _hybrid_processes(f0: np.ndarray, f1: np.ndarray, cfg: FlowConfig, mesh: Mesh, g0: int,
                      n: int) -> FlowResult:
    """The hybrid on a mesh over processes (module docstring): this
    process's phase A, its part of every transfer in pair order, then its
    row's pairs' fine levels; downloads once, pinned, on a copy stream."""
    from tpuflow_torch.parallel.multihost import _copy_stream, _download

    b, h, w = f0.shape
    me = mesh.local_positions()[0]
    data, device = me // mesh.n_y, mesh.devices[me]
    moves = hybrid_moves(b, mesh)
    if moves:
        mesh.check_p2p("compute_flow_hybrid, moving each pair to its row,")
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    sharded = sharded_solve(cfg, mesh, (h, w), data=data)
    mine = tuple(i for i in range(b) if i % mesh.n_data == data)
    with _full_float32(), _on(device), mesh.on(me), Timer() as timer:
        work = {}
        for i in range(me, b, mesh.size):       # phase A
            frames = _upload(f0[i], f1[i], device)
            smoothed = smooth_pair(frames[0], frames[1], cfg)
            work[i] = (smoothed, solve(smoothed[0], smoothed[1], cfg, levels=range(g0),
                                       smoothed=True))
        for i, owner, to in moves:              # phase B's transfers, in pair order
            if me == owner:
                tensors = [x.contiguous() for x in work[i] if x is not None]
            elif me in to:
                tensors = [torch.empty((2, h, w), dtype=torch.float32, device=device)]
                if g0:
                    tensors.append(torch.empty((2, specs[g0 - 1].height, specs[g0 - 1].width),
                                               dtype=torch.float32, device=device))
                work[i] = (tensors[0], tensors[1] if g0 else None)
            else:
                continue
            row_send_recv(tensors, mesh.ranks[owner], [mesh.ranks[p] for p in (owner, *to)])
        flows = [solve(work[i][0][0], work[i][0][1], cfg, levels=range(g0, n), uv=work[i][1],
                       smoothed=True, **sharded) for i in mine]
        if not flows:
            uv = np.empty((2, 0, h, w), dtype=np.float32)
        else:
            host, copied = _download(torch.stack(flows, dim=1),
                                     _copy_stream(_DOWNLOAD_STREAMS, device))
            if copied is not None:
                copied.synchronize()
            uv = host.numpy()
    return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds, pairs=mine)

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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.parallel.halo import _copy, _event
from tpuflow_torch.parallel.mesh import Mesh, resolve_device
from tpuflow_torch.parallel.model import hybrid_split, link_params, rub_default_levels
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.flow2d import FlowResult, _frames, _full_float32, _on, _upload
from tpuflow_torch.solver.level import smooth_pair, solve
from tpuflow_torch.solver.sharded import row_device, sharded_relax_for
from tpuflow_torch.utils.timing import Timer


def hybrid_split_level(w: int, h: int, cfg: FlowConfig, mesh: Mesh) -> int:
    """The router's split of a w x h pair on ``mesh``: the position, in the
    coarse-to-fine schedule, of the first level it shards over ``y``."""
    cards = mesh.row_cards(0)
    return hybrid_split(rub_default_levels(w, h, cfg, link_params(cards)), cfg, mesh.n_y,
                        link_params(cards), cards=cards)


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
    must be the mesh's first device. A mesh over processes raises
    NotImplementedError: moving a pair's working set between processes
    needs NCCL send/recv, which is not built (ROADMAP Queue 1)."""
    if mesh.spans_processes:
        raise NotImplementedError("compute_flow_hybrid over processes needs NCCL send/recv "
                                  "to move each pair to its row, which is not built (ROADMAP "
                                  "Queue 1); compute_flow(..., mesh=) deals a stack over them")
    cfg = cfg or FlowConfig()
    f0, f1 = _frames(frames_0, frames_1, stacks=True)
    if f0.ndim != 3:
        raise ValueError(f"expected (B, H, W) stacks, got {f0.shape}")
    if resolve_device(device) != row_device(mesh):
        raise ValueError(f"device {str(device)!r} is not the mesh's device, {row_device(mesh)}")
    b, h, w = f0.shape
    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    g0 = hybrid_split_level(w, h, cfg, mesh) if split_level is None else split_level
    if not 0 <= g0 <= n:
        raise ValueError(f"split_level {g0} outside the {n} levels of a {w}x{h} pair")
    relax_for = [sharded_relax_for(cfg, mesh, "auto", data=d) for d in range(mesh.n_data)]
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
                                          uv=uv, smoothed=True, relax_for=relax_for[data])))
        out = np.empty((2, b, h, w), dtype=np.float32)
        for i, (home, flow) in enumerate(flows):
            with mesh.on(home):
                out[:, i] = flow.cpu().numpy()
    return FlowResult(u=out[0], v=out[1], seconds=timer.seconds)

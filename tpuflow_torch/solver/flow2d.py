"""The public front door: ``compute_flow``, ``compute_flow_async``,
``compute_flow_warp_report``, ``FlowResult``, ``LevelTrace``,
``endpoint_error`` (the port of tpuflow/solver/flow2d.py:33-60, :99-228,
:230, :354 and tpuflow/solver/bucketed.py:1249-1283).

One pair, or a (B, H, W) stack of pairs solved in order, with the data
constancy of ``cfg.data_constancy`` (grey, gradient or log-derivative). The
device is explicit: ``device="cuda"`` runs the CUDA kernels and raises on a
machine without CUDA; it never falls back to the CPU. ``device="cpu"`` runs
the kernels' plain PyTorch versions.

On the card a pair is submitted without a host fence: the frames go up
through a ring of pinned staging buffers (a copy from pageable memory would
wait for every pair queued before it), the presmooth's and resample's
plans stay on the device, and ``solve`` has no synchronisation inside.
``compute_flow`` waits for the card once, in its final copy to the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.parallel.mesh import resolve_device
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import solve
from tpuflow_torch.utils.timing import Timer


@dataclasses.dataclass
class LevelTrace:
    """One pyramid level's record of ``compute_flow(..., collect_trace=True)``:
    its index, size and seconds (resample and level step)."""

    level: int
    width: int
    height: int
    seconds: float


@dataclasses.dataclass
class FlowResult:
    """Final flow in original-pixel units, on the host (numpy): (H, W), or
    (B, H, W) for a stack. ``seconds`` covers upload, the solve and the
    download; ``levels`` holds the per-level records when a trace was asked
    for. ``pairs`` names the stack indices of a stack's flows where they are
    only some of them (this process's pairs on a mesh over processes, the
    counterpart of a global array's addressable shards); None: all."""

    u: np.ndarray
    v: np.ndarray
    seconds: float
    levels: List[LevelTrace] = dataclasses.field(default_factory=list)
    pairs: Optional[Tuple[int, ...]] = None

    @property
    def megapixels_per_second(self) -> float:
        return self.u.size / self.seconds / 1e6


@contextlib.contextmanager
def _full_float32():
    """TF32 off for matmuls and cuDNN inside; the caller's flags after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not available")
    return device


def _on(device: torch.device):
    """The CUDA device guard for ``device``; nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _frames(frame_0, frame_1, stacks: bool = False):
    f0 = np.asarray(frame_0, dtype=np.float32)
    f1 = np.asarray(frame_1, dtype=np.float32)
    if f0.shape != f1.shape or f0.ndim not in ((2, 3) if stacks else (2,)):
        want = "(H, W) frames or (B, H, W) stacks" if stacks else "(H, W) frames"
        raise ValueError(f"expected two equal {want}, got {f0.shape} {f1.shape}")
    return f0, f1


# Pinned staging buffers per frame shape and device. Each upload takes the
# next slot of its ring and first waits for the copy that last read that
# slot, so the host runs at most STAGING_SLOTS pairs ahead of the card.
STAGING_SLOTS = 3
_STAGING_SHAPES = 4
_staging: dict = {}
_staging_lock = threading.Lock()


def _upload(f0: np.ndarray, f1: np.ndarray, device: torch.device) -> torch.Tensor:
    """[f0, f1] as one (2, H, W) float32 tensor on ``device``. On the card
    the copy is asynchronous, from a pinned buffer."""
    if device.type != "cuda":
        return torch.from_numpy(np.stack([f0, f1])).to(device)
    key = (f0.shape, device)
    with _staging_lock:
        ring = _staging.pop(key, None)
        if ring is None:
            if len(_staging) >= _STAGING_SHAPES:
                # the oldest shape's buffers; the host allocator keeps a block
                # whose copy is still pending until that copy has completed
                _staging.pop(next(iter(_staging)))
            ring = {"slots": [[torch.empty((2, *f0.shape), dtype=torch.float32,
                                           pin_memory=True), None]
                              for _ in range(STAGING_SLOTS)], "next": 0}
        _staging[key] = ring   # the most recent shape last
        slot = ring["slots"][ring["next"]]
        ring["next"] = (ring["next"] + 1) % STAGING_SLOTS
        host, copied = slot
        if copied is not None:
            copied.synchronize()   # the card has read this slot's last frames
        staged = host.numpy()
        staged[0], staged[1] = f0, f1
        frames = torch.empty(host.shape, dtype=torch.float32, device=device)
        frames.copy_(host, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
    return frames


def _submit(f0: np.ndarray, f1: np.ndarray, cfg: FlowConfig, device: torch.device,
            **solve_kw) -> torch.Tensor:
    """Upload one pair and queue its solve; (2, H, W) on ``device``. The
    caller holds the TF32 flags and the device guard."""
    frames = _upload(f0, f1, device)
    return solve(frames[0], frames[1], cfg, **solve_kw)


def compute_flow_async(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *,
                       device="cuda") -> torch.Tensor:
    """The flow of one pair as a (2, H, W) float32 tensor [u, v] on
    ``device``, returned without waiting for the card: the streaming
    building block. Submit pairs back to back and fetch once; each flow is
    bitwise ``compute_flow``'s."""
    cfg = cfg or FlowConfig()
    device = _device(device)
    f0, f1 = _frames(frame_0, frame_1)
    with _full_float32(), _on(device):
        return _submit(f0, f1, cfg, device)


def plan_parallel(shape, batched: bool, cfg: FlowConfig, mesh, data: int = 0) -> str:
    """How ``compute_flow(..., mesh=)`` spreads its work (the JAX front
    door's rule, tpuflow/solver/flow2d.py:63-96): a (B, H, W) stack
    ``"dp"``, its pairs dealt over the mesh's positions; one pair ``"sp"``
    where the cost router (``parallel.model.plan_level``) would shard its
    finest level over the ``y`` positions of data row ``data``, else
    ``"single"``."""
    from tpuflow_torch.solver.sharded import level_route

    if batched:
        return "dp"
    h, w = shape
    shardable = mesh.n_y > 1 and level_route(h, w, cfg, mesh, "auto",
                                             data=data)[0] != "replicated"
    return "sp" if shardable else "single"


def _compute_flow_dp(f0: np.ndarray, f1: np.ndarray, cfg: FlowConfig, mesh) -> FlowResult:
    """A (B, H, W) stack with pair i on position i % mesh.size, each
    submitted on its position's stream, then fetched in order."""
    with _full_float32(), Timer() as timer:
        flows = []
        for i, (a, b) in enumerate(zip(f0, f1)):
            p = i % mesh.size
            with _on(mesh.devices[p]), mesh.on(p):
                flows.append(_submit(a, b, cfg, mesh.devices[p]))
        uv = np.empty((2, *f0.shape), dtype=np.float32)
        for i, flow in enumerate(flows):
            with mesh.on(i % mesh.size):
                uv[:, i] = flow.cpu().numpy()
    return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds)


# The copy stream of each card that downloads the flows of a mesh over
# processes (``_compute_flow_processes``).
_DOWNLOAD_STREAMS: dict = {}


def _compute_flow_processes(f0: np.ndarray, f1: np.ndarray, cfg: FlowConfig,
                            mesh) -> FlowResult:
    """This process's share of a (B, H, W) stack on a mesh over processes:
    pair i goes to data row i % n_data, and this process solves its row's
    pairs in stack order, sharded over the row where the row spans several
    processes (``halo="auto"``, every process of the row at once), on one
    position otherwise. Downloads once, pinned, on a copy stream."""
    from tpuflow_torch.parallel.multihost import _copy_stream, _download
    from tpuflow_torch.solver.sharded import row_device, sharded_solve

    data = mesh.local_row()
    device = row_device(mesh, data)
    mine = tuple(i for i in range(f0.shape[0]) if i % mesh.n_data == data)
    sharded = sharded_solve(cfg, mesh, f0.shape[1:], data=data) if mesh.n_y > 1 else {}
    with _full_float32(), _on(device), Timer() as timer:
        if not mine:
            uv = np.empty((2, 0, *f0.shape[1:]), dtype=np.float32)
        else:
            flows = torch.stack([_submit(f0[i], f1[i], cfg, device, **sharded)
                                 for i in mine], dim=1)
            host, copied = _download(flows, _copy_stream(_DOWNLOAD_STREAMS, device))
            if copied is not None:
                copied.synchronize()
            uv = host.numpy()
    return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds, pairs=mine)


def compute_flow(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *,
                 collect_trace: bool = False, device="cuda", mesh=None,
                 _sharded: Optional[dict] = None) -> FlowResult:
    """Dense 2D optical flow from frame_0 to frame_1, two (H, W) frames of
    any real dtype, or two (B, H, W) stacks of independent pairs, solved in
    order (each pair's flow bitwise that of a call on the pair alone); the
    computation is float32 on ``device``.

    With a ``mesh`` (``parallel.make_mesh``) the work spreads as
    ``plan_parallel`` says: a stack's pairs over the mesh's positions, one
    stream each; one pair sharded by rows over its ``y`` positions with the
    cost router's routes (``compute_flow_sharded(..., halo="auto")``), or
    on one position. Every flow is bitwise that of a call without a mesh.
    ``device`` must be the mesh's first device.

    On a mesh over processes (``make_mesh`` inside a group of several) every
    process calls it at once with the same frames and its own card as
    ``device``. A stack's pair i goes to data row i % n_data, and each
    process returns the flows its row solved, in stack order, named by
    ``FlowResult.pairs``. One pair is solved by every data row, sharded
    over the row's processes where the router shards it, and every process
    returns the whole flow.

    ``collect_trace`` fills ``FlowResult.levels`` with one ``LevelTrace``
    per level, timed by CUDA events on the card and by the host clock on
    the CPU; the flow is the same with or without it. A stack takes no
    trace: it raises.

    It switches TF32 off for matmuls and cuDNN for the solve (any matmul
    there must be full float32, as the JAX package's are, Precision.HIGHEST;
    the presmooth and the resample are the banded kernels', which never
    rounds to TF32) and gives both process-wide flags back as the caller
    set them, also when the solve raises. ``_sharded`` is ``solve``'s
    keywords of a sharded pair (``solver.sharded.sharded_solve``), for
    ``compute_flow_sharded``.
    """
    cfg = cfg or FlowConfig()
    device = _device(device)
    f0, f1 = _frames(frame_0, frame_1, stacks=True)
    if mesh is not None:
        from tpuflow_torch.solver.sharded import row_device, sharded_solve

        data = mesh.local_row()
        if resolve_device(device) != row_device(mesh, data):
            raise ValueError(f"device {str(device)!r} is not the mesh's device, "
                             f"{row_device(mesh, data)}")
        if f0.ndim == 3 and not collect_trace:
            if mesh.spans_processes:
                return _compute_flow_processes(f0, f1, cfg, mesh)
            return _compute_flow_dp(f0, f1, cfg, mesh)
        if f0.ndim == 2 and plan_parallel(f0.shape, False, cfg, mesh, data) == "sp":
            _sharded = sharded_solve(cfg, mesh, f0.shape, data=data)
        device = row_device(mesh, data)
    if f0.ndim == 3:
        if collect_trace:
            raise ValueError("collect_trace=True traces one pair; a (B, H, W) stack "
                             "takes no trace")
        with _full_float32(), _on(device), Timer() as timer:
            flows = [_submit(a, b, cfg, device, **(_sharded or {})) for a, b in zip(f0, f1)]
            uv = torch.stack(flows, dim=1).cpu().numpy()
        return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds)
    trace = [] if collect_trace else None
    with _full_float32(), _on(device), Timer() as timer:
        uv = _submit(f0, f1, cfg, device, trace=trace, **(_sharded or {})).cpu().numpy()
    return FlowResult(u=uv[0], v=uv[1], seconds=timer.seconds,
                      levels=[LevelTrace(*t) for t in trace or ()])


def compute_flow_warp_report(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *,
                             device="cuda"):
    """The flow of one pair (numpy u, v, bitwise ``compute_flow``'s) and its
    per-level displacement report, a dict:

      tiers  -- (n_levels,) int32, coarsest level first: 0 when the
                prolongated flow moves no pixel's bilinear base by more than
                ``WARP_MAX_DISP`` level pixels in x or y, 1 within twice
                that, 2 beyond (``solver.level.warp_tier``, the JAX package's
                ``warp_small_pred``);
      levels -- (width, height) of each level;
      n_wide, n_gather -- the levels of tier 1 and of tier 2.

    On the TPU the tiers chose the warp's code path; the port's warp is one
    exact gather at any displacement, so here they say which levels saw
    motion beyond ±4 and ±8 px. They are taken on the device, level by
    level, and fetched once after the last level.
    """
    cfg = cfg or FlowConfig()
    device = _device(device)
    f0, f1 = _frames(frame_0, frame_1)
    tiers: list = []
    with _full_float32(), _on(device):
        uv = _submit(f0, f1, cfg, device, tiers=tiers).cpu().numpy()
        tier = torch.stack(tiers).cpu().numpy()
    h, w = f0.shape
    report = {"tiers": tier,
              "levels": [(s.width, s.height) for s in level_schedule(
                  w, h, cfg.warp_levels_count, cfg.warp_scale_factor)],
              "n_wide": int((tier == 1).sum()),
              "n_gather": int((tier == 2).sum())}
    return uv[0], uv[1], report


def endpoint_error(u_a, v_a, u_b, v_b) -> float:
    """Mean endpoint error between two flow fields (the parity metric)."""
    u_a, v_a = np.asarray(u_a), np.asarray(v_a)
    u_b, v_b = np.asarray(u_b), np.asarray(v_b)
    return float(np.mean(np.sqrt((u_a - u_b) ** 2 + (v_a - v_b) ** 2)))

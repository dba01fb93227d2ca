"""The row-sharded pipeline: ``compute_flow_sharded`` (the port of
``compute_flow_bucketed_sharded``, tpuflow/solver/bucketed.py:1470-1633).

The relaxation is sharded over the ``y`` positions of one data row of the
mesh; the resample, warp, derivatives, tensor and median run with the
level kernels, on the whole field on the row's first device, or, over a
suffix of sharded levels, by rows on each card (below). Each level takes
one of three relaxations:

  * ``"kernel"``: ``relax_sharded_kernel`` (csrc/sharded.cu), one launch on
    each card of the row, where its gate admits the level (over several
    cards the halos are stored through peer pointers and the cards meet at
    flag barriers);
  * ``"explicit"``: ``relax_sharded_explicit``, each shard on its
    position's device and stream, halos copied between them, where
    ``halo_applicable`` admits the level;
  * ``"replicated"``: the unsharded ``relax``, as the JAX pipeline
    replicates the buckets its gates refuse.

``halo="kernel"`` and ``"explicit"`` shard every level their gate admits at
the caller's k; ``"auto"`` takes each level's route and k from the cost
model (``parallel.model.plan_level``). Every route gives the flow of
``compute_flow``, bit for bit.

On a mesh over processes (one position a process) a data row whose
positions belong to several processes runs as follows. Each level's
relaxation is ``"replicated"``, the kernel (one launch a process,
``relax_sharded_kernel``) or the explicit route (each process its own
shard, halos and owned rows as NCCL messages between the cards,
``relax_sharded_explicit``); every route gives every process the whole T.
``"auto"`` prices the two with the row's constants (``NCCL`` for the
explicit route's messages); where processes share a card it replicates,
and ``halo="explicit"`` raises there, since NCCL refuses two ranks on one
card. The plan depends only on the shape, the config and the constants, so
every process takes the same one.

The whole-field stages (the flow's resample, warp, derivatives, tensor,
add and median) run on each process's own card. Up to the schedule's
suffix of sharded levels every process computes them over the whole
field: the same kernels on the same inputs, so the values are bitwise the
same on every card. Over the suffix each process computes only the rows
its own later steps read, halos included (``solver.bands``, the plan
``sharded_bands``), into whole-size buffers, with no message between
levels; the finest flow's owned rows then go to every process of the row
in one batch. That needs a card a process (``Mesh.p2p_ok``): where two
processes share a card NCCL refuses the batch, so there every level runs
its whole-field stages over the whole field, as a routing rule (as
``level_route`` replicates there), not a fallback. The frame pyramid is
whole on every process.

One process driving a row over several cards (``mesh.row_cards(data) >=
2``, peer access between them) does the same by lanes, one a card
(``sharded_lanes``, ``solver.bands.lane_plans``; solver/level.py steps
them), over the same suffix of sharded levels, kernel and explicit alike:
each route reads each card's own fields and gives each card its own T
(the kernel's copy-out fills every card's T; the explicit route gives
each card its own shards' owned rows and, as peer copies, the other
shards' rows that its add + median reads). Each card smooths the pair and
takes its frame pyramid itself; the finest flow's owned rows reach the
first card as peer copies. The one-process hybrid's fine part
(parallel/hybrid.py) takes the same lanes from its split on. The whole
field stays on the first card only by routing rules decided from the
plan before any launch: at the replicated levels before that suffix, and
on a row on one card.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.level import launch_counts as level_launch_counts
from tpuflow_torch.ops.level import reset_row_counts
from tpuflow_torch.ops.level import reset_launch_counts as reset_level_launch_counts
from tpuflow_torch.parallel.group import process_rank, row_exchange
from tpuflow_torch.parallel.halo import halo_applicable, relax_sharded_explicit
from tpuflow_torch.parallel.halo_kernel import kernel_halo_applicable, relax_sharded_kernel
from tpuflow_torch.parallel.mesh import Mesh, enable_peer_access, peer_copy, resolve_device
from tpuflow_torch.parallel.model import plan_level
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.bands import BandPlan, Lane, band_plan, lane_plans
from tpuflow_torch.solver.flow2d import FlowResult, compute_flow
from tpuflow_torch.solver.level import RelaxFn, relax

HALO_MODES = ("kernel", "explicit", "auto")
# The halo mode of the JAX pipeline that the port does not run.
NOT_PORTED = {"gspmd": "compiler-partitioned stencils are on ROADMAP's 'Do not port' list"}



def row_device(mesh: Mesh, data: int = 0):
    """The device of a data row's first position: where the row's
    whole-field work runs. On a mesh over processes, this process's
    position's device, where this process runs it."""
    if mesh.spans_processes:
        mine = [p for p in mesh.row(data) if p in mesh.local_positions()]
        if not mine:
            raise ValueError(f"this process holds no position of data row {data} of {mesh!r}")
        return mesh.devices[mine[0]]
    return mesh.devices[mesh.row(data)[0]]


def level_route(h: int, w: int, cfg: FlowConfig, mesh: Mesh, halo: str, k_outer: int = 1,
                data: int = 0) -> Tuple[str, int]:
    """(route, k) of an (h, w) level's relaxation over data row ``data``:
    ``"kernel"``, ``"explicit"`` or ``"replicated"``."""
    n_y, cards = mesh.n_y, mesh.row_cards(data)
    processes = mesh.row_spans_processes(data)
    if halo == "auto":
        if processes and cards < n_y:
            # Processes that share a card take turns on it by time slices, so
            # every row barrier between them waits for a slice: 6.43 s for a
            # 1080p full_model() pair's 2,754 row barriers against 0.22 s for
            # compute_flow, two processes on one H100 (PERF.md section 6).
            return "replicated", 1
        # over processes the explicit route's messages need ``mesh.p2p_ok``
        paths = ("kernel", "explicit") if mesh.p2p_ok else ("kernel",)
        path, k, _ = plan_level(h, w, cfg, n_y, paths=paths, cards=cards, processes=processes)
        return path, k
    admitted = (kernel_halo_applicable if halo == "kernel" else halo_applicable)
    return (halo if admitted(h, n_y, cfg, k_outer) else "replicated"), k_outer


def sharded_plan(w: int, h: int, cfg: FlowConfig, mesh: Mesh, halo: str = "auto",
                 k_outer: int = 1, data: int = 0) -> List[Tuple[int, int, str, int]]:
    """(height, width, route, k) of every level of a w x h pair, coarse to
    fine."""
    return [(s.height, s.width) + level_route(s.height, s.width, cfg, mesh, halo, k_outer, data)
            for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)]


def _check_halo(halo: str, k_outer: int) -> None:
    if halo in NOT_PORTED:
        raise NotImplementedError(f"halo={halo!r} is not ported: {NOT_PORTED[halo]}")
    if halo not in HALO_MODES:
        raise ValueError(f"unknown halo mode {halo!r}")
    if k_outer < 1:
        raise ValueError(f"k_outer must be at least 1, got {k_outer}")


def _route_fn(route: str, k: int, mesh: Mesh, data: int,
              reserve: Optional[Tuple[int, int]]) -> RelaxFn:
    """The relaxation of one level on ``route`` with k outer iterations a
    halo exchange."""
    if route == "kernel":
        # a row over processes sizes its arenas for the pair's finest level
        arenas = {"reserve": reserve} if mesh.row_spans_processes(data) else {}
        return functools.partial(relax_sharded_kernel, mesh=mesh, k_outer=k, data=data,
                                 **arenas)
    if route == "explicit":
        return functools.partial(relax_sharded_explicit, mesh=mesh, k_outer=k, data=data)
    return relax


def sharded_bands(w: int, h: int, cfg: FlowConfig, mesh: Mesh, halo: str = "auto",
                  k_outer: int = 1, data: int = 0,
                  plan: Optional[List[Tuple[int, int, str, int]]] = None) -> Optional[BandPlan]:
    """This process's band plan of a w x h pair on data row ``data``, whose
    levels take ``sharded_plan``'s routes (``plan``, where the caller has
    it; ``solver.bands.band_plan``): where the row's positions belong to
    several processes, each with its own card (``Mesh.p2p_ok``, which the
    finest flow's gather needs). None where the path is not taken: a row
    of one process, or processes that share a card (NCCL refuses the gather
    there; every level then runs its whole-field stages over the whole
    field), or no sharded finest level."""
    if not (mesh.row_spans_processes(data) and mesh.p2p_ok):
        return None
    if plan is None:
        plan = sharded_plan(w, h, cfg, mesh, halo, k_outer, data)
    ranks = mesh.row_ranks(data)
    return band_plan(w, h, cfg, [(route, k) for *_, route, k in plan], mesh.n_y,
                     ranks.index(process_rank()[0]), ranks)


def sharded_lanes(w: int, h: int, cfg: FlowConfig, mesh: Mesh, halo: str = "auto",
                  k_outer: int = 1, data: int = 0,
                  plan: Optional[List[Tuple[int, int, str, int]]] = None
                  ) -> Optional[Tuple[Lane, ...]]:
    """The lanes of a w x h pair on data row ``data`` of a one-process mesh
    whose row spans at least two cards: one a card (``Mesh.row_groups``
    order), its plan the hull of its shards' (``bands.lane_plans``, the
    suffix of sharded levels of ``sharded_plan``'s routes, kernel and
    explicit alike, ``plan`` where the caller has it), the first lane's
    stream the caller's, each other's that of the card's first position.
    Peer access between the cards is enabled here, and raises where a pair
    lacks it. None where the path is not taken: a row over processes
    (``sharded_bands``), a row on one card, or a replicated finest
    level."""
    if mesh.row_spans_processes(data) or mesh.row_cards(data) < 2:
        return None
    if plan is None:
        plan = sharded_plan(w, h, cfg, mesh, halo, k_outer, data)
    groups = mesh.row_groups(data)
    plans = lane_plans(w, h, cfg, [(route, k) for *_, route, k in plan], mesh.n_y,
                       [ys for _, ys in groups])
    if plans is None:
        return None
    cards = [dev for dev, _ in groups]
    if all(dev.type == "cuda" for dev in cards):
        enable_peer_access(cards)
    row = mesh.row(data)
    return tuple(Lane(p, dev, None if i == 0 else mesh.stream(row[ys[0]]))
                 for i, (p, (dev, ys)) in enumerate(zip(plans, groups)))


def sharded_solve(cfg: FlowConfig, mesh: Mesh, shape: Tuple[int, int], halo: str = "auto",
                  k_outer: int = 1, data: int = 0) -> dict:
    """``solve``'s keywords for an (h, w) pair (``shape``) over data row
    ``data`` of ``mesh``: ``relax_for`` and ``bands`` (``sharded_bands``
    over processes, ``sharded_lanes`` in one process over several cards),
    both from one ``sharded_plan``, so the band rows follow the routes that
    the levels relax on."""
    _check_halo(halo, k_outer)
    h, w = shape
    plan = sharded_plan(w, h, cfg, mesh, halo, k_outer, data)
    routes = {(lh, lw): (route, k) for lh, lw, route, k in plan}

    def relax_for(lh: int, lw: int):
        return _route_fn(*routes[(lh, lw)], mesh, data, (h, w))

    bands = (sharded_bands(w, h, cfg, mesh, halo, k_outer, data, plan)
             if mesh.row_spans_processes(data)
             else sharded_lanes(w, h, cfg, mesh, halo, k_outer, data, plan))
    return {"relax_for": relax_for, "bands": bands}


def compute_flow_sharded(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *, mesh: Mesh,
                         halo: str = "kernel", k_outer: int = 1,
                         device="cuda") -> FlowResult:
    """``compute_flow`` of one pair with the rows of every admitted level's
    relaxation sharded over the ``y`` positions of ``mesh``'s first data
    row, halos exchanged once every ``k_outer`` outers (``"auto"`` picks k
    per level). ``halo`` is ``"kernel"``, ``"explicit"`` or ``"auto"``
    (over several cards the kernel needs peer access between them, and
    raises without it; over processes the explicit route needs a card a
    process, and raises where two share one); the JAX pipeline's
    ``"gspmd"`` raises NotImplementedError. ``device`` must be the row's first device, its index
    included; ``"cuda"`` raises without CUDA. A (B, H, W) stack goes through
    ``compute_flow(..., mesh=)``. On a mesh over processes every process of
    the row calls it at once, with its own card as ``device``, and each
    gets the whole flow (module docstring)."""
    data = mesh.local_row()
    sharded = sharded_solve(cfg or FlowConfig(), mesh, np.shape(frame_0)[-2:], halo, k_outer,
                            data)
    if np.ndim(frame_0) == 3:
        raise ValueError("compute_flow_sharded solves one pair; a (B, H, W) stack goes "
                         "through compute_flow(..., mesh=), which deals its pairs over the "
                         "mesh's positions")
    home = row_device(mesh, data)
    if resolve_device(device) != home:
        raise ValueError(f"device {str(device)!r} is not the mesh's device, {home}")
    return compute_flow(frame_0, frame_1, cfg, device=home, _sharded=sharded)


def reset_launch_counts() -> None:
    """Set the launch counts of the sharded path's kernels, the rows that
    the row stages computed (``ops.level.row_counts``), the explicit
    route's copies, the rows' messages between processes and the lanes'
    peer copies (``mesh.peer_copy``) to 0."""
    reset_level_launch_counts()
    reset_row_counts()
    relax_sharded_kernel.launches = 0
    relax_sharded_explicit.copies = 0
    row_exchange.sends = 0
    peer_copy.messages = peer_copy.bytes = 0


def launch_counts() -> dict:
    """The level kernels' launch counts and ``relax_sharded``'s."""
    return {**level_launch_counts(), "relax_sharded": relax_sharded_kernel.launches}

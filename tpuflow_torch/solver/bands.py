"""The rows each card computes of a sharded level's whole-field stages.

On a data row of a mesh over processes (one position a process, each with
its own card) the relaxation of a sharded level runs on the row's routes,
and every route gives every process the whole T: the kernel's copy-out
stores each shard's owned rows into every card's T, the explicit route and
the plain twin gather the owned rows. Every process also holds the whole
frame pyramid, which it computes itself. So from the first level of the
schedule's suffix of sharded levels on, a process computes only the rows of
each whole-field stage (the flow's resample, the warp, the derivatives, the
tensor, add + median) that its own later steps read, halos included, into
buffers of the whole level's size, and needs no message between levels;
the finest level's owned rows of the flow go to every process of the row
once, at the end (``gather_rows``: one ``row_exchange`` batch, two planes
each way with every other rank).

One process driving a row over several cards does the same with a *lane*
a card (``Lane``: the card's plan, device and stream), each card's plan
the hull of its shards' rows (``lane_plans``), over the same suffix of
sharded levels, kernel and explicit alike. Both routes read each card's
own fields and give each card its own T there: the kernel's copy-out
stores every shard's owned rows into every card's T, and the explicit
route copies each shard's padded block in from its own card's fields and
gives each card its own shards' owned rows and, as peer copies, the
other shards' rows of T that its add + median reads (``LevelRows.T``).
The level driver steps the lanes level by level (solver/level.py::solve),
and the finest flow's owned rows reach the first card as peer copies
(``gather_lanes``).

``band_plan`` finds those rows backward from the finest level, whose median
rows are the process's owned rows:

  * the rows the route's relaxation reads of uv, fxyz and J (``C``): the
    owned rows for the kernel (its copy-in) and for its plain twin, the
    padded block ``[first, first + padded)`` for the explicit route;
  * J over ``C``; fxyz over ``C`` and, for the gradient tensor, the rows
    its stencil reads of fxyz (``clamp`` of each row -+ 1);
  * the warped frame over the rows the derivatives read of it (``refl``
    of each fxyz row -+ 1) and, for the log tensor, the rows its log1p
    derivatives read through the clamp and then the reflect;
  * uv over the warp's rows, ``C``, and the rows the median's windows read
    (``refl`` of each median row -+ R/2), which are also the rows of T
    that add + median reads;
  * the previous level's median rows: the coarse rows that the resample's
    Y windows read over this level's uv rows (``banded.band_span``), since
    row_split rounds each level's owned rows on its own, so a fixed pad
    could miss them.

Each reach is taken with the kernels' own ``refl`` and ``clamp`` at the
level's height, so rows at the image edges are right; a stage whose rows
fall into two ranges takes their hull, and so does a card that holds
several shards. The plan is host arithmetic, the same on every process for
its own shard. ``prior`` is the median rows of the level before the
suffix: the rows of its flow that the suffix's first level reads, which a
lane receives from the first card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.banded import band_span
from tpuflow_torch.ops.median import effective_radius
from tpuflow_torch.ops.resample import resample_band
from tpuflow_torch.ops.solver_ops import clamp, refl
from tpuflow_torch.parallel.group import row_exchange
from tpuflow_torch.parallel.halo import (
    card_copies, card_rows, halo_rows, owned_rows, padded_rows, relax_padded, relax_sharded,
    row_split,
)
from tpuflow_torch.parallel.mesh import Mesh, peer_copy
from tpuflow_torch.pyramid import level_schedule

Rows = Tuple[int, int]
# The routes whose levels are banded, over processes and by lanes.
SHARDED_ROUTES = ("kernel", "explicit")
# each row stage (``ops.level.row_counts``' names) and its field of ``LevelRows``
STAGE_ROWS = {"resample": "uv", "warp": "warp", "level_derivs": "fxyz", "level_tensor": "J",
              "add_median": "median"}


@dataclasses.dataclass(frozen=True)
class LevelRows:
    """A banded level's output rows (lo, hi) of each stage: the resampled
    flow, the warped frame, fxyz, J (the relaxation's rows of its inputs)
    and add + median; and T, the rows of the relaxation's output that add +
    median reads."""

    uv: Rows
    warp: Rows
    fxyz: Rows
    J: Rows
    median: Rows
    T: Rows


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """One process's or card's rows of every banded level of a pair: the
    levels from schedule position ``start`` to the finest, ``levels[i]`` at
    position ``start + i``. ``owned`` holds every shard's owned rows of the
    finest level; ``shard`` is this process's, or the card's shard or
    shards (a tuple: the plan is the hull of theirs). ``prior`` is the rows
    of the flow of the level before ``start`` that the plan reads (None
    where ``start`` is 0). ``ranks`` are the row's ranks, between which
    ``gather_rows`` moves the finest flow (None: no gather between
    processes). ``routes`` are the levels' (route, k), as ``levels``."""

    start: int
    levels: Tuple[LevelRows, ...]
    owned: Tuple[Rows, ...]
    shard: Union[int, Tuple[int, ...]]
    ranks: Optional[Tuple[int, ...]] = None
    prior: Optional[Rows] = None
    routes: Tuple[Tuple[str, int], ...] = ()

    @property
    def shards(self) -> Tuple[int, ...]:
        return (self.shard,) if isinstance(self.shard, int) else self.shard

    def at(self, position: int) -> Optional[LevelRows]:
        """The rows of the level at schedule ``position``; None before the
        suffix."""
        return self.levels[position - self.start] if position >= self.start else None

    def route(self, position: int) -> Tuple[str, int]:
        """The (route, k) of the banded level at schedule ``position``."""
        return self.routes[position - self.start]

    def entry(self, position: int) -> Rows:
        """The rows of the flow of the level before banded ``position`` that
        the level at ``position`` reads."""
        return self.prior if position == self.start else self.at(position - 1).median


@dataclasses.dataclass(frozen=True)
class Lane:
    """One card of a one-process row over several cards: its plan, its
    device, and the stream its stages go on (None: the caller's current
    one, the first card's)."""

    plan: BandPlan
    device: torch.device
    stream: Optional[torch.cuda.Stream] = None


def stage_rows(w: int, h: int, cfg: FlowConfig, plan: Optional[BandPlan],
               prefix: bool = True, levels: Optional[range] = None) -> dict:
    """The output rows that a w x h pair's solve computes of each row stage
    (``ops.level.row_counts``' names), summed over its levels (those of
    ``levels``, where given: a solve in parts): the plan's at its banded
    levels, every row at the others (all of them without a plan); without
    ``prefix`` none before the plan's suffix (a lane after the first
    card's, ``ops.level.row_counts(lane)``). ``solve`` resamples no flow at
    the coarsest level nor where the size stays, and takes no tensor for
    grey."""
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    out = dict.fromkeys(STAGE_ROWS, 0)
    for p, spec in enumerate(specs):
        lv = plan.at(p) if plan is not None else None
        if (lv is None and not prefix) or (levels is not None and p not in levels):
            continue
        for stage, field in STAGE_ROWS.items():
            if stage == "resample" and (not p or (specs[p - 1].width, specs[p - 1].height)
                                        == (spec.width, spec.height)):
                continue
            if stage == "level_tensor" and cfg.data_constancy == DataConstancy.GREY:
                continue
            lo, hi = getattr(lv, field) if lv is not None else (0, spec.height)
            out[stage] += hi - lo
    return out


def hull(*ranges: Rows) -> Rows:
    return min(r[0] for r in ranges), max(r[1] for r in ranges)


def reach(rows: Rows, r: int, h: int, rule: Callable) -> Rows:
    """The hull of ``rule(y + d, h)`` for y in ``rows`` and |d| <= r: the
    rows a stencil of reach r reads of a level h rows high."""
    ys = rule(np.arange(rows[0] - r, rows[1] + r), h)
    return int(ys.min()), int(ys.max()) + 1


def level_rows(h: int, median: Rows, copy_in: Rows, cfg: FlowConfig) -> LevelRows:
    """The stages' rows of an h-row level whose median rows are ``median``
    and whose relaxation reads ``copy_in`` of uv, fxyz and J (module
    docstring)."""
    constancy = cfg.data_constancy
    fxyz = copy_in
    if constancy == DataConstancy.GRADIENT:
        fxyz = hull(copy_in, reach(copy_in, 1, h, clamp))
    warp = reach(fxyz, 1, h, refl)
    if constancy == DataConstancy.LOG_DERIVATIVES:
        g = reach(copy_in, 1, h, clamp)        # the log derivatives the tensor reads
        warp = hull(warp, g, reach(g, 1, h, refl))
    T = reach(median, effective_radius(cfg.median_radius) // 2, h, refl)
    uv = hull(warp, copy_in, T)
    return LevelRows(uv=uv, warp=warp, fxyz=fxyz, J=copy_in, median=median, T=T)


def band_plan(w: int, h: int, cfg: FlowConfig, routes: Sequence[Tuple[str, int]], n_y: int,
              shard: Union[int, Sequence[int]],
              ranks: Optional[Sequence[int]] = None) -> Optional[BandPlan]:
    """Shard ``shard``'s plan (``BandPlan``; shards in a sequence: the hull
    of their rows, a card's) of a w x h pair over a row of ``n_y`` shards
    whose levels, coarse to fine, take ``routes`` ((route, k) a level,
    ``solver.sharded.sharded_plan``'s); None where the finest level is
    replicated. The banded levels are the suffix after the last replicated
    level (``SHARDED_ROUTES``). Found once for each set of arguments."""
    return _band_plan(w, h, cfg, tuple((r, k) for r, k in routes), n_y,
                      shard if isinstance(shard, int) else tuple(shard),
                      None if ranks is None else tuple(ranks))


@functools.lru_cache(maxsize=64)
def _band_plan(w: int, h: int, cfg: FlowConfig, routes: Tuple[Tuple[str, int], ...], n_y: int,
               shard: Union[int, Tuple[int, ...]],
               ranks: Optional[Tuple[int, ...]]) -> Optional[BandPlan]:
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    if len(routes) != len(specs):
        raise ValueError(f"{len(routes)} routes for the {len(specs)} levels of a {w}x{h} pair")
    start = len(specs)
    while start and routes[start - 1][0] in SHARDED_ROUTES:
        start -= 1
    if start == len(specs):
        return None
    shards = (shard,) if isinstance(shard, int) else shard
    owned = tuple((sh.row0, sh.row0 + sh.rows) for sh in row_split(h, n_y, 0))
    median = hull(*(owned[s] for s in shards))
    levels: List[LevelRows] = []
    for p in range(len(specs) - 1, start - 1, -1):
        spec, (route, k) = specs[p], routes[p]
        split = row_split(spec.height, n_y, halo_rows(cfg, k))
        copy_in = hull(*((sh.first, sh.first + sh.padded) if route == "explicit"
                         else (sh.row0, sh.row0 + sh.rows) for sh in (split[s] for s in shards)))
        lv = level_rows(spec.height, median, copy_in, cfg)
        levels.append(lv)
        if p:
            prev = specs[p - 1]
            median = lv.uv
            if (prev.width, prev.height) != (spec.width, spec.height):
                median = band_span(resample_band(prev.height, spec.height), *lv.uv)
    return BandPlan(start=start, levels=tuple(reversed(levels)), owned=owned, shard=shard,
                    ranks=ranks, prior=median if start else None, routes=routes[start:])


def lane_plans(w: int, h: int, cfg: FlowConfig, routes: Sequence[Tuple[str, int]], n_y: int,
               groups: Sequence[Sequence[int]]) -> Optional[Tuple[BandPlan, ...]]:
    """The plan of each card of a one-process row (``groups``: each card's
    shards, in ``Mesh.row_groups`` order) over the suffix of sharded
    levels, kernel and explicit alike; None where the finest level is
    replicated."""
    plans = tuple(band_plan(w, h, cfg, routes, n_y, ys[0] if len(ys) == 1 else tuple(ys))
                  for ys in groups)
    return None if plans[0] is None else plans


def gather_rows(uv: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """The finest flow (2, h, w) with every process's owned rows, in place,
    on a row over processes: this process's to every other process of the
    row, theirs into ``uv``, one ``row_exchange`` batch (a plane a
    message). One process over several cards gathers by ``gather_lanes``."""
    lo, hi = plan.owned[plan.shard]
    me = plan.ranks[plan.shard]
    sends, recvs = [], []
    for (o_lo, o_hi), r in zip(plan.owned, plan.ranks):
        if r == me:
            continue
        for c in range(2):
            sends.append((r, uv[c, lo:hi]))
            recvs.append((r, uv[c, o_lo:o_hi]))
    row_exchange(sends, recvs)
    return uv


def gather_lanes(uv: torch.Tensor, lanes: Sequence[Lane],
                 flows: Sequence[torch.Tensor]) -> torch.Tensor:
    """The finest flow (2, h, w) on the first lane's card with every
    card's owned rows, in place, on one process's row over several cards:
    each other lane's ``flows`` entry gives its shards' owned rows, a plane
    a ``peer_copy`` (on the sender's stream, fenced both ways with the
    first card's). A row over processes gathers by ``gather_rows``."""
    for lane, flow in zip(lanes[1:], flows[1:]):
        for s in lane.plan.shards:
            lo, hi = lane.plan.owned[s]
            for c in range(2):
                peer_copy(uv[c, lo:hi], flow[c, lo:hi], lanes[0].stream, lane.stream)
    return uv


def poisoned(steps, fill: float):
    """``steps`` (``solver.level.Steps``) whose banded stages write their
    rows into a new whole-size buffer of ``fill``, as does the buffer of
    the flow a lane receives: a stage that reads a row the plan left out
    changes the flow."""

    def filled(fn, shape_of):
        def call(*args, rows=None, **kw):
            if rows is not None:
                kw["out"] = torch.full(shape_of(*args), fill, dtype=torch.float32,
                                       device=args[0].device)
            return fn(*args, rows=rows, **kw)
        return call

    return steps._replace(
        resample=filled(steps.resample, lambda uv, w, h: (uv.shape[0], h, w)),
        warp=filled(steps.warp, lambda f0, *_: f0.shape),
        level_derivs=filled(steps.level_derivs, lambda f0, *_: (3, *f0.shape)),
        level_tensor=filled(steps.level_tensor, lambda f0, *_: (5, *f0.shape)),
        add_median=filled(steps.add_median, lambda T, *_: T.shape),
        buffer=lambda shape, device: torch.full(shape, fill, dtype=torch.float32,
                                                device=device))


def lane_copies(w: int, h: int, cfg: FlowConfig, plans: Sequence[BandPlan],
                start: int = 0) -> dict:
    """The peer copies (``mesh.peer_copy``) of a w x h pair's lane solve
    with ``plans`` (one a lane) from schedule position ``start`` (the
    hybrid's split; a solve of no level makes none): to each other lane the
    pair, then the entry rows of the flow before its first banded level
    (a plane a copy; none where that is level 0); at each explicit level
    the other shards' rows of T that each card reads (``halo.card_copies``,
    every lane, the first included); and from each other lane at the end
    its shards' owned rows of the finest flow (a plane a copy)."""
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    messages = nbytes = 0
    if start >= len(specs):
        return {"messages": messages, "bytes": nbytes}
    first = max(start, plans[0].start)
    for plan in plans[1:]:
        messages, nbytes = messages + 1, nbytes + 2 * h * w * 4
        if first:
            lo, hi = plan.entry(first)
            messages += 2
            nbytes += 2 * (hi - lo) * specs[first - 1].width * 4
        for s in plan.shards:
            lo, hi = plan.owned[s]
            messages, nbytes = messages + 2, nbytes + 2 * (hi - lo) * w * 4
    groups = [plan.shards for plan in plans]
    for p in range(first, len(specs)):
        route, k = plans[0].route(p)
        if route == "explicit":
            split = row_split(specs[p].height, len(plans[0].owned), halo_rows(cfg, k))
            got = card_copies(split, groups, [plan.at(p).T for plan in plans], specs[p].width)
            messages, nbytes = messages + got["messages"], nbytes + got["bytes"]
    return {"messages": messages, "bytes": nbytes}


def emulate_shard(f0: torch.Tensor, f1: torch.Tensor, cfg: FlowConfig, plan: BandPlan,
                  fill: Optional[float] = None,
                  _steps=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One process's band path in this process alone, against the whole
    solve: (the banded solve's flow, ``solve``'s). The whole solve records
    each level's uv, fxyz, J and T; the banded one's relaxation checks that
    the rows it would read (the plan's J rows) of uv, fxyz and J are
    bitwise the whole solve's, and returns the whole solve's T, as each
    route returns the whole T. Where ``fill`` is set, each banded stage
    writes its rows into a whole-size buffer of ``fill``, so a stage that
    read a row the plan left out changes the flow. The plan takes no
    gather (``ranks`` None): the banded flow holds the owned rows of
    ``plan.shard``."""
    from tpuflow_torch.solver.level import KERNEL_STEPS, relax, solve

    steps = KERNEL_STEPS if _steps is None else _steps
    if plan.ranks is not None:
        raise ValueError("an emulated shard gathers nothing: give a plan without ranks")
    recorded = []

    def record(fxyz, uv, sc, cfg, J=None):
        T = relax(fxyz, uv, sc, cfg, _steps=steps, J=J)
        recorded.append((uv, fxyz, J, T))
        return T

    whole = solve(f0, f1, cfg, steps, relax_for=lambda h, w: record)
    levels = iter(enumerate(recorded))

    def relax_for(h, w):
        p, (uv_r, fxyz_r, J_r, T) = next(levels)
        lv = plan.at(p)
        lo, hi = (0, h) if lv is None else lv.J

        def fn(fxyz, uv, sc, cfg, J=None):
            for name, got, want in (("uv", uv, uv_r), ("fxyz", fxyz, fxyz_r), ("J", J, J_r)):
                if want is not None and not torch.equal(got[:, lo:hi], want[:, lo:hi]):
                    raise AssertionError(f"level {p} ({h}x{w}): rows {lo}..{hi - 1} of "
                                         f"{name} differ from the whole solve's")
            return T.clone()
        return fn

    if fill is not None:
        steps = poisoned(steps, fill)
    banded = solve(f0, f1, cfg, steps, relax_for=relax_for, bands=plan)
    if next(levels, None) is not None:
        raise AssertionError("the banded solve did not relax every level")
    return banded, whole


def emulate_lanes(f0: torch.Tensor, f1: torch.Tensor, cfg: FlowConfig,
                  routes: Sequence[Tuple[str, int]], n_y: int,
                  groups: Optional[Sequence[Sequence[int]]] = None, fill: Optional[float] = None,
                  levels: Optional[range] = None, uv: Optional[torch.Tensor] = None,
                  smoothed: bool = False,
                  _steps=None) -> Tuple[torch.Tensor, Tuple[BandPlan, ...]]:
    """A one-process row over several cards, every lane on f0's device:
    the level driver's lanes (``solve(..., bands=lanes)``, with ``levels``,
    ``uv`` and ``smoothed`` as ``solve`` takes them: the hybrid's fine
    part), one a group of shards (``groups``, by default one shard a lane)
    over a row of ``n_y`` shards whose levels take ``routes``, with their
    plans (``lane_plans``). A kernel level of the suffix relaxes by the
    plain ``relax_sharded`` over the owned rows each lane's card would copy
    in (``halo.owned_rows``), and every lane gets its own copy of T; an
    explicit level relaxes each shard's padded block from its own lane's
    fields (``halo.padded_rows``, ``halo.relax_padded`` with the steps'
    prologue and sweeps: the plain versions on the CPU), and each lane's T
    holds only the rows the explicit route gives it (``halo.card_rows``),
    the rest ``fill`` (NaN without it), the other lanes' rows by
    ``peer_copy``; the levels before the suffix relax by ``relax``. Where
    ``fill`` is set every banded stage writes its rows into a whole-size
    buffer of ``fill`` (``poisoned``). Returns (the first lane's flow after
    the gather, the plans); each lane's rows count under its index
    (``ops.level.row_counts(lane)``)."""
    from tpuflow_torch.solver.level import KERNEL_STEPS, relax, solve

    steps = KERNEL_STEPS if _steps is None else _steps
    h, w = f0.shape
    groups = (tuple((y,) for y in range(n_y)) if groups is None
              else tuple(tuple(ys) for ys in groups))
    plans = lane_plans(w, h, cfg, routes, n_y, groups)
    if plans is None:
        raise ValueError("the finest level is replicated: no lanes")
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    positions = iter(range(len(specs)) if levels is None else levels)
    cards = [(f0.device, ys) for ys in groups]
    mesh = Mesh(n_y, f0.device)
    poison = float("nan") if fill is None else fill

    def relax_for(lh, lw):
        route, k = routes[next(positions)]

        def fn(fxyz, uv, sc, cfg, J=None, rows=None):
            if not isinstance(uv, tuple):
                return relax(fxyz, uv, sc, cfg, _steps=steps, J=J)
            halo = halo_rows(cfg, k)
            split = row_split(lh, n_y, halo)
            if route == "kernel":
                T = relax_sharded(owned_rows(fxyz, cards, split), owned_rows(uv, cards, split),
                                  sc, cfg, mesh, k,
                                  None if J is None else owned_rows(J, cards, split))
                return tuple(T.clone() for _ in uv)
            T_b = relax_padded(padded_rows(fxyz, cards, split), padded_rows(uv, cards, split),
                               None if J is None else padded_rows(J, cards, split), sc, cfg,
                               split, halo, k, lh, steps.outer_prologue, steps.jacobi_sweeps)
            Ts = []
            for (_, ys), need, mine in zip(cards, rows, uv):
                T = torch.full_like(mine, poison)
                for s, lo, hi in card_rows(split, ys, need):
                    got = T_b[s][:, lo - split[s].first:hi - split[s].first]
                    if s in ys:
                        T[:, lo:hi] = got
                    else:   # from another lane's card, as the explicit route copies it
                        for plane in range(2):
                            peer_copy(T[plane, lo:hi], got[plane])
                Ts.append(T)
            return tuple(Ts)
        return fn

    if fill is not None:
        steps = poisoned(steps, fill)
    lanes = [Lane(plan, f0.device) for plan in plans]
    return solve(f0, f1, cfg, steps, relax_for=relax_for, levels=levels, uv=uv,
                 smoothed=smoothed, bands=lanes), plans

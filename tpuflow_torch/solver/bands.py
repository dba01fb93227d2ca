"""The rows each process computes of a sharded level's whole-field stages.

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
    (``refl`` of each median row -+ R/2);
  * the previous level's median rows: the coarse rows that the resample's
    Y windows read over this level's uv rows (``banded.band_span``), since
    row_split rounds each level's owned rows on its own, so a fixed pad
    could miss them.

Each reach is taken with the kernels' own ``refl`` and ``clamp`` at the
level's height, so rows at the image edges are right; a stage whose rows
fall into two ranges takes their hull. The plan is host arithmetic, the
same on every process for its own shard.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.banded import band_span
from tpuflow_torch.ops.median import effective_radius
from tpuflow_torch.ops.resample import resample_band
from tpuflow_torch.ops.solver_ops import clamp, refl
from tpuflow_torch.parallel.group import row_exchange
from tpuflow_torch.parallel.halo import halo_rows, row_split
from tpuflow_torch.pyramid import level_schedule

Rows = Tuple[int, int]
SHARDED_ROUTES = ("kernel", "explicit")
# each row stage (``ops.level.row_counts``' names) and its field of ``LevelRows``
STAGE_ROWS = {"resample": "uv", "warp": "warp", "level_derivs": "fxyz", "level_tensor": "J",
              "add_median": "median"}


@dataclasses.dataclass(frozen=True)
class LevelRows:
    """A banded level's output rows (lo, hi) of each stage: the resampled
    flow, the warped frame, fxyz, J (the relaxation's rows of its inputs)
    and add + median."""

    uv: Rows
    warp: Rows
    fxyz: Rows
    J: Rows
    median: Rows


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """One process's rows of every banded level of a pair: the levels from
    schedule position ``start`` to the finest, ``levels[i]`` at position
    ``start + i``. ``owned`` holds every shard's owned rows of the finest
    level; ``shard`` is this process's. ``ranks`` are the row's ranks,
    between which ``gather_rows`` moves the finest flow (None: no gather,
    one process's share alone)."""

    start: int
    levels: Tuple[LevelRows, ...]
    owned: Tuple[Rows, ...]
    shard: int
    ranks: Optional[Tuple[int, ...]] = None

    def at(self, position: int) -> Optional[LevelRows]:
        """The rows of the level at schedule ``position``; None before the
        suffix."""
        return self.levels[position - self.start] if position >= self.start else None


def stage_rows(w: int, h: int, cfg: FlowConfig, plan: Optional[BandPlan]) -> dict:
    """The output rows that a w x h pair's solve computes of each row stage
    (``ops.level.row_counts``' names), summed over its levels: the plan's
    at its banded levels, every row at the others (all of them without a
    plan). ``solve`` resamples no flow at the coarsest level nor where the
    size stays, and takes no tensor for grey."""
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    out = dict.fromkeys(STAGE_ROWS, 0)
    for p, spec in enumerate(specs):
        lv = plan.at(p) if plan is not None else None
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
    r2 = effective_radius(cfg.median_radius) // 2
    uv = hull(warp, copy_in, reach(median, r2, h, refl))
    return LevelRows(uv=uv, warp=warp, fxyz=fxyz, J=copy_in, median=median)


def band_plan(w: int, h: int, cfg: FlowConfig, routes: Sequence[Tuple[str, int]], n_y: int,
              shard: int, ranks: Optional[Sequence[int]] = None) -> Optional[BandPlan]:
    """Shard ``shard``'s plan (``BandPlan``) of a w x h pair over a row of
    ``n_y`` shards whose levels, coarse to fine, take ``routes`` ((route,
    k) a level, ``solver.sharded.sharded_plan``'s); None where the finest
    level is not sharded. The banded levels are the suffix after the last
    level of any other route. Found once for each set of arguments."""
    return _band_plan(w, h, cfg, tuple((r, k) for r, k in routes), n_y, shard,
                      None if ranks is None else tuple(ranks))


@functools.lru_cache(maxsize=64)
def _band_plan(w: int, h: int, cfg: FlowConfig, routes: Tuple[Tuple[str, int], ...], n_y: int,
               shard: int, ranks: Optional[Tuple[int, ...]]) -> Optional[BandPlan]:
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    if len(routes) != len(specs):
        raise ValueError(f"{len(routes)} routes for the {len(specs)} levels of a {w}x{h} pair")
    start = len(specs)
    while start and routes[start - 1][0] in SHARDED_ROUTES:
        start -= 1
    if start == len(specs):
        return None
    owned = tuple((sh.row0, sh.row0 + sh.rows) for sh in row_split(h, n_y, 0))
    median = owned[shard]
    levels: List[LevelRows] = []
    for p in range(len(specs) - 1, start - 1, -1):
        spec, (route, k) = specs[p], routes[p]
        sh = row_split(spec.height, n_y, halo_rows(cfg, k))[shard]
        copy_in = ((sh.first, sh.first + sh.padded) if route == "explicit"
                   else (sh.row0, sh.row0 + sh.rows))
        lv = level_rows(spec.height, median, copy_in, cfg)
        levels.append(lv)
        if p:
            prev = specs[p - 1]
            median = lv.uv
            if (prev.width, prev.height) != (spec.width, spec.height):
                median = band_span(resample_band(prev.height, spec.height), *lv.uv)
    return BandPlan(start=start, levels=tuple(reversed(levels)), owned=owned, shard=shard,
                    ranks=ranks)


def gather_rows(uv: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """The finest flow (2, h, w) with every process's owned rows, in place:
    this process's to every other process of the row, theirs into ``uv``,
    one ``row_exchange`` batch (a plane a message)."""
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

    def filled(fn, shape_of):
        """``fn`` writing a banded stage's rows into a new buffer of ``fill``."""
        def call(*args, rows=None, **kw):
            if rows is not None:
                kw["out"] = torch.full(shape_of(*args), fill, dtype=torch.float32,
                                       device=args[0].device)
            return fn(*args, rows=rows, **kw)
        return call

    if fill is not None:
        steps = steps._replace(
            resample=filled(steps.resample, lambda uv, w, h: (uv.shape[0], h, w)),
            warp=filled(steps.warp, lambda f0, *_: f0.shape),
            level_derivs=filled(steps.level_derivs, lambda f0, *_: (3, *f0.shape)),
            level_tensor=filled(steps.level_tensor, lambda f0, *_: (5, *f0.shape)),
            add_median=filled(steps.add_median, lambda T, *_: T.shape))
    banded = solve(f0, f1, cfg, steps, relax_for=relax_for, bands=plan)
    if next(levels, None) is not None:
        raise AssertionError("the banded solve did not relax every level")
    return banded, whole

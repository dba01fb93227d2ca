"""One pyramid level and the coarse-to-fine loop.

The port of the bucketed engine's level step and pipeline
(tpuflow/solver/bucketed.py: ``level_constants`` :389, ``_relax_dyn`` :448,
the level steps :615/:953, ``make_pipeline_fn`` :1131) without its TPU
machinery: every level's fields are exact-size float32 tensors, so there
are no buckets, trims, ghost rows or VMEM gates, and no host
synchronisation inside the loop. A level is

    resample (flow from the previous level; the frames of every level come
    from the full-resolution smoothed pair, all taken before the loop) ->
    warp -> derivatives [-> gradient/log tensor] -> outer x (prologue + the
    inner sweeps) -> add + median

where every step after the resample is a kernel wrapper from
``tpuflow_torch.ops``. The data constancy changes only the tensor the
prologue's hoists read: grey takes the products of the grey derivatives,
gradient and log the second-order tensor of ``level_tensor``. Level 0 uses
the smoothed frames directly (oracle.py:591-595); the flow stays in
original-pixel units.

A banded solve (``solve(..., bands=)``, solver/bands.py) computes each
whole-field stage of its suffix of sharded levels over one card's rows.
Over processes that is this process's card. In one process over several
cards it is every card of the row, each a lane (``bands.Lane``) with its
own frames, pyramid, flow and stream; the levels before the suffix run on
the first card, and from the suffix's first level on the lanes are stepped
together, level by level: every lane's resample, warp, derivatives and
tensor over its rows, one relaxation call for the row on the level's
route (the kernel or the explicit route, each of which reads each card's
fields and gives each card its own T), every lane's add + median. A
lane's stages are the calls a process makes over its rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.gaussian import gaussian_smooth
from tpuflow_torch.ops.level import (
    add_median, add_median_plain, jacobi_sweep_chain, jacobi_sweeps, jacobi_sweeps_plain,
    level_derivs, level_derivs_plain, level_tensor, level_tensor_plain,
    outer_prologue, outer_prologue_plain,
)
from tpuflow_torch.ops.resample import resample, resample_levels
from tpuflow_torch.ops.solver_ops import row_lane
from tpuflow_torch.ops.warp import warp, warp_plain
from tpuflow_torch.parallel.mesh import peer_copy
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.bands import BandPlan, Lane, LevelRows, gather_lanes, gather_rows

F = np.float32


@dataclasses.dataclass(frozen=True)
class LevelScalars:
    """Host-rounded float32 level constants, rounded exactly as
    ``LevelScalars.make`` does (tpuflow/solver/bucketed.py:141-168); only
    the fields the port reads. ``hx_1``/``hy_1`` are f32(1/(2h)) rounded
    once from float64, not the float32 reciprocal of ``div2hx``: the
    gradient/log tensor multiplies by them."""

    cw: int
    ch: int
    inv_hx: np.float32
    inv_hy: np.float32
    div2hx: np.float32
    div2hy: np.float32
    div4hx: np.float32
    div4hy: np.float32
    alpha_hx2: np.float32
    alpha_hy2: np.float32
    hx_1: np.float32
    hy_1: np.float32

    @staticmethod
    def make(cw: int, ch: int, hx: float, hy: float, alpha: float) -> "LevelScalars":
        return LevelScalars(
            cw=int(cw),
            ch=int(ch),
            inv_hx=F(1.0) / F(hx),
            inv_hy=F(1.0) / F(hy),
            div2hx=F(2.0 * hx),
            div2hy=F(2.0 * hy),
            div4hx=F(4.0 * hx),
            div4hy=F(4.0 * hy),
            alpha_hx2=F(float(alpha) / (float(hx) * float(hx))),
            alpha_hy2=F(float(alpha) / (float(hy) * float(hy))),
            hx_1=F(1.0 / (2.0 * hx)),
            hy_1=F(1.0 / (2.0 * hy)),
        )


class Steps(NamedTuple):
    """The per-level step functions the driver calls."""

    warp: Callable
    level_derivs: Callable
    level_tensor: Callable
    outer_prologue: Callable
    jacobi_sweeps: Callable   # (T, uv, hoist, inner) -> T after the inner sweeps
    add_median: Callable
    resample: Callable = resample   # the flow's, to the next level's size
    # (shape, device) -> a float32 buffer of which a lane fills only some
    # rows: the flow it receives from the first card
    buffer: Callable = lambda shape, device: torch.empty(shape, dtype=torch.float32,
                                                          device=device)


# The kernel wrappers (their plain versions on CPU tensors): the main path.
KERNEL_STEPS = Steps(warp, level_derivs, level_tensor, outer_prologue, jacobi_sweeps,
                     add_median)
# The plain PyTorch versions on any device, to compare the kernels against.
PLAIN_STEPS = Steps(warp_plain, level_derivs_plain, level_tensor_plain,
                    outer_prologue_plain, jacobi_sweeps_plain, add_median_plain)
# The kernel path with one launch per sweep, the k-sweep kernel's twin: the
# same flow, bit for bit, at 5x the sweep launches.
CHAIN_STEPS = KERNEL_STEPS._replace(jacobi_sweeps=jacobi_sweep_chain)


def relax(fxyz: torch.Tensor, uv: torch.Tensor, sc: LevelScalars,
          cfg: FlowConfig, _steps: Steps = KERNEL_STEPS,
          J: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The iterate T = uv + d (2, h, w) after outer x inner relaxation from
    d = 0; ``T - uv`` is the (du, dv) the TPU relaxation kernels return.
    ``J`` is the gradient/log tensor (None for grey), their ``tensor=``."""
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    T = uv.clone()
    for _ in range(cfg.outer_iterations_count):
        hoist = _steps.outer_prologue(T, uv, fxyz, sc.div2hx, sc.div2hy,
                                      sc.alpha_hx2, sc.alpha_hy2, e_s2, e_d2, J)
        T = _steps.jacobi_sweeps(T, uv, hoist, cfg.inner_iterations_count)
    return T


# A level's relaxation: (fxyz, uv, sc, cfg, J=...) -> T, as ``relax``
# computes it (the ``relax_fn=`` of bucketed_level_step, bucketed.py:1595-1603).
RelaxFn = Callable[..., torch.Tensor]


def _stage(rows: Optional[LevelRows], name: str) -> dict:
    """The keywords of one stage of a banded level: its output rows; none
    for a whole level."""
    return {} if rows is None else {"rows": getattr(rows, name)}


def relax_fields(f0_l: torch.Tensor, f1_w: torch.Tensor, sc: LevelScalars, cfg: FlowConfig,
                 _steps: Steps = KERNEL_STEPS, rows: Optional[LevelRows] = None):
    """The fields of a warped level that its relaxation reads, (fxyz, J):
    the derivatives and the gradient/log tensor (None for grey), each over
    its ``rows`` where given."""
    fxyz = _steps.level_derivs(f0_l, f1_w, sc.div4hx, sc.div4hy, **_stage(rows, "fxyz"))
    J = None
    if cfg.data_constancy != DataConstancy.GREY:
        J = _steps.level_tensor(f0_l, f1_w, fxyz, sc,
                                cfg.data_constancy == DataConstancy.LOG_DERIVATIVES,
                                **_stage(rows, "J"))
    return fxyz, J


def level_tail(f0_l: torch.Tensor, f1_w: torch.Tensor, uv: torch.Tensor,
               sc: LevelScalars, cfg: FlowConfig, _steps: Steps = KERNEL_STEPS,
               relax_fn: Optional[RelaxFn] = None,
               rows: Optional[LevelRows] = None) -> torch.Tensor:
    """Derivatives + relaxation + add + median on an already warped level
    (what ``level_fused`` computes); returns the level's flow (2, h, w).
    ``relax_fn`` is the relaxation, by default ``relax`` with ``_steps``.
    ``rows`` (a ``solver.bands.LevelRows``) computes each stage over its
    rows alone."""
    fxyz, J = relax_fields(f0_l, f1_w, sc, cfg, _steps, rows)
    T = (relax_fn or functools.partial(relax, _steps=_steps))(fxyz, uv, sc, cfg, J=J)
    return _steps.add_median(T, uv, cfg.median_radius, **_stage(rows, "median"))


def level_step(frames_l: torch.Tensor, uv: torch.Tensor, sc: LevelScalars,
               cfg: FlowConfig, _steps: Steps = KERNEL_STEPS,
               relax_fn: Optional[RelaxFn] = None,
               rows: Optional[LevelRows] = None) -> torch.Tensor:
    """One whole level after the resample (what ``level_fused_whole``
    computes): frames_l (2, h, w) = [f0_l, f1_l], uv (2, h, w) the
    prolongated flow; returns the level's flow (2, h, w). With ``rows``,
    each stage over its rows alone (``level_tail``)."""
    f1_w = _steps.warp(frames_l[0], frames_l[1], uv, sc.inv_hx, sc.inv_hy,
                       **_stage(rows, "warp"))
    return level_tail(frames_l[0], f1_w, uv, sc, cfg, _steps, relax_fn, rows)


def _clock(device: torch.device):
    """A point in time on ``device``'s clock: a recorded CUDA event on the
    card, the host clock on the CPU (whose ops run synchronously)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(start, end) -> float:
    """Seconds between two points of ``_clock``."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) * 1e-3


# The displacement window of the TPU warp's fast path, in level pixels
# (tpuflow/solver/bucketed.py:179, the default of TPUFLOW_WARP_DISP).
WARP_MAX_DISP = 4


def warp_tier(uv: torch.Tensor, inv_hx: float, inv_hy: float,
              disp: int = WARP_MAX_DISP) -> torch.Tensor:
    """The displacement class of a level's prolongated flow ``uv`` (2, h, w)
    as a 0-dim int32 tensor on its device, computed there: 0 when no pixel's
    bilinear base ``floor(x + u inv_hx) - x`` (and in y) moves by more than
    ``disp``, 1 within ``2 disp``, else 2. A target outside the level or NaN
    counts as 0, as in the warp, which copies f0 there. The tiers of
    ``warp_small_pred`` and ``_warp_coords`` (tpuflow/solver/bucketed.py:182-233)."""
    h, w = uv.shape[-2:]
    xs = torch.arange(w, dtype=torch.float32, device=uv.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=uv.device)[:, None]
    x_f = xs + uv[0] * inv_hx
    y_f = ys + uv[1] * inv_hy
    invalid = ((x_f < 0.0) | (x_f > w - 1) | (y_f < 0.0) | (y_f > h - 1)
               | torch.isnan(x_f) | torch.isnan(y_f))
    zero = torch.zeros((), dtype=torch.float32, device=uv.device)
    dxq = torch.where(invalid, zero, torch.floor(x_f) - xs)
    dyq = torch.where(invalid, zero, torch.floor(y_f) - ys)
    most = torch.maximum(dxq.abs().amax(), dyq.abs().amax())
    return (most > disp).int() + (most > 2 * disp).int()


def smooth_pair(f0: torch.Tensor, f1: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """The presmoothed pair (2, h, w) that every level resamples."""
    return gaussian_smooth(torch.stack([f0, f1]), cfg.gaussian_sigma)


@dataclasses.dataclass
class _LaneRun:
    """A lane during one solve: its card's smoothed pair, frame pyramid and
    flow, and its index (the lane its stages' rows count under)."""

    lane: Lane
    index: int
    frames: torch.Tensor
    pyramid: dict
    uv: Optional[torch.Tensor] = None

    def on(self) -> contextlib.ExitStack:
        """The lane's device and stream as the current ones, its rows
        counted under its index."""
        stack = contextlib.ExitStack()
        if self.lane.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.lane.device))
            if self.lane.stream is not None:
                stack.enter_context(torch.cuda.stream(self.lane.stream))
        stack.enter_context(row_lane(self.index))
        return stack

    def frames_at(self, spec) -> torch.Tensor:
        """The frames of level ``spec``."""
        if spec.level == 0:
            return self.frames
        return self.pyramid.get((spec.width, spec.height), self.frames)


def _pyramid_sizes(specs, size) -> tuple:
    """Each distinct size of ``specs`` but level 0's and the pair's own."""
    return tuple(dict.fromkeys((s.width, s.height) for s in specs
                               if s.level != 0 and (s.width, s.height) != size))


def _as_lanes(bands: Union[BandPlan, Sequence[Lane]], device: torch.device) -> List[Lane]:
    """``solve``'s ``bands`` as lanes, the first on ``device`` with the
    caller's current stream."""
    lanes = [Lane(bands, device)] if isinstance(bands, BandPlan) else list(bands)
    if lanes[0].device != device:
        raise ValueError(f"the first lane is on {lanes[0].device}, the frames on {device}")
    if device.type == "cuda":
        lanes[0] = dataclasses.replace(lanes[0], stream=torch.cuda.current_stream(device))
    return lanes


def _lane_runs(lanes: List[Lane], run0: _LaneRun, pair: torch.Tensor, smoothed: bool,
               cfg: FlowConfig, specs, size) -> List[_LaneRun]:
    """Every lane after the first, with the pair peer-copied from the first
    card, its own presmooth and its own frame pyramid of ``specs``."""
    sizes = _pyramid_sizes(specs, size)
    runs = [run0]
    for i, lane in enumerate(lanes[1:], 1):
        run = _LaneRun(lane, i, None, {})
        with run.on():
            raw = torch.empty(pair.shape, dtype=torch.float32, device=lane.device)
        peer_copy(raw, pair, lane.stream, lanes[0].stream)
        with run.on():
            run.frames = raw if smoothed else gaussian_smooth(raw, cfg.gaussian_sigma)
            run.pyramid = dict(zip(sizes, resample_levels(run.frames, sizes)))
        runs.append(run)
    return runs


def _hand_over(runs: List[_LaneRun], position: int, _steps: Steps) -> None:
    """Each other lane receives the rows of the first card's flow (the
    level before ``position``'s) that its plan reads there, a plane a
    ``peer_copy``, into a whole-size buffer."""
    uv = runs[0].uv
    for run in runs[1:]:
        lo, hi = run.lane.plan.entry(position)
        with run.on():
            run.uv = _steps.buffer(tuple(uv.shape), run.lane.device)
        for c in range(2):
            peer_copy(run.uv[c, lo:hi], uv[c, lo:hi], run.lane.stream, runs[0].lane.stream)


def _lanes_level(runs: List[_LaneRun], position: int, spec, sc: LevelScalars,
                 cfg: FlowConfig, _steps: Steps, relax_fn: Optional[RelaxFn]) -> None:
    """One banded level on every lane: each lane's stages up to the
    relaxation over its rows, one relaxation call for the row with every
    lane's fields (one tuple each, every lane's stream current) and the
    rows of T each lane's add + median reads (``rows``), then each lane's
    add + median over its rows."""
    if relax_fn is None:
        raise ValueError("lanes relax on the row's routes: give relax_for")
    cw, ch = spec.width, spec.height
    fields = []
    for run in runs:
        rows = run.lane.plan.at(position)
        with run.on():
            frames_l = run.frames_at(spec)
            if run.uv is None:
                run.uv = torch.zeros((2, ch, cw), dtype=torch.float32, device=run.lane.device)
            else:
                run.uv = _steps.resample(run.uv, cw, ch, **_stage(rows, "uv"))
            f1_w = _steps.warp(frames_l[0], frames_l[1], run.uv, sc.inv_hx, sc.inv_hy,
                               **_stage(rows, "warp"))
            fields.append(relax_fields(frames_l[0], f1_w, sc, cfg, _steps, rows))
    fxyz, J = zip(*fields)
    with contextlib.ExitStack() as every:
        for run in runs:
            every.enter_context(run.on())
        T = relax_fn(fxyz, tuple(run.uv for run in runs), sc, cfg,
                     J=None if J[0] is None else J,
                     rows=tuple(run.lane.plan.at(position).T for run in runs))
    for run, T_lane in zip(runs, T):
        with run.on():
            run.uv = _steps.add_median(T_lane, run.uv, cfg.median_radius,
                                       **_stage(run.lane.plan.at(position), "median"))


def solve(f0: torch.Tensor, f1: torch.Tensor, cfg: FlowConfig,
          _steps: Steps = KERNEL_STEPS, trace: Optional[list] = None,
          relax_for: Optional[Callable[[int, int], RelaxFn]] = None,
          tiers: Optional[list] = None, levels: Optional[range] = None,
          uv: Optional[torch.Tensor] = None, smoothed: bool = False,
          bands: Union[BandPlan, Sequence[Lane], None] = None) -> torch.Tensor:
    """The coarse-to-fine solve on f0's device; returns (u, v) as (2, h, w).

    ``levels`` runs only those positions of the coarse-to-fine schedule
    (``pyramid.level_schedule``), from ``uv``, the flow the level before
    the first of them returned (None from the coarsest), and returns the
    flow of the last of them at its size. With ``smoothed``, f0 and f1 are
    already ``smooth_pair``'s. A solve run in parts this way gives the
    whole solve's flow, bit for bit (the hybrid's split).

    The frames of every level in ``levels`` but level 0 (which uses the
    smoothed pair as it is) are resampled before the level loop, in one call
    of ``resample_levels`` (two launches on the card), from one read of the
    smoothed pair; each level's flow is resampled from the level before.

    With a list ``trace``, appends one ``(level, width, height, seconds)``
    per level, the resample included: the first level's seconds include the
    frame pyramid, so the levels' seconds add up to the solve. On the card
    each level is timed by CUDA events, read once after the last level, so
    the trace adds no host synchronisation inside the solve and leaves the
    flow unchanged.
    With a list ``tiers``, appends each level's ``warp_tier`` of its
    prolongated flow, a tensor on the device (no synchronisation).
    ``relax_for(h, w)`` gives each (h, w) level's relaxation (by default
    ``relax``); the sharded pipeline routes levels with it. ``_steps`` is for comparing
    the kernels with their plain versions end to end, and for the band
    path's emulations (``bands.emulate_shard``, ``bands.emulate_lanes``);
    callers leave it alone.

    ``bands`` (a ``solver.bands.BandPlan``, with the ``relax_for`` of the
    same routes) computes each level of its suffix over its rows alone, the
    flow's resample included, and the finest flow's owned rows then go to
    every process of the row (``bands.gather_rows``; with ``ranks`` None
    the flow holds this shard's owned rows alone). A sequence of
    ``bands.Lane`` (one a card of a one-process row, the first on f0's
    device) steps every lane through the suffix together (module
    docstring): each other card first gets the pair (a peer copy; with
    ``smoothed`` the smoothed pair, else it smooths it), takes its own
    frame pyramid, then at the first banded level of ``levels`` the rows of
    the first card's flow that its plan reads; ``relax_for`` gives each
    suffix level's relaxation, which takes one field tuple a lane and the
    rows of T each lane reads, and returns one T a lane; the finest flow's
    owned rows then reach the first card (``bands.gather_lanes``). A
    banded solve takes no ``tiers``, and ``levels`` must end at the finest
    level; one of no level (the hybrid's split past the finest) makes no
    lane and gathers nothing.
    """
    h0, w0 = f0.shape
    if min(h0, w0) < 4:
        raise ValueError(f"frames must be at least 4x4, got {h0}x{w0}")
    pair = torch.stack([f0, f1])
    frames = pair if smoothed else gaussian_smooth(pair, cfg.gaussian_sigma)
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    levels = range(len(specs)) if levels is None else levels
    if (uv is None) != (levels.start == 0):
        raise ValueError("a solve from the coarsest level starts from no flow; a later "
                         "level needs the flow of the level before it")
    if bands is not None and (tiers is not None or levels.stop != len(specs)):
        raise ValueError("a banded solve takes no warp tiers and ends at the finest level")
    lanes = [] if bands is None else _as_lanes(bands, f0.device)
    plan = lanes[0].plan if lanes else None
    specs = specs[levels.start:levels.stop]
    marks = [_clock(f0.device)] if trace is not None else None
    # Frames always come from the full-resolution smoothed pair (reference:
    # optical_flow_2d.cpp:283-304): every level's at once, each distinct size
    # once; level 0, and a level of the full size, use it as is.
    sizes = _pyramid_sizes(specs, (w0, h0))
    pyramid = dict(zip(sizes, resample_levels(frames, sizes)))
    runs = None
    if len(lanes) > 1 and len(levels):
        # every card but the first runs the suffix alone
        first = max(levels.start, plan.start)
        runs = _lane_runs(lanes, _LaneRun(lanes[0], 0, frames, pyramid), pair, smoothed, cfg,
                          specs[first - levels.start:], (w0, h0))
    for position, spec in enumerate(specs, levels.start):
        cw, ch = spec.width, spec.height
        sc = LevelScalars.make(cw, ch, spec.hx, spec.hy, cfg.equation_alpha)
        relax_fn = relax_for(ch, cw) if relax_for is not None else None
        if runs is not None and position >= plan.start:
            if position == first and uv is not None:
                runs[0].uv = uv
                _hand_over(runs, position, _steps)
            _lanes_level(runs, position, spec, sc, cfg, _steps, relax_fn)
            uv = runs[0].uv
        else:
            frames_l = pyramid.get((cw, ch), frames) if spec.level != 0 else frames
            rows = plan.at(position) if plan is not None else None
            if uv is None:
                uv = torch.zeros((2, ch, cw), dtype=torch.float32, device=f0.device)
            else:
                uv = _steps.resample(uv, cw, ch, **_stage(rows, "uv"))
            if tiers is not None:
                tiers.append(warp_tier(uv, sc.inv_hx, sc.inv_hy))
            uv = level_step(frames_l, uv, sc, cfg, _steps, relax_fn, rows)
        if marks is not None:
            marks.append(_clock(f0.device))
    # a solve of no level (the hybrid's fine part after a split past the finest) gathers none
    if plan is not None and len(levels) and (runs is not None or plan.ranks is not None):
        uv = (gather_lanes(uv, lanes, [run.uv for run in runs]) if runs is not None
              else gather_rows(uv, plan))
        if marks is not None:
            marks[-1] = _clock(f0.device)   # the finest level's time holds the gather
    if marks is not None:
        if f0.device.type == "cuda":
            marks[-1].synchronize()
        trace.extend((spec.level, spec.width, spec.height, _seconds(a, b))
                     for spec, a, b in zip(specs, marks, marks[1:]))
    return uv

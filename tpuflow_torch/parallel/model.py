"""The cost model of row sharding and the per-level router behind
``halo="auto"`` (the port of tpuflow/parallel/model.py:51-398).

Each level is priced on each route the gates admit, and the cheapest wins:

    replicated  t1, the level's time unsharded;
    explicit    max(t_compute, t_host) + t_comm
                t_compute = t1 * ceil(n_y / cards) * (h // n_y + 2 halo) / h
                t_host    = n_y * (relaxation launches) * launch_s
                t_comm    = the JAX model's messages (tpuflow/parallel/model.py:83-92)
    kernel      one cooperative launch on each card of the row
                (csrc/sharded.cu): the busiest card's padded rows at the
                kernel's pixel rate, its grid syncs at ONE_CARD's
                hop_latency_s each and, over several cards, its row
                barriers at ROW_BARRIER_S each and its owned rows copied
                in and out over NVLink; against the host's launches (one a
                card beside the level's other kernels).

``cards`` is how many distinct cards the shards span. With one shard a card
t_compute is the JAX model's; on one card the shards share it, so the
explicit route does the level's work and more, and never beats
replicating. One host thread issues every shard's launches, wherever they
run: t_host is that thread's pace. With ``launch_s`` = 0 and one shard a card
the explicit route's price is the JAX model's to the digit.

On a row of processes (``processes=True``, one shard a process and a card)
each process issues its own shard's launches, so t_host is one shard's, and
every process holds the level's fields: the explicit route's messages are
T's halos, one batch an exchange after the first, and the owned rows
gathered at the end, priced by ``NCCL``: ``dispatch_s`` a batch, as the
route pays it in step with its neighbours (with one neighbour or two
alike), and its bytes. ``link_params`` gives each route its constants: the
kernel keeps NVLINK's over processes.

The constants are the port's, for an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"),
measured by ``python -m tpuflow_torch.tools.report_scaling --link``
(chip_smoke.py phase 22 prints them again): ``ONE_CARD``'s on one card,
``NVLINK``'s between two of four cards of one host.
``ROW_BARRIER_S`` is the cross-card kernel's, from ``report_scaling
--link`` on two of four such cards. ``NCCL``'s, an exchange between
processes' cards, from ``report_scaling --procs 4 --link``. ``estimate_level_t1``
is anchored on the port's own per-level times on the H100 (PERF.md
sections 5 and 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.level import KMAX
from tpuflow_torch.parallel.halo import halo_applicable, halo_rows
from tpuflow_torch.parallel.halo_kernel import (
    grid_syncs, kernel_halo_applicable, row_barriers,
)
from tpuflow_torch.pyramid import level_schedule


@dataclass(frozen=True)
class ICIParams:
    """What moving a halo and driving a shard cost: the copy rate between
    shards, the device latency of one exchange step (a small copy, or one
    grid sync of the cooperative kernel), the host's time to issue one
    message (an event wait and a copy; for NCCL between processes, one
    exchange's batch as the route pays it) and one kernel launch."""

    bandwidth_bytes_s: float = 1.43e12
    hop_latency_s: float = 5.75e-6
    dispatch_s: float = 42.5e-6
    launch_s: float = 30.8e-6


# Shards on one H100: the means of two runs of ``report_scaling --link`` on
# "NVIDIA H100 80GB HBM3, 700.00 W" (a 64 MiB copy at 1.429 and 1.433 TB/s;
# a grid sync 5.89 and 5.61 us; a halo message 46.7 and 38.3 us of host
# time, a launch 31.1 and 30.6 us).
ONE_CARD = ICIParams()
# Shards on distinct H100s of one host over NVLink 4, from one run of
# ``report_scaling --link`` on four such cards: a 64 MiB copy from one card
# to the next at 357 GB/s (NVIDIA publishes 450 GB/s each way for the H100
# SXM), a halo copy 28.4 us on the device (a 2-plane halo is not contiguous,
# so torch stages it through temporaries), 83.3 us of host time a message.
NVLINK = replace(ONE_CARD, bandwidth_bytes_s=3.57e11, hop_latency_s=2.84e-5,
                 dispatch_s=8.33e-5)

# The cooperative kernel's exchange across cards: each row barrier adds
# ROW_BARRIER_S to the launch, its flag step, its second grid sync and its
# share of the push (7.82 us, one run of ``report_scaling --link`` on two of
# four H100s, PERF.md section 6). The pushes' stores cross NVLink,
# priced at NVLINK's copy rate (the in-kernel push of a 3840-wide halo took
# no measurable time over a 300-wide one). On one card a push is a store
# into the same memory and its barrier one grid sync (ONE_CARD).
ROW_BARRIER_S = 7.82e-6

# Messages between processes' H100s of one host by NCCL send/recv
# (``group.row_exchange``), from two runs of ``report_scaling --procs 4
# --link`` on four "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md section 6),
# reduced together by its ``link_summary``: ``dispatch_s`` is what one
# exchange costs the explicit route itself, the median of 180-396 us over
# rows of two and of four processes (the runs' own medians 335 and 249 us;
# no difference between one neighbour and two showed); the rate and
# latency are the line through 1 to 64 x 184,320-byte batches (the runs'
# own 210 and 224 GB/s). The router's choice over processes rests on these.
NCCL = replace(NVLINK, bandwidth_bytes_s=2.17e11, hop_latency_s=1.25e-5, dispatch_s=2.74e-4)

# Device seconds per level pixel at 40 x (1 + 5) passes: the level kernels
# unsharded (PERF.md section 6: one 4K full_model() level, 21.6 ms a level
# of 8.29 Mpx), and the cooperative kernel per padded pixel (4K level 0 on
# 4 shards, 26.6 ms for 8.43 Mpx of padded rows).
LEVEL_PX_S = 2.6e-9
KERNEL_PX_S = 3.16e-9
_PASSES = 240.0


def link_params(cards: int, path: str = "kernel", processes: bool = False) -> ICIParams:
    """The constants of ``path``'s messages between shards on ``cards``
    cards: on one card ONE_CARD's; across cards NVLINK's (the kernel's
    stores, and the explicit route's copies in one process), except the
    explicit route over processes, whose messages are NCCL's."""
    if cards == 1:
        return ONE_CARD
    return NCCL if processes and path == "explicit" else NVLINK


def _n_const_fields(cfg: FlowConfig) -> int:
    return 5 if cfg.data_constancy == DataConstancy.GREY else 10


def _passes(cfg: FlowConfig) -> float:
    return cfg.outer_iterations_count * (1 + cfg.inner_iterations_count) / _PASSES


def relax_launches(cfg: FlowConfig) -> int:
    """Launches of one unsharded relaxation: a prologue and ceil(inner /
    KMAX) k-sweeps an outer."""
    return cfg.outer_iterations_count * (1 + -(-cfg.inner_iterations_count // KMAX))


def level_launches(cfg: FlowConfig) -> int:
    """Launches of one unsharded level: the relaxation, the warp, the
    derivatives, the tensor (gradient and log), the median and four banded
    launches: the flow's resample, X then Y, and two more, though the frames
    of every level come from one pyramid a solve (two launches a solve), so
    this prices a level two launches high."""
    tensor = cfg.data_constancy != DataConstancy.GREY
    return relax_launches(cfg) + 3 + int(tensor) + 4


def level_comm_cost(h: int, w: int, cfg: FlowConfig, n_y: int, path: str, ici: ICIParams,
                    k: int = 1, cards: Optional[int] = None, processes: bool = False) -> float:
    """Seconds of halo exchange for one level on one shard (both directions
    run at once, so one direction's volume). The explicit route's messages
    are torch copies priced by ``ici``. The kernel's are stores inside the
    launch, whatever ``ici`` is: the constants' halos once, then per
    exchange the iterate's 2 planes and the barrier around the push (on one
    card ONE_CARD's rate and one grid sync; across cards, ``cards``
    defaulting to one shard a card, NVLINK's rate and two row barriers at
    ROW_BARRIER_S). The kernel's halo is not rounded to 8 rows: that served
    the TPU's tiles. Over ``processes`` the explicit route sends one batch
    an exchange after the first (T's 2 planes each way with each of up to
    two neighbours) and gathers the other shards' owned rows at the end
    (one batch with every other process): ``dispatch_s`` a batch, which
    already holds the device's latency and the wait for the neighbours."""
    outer = cfg.outer_iterations_count
    n_exchanges = -(-outer // k)
    row_bytes = halo_rows(cfg, k) * w * 4
    if path == "explicit" and processes:
        exchange = ici.dispatch_s + 2 * row_bytes / ici.bandwidth_bytes_s
        gather = ici.dispatch_s + 2 * (n_y - 1) * -(-h // n_y) * w * 4 / ici.bandwidth_bytes_s
        return (n_exchanges - 1) * exchange + gather
    if path == "explicit":
        msgs = _n_const_fields(cfg) + 2 + 2 * n_exchanges
        return msgs * (ici.dispatch_s + ici.hop_latency_s + row_bytes / ici.bandwidth_bytes_s)
    if path == "kernel":
        one_card = (n_y if cards is None else cards) == 1
        rate = (ONE_CARD if one_card else NVLINK).bandwidth_bytes_s
        barrier = ONE_CARD.hop_latency_s if one_card else 2 * ROW_BARRIER_S
        return (_n_const_fields(cfg) * row_bytes / rate
                + n_exchanges * (2 * row_bytes / rate + barrier))
    raise ValueError(path)


def kernel_level_time(h: int, w: int, cfg: FlowConfig, n_y: int, ici: ICIParams,
                      k: int = 1, cards: int = 1) -> float:
    """One level with its relaxation in one cooperative launch on each of
    ``cards`` cards: on one card its padded rows and grid syncs at ``ici``'s
    latency; across cards the busiest card's padded rows (ceil(n_y / cards)
    shards), one shard's grid syncs at ONE_CARD's latency, the row barriers
    at ROW_BARRIER_S and its owned rows' constants copied in and T copied out
    at ``ici``'s rate; on the device, against the host's launches of the
    level's other kernels and one a card."""
    halo = halo_rows(cfg, k)
    if cards == 1:
        padded = h + 2 * halo * (n_y - 1)
        device = (KERNEL_PX_S * padded * w * _passes(cfg)
                  + grid_syncs(cfg, n_y, k) * ici.hop_latency_s)
    else:
        mine = -(-n_y // cards)
        rows = mine * -(-h // n_y)
        copies = (_n_const_fields(cfg) + 2) * rows * w * 4
        device = (KERNEL_PX_S * (rows + 2 * halo * mine) * w * _passes(cfg)
                  + grid_syncs(cfg, 1, k) * ONE_CARD.hop_latency_s
                  + row_barriers(cfg, n_y, cards, k) * ROW_BARRIER_S
                  + copies / ici.bandwidth_bytes_s)
    host = (level_launches(cfg) - relax_launches(cfg) + cards) * ici.launch_s
    return max(device, host)


def level_sharded_time(t1_s: float, h: int, w: int, cfg: FlowConfig, n_y: int, path: str,
                       ici: ICIParams, k: int = 1, cards: Optional[int] = None,
                       processes: bool = False) -> Tuple[float, str]:
    """(projected seconds on n_y shards over ``cards`` cards, resolved path)
    for one level. The gates route as ``compute_flow_sharded`` does: the
    kernel where its gate holds, on one card or across cards, else the
    explicit route, else replication. Over ``processes`` one host thread
    issues each shard."""
    cards = n_y if cards is None else cards
    resolved = path
    if path == "kernel" and not kernel_halo_applicable(h, n_y, cfg, k):
        resolved = "explicit"
    if resolved == "explicit" and not halo_applicable(h, n_y, cfg, k):
        return t1_s, "replicated"
    if resolved == "kernel":
        return kernel_level_time(h, w, cfg, n_y, ici, k, cards), resolved
    halo = halo_rows(cfg, k)
    compute = t1_s * math.ceil(n_y / cards) * (h // n_y + 2 * halo) / h
    host = (1 if processes else n_y) * relax_launches(cfg) * ici.launch_s
    comm = level_comm_cost(h, w, cfg, n_y, resolved, ici, k, processes=processes)
    return max(compute, host) + comm, resolved


def project_schedule(levels: Sequence[Tuple[int, int, float]], cfg: FlowConfig, n_y: int,
                     path: str = "kernel", ici: ICIParams = ONE_CARD, k: int = 1,
                     cards: Optional[int] = None) -> dict:
    """The projected time of a [(h, w, t1_seconds), ...] schedule on one
    path at one k: totals, speedup against sum(t1), efficiency (speedup /
    n_y), levels by resolved path, and how the time splits between
    replicated levels, sharded compute and communication, with the
    efficiency the sharded levels alone would reach (``eff_if_tail_free``)."""
    t1_total = sum(t for _, _, t in levels)
    tn_total = t_repl = t_comm = t_shard = 0.0
    counts: dict = {}
    for h, w, t1 in levels:
        tn, resolved = level_sharded_time(t1, h, w, cfg, n_y, path, ici, k, cards)
        tn_total += tn
        counts[resolved] = counts.get(resolved, 0) + 1
        if resolved == "replicated":
            t_repl += tn
        else:
            c = level_comm_cost(h, w, cfg, n_y, resolved, ici, k, cards)
            t_comm += c
            t_shard += tn - c
    speedup = t1_total / tn_total if tn_total else float("inf")
    tail_free = tn_total - t_repl
    eff_tail_free = (t1_total - t_repl) / tail_free / n_y if tail_free else float("inf")
    return {
        "n_y": n_y,
        "path": path,
        "k": k,
        "t1_ms": round(t1_total * 1e3, 3),
        "tn_ms": round(tn_total * 1e3, 3),
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_y, 3),
        "levels": counts,
        "tn_replicated_ms": round(t_repl * 1e3, 3),
        "tn_comm_ms": round(t_comm * 1e3, 3),
        "tn_sharded_compute_ms": round(t_shard * 1e3, 3),
        "eff_if_tail_free": round(eff_tail_free, 3),
    }


def estimate_level_t1(h: int, w: int, cfg: FlowConfig, ici: ICIParams = ONE_CARD) -> float:
    """One level's seconds unsharded on the H100: its device work, or the
    host's pace of its launches where that is longer (every level below
    about 0.6 Mpx at the default schedule, PERF.md section 7)."""
    return max(LEVEL_PX_S * h * w * _passes(cfg), level_launches(cfg) * ici.launch_s)


_PLAN_KS = (1, 2, 4, 5, 8, 10, 20, 40)


def plan_level(h: int, w: int, cfg: FlowConfig, n_y: int, ici: Optional[ICIParams] = None,
               t1: Optional[float] = None, paths: Sequence[str] = ("kernel", "explicit"),
               ks: Sequence[int] = _PLAN_KS, cards: Optional[int] = None,
               processes: bool = False) -> Tuple[str, int, float]:
    """The cheapest (path, k, projected seconds) for one level: replicate,
    or each admitted path at each k, priced with ``ici`` or, by default,
    with each path's own constants (``link_params``)."""
    links = {p: ici or link_params(n_y if cards is None else cards, p, processes)
             for p in paths}
    t1 = estimate_level_t1(h, w, cfg, ici or ONE_CARD) if t1 is None else t1
    best = (t1, "replicated", 1)
    for path in paths:
        for k in ks:
            tt, resolved = level_sharded_time(t1, h, w, cfg, n_y, path, links[path], k, cards,
                                              processes)
            if resolved == path and tt < best[0]:
                best = (tt, path, k)
    return best[1], best[2], best[0]


def project_schedule_auto(levels: Sequence[Tuple[int, int, float]], cfg: FlowConfig, n_y: int,
                          ici: ICIParams = ONE_CARD,
                          paths: Sequence[str] = ("kernel", "explicit"),
                          cards: Optional[int] = None) -> dict:
    """``project_schedule`` with the router's (path, k) at every level, and
    the plan by level."""
    t1_total = sum(t for _, _, t in levels)
    tn_total = t_repl = 0.0
    counts: dict = {}
    plan: dict = {}
    for li, (h, w, t1) in enumerate(levels):
        path, k, tt = plan_level(h, w, cfg, n_y, ici, t1, paths, cards=cards)
        tn_total += tt
        counts[path] = counts.get(path, 0) + 1
        plan[f"L{li}:{h}x{w}"] = f"{path}@k={k}" if path != "replicated" else path
        if path == "replicated":
            t_repl += tt
    speedup = t1_total / tn_total if tn_total else float("inf")
    tail_free = tn_total - t_repl
    return {
        "n_y": n_y,
        "path": "auto",
        "t1_ms": round(t1_total * 1e3, 3),
        "tn_ms": round(tn_total * 1e3, 3),
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_y, 3),
        "levels": counts,
        "tn_replicated_ms": round(t_repl * 1e3, 3),
        "eff_if_tail_free": round(
            (t1_total - t_repl) / tail_free / n_y if tail_free else float("inf"), 3),
        "plan": plan,
    }


def project_schedule_hybrid(levels: Sequence[Tuple[int, int, float]], cfg: FlowConfig,
                            n_y: int, B: Optional[int] = None, ici: ICIParams = ONE_CARD,
                            paths: Sequence[str] = ("kernel", "explicit"),
                            cards: Optional[int] = None) -> dict:
    """The dp x sp hybrid (parallel/hybrid.py) priced per pair: phase A runs
    the levels before the router's first sharded one, B pairs over n_y
    positions; each pair's working set (the smoothed pair and u, v at the
    finest level) moves to its phase-B row, which costs nothing on one
    card; phase B runs the other levels pair by pair on the router's
    routes."""
    cards = n_y if cards is None else cards
    B = n_y if B is None else B
    t1_total = sum(t for _, _, t in levels)
    plans = [plan_level(h, w, cfg, n_y, ici, t1, paths, cards=cards) for h, w, t1 in levels]
    g0 = next((i for i, (p, _, _) in enumerate(plans) if p != "replicated"), len(levels))
    phase_a = -(-B // n_y) * sum(t for _, _, t in levels[:g0])
    t_fine = sum(tt for _, _, tt in plans[g0:])
    h0, w0 = max(((h, w) for h, w, _ in levels), key=lambda s: s[0] * s[1]) if levels else (0, 0)
    reshard = 0.0 if cards == 1 else (
        ici.dispatch_s + 4 * h0 * w0 * 4 * (n_y - 1) / n_y / ici.bandwidth_bytes_s)
    per_pair = (phase_a + B * (reshard + t_fine)) / B if B else 0.0
    speedup = t1_total / per_pair if per_pair else float("inf")
    counts: dict = {}
    for p, _, _ in plans[g0:]:
        counts[p] = counts.get(p, 0) + 1
    return {
        "n_y": n_y,
        "path": "hybrid",
        "B": B,
        "split_level": g0,
        "t1_ms": round(t1_total * 1e3, 3),
        "per_pair_ms": round(per_pair * 1e3, 3),
        "phase_a_ms": round(phase_a * 1e3, 3),
        "reshard_us_per_pair": round(reshard * 1e6, 3),
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_y, 3),
        "levels_phase_b": counts,
    }


def project_sensitivity(levels: Sequence[Tuple[int, int, float]], cfg: FlowConfig, n_y: int,
                        scales: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
                        cards: Optional[int] = None) -> dict:
    """The router's and the hybrid's efficiency with the copy rate scaled
    down and every latency scaled up by each factor at once."""
    cards = n_y if cards is None else cards
    base = link_params(cards)
    rows = []
    for s in scales:
        ici = ICIParams(bandwidth_bytes_s=base.bandwidth_bytes_s / s,
                        hop_latency_s=base.hop_latency_s * s, dispatch_s=base.dispatch_s * s,
                        launch_s=base.launch_s * s)
        rows.append({"knob_scale": s,
                     "eff_auto": project_schedule_auto(levels, cfg, n_y, ici,
                                                       cards=cards)["efficiency"],
                     "eff_hybrid": project_schedule_hybrid(levels, cfg, n_y, ici=ici,
                                                           cards=cards)["efficiency"]})
    return {"n_y": n_y, "cards": cards, "sweep": rows}


def best_k(levels: Sequence[Tuple[int, int, float]], cfg: FlowConfig, n_y: int,
           path: str = "kernel", ici: ICIParams = ONE_CARD, ks: Sequence[int] = _PLAN_KS,
           cards: Optional[int] = None) -> dict:
    """The best projection over fixed k (ties go to the smallest k)."""
    best = None
    for k in ks:
        r = project_schedule(levels, cfg, n_y, path, ici, k, cards)
        if best is None or r["tn_ms"] < best["tn_ms"]:
            best = r
    return best


def rub_default_levels(w: int = 584, h: int = 388, cfg: Optional[FlowConfig] = None,
                       ici: ICIParams = ONE_CARD) -> List[Tuple[int, int, float]]:
    """[(h, w, t1 seconds)] of every level of a w x h pair, coarse to fine,
    from ``estimate_level_t1``: the schedule the report projects when no
    level was timed."""
    cfg = cfg or FlowConfig()
    return [(s.height, s.width, estimate_level_t1(s.height, s.width, cfg, ici))
            for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)]

"""Scaling report: Mpix/s at one position against N, data-parallel and
row-sharded, one JSON line (the port of tools/report_scaling.py).

    python -m tpuflow_torch.tools.report_scaling [N] [--size WxH] [--preset P]
            [--routes NAME,...] [--profile] [--turns PARENT]
        N positions (default 4) dealt over every visible card, one process,
        on a seeded textured pair (``synthetic.textured_pair``) at WxH
        (default 584x388) with the preset (a function of
        tpuflow_torch.models; default FlowConfig()):
          dp  a stack of N pairs through compute_flow(..., mesh=) against
              N single pairs, by the k-slope;
          sp  one pair through compute_flow_sharded with halo="explicit",
              "kernel" and "auto" (each flow checked bitwise against
              compute_flow), and the hybrid on N pairs.
        With one card the N positions are N streams of it: the line says
        "streams on one card", which is not scaling. ``--routes`` (for
        example ``sp_kernel``) times those alone beside one position.
        ``--profile``: for each sp route, one pair under torch.profiler:
        card 0's busy share and device ms by kernel, those of the
        whole-field kernels by name (``WHOLE_FIELD``), the peer copies'
        device ms on each card, the kernels the one host thread launched,
        and, where the package counts them, the peer copies (messages and
        bytes, ``mesh.peer_copy``) and each card's rows of each row stage
        against its lane's plan (``ops.level.row_counts(lane)``,
        ``bands.stage_rows``); beside it the host's ms to queue one pair
        (every card idle before it) and the host's µs a launch.
        ``--turns PARENT`` runs the same report in
        four processes of this file, in turns on PARENT's package (a
        checkout's root) and on the package this process imports: parent,
        this, this, parent; one line with the four reports.

    python -m tpuflow_torch.tools.report_scaling --link
        The constants of the cost model (parallel/model.py), measured on
        the card: the host's time to issue one halo message (an event wait
        and a copy) and one kernel launch, the device's time for one grid
        sync of the cooperative kernel and for one small copy, and the copy
        rate between two blocks on one card; with several cards also the
        same between two cards, the peer-access matrix, and the sharded
        kernel's exchange across two cards timed in the kernel: what one
        row barrier adds to a launch, and what a wider peer-store push adds.

    python -m tpuflow_torch.tools.report_scaling --procs N [--size WxH]
            [--preset P] [--profile] [--routes NAME,...]
        The same over N processes, one a card (cuda:rank modulo the
        cards), joined by ``initialize_distributed``: dp (a stack of N pairs
        on an (N, 1) mesh over the processes, one pair each), sp (one pair
        on the row (1, N) over the processes, halo "kernel", "explicit" at
        k = 1, its halos and owned rows sent by NCCL, and "auto") and the
        hybrid (the stack of N pairs on the row, each pair's working set
        sent to it by NCCL) by the k-slope, in turns with one position in
        one process and with the one-process routes over the same cards
        (rank 0 drives them while the others wait), every flow checked
        bitwise against compute_flow;
        the level-0 launch of the sharded kernel (grey, k = 1) over the
        processes against the one-process launch over the same cards, beside
        its bound (roofline.kernel_work(..., cards=N)); with an even N the
        row barrier between two processes, timed in the kernel as --link
        times it between two cards; with --profile, card 0's busy share and
        the host's launches a pair on the kernel route, in one process and
        over the processes, and on the explicit route (k = 1) over the
        processes, with card 0's device ms by kernel, those of the
        whole-field kernels by name (the warp, the derivatives, the tensor,
        add + median, the banded X and Y passes: ``WHOLE_FIELD``) and of
        NCCL's kernels (on the kernel route: the finest flow's gather),
        the gather's bytes on card 0 and, where the package counts them,
        the rows each row stage computed on rank 0 against the whole
        field's. The preset is a function of tpuflow_torch.models
        (default reference_default). Prints rank 0's line with every rank's
        bitwise checks. ``--routes`` (for example ``sp_kernel``) checks,
        profiles and times those routes alone beside ``one``, and leaves
        out the level-0 launch and the row barrier. The workers run this file and import the package
        that this process imported, so ``PYTHONPATH=CHECKOUT python
        PATH/report_scaling.py --procs N ...`` times another checkout's
        package with the same report (as tools/banded_turns.py does).

    python -m tpuflow_torch.tools.report_scaling --procs N --link
        The constants of ``parallel.model.NCCL``, over N processes one a
        card (N even): ranks 2i and 2i + 1 exchange one halo message each
        way (``group.row_exchange``, one batch) of 1, 2, 3, 4, 16 and 64 x
        184,320 bytes (a 6-row, 3840-wide, 2-plane halo): the host's time to
        issue one (while the card sleeps), its device time (a run of them
        queued behind a sleep, timed by CUDA events), bytes over device
        time, and the line through every rank's device times: its intercept
        (the latency) and the inverse of its slope (the rate); the host's
        time for a batch of two messages each way (one a plane, as the
        explicit route sends them); and what one exchange costs the
        explicit route itself (a 1920x1080 grey level at k = 1 less k = 2)
        on rows of two and (N >= 4) on the row of all N, whose middle
        processes have two neighbours: their median is the model's
        ``dispatch_s``.

    python -m tpuflow_torch.tools.report_scaling --project [W H]
        No card needed: the cost model's table for the default schedule at
        584x388 and 1920x1080 (or W x H), with the shards on one card and
        on one card each, at 2, 4 and 8 shards.

The measuring modes need CUDA and raise without it.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List

SIZE = (584, 388)
POSITIONS = 4


def time_best(fn: Callable, reps: int = 4, k: int = 8) -> float:
    """Seconds per call by the k-slope of chains of k/4 and k calls, in
    alternating order, the median of ``reps`` of each: what a fence or a
    download at the end of a chain costs drops out. ``fn`` must finish its
    work before it returns (compute_flow does)."""
    if k < 2:
        raise ValueError(f"the k-slope needs two chain lengths, k={k}")
    k_lo, k_hi = max(1, k // 4), k
    ts = {k_lo: [], k_hi: []}
    for r in range(reps):
        for kk in ((k_lo, k_hi) if r % 2 == 0 else (k_hi, k_lo)):
            t0 = time.perf_counter()
            for _ in range(kk):
                fn()
            ts[kk].append(time.perf_counter() - t0)
    med = {kk: sorted(v)[len(v) // 2] for kk, v in ts.items()}
    return (med[k_hi] - med[k_lo]) / (k_hi - k_lo)


def _cuda_devices() -> List:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the scaling report times CUDA cards, and none is available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def measure_link(device="cuda", messages: int = 256, sleep_cycles: int = 200_000_000) -> dict:
    """The cost model's constants on one card (see the module docstring).
    The host's times are taken while the card sleeps, so no call waits for
    it: host seconds over ``messages`` calls."""
    import torch

    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import outer_prologue
    from tpuflow_torch.parallel import make_mesh, relax_sharded_kernel
    from tpuflow_torch.parallel.halo import _copy, _event
    from tpuflow_torch.parallel.halo_kernel import grid_syncs
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.tools.roofline import cuda_ms, device_info, graph_ms

    _cuda_devices()
    dev = torch.device(device)
    cfg = FlowConfig()
    with torch.cuda.device(dev):
        dev = torch.device("cuda", torch.cuda.current_device())
        src, dst = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        w, halo = 1920, 6
        a = torch.rand((2, 540, w), device=dev)
        b = torch.rand((2, 540, w), device=dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        src.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        for _ in range(messages):
            _copy(b[:, :halo], a[:, -halo:], dst, src, _event(src))
        dispatch_s = (time.perf_counter() - t0) / messages
        torch.cuda.synchronize()
        small_copy_ms = graph_ms(lambda: b[:, :halo].copy_(a[:, -halo:]), calls=50, replays=5)
        big_a = torch.empty((64 << 20) // 4, device=dev)
        big_b = torch.empty_like(big_a)
        copy_ms = graph_ms(lambda: big_b.copy_(big_a), calls=5, replays=5)
        T = torch.rand((2, 64, 72), device=dev)
        uv, fxyz = torch.rand_like(T), torch.rand((3, 64, 72), device=dev)
        outer_prologue(T, uv, fxyz, 2.0, 2.0, 35.0, 35.0, 1e-6, 1e-6)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        for _ in range(messages):
            outer_prologue(T, uv, fxyz, 2.0, 2.0, 35.0, 35.0, 1e-6, 1e-6)
        launch_s = (time.perf_counter() - t0) / messages
        torch.cuda.synchronize()
        sc = LevelScalars.make(300, 64, 1.0, 1.0, cfg.equation_alpha)
        T = torch.rand((2, 64, 300), device=dev)
        fxyz = torch.rand((3, 64, 300), device=dev)
        mesh = make_mesh(1, dev)
        sync_ms = cuda_ms(lambda: relax_sharded_kernel(fxyz, T, sc, cfg, mesh), 5)
    out = {"card": device_info()["nvidia_smi"], "device": str(dev),
           "dispatch_s": dispatch_s, "launch_s": launch_s,
           "hop_latency_s": sync_ms * 1e-3 / grid_syncs(cfg, 1),
           "small_copy_s": small_copy_ms * 1e-3,
           "bandwidth_bytes_s": big_a.numel() * 4 / (copy_ms * 1e-3)}
    if torch.cuda.device_count() > 1:
        out.update(_peer_link(dev, a, big_a, halo, messages, sleep_cycles))
        out.update(_kernel_link(dev, out["peer"]))
    return {**out,
            "how": {"dispatch_s": f"host s per _copy of a {halo}-row, {w}-wide, 2-plane halo "
                                  "between two streams (event, wait, copy, record_stream)",
                    "launch_s": "host s per outer_prologue launch on a 64x72 level",
                    "hop_latency_s": "device s per grid sync: relax_sharded_kernel on a "
                                     "64x300 level, one shard, 40 x 5, over its grid syncs",
                    "small_copy_s": "device s of that halo copy (CUDA-graph replay)",
                    "bandwidth_bytes_s": "bytes of a 64 MiB copy on the card over its "
                                         "device s (CUDA-graph replay)",
                    "peer_*": "the same between this card and the next, where there are "
                              "several: the message from a stream of this card to one of "
                              "the next, the copy timed by CUDA events over 10 copies",
                    "row_barrier_s": KERNEL_LINK_HOW["row_barrier_s"],
                    "kernel_push_s": KERNEL_LINK_HOW["kernel_push_s"]}}


def _peer_link(dev, a, big_a, halo: int, messages: int, sleep_cycles: int) -> dict:
    """The halo message, the small copy and the 64 MiB copy from ``dev`` to
    the next card."""
    import torch

    from tpuflow_torch.parallel.halo import _copy, _event
    from tpuflow_torch.tools.roofline import cuda_ms

    peer = torch.device("cuda", (dev.index + 1) % torch.cuda.device_count())
    with torch.cuda.device(dev):
        src, dst = torch.cuda.Stream(dev), torch.cuda.Stream(peer)
        b = torch.empty_like(a, device=peer)
        big_b = torch.empty_like(big_a, device=peer)
        b[:, :halo].copy_(a[:, -halo:])
        torch.cuda.synchronize(dev)
        torch.cuda.synchronize(peer)
        torch.cuda._sleep(sleep_cycles)
        src.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        for _ in range(messages):
            _copy(b[:, :halo], a[:, -halo:], dst, src, _event(src))
        dispatch_s = (time.perf_counter() - t0) / messages
        torch.cuda.synchronize(dev)
        torch.cuda.synchronize(peer)
        # a copy between cards runs on the source card's current stream,
        # where these events are recorded
        small_ms = cuda_ms(lambda: b[:, :halo].copy_(a[:, -halo:]), 50)
        copy_ms = cuda_ms(lambda: big_b.copy_(big_a), 10)
    return {"peer": str(peer), "peer_access": torch.cuda.can_device_access_peer(dev, peer),
            "peer_dispatch_s": dispatch_s, "peer_small_copy_s": small_ms * 1e-3,
            "peer_bandwidth_bytes_s": big_a.numel() * 4 / (copy_ms * 1e-3)}


KERNEL_LINK_WIDTHS = (300, 3840)
KERNEL_LINK_HOW = {
    "row_barrier_s": "device s a row barrier adds: relax_sharded_kernel (grey, inner 5) on a "
                     "64-row, 300-wide level over two shards on two cards, less one shard's "
                     "launch of the same 38 padded rows on one card, at 40 and at 20 outers; "
                     "the slope per exchange (2 row barriers, a 2-plane 6-row push, 3 grid "
                     "syncs) over 2",
    "kernel_push_s": "device s a 3840-wide push adds over a 300-wide one: the same slope "
                     "per exchange at both widths, differenced (kernel_push_bytes more)"}


def _kernel_link(dev, peer, reps: int = 5) -> dict:
    """The sharded kernel's exchange between ``dev`` and ``peer``, timed in
    the kernel (KERNEL_LINK_HOW), and the peer-access matrix."""
    import dataclasses

    import torch

    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.parallel import make_mesh, relax_sharded_kernel
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.tools.roofline import cuda_ms

    peer = torch.device(peer)
    n = torch.cuda.device_count()
    matrix = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
              for i in range(n)]
    base = FlowConfig()
    per_exchange = {}
    with torch.cuda.device(dev):
        two, one = make_mesh(2, [dev, peer]), make_mesh(1, dev)
        for w in KERNEL_LINK_WIDTHS:
            sc = LevelScalars.make(w, 64, 1.0, 1.0, base.equation_alpha)
            T = torch.rand((2, 64, w), device=dev)
            fxyz = torch.rand((3, 64, w), device=dev)
            T1, fxyz1 = T[:, :38].contiguous(), fxyz[:, :38].contiguous()
            sc1 = LevelScalars.make(w, 38, 1.0, 1.0, base.equation_alpha)
            delta = {}
            for outer in (40, 20):
                cfg = dataclasses.replace(base, outer_iterations_count=outer)
                delta[outer] = (
                    cuda_ms(lambda c=cfg: relax_sharded_kernel(fxyz, T, sc, c, two), reps)
                    - cuda_ms(lambda c=cfg: relax_sharded_kernel(fxyz1, T1, sc1, c, one), reps))
            per_exchange[w] = (delta[40] - delta[20]) / 20 * 1e-3
    lo, hi = KERNEL_LINK_WIDTHS
    push_bytes = 2 * 6 * (hi - lo) * 4
    push_s = per_exchange[hi] - per_exchange[lo]
    return {"peer_access_matrix": matrix, "row_barrier_s": per_exchange[lo] / 2,
            "kernel_exchange_s": {str(w): t for w, t in per_exchange.items()},
            "kernel_push_s": push_s, "kernel_push_bytes": push_bytes,
            "kernel_push_bytes_s": push_bytes / push_s if push_s > 0 else None}


def measure(n: int = POSITIONS, size=SIZE, reps: int = 4, k: int = 4,
            preset: str = None, profile: bool = False, routes=None) -> dict:
    """Mpix/s at one position and at ``n``, dp and sp (module docstring)."""
    import numpy as np

    from tpuflow_torch import (
        FlowConfig, compute_flow, compute_flow_async, compute_flow_hybrid,
        compute_flow_sharded, make_mesh, models,
    )
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import device_info

    cards = _cuda_devices()
    devices = [cards[i % len(cards)] for i in range(n)]
    distinct = len(set(devices))
    w, h = size
    mpix = w * h / 1e6
    cfg = FlowConfig() if preset is None else getattr(models, preset)()
    f0, f1 = textured_pair(w, h)
    home = devices[0]

    def one():
        return compute_flow_async(f0, f1, cfg, device=home).cpu()

    one()
    t1 = time_best(one, reps, k)
    report = {"card": device_info()["nvidia_smi"], "size": [w, h], "positions": n,
              "distinct_cards": distinct, "preset": preset or "FlowConfig()",
              "kind": "streams on one card" if distinct == 1 else f"scaling over {distinct} cards",
              "mpix_s_1": mpix / t1, "ms_1": t1 * 1e3}
    if n < 2:
        return report
    F0, F1 = np.stack([f0] * n), np.stack([f1] * n)
    dp = make_mesh((n, 1), devices)
    runs = {"dp": lambda: compute_flow(F0, F1, cfg, mesh=dp, device=home)}
    sp = make_mesh(n, devices)
    for halo in ("explicit", "kernel", "auto"):
        runs[f"sp_{halo}"] = (lambda hl=halo: compute_flow_sharded(
            f0, f1, cfg, mesh=sp, halo=hl, device=home))
    runs["hybrid"] = lambda: compute_flow_hybrid(F0, F1, cfg, mesh=sp, device=home)
    if routes:
        runs = {name: fn for name, fn in runs.items() if name in routes}
    base = compute_flow(f0, f1, cfg, device=home)
    for name, fn in runs.items():
        res = fn()
        if name.startswith("sp_"):
            report[f"{name}_bitwise"] = (res.u.tobytes() == base.u.tobytes()
                                         and res.v.tobytes() == base.v.tobytes())
        if profile and name.startswith("sp_"):
            report[f"{name}_profile"] = _profiled_lanes(fn, home, sp, cfg, w, h, name[3:])
            report[f"{name}_host"] = _issue(f0, f1, cfg, sp, name[3:], home,
                                            report[f"{name}_profile"]["kernels_launched"])
        t = time_best(fn, reps, k)
        pairs = n if name in ("dp", "hybrid") else 1
        report[f"mpix_s_{name}"] = pairs * mpix / t
        report[f"{name}_speedup"] = pairs * t1 / t
        report[f"{name}_efficiency"] = pairs * t1 / t / n
    return report


PROC_TIMEOUT_S = 1500
PROC_ROUNDS = 2
SP_HALOS = ("kernel", "explicit", "auto")


# card 0's device time of the whole-field stages, by the demangled kernel
# names of csrc/level.cu and csrc/banded.cu, and of NCCL's kernels
WHOLE_FIELD = {"warp": "warp_kernel(", "level_derivs": "level_derivs_kernel(",
               "level_tensor": "level_tensor", "add_median": "add_median_kernel<",
               "banded_x": "banded_x_kernel<", "banded_y": "banded_y_kernel(",
               "nccl": "nccl"}


def measure_procs(n: int, size=SIZE, preset: str = "reference_default",
                  profile: bool = False, reps: int = 3, k: int = 4, routes=None) -> dict:
    """The --procs report (module docstring): N worker processes of this
    file, which import the package this process imported; any worker's
    failure raises."""
    import tpuflow_torch
    from tpuflow_torch.parallel.multihost import process_results

    _cuda_devices()
    root = os.path.dirname(os.path.dirname(os.path.abspath(tpuflow_torch.__file__)))
    os.environ["PYTHONPATH"] = os.pathsep.join([root] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    command = [sys.executable, os.path.abspath(__file__), "--proc-worker",
               f"{size[0]}x{size[1]}", preset, str(int(profile)), str(reps), str(k),
               ",".join(routes) if routes else "all"]
    reports = process_results(command, n, PROC_TIMEOUT_S)
    out = reports[0]
    out["package"] = root
    out["bitwise_by_rank"] = [r["bitwise"] for r in reports]
    out["bitwise"] = all(all(r["bitwise"].values()) for r in reports)
    out["dp_ms_by_rank"] = [r["ms"].get("dp") for r in reports]
    return out


def _profiled(fn, device) -> dict:
    """One call of ``fn`` under torch.profiler: the wall, this card's busy
    ms (every kernel, copy and set on it) and idle share, and the kernels
    this process launched on every card (the layers' ranges, which the
    profiler also puts on the device's timeline, left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from tpuflow_torch.profile_pair import LAYERS, PROFILER_OVERHEAD, _device_us

    by_name, launches, peer = {}, 0, {}
    for evt in prof.events():
        # the layers' record_function ranges show on the device's timeline too:
        # neither a launch nor busy time of their own
        if (evt.device_type != DeviceType.CUDA or evt.name in PROFILER_OVERHEAD
                or evt.name in LAYERS):
            continue
        if evt.device_index == device.index:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + _device_us(evt, True) / 1e3
        if "PtoP" in evt.name:   # a copy between two cards, on the sender's stream
            peer[evt.device_index] = peer.get(evt.device_index, 0.0) + _device_us(evt, True) / 1e3
        launches += "memcpy" not in evt.name.lower() and "memset" not in evt.name.lower()
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    whole = {key: sum(ms for name, ms in by_name.items() if pattern in name)
             for key, pattern in WHOLE_FIELD.items()}
    return {"wall_ms": wall * 1e3, "card_busy_ms": busy, "card_busy_share": busy / (wall * 1e3),
            "card_idle_share": 1.0 - busy / (wall * 1e3), "kernels_launched": launches,
            "card_ms_by_kernel_top8": top, "card_ms_whole_field": whole,
            "card_ms_whole_field_sum": sum(v for key, v in whole.items() if key != "nccl"),
            "peer_copy_ms_by_card": {f"cuda:{i}": ms for i, ms in sorted(peer.items())}}


def _profiled_lanes(fn, device, mesh, cfg, w: int, h: int, halo: str) -> dict:
    """``_profiled`` of one pair on a one-process mesh, with the peer
    copies and each card's rows where the package counts them (module
    docstring)."""
    import inspect

    from tpuflow_torch.ops import level as L
    from tpuflow_torch.parallel import mesh as M
    from tpuflow_torch.solver import sharded

    sharded.reset_launch_counts()
    if hasattr(M, "peer_copy"):
        M.peer_copy.messages = M.peer_copy.bytes = 0
    out = _profiled(fn, device)
    out["launch_counts"] = sharded.launch_counts()
    if not hasattr(M, "peer_copy") or "lane" not in inspect.signature(L.row_counts).parameters:
        out["lanes"] = "not counted by this package"
        return out
    from tpuflow_torch.solver.bands import lane_copies, stage_rows

    lanes = sharded.sharded_lanes(w, h, cfg, mesh, halo)
    out["peer_copies"] = {"messages": M.peer_copy.messages, "bytes": M.peer_copy.bytes}
    if lanes:
        out["peer_copies_expected"] = lane_copies(w, h, cfg, [lane.plan for lane in lanes])
        out["banded_levels"] = len(lanes[0].plan.levels)
        out["rows_by_card"] = [L.row_counts(i) for i in range(len(lanes))]
        out["rows_by_card_plan"] = [stage_rows(w, h, cfg, lane.plan, prefix=i == 0)
                                    for i, lane in enumerate(lanes)]
        out["rows_whole_field"] = stage_rows(w, h, cfg, None)
    return out


def _issue(f0, f1, cfg, mesh, halo: str, device, launches: int, reps: int = 5) -> dict:
    """The host's ms to queue one pair's sharded solve (the pair already on
    the card, every card idle before it), the wall to its end, and the
    host's µs a launch (over the profiled pair's ``launches``): best of
    ``reps``."""
    import numpy as np
    import torch

    from tpuflow_torch.solver.level import solve
    from tpuflow_torch.solver.sharded import sharded_solve

    frames = torch.from_numpy(np.stack([f0, f1]).astype(np.float32)).to(device)
    kw = sharded_solve(cfg, mesh, f0.shape, halo)
    issue, wall = [], []
    with torch.cuda.device(device):
        for _ in range(reps):
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            solve(frames[0], frames[1], cfg, **kw)
            t1 = time.perf_counter()
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            issue.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
    return {"issue_ms": min(issue), "issue_ms_all": issue, "wall_ms": min(wall),
            "host_us_a_launch": min(issue) * 1e3 / launches}


def measure_turns(parent: str, argv: List[str], timeout_s: int = 1500) -> dict:
    """``--turns PARENT`` (module docstring): this report, less --turns,
    from PARENT's package and this process's, in turns."""
    import subprocess

    import tpuflow_torch

    this = os.path.dirname(os.path.dirname(os.path.abspath(tpuflow_torch.__file__)))
    trees = {"parent": os.path.abspath(parent), "this": this}
    runs = []
    for tree in ("parent", "this", "this", "parent"):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([trees[tree]] + [
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        done = subprocess.run([sys.executable, os.path.abspath(__file__)] + argv, env=env,
                              capture_output=True, text=True, timeout=timeout_s)
        if done.returncode:
            raise RuntimeError(f"the report on {tree} ({trees[tree]}): {done.stderr[-4000:]}")
        runs.append({"tree": tree, "package": trees[tree],
                     **json.loads(done.stdout.strip().splitlines()[-1])})
    return {"turns": [r["tree"] for r in runs], "runs": runs}


def _proc_report(rank: int, world: int, size, preset: str, profile: bool, reps: int,
                 k: int, routes=None) -> dict:
    """One worker's measurements (measure_procs); rank 0 drives the
    one-process routes while the others wait at a barrier."""
    import dataclasses

    import numpy as np
    import torch

    from tpuflow_torch import (
        compute_flow, compute_flow_hybrid, compute_flow_sharded, make_mesh, models,
    )
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.parallel import relax_sharded_kernel
    from tpuflow_torch.parallel.group import row_barrier
    from tpuflow_torch.parallel.mesh import Mesh
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import cuda_ms, device_info, kernel_work

    everyone = list(range(world))
    dev = torch.device("cuda", torch.cuda.current_device())
    cards = [torch.device("cuda", r % torch.cuda.device_count()) for r in everyone]
    w, h = size
    mpix = w * h / 1e6
    cfg = getattr(models, preset)()
    f0, f1 = textured_pair(w, h)
    F0, F1 = np.stack([f0] * world), np.stack([f1] * world)
    base = compute_flow(f0, f1, cfg, device=dev)
    dp, row = make_mesh((world, 1)), make_mesh((1, world))
    runs = {  # name: (every process at once, fn)
        "one": (False, lambda: compute_flow(f0, f1, cfg, device=dev)),
        "dp": (True, lambda: compute_flow(F0, F1, cfg, mesh=dp, device=dev)),
        "hybrid": (True, lambda: compute_flow_hybrid(F0, F1, cfg, mesh=row, device=dev))}
    for halo in SP_HALOS:
        runs[f"sp_{halo}"] = (True, lambda hl=halo: compute_flow_sharded(
            f0, f1, cfg, mesh=row, halo=hl, device=dev))
    one_dp = one_row = None   # rank 0's one-process meshes over the same cards
    if rank == 0:
        one_dp, one_row = Mesh(1, n_data=world, devices=cards), Mesh(world, devices=cards)
        runs["dp_one_process"] = (False, lambda: compute_flow(F0, F1, cfg, mesh=one_dp,
                                                              device=dev))
        runs["hybrid_one_process"] = (False, lambda: compute_flow_hybrid(
            F0, F1, cfg, mesh=one_row, device=dev))
        for halo in SP_HALOS:
            runs[f"sp_{halo}_one_process"] = (False, lambda hl=halo: compute_flow_sharded(
                f0, f1, cfg, mesh=one_row, halo=hl, device=dev))
    names = ["one", "dp", "dp_one_process", "hybrid", "hybrid_one_process"] + [
        f"sp_{halo}{mode}" for halo in SP_HALOS for mode in ("", "_one_process")]
    if routes:
        names = [name for name in names if name == "one" or name in routes]
    bitwise, ms = {}, {name: [] for name in names}

    def each(together: bool, fn):
        """Every process waits for the others; then all of them run ``fn``,
        or rank 0 alone."""
        row_barrier(everyone)
        return fn() if together or rank == 0 else None

    profiled, rows = {}, {}
    chosen = set(names)

    def report_rows():
        """The rows each row stage computed in one kernel-route pair, where
        the package counts them (with its band plan's and the whole
        field's), and the finest flow's gather's bytes on this card."""
        from tpuflow_torch.ops import level as L
        from tpuflow_torch.parallel.halo import row_split

        owned = row_split(h, world, 0)
        mine = owned[row.row(0).index(row.local_positions()[0])].rows
        rows["gather_bytes_sent"] = 2 * mine * w * 4 * (world - 1)
        rows["gather_bytes_received"] = 2 * (h - mine) * w * 4
        if not hasattr(L, "row_counts"):
            rows["rows_per_stage"] = "not counted by this package"
            return
        from tpuflow_torch.solver.bands import stage_rows
        from tpuflow_torch.solver.sharded import sharded_bands

        L.reset_row_counts()
        each(True, runs["sp_kernel"][1])
        rows["rows_per_stage"] = L.row_counts()
        rows["rows_per_stage_plan"] = stage_rows(w, h, cfg, sharded_bands(w, h, cfg, row,
                                                                          "kernel"))
        rows["rows_per_stage_whole_field"] = stage_rows(w, h, cfg, None)

    def profile_route(name):
        together, call = runs.get(name, (False, None))
        got = each(together, lambda: _profiled(call, dev))
        if got is not None and rank == 0:
            profiled[name] = got

    # The routes over the processes first: until rank 0 drives the one-process
    # routes it holds a context on its own card alone, and a profiler in a
    # process with contexts on the other cards serialises the kernels there.
    for name in sorted(names, key=lambda nm: nm.endswith("_one_process")):
        together, call = runs.get(name, (False, None))
        res = each(together, call)
        if res is not None:
            us, vs = (res.u, res.v) if res.u.ndim == 3 else (res.u[None], res.v[None])
            bitwise[name] = all(u.tobytes() == base.u.tobytes() and v.tobytes() ==
                                base.v.tobytes() for u, v in zip(us, vs))
        if profile and name == [nm for nm in names if not nm.endswith("_one_process")][-1]:
            for route in ("sp_kernel", "sp_explicit"):
                if route in chosen:
                    profile_route(route)
            if "sp_kernel" in chosen:
                report_rows()
    for r in range(PROC_ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            together, call = runs.get(name, (False, None))
            t = each(together, lambda: time_best(call, reps, k))
            if t is not None:
                ms[name].append(t * 1e3)
    ms = {name: sorted(v)[len(v) // 2] for name, v in ms.items() if v}
    pairs = {name: world for name in ("dp", "dp_one_process", "hybrid", "hybrid_one_process")}
    report = {"card": device_info()["nvidia_smi"], "size": [w, h], "preset": preset,
              "processes": world, "distinct_cards": len(set(cards)), "devices": list(map(str, cards)),
              "timing": f"the k-slope (time_best, reps {reps}, k {k}), the median of "
                        f"{PROC_ROUNDS} rounds in turns", "ms": ms, "bitwise": bitwise}
    if "one" in ms:
        for name, t in ms.items():
            report[f"mpix_s_{name}"] = pairs.get(name, 1) * mpix / (t * 1e-3)
            report[f"{name}_speedup"] = pairs.get(name, 1) * ms["one"] / t

    if profile and "sp_kernel_one_process" in chosen:
        profile_route("sp_kernel_one_process")
    if profile:
        report["profile"], report["rows"] = profiled, rows
    if routes:
        return report

    # level 0's relaxation: one launch over the processes, and over the same
    # cards from this one process, in turns (grey, k = 1)
    grey = FlowConfig()
    sc = LevelScalars.make(w, h, 1.0, 1.0, grey.equation_alpha)
    gen = torch.Generator().manual_seed(1)
    uv = torch.randn((2, h, w), generator=gen).mul_(2.0).to(dev)
    fxyz = torch.randn((3, h, w), generator=gen).to(dev)
    level = {"processes": [], "one_process": []}
    for r in range(PROC_ROUNDS + 1):
        for name in (("processes", "one_process") if r % 2 else ("one_process", "processes")):
            mesh = row if name == "processes" else (one_row if rank == 0 else None)
            t = each(name == "processes", lambda: cuda_ms(
                lambda: relax_sharded_kernel(fxyz, uv, sc, grey, mesh), 3))
            if t is not None and r > 0:   # round 0 warms up and sizes the arenas
                level[name].append(t)
    work = kernel_work("relax_sharded", h, w, n_y=world, cards=len(set(cards)))
    report["level0"] = {"shape": [h, w], "n_y": world, "k": 1, "config": "FlowConfig()",
                        "ms": sorted(level["processes"])[len(level["processes"]) // 2],
                        "ms_all": level["processes"], **work}
    report["level0"]["share"] = work["bound_ms"] / report["level0"]["ms"]
    if level["one_process"]:
        report["level0"]["one_process_ms"] = sorted(level["one_process"])[
            len(level["one_process"]) // 2]
        report["level0"]["one_process_ms_all"] = level["one_process"]

    if world % 2 == 0:
        # a row barrier between two processes: as _kernel_link between two
        # cards, on the rows of a (world / 2, 2) mesh over the processes
        pairs_mesh, lone = make_mesh((world // 2, 2)), Mesh(1, dev)
        data = pairs_mesh.local_row()
        lw = KERNEL_LINK_WIDTHS[0]
        T = torch.rand((2, 64, lw), generator=gen).to(dev)
        fx = torch.rand((3, 64, lw), generator=gen).to(dev)
        T1, fx1 = T[:, :38].contiguous(), fx[:, :38].contiguous()
        sc2 = LevelScalars.make(lw, 64, 1.0, 1.0, grey.equation_alpha)
        sc1 = LevelScalars.make(lw, 38, 1.0, 1.0, grey.equation_alpha)
        delta = {}
        for outer in (40, 20, 40, 20):
            c = dataclasses.replace(grey, outer_iterations_count=outer)
            two_ms = each(True, lambda: cuda_ms(
                lambda: relax_sharded_kernel(fx, T, sc2, c, pairs_mesh, data=data), 5))
            alone = cuda_ms(lambda: relax_sharded_kernel(fx1, T1, sc1, c, lone), 5)
            delta[outer] = two_ms - alone
        report["process_row_barrier_s"] = (delta[40] - delta[20]) / 20 * 1e-3 / 2
        report["process_row_barrier_how"] = (
            "device s a row barrier between two processes adds: relax_sharded_kernel (grey, "
            "inner 5) on a 64-row, 300-wide level over a row of two processes, less one "
            "shard's launch of the same 38 padded rows on one card, at 40 and at 20 outers; "
            "the slope per exchange over 2 (the last barrier of the process mode is in both)")

    return report


HALO_BYTES = 2 * 6 * 3840 * 4      # a 6-row, 3840-wide, 2-plane halo: 184,320 bytes
LINK_SIZES = (1, 2, 3, 4, 16, 64)  # messages of 1 to 4 halos, and large enough for the rate
LINK_MESSAGES = 64


def measure_procs_link(n: int) -> dict:
    """The --procs N --link report (module docstring): N worker processes;
    rank 0's line with every rank's numbers."""
    from tpuflow_torch.ops.cuda_lib import load_library
    from tpuflow_torch.parallel.multihost import process_results

    _cuda_devices()
    if n < 2 or n % 2:
        raise ValueError(f"--procs --link pairs the processes: N must be even, got {n}")
    load_library()                        # built once, for every worker
    command = [sys.executable, "-m", "tpuflow_torch.tools.report_scaling", "--proc-link"]
    return link_summary(process_results(command, n, PROC_TIMEOUT_S))


def link_summary(reports: List[dict]) -> dict:
    """The --procs N --link line from its workers' reports (``by_rank``):
    the line through the device times, the host times, and the explicit
    route's exchange, whose median is ``NCCL.dispatch_s``."""
    xs = [x for r in reports for x in r["sizes_bytes"]]
    ys = [t * 1e-6 for r in reports for t in r["device_us"]]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = (sum((a - mx) * (b - my) for a, b in zip(xs, ys))
             / sum((a - mx) ** 2 for a in xs))
    host = [t for r in reports for t in r["host_us"][:4]]
    two = [r["two_planes_host_us"] for r in reports]
    exchange = {key: sorted(r["route_exchange_us"][key] for r in reports)
                for key in ("pairs", "row")}
    every = sorted(exchange["pairs"] + exchange["row"])
    out = {"card": reports[0]["card"], "processes": len(reports),
           "hop_latency_s": my - slope * mx,
           "bandwidth_bytes_s": 1.0 / slope if slope > 0 else None,
           "dispatch_s": every[len(every) // 2] * 1e-6,
           "batch_host_us": sum(host) / len(host),
           "two_planes_batch_host_us": sum(two) / len(two),
           "exchange_one_peer_us": exchange["pairs"],
           "exchange_two_peers_us": exchange["row"]}
    out["how"] = {
        "hop_latency_s": "intercept of every rank's device us a batch against bytes (one "
                         f"line through them all, {LINK_SIZES} x 184,320 bytes)",
        "bandwidth_bytes_s": "inverse slope of that line",
        "batch_host_us": "host us to issue a batch of one send and one receive of 1 to 4 "
                         "halos, the card asleep (mean over the ranks)",
        "two_planes_batch_host_us": "the same for two sends and two receives (184,320 "
                                    "bytes in all)",
        "exchange_one_peer_us": "what one exchange costs the explicit route on rows of two "
                                "processes, every rank's: a 1920x1080 grey level's "
                                "relax_sharded_explicit at k = 1 less k = 2, over the 20 "
                                "exchanges k = 2 leaves out",
        "exchange_two_peers_us": "the same on the row of all the processes, whose middle "
                                 "ones have two neighbours",
        "dispatch_s": "s an exchange: the median of both lists"}
    out["by_rank"] = reports
    return out


def _explicit_exchange_s(dev, mesh, rounds: int = 5, size=(1920, 1080)) -> float:
    """Seconds one exchange costs the explicit route over processes: one
    grey level of ``size`` through ``relax_sharded_explicit`` on this
    process's row of ``mesh`` at k = 1 and 2, in turns, the difference over
    the exchanges k = 2 leaves out; the median of ``rounds``. Every
    process of the row calls it at once."""
    import torch

    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.parallel.group import row_barrier
    from tpuflow_torch.parallel.halo import relax_sharded_explicit
    from tpuflow_torch.solver.level import LevelScalars

    cfg, (w, h) = FlowConfig(), size
    gen = torch.Generator(device=dev).manual_seed(5)
    fxyz = torch.rand((3, h, w), device=dev, generator=gen)
    uv = torch.zeros((2, h, w), device=dev)
    sc = LevelScalars.make(w, h, 1.0, 1.0, cfg.equation_alpha)
    data = mesh.local_row()

    def run(k: int) -> float:
        torch.cuda.synchronize()
        row_barrier(mesh.row_ranks(data))
        t0 = time.perf_counter()
        relax_sharded_explicit(fxyz, uv, sc, cfg, mesh, k, data=data)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1), run(2)                        # build, connect and warm up
    exchanges = {k: -(-cfg.outer_iterations_count // k) - 1 for k in (1, 2)}
    diffs = []
    for r in range(rounds):
        t = {k: run(k) for k in ((1, 2) if r % 2 == 0 else (2, 1))}
        diffs.append((t[1] - t[2]) / (exchanges[1] - exchanges[2]))
    return sorted(diffs)[len(diffs) // 2]


def _proc_link(rank: int, world: int, messages: int = LINK_MESSAGES,
               sleep_cycles: int = 200_000_000) -> dict:
    """One worker of measure_procs_link: this rank and its partner (rank ^ 1)
    exchange one message each way per batch, at each of LINK_SIZES; then
    what an exchange costs the explicit route on rows of two (this rank and
    its partner) and on the row of every rank."""
    import torch

    from tpuflow_torch.parallel import make_mesh
    from tpuflow_torch.parallel.group import row_barrier, row_exchange
    from tpuflow_torch.tools.roofline import device_info

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((world, 1), dev)     # every process at once: joins the messages
    peer, everyone = rank ^ 1, list(range(world))
    out = {"card": device_info()["nvidia_smi"], "device": str(dev), "rank": rank,
           "peer": peer, "distinct_cards": mesh.cards, "sizes_bytes": [], "host_us": [],
           "device_us": [], "bytes_s": []}
    def queued(x, got, count: int):
        """(host s to issue ``count`` batches, device s they take), queued
        behind a sleep of the card."""
        torch.cuda.synchronize()
        row_barrier(everyone)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(count):
            row_exchange([(peer, x)], [(peer, got)])
        host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        return host, start.elapsed_time(end) * 1e-3

    for m in LINK_SIZES:
        nbytes = m * HALO_BYTES
        x = torch.rand(nbytes // 4, device=dev)
        got = torch.empty_like(x)
        for _ in range(8):                # connect and warm up
            row_exchange([(peer, x)], [(peer, got)])
        few, many = queued(x, got, messages // 4), queued(x, got, messages)
        # the slope between the two runs: the partners' skew at the start drops out
        device_s = (many[1] - few[1]) / (messages - messages // 4)
        out["sizes_bytes"].append(nbytes)
        out["host_us"].append(many[0] / messages * 1e6)
        out["device_us"].append(device_s * 1e6)
        out["bytes_s"].append(nbytes / device_s)
    # two messages each way a batch, one a plane of a halo, as the route sends
    x = torch.rand(HALO_BYTES // 4, device=dev)
    got = torch.empty_like(x)
    half = x.numel() // 2
    sends = [(peer, x[:half]), (peer, x[half:])]
    recvs = [(peer, got[:half]), (peer, got[half:])]
    for _ in range(8):
        row_exchange(sends, recvs)
    torch.cuda.synchronize()
    row_barrier(everyone)
    torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    for _ in range(messages):
        row_exchange(sends, recvs)
    out["two_planes_host_us"] = (time.perf_counter() - t0) / messages * 1e6
    torch.cuda.synchronize()
    out["route_exchange_us"] = {
        "pairs": _explicit_exchange_s(dev, make_mesh((world // 2, 2), dev)) * 1e6,
        "row": _explicit_exchange_s(dev, make_mesh((1, world), dev)) * 1e6,
        "row_peers": [r for r in (rank - 1, rank + 1) if 0 <= r < world]}
    out["how"] = {"host_us": f"host us to issue one batch ({messages} in a row, the card "
                             "asleep): a send and a receive with the partner",
                  "device_us": f"device us a batch: {messages} and {messages // 4} queued "
                               "behind a sleep, CUDA events on the caller's stream, which "
                               "waits for each; the slope between the two",
                  "two_planes_host_us": "the same host us for a batch of two sends and two "
                                        "receives, half the bytes each",
                  "route_exchange_us": "us an exchange costs the explicit route "
                                       "(_explicit_exchange_s): on rows of two, and on the "
                                       "row of all, with this rank's neighbours"}
    return out


def _proc_worker(argv) -> int:
    """``--proc-worker WxH PRESET PROFILE REPS K ROUTES HOST:PORT RANK WORLD``, or
    ``--proc-link HOST:PORT RANK WORLD``."""
    import torch

    from tpuflow_torch.parallel.group import process_group
    from tpuflow_torch.parallel.multihost import initialize_distributed

    if argv[0] == "--proc-link":
        address, rank, world = argv[1], int(argv[2]), int(argv[3])
        initialize_distributed(address, num_processes=world, process_id=rank)
        report = _proc_link(rank, world)
    else:
        size = tuple(int(x) for x in argv[0].split("x"))
        preset, profile, reps, k = argv[1], bool(int(argv[2])), int(argv[3]), int(argv[4])
        routes = None if argv[5] == "all" else argv[5].split(",")
        address, rank, world = argv[6], int(argv[7]), int(argv[8])
        initialize_distributed(address, num_processes=world, process_id=rank)
        report = _proc_report(rank, world, size, preset, profile, reps, k, routes)
    print("PROCRESULT " + json.dumps(report), flush=True)
    torch.distributed.barrier(group=process_group())
    torch.distributed.destroy_process_group()
    return 0


def project(w: int = None, h: int = None) -> list:
    """The cost model's rows (module docstring)."""
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.parallel.model import (
        best_k, link_params, project_schedule, project_schedule_auto, project_schedule_hybrid,
        project_sensitivity, rub_default_levels,
    )

    cfg = FlowConfig()
    sizes = [(w, h)] if w else [SIZE, (1920, 1080)]
    out = []
    for sw, sh in sizes:
        for n_y in (2, 4, 8):
            for cards in (1, n_y):
                ici = link_params(cards)
                levels = rub_default_levels(sw, sh, cfg, ici)
                paths = ("kernel", "explicit")
                rows = [project_schedule(levels, cfg, n_y, p, ici, 1, cards) for p in paths]
                rows += [dict(best_k(levels, cfg, n_y, p, ici, cards=cards),
                              path=f"{p}+best_k") for p in paths]
                rows.append(project_schedule_auto(levels, cfg, n_y, ici, paths, cards))
                rows.append(project_schedule_hybrid(levels, cfg, n_y, ici=ici, paths=paths,
                                                    cards=cards))
                rows.append(dict(project_sensitivity(levels, cfg, n_y, cards=cards),
                                 path="sensitivity"))
                for row in rows:
                    row.update(case=f"{sw}x{sh}", cards=cards)
                out += rows
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--proc-worker"]:
        return _proc_worker(argv[1:])
    if argv[:1] == ["--proc-link"]:
        return _proc_worker(argv)
    if "--project" in argv:
        pos = [int(a) for a in argv if not a.startswith("-")]
        print(json.dumps(project(*pos[:2]), indent=1))
        return 0
    if "--link" in argv and "--procs" in argv:
        print(json.dumps(measure_procs_link(int(argv[argv.index("--procs") + 1]))))
        return 0
    if "--link" in argv:
        print(json.dumps(measure_link()))
        return 0
    size = SIZE
    if "--size" in argv:
        size = tuple(int(x) for x in argv[argv.index("--size") + 1].split("x"))
    if "--procs" in argv:
        preset = argv[argv.index("--preset") + 1] if "--preset" in argv else "reference_default"
        routes = argv[argv.index("--routes") + 1].split(",") if "--routes" in argv else None
        print(json.dumps(measure_procs(int(argv[argv.index("--procs") + 1]), size, preset,
                                       "--profile" in argv, routes=routes)))
        return 0
    if "--turns" in argv:
        i = argv.index("--turns")
        print(json.dumps(measure_turns(argv[i + 1], argv[:i] + argv[i + 2:])))
        return 0
    valued = ("--size", "--preset", "--routes")
    pos = [a for i, a in enumerate(argv) if not a.startswith("-")
           and (i == 0 or argv[i - 1] not in valued)]
    preset = argv[argv.index("--preset") + 1] if "--preset" in argv else None
    routes = argv[argv.index("--routes") + 1].split(",") if "--routes" in argv else None
    print(json.dumps(measure(int(pos[0]) if pos else POSITIONS, size, preset=preset,
                             profile="--profile" in argv, routes=routes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

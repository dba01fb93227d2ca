"""Where the device time of one frame pair goes, by kernel and by layer.

    python -m tpuflow_torch.profile_pair --size 3840x2160 --preset full_model

Runs ``compute_flow(..., device="cuda")`` on the seeded textured pair of
``synthetic.py``: one warm-up pair, ``REPS`` unprofiled pairs timed on the
host clock, then one pair under ``torch.profiler``. Prints one JSON line:
the wall ms, the peak device memory of the unprofiled pairs
(``torch.cuda.max_memory_allocated``), the device busy ms (the sum of the device time of every kernel
and copy), the idle share, the device ms by kernel name, and the device ms
of the layers ``gaussian`` (presmooth) and ``resample`` (frames and flow),
read from the ``record_function`` ranges that ``ops/gaussian.py`` and
``ops/resample.py`` open, and for each kernel of the solve (the level
kernels, and the banded kernels along x and y) its device ms and
launches beside the pair's bound (``roofline.pair_bounds``: launches x
bound at each level's own size) and the gap between them, largest first.

    python -m tpuflow_torch.profile_pair --size 3840x2160 --prologue-levels

times instead both instantiations of ``ops.level.outer_prologue`` (grey,
and with the tensor J) at each level of the preset's schedule by CUDA-graph
replay (``roofline.graph_ms``), beside each level's bound, and a yardstick
of the card's rate for a stream that reads as much as it writes: one
``Tensor.copy_`` of 9 level-0 planes.

    python -m tpuflow_torch.profile_pair --size 3840x2160 --sweep-levels

times the inner loop of one outer iteration at each level the same way, in
turns: ``inner`` chained one-sweep launches, and ``ops.level.jacobi_sweeps``
as the main path runs it; beside the bound of the function and the bytes the
k-sweep kernel streams.

    python -m tpuflow_torch.profile_pair --size 3840x2160 --relax-levels

times a level's whole relaxation at each level that the sharded kernel's
gate admits at one shard: ``solver.level.relax`` (``outer`` prologue and
k-sweep launches, paced by the host) against one launch of
``relax_sharded_kernel`` on a one-shard mesh, in turns, by CUDA events; and
names the largest level where the one launch wins. All four need a CUDA
device, and raise without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpuflow_torch import compute_flow, models
from tpuflow_torch.config import DataConstancy
from tpuflow_torch.ops.level import jacobi_sweep_chain, jacobi_sweeps, outer_prologue
from tpuflow_torch.parallel import kernel_halo_applicable, make_mesh, relax_sharded_kernel
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import LevelScalars, relax
from tpuflow_torch.synthetic import textured_pair
from tpuflow_torch.tools.roofline import (
    cuda_ms, device_info, graph_ms, kernel_work, level_launches, pair_bounds,
)

REPS = 3
LAYERS = ("gaussian", "resample")
PROFILER_OVERHEAD = ("Activity Buffer Request",)  # CUPTI's own device records
# roofline.kernel_work names -> the demangled kernel name in csrc/level.cu
# and csrc/banded.cu
LEVEL_KERNELS = {
    "banded_x": "banded_x_kernel<", "banded_y": "banded_y_kernel(",
    "warp": "warp_kernel(", "level_derivs": "level_derivs_kernel(",
    "level_tensor_gradient": "level_tensor_kernel(",
    "level_tensor_log": "level_tensor_log_kernel(",
    "outer_prologue": "outer_prologue_kernel<false>",
    "outer_prologue_tensor": "outer_prologue_kernel<true>",
    "jacobi_sweep": "jacobi_sweep_kernel(", "jacobi_sweeps": "jacobi_sweeps_kernel<",
    "add_median": "add_median_kernel<",
}


def _device_us(evt, self_only: bool) -> float:
    for attr in (("self_device_time_total", "self_cuda_time_total") if self_only
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_pair(w: int, h: int, preset: str) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_pair measures device time and needs CUDA")
    cfg = getattr(models, preset)()
    f0, f1 = textured_pair(w, h)
    run = lambda: compute_flow(f0, f1, cfg, device="cuda")  # noqa: E731
    run()  # warm-up: builds the kernels and the banded kernels' plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, layers = {}, {}
    for evt in prof.key_averages():
        if evt.key in LAYERS:
            layers[evt.key] = _device_us(evt, self_only=False) / 1e3
        elif evt.device_type == DeviceType.CUDA and evt.key not in PROFILER_OVERHEAD:
            # Kernels, copies and memsets; the CPU ops that launched them
            # would count their time twice.
            by_kernel[evt.key] = {"ms": _device_us(evt, self_only=True) / 1e3,
                                  "calls": evt.count}
    busy = sum(k["ms"] for k in by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:15])
    level = {}
    for name, b in pair_bounds(w, h, cfg).items():
        hits = [v for k, v in by_kernel.items() if LEVEL_KERNELS[name] in k]
        ms = sum(v["ms"] for v in hits)
        level[name] = {"ms": ms, "calls": sum(v["calls"] for v in hits),
                       "launches": b["launches"], "bound_ms": b["bound_ms"],
                       "gap_ms": ms - b["bound_ms"], "share": b["bound_ms"] / ms if ms else None}
    level = dict(sorted(level.items(), key=lambda kv: -kv[1]["gap_ms"]))
    return {"shape": [h, w], "preset": preset, "constancy": cfg.data_constancy.value,
            "wall_ms_unprofiled": wall, "wall_ms_profiled": profiled_ms,
            "max_memory_allocated_bytes_unprofiled": peak,
            "device_busy_ms": busy, "idle_share_of_profiled_wall": 1.0 - busy / profiled_ms,
            "layer_device_ms": layers,
            "layer_share_of_busy": {k: v / busy for k, v in layers.items()} if busy else {},
            "by_kernel_top15": top, "level_kernels_by_gap": level}


def _level_fields(w: int, h: int, seed: int) -> dict:
    """Seeded level-0-sized fields on the card: an iterate T, the flow uv it
    started from, grey derivatives fxyz and a tensor J."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    uv = torch.from_numpy((rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)).to(dev)
    T = uv + torch.from_numpy((rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)).to(dev)
    fxyz = torch.from_numpy((rng.standard_normal((3, h, w)) * 10.0).astype(np.float32)).to(dev)
    J = torch.from_numpy(rng.standard_normal((5, h, w)).astype(np.float32)).to(dev)
    return {"T": T, "uv": uv, "fxyz": fxyz, "J": J}


def prologue_by_level(w: int, h: int, preset: str = "full_model", seed: int = 0) -> dict:
    """Both prologues at every level of one pair, on seeded fields cut from
    level-0-sized ones: per level [h, w, grey ms, tensor ms, grey bound ms,
    tensor bound ms], and the sums over the pair (``outer_iterations_count``
    launches per level)."""
    if not torch.cuda.is_available():
        raise RuntimeError("prologue_by_level times a CUDA card, and none is available")
    cfg = getattr(models, preset)()
    x = _level_fields(w, h, seed)
    T, uv, fxyz, J = x["T"], x["uv"], x["fxyz"], x["J"]
    e2 = float(np.float32(cfg.equation_smoothness) * np.float32(cfg.equation_smoothness))
    ed2 = float(np.float32(cfg.equation_data) * np.float32(cfg.equation_data))
    rows = []
    for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
        lh, lw = s.height, s.width
        t, u, f, j = (a[:, :lh, :lw].contiguous() for a in (T, uv, fxyz, J))
        sc = LevelScalars.make(lw, lh, s.hx, s.hy, cfg.equation_alpha)
        pro = (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e2, ed2)
        grey = graph_ms(lambda: outer_prologue(t, u, f, *pro), calls=20, replays=3)
        tensor = graph_ms(lambda: outer_prologue(t, u, f, *pro, J=j), calls=20, replays=3)
        rows.append([lh, lw, grey, tensor, kernel_work("outer_prologue", lh, lw)["bound_ms"],
                     kernel_work("outer_prologue_tensor", lh, lw)["bound_ms"]])
    outer = cfg.outer_iterations_count
    src = torch.cat([T, uv, fxyz, J[:2]])
    dst = torch.empty_like(src)
    copy_ms = graph_ms(lambda: dst.copy_(src), calls=20, replays=3)
    return {"shape": [h, w], "preset": preset, "outer": outer,
            "pair_ms": {"grey": outer * sum(r[2] for r in rows),
                        "tensor": outer * sum(r[3] for r in rows)},
            "pair_bound_ms": {"grey": outer * sum(r[4] for r in rows),
                              "tensor": outer * sum(r[5] for r in rows)},
            "levels": rows,
            "copy_9_planes_ms": copy_ms,
            "copy_9_planes_tb_per_s": 2 * src.numel() * 4 / (copy_ms * 1e-3) / 1e12,
            "timing": "CUDA-graph replay (roofline.graph_ms)", "device": device_info()}


def sweeps_by_level(w: int, h: int, preset: str = "full_model", seed: int = 0) -> dict:
    """The inner loop of one outer at every level of one pair, on seeded
    fields cut from level-0-sized ones, with hoists from the grey prologue:
    per level [h, w, chained ms, k-sweep ms, bound ms, design bytes], and
    the sums over the pair (``outer_iterations_count`` loops per level)."""
    if not torch.cuda.is_available():
        raise RuntimeError("sweeps_by_level times a CUDA card, and none is available")
    cfg = getattr(models, preset)()
    inner, outer = cfg.inner_iterations_count, cfg.outer_iterations_count
    # the kernel_work arguments of the loop's launches
    loop = [kw for name, _, kw in level_launches(cfg) if name == "jacobi_sweeps"]
    x = _level_fields(w, h, seed)
    e2 = float(np.float32(cfg.equation_smoothness) * np.float32(cfg.equation_smoothness))
    ed2 = float(np.float32(cfg.equation_data) * np.float32(cfg.equation_data))
    rows = []
    for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
        lh, lw = s.height, s.width
        t, u, f = (x[k][:, :lh, :lw].contiguous() for k in ("T", "uv", "fxyz"))
        sc = LevelScalars.make(lw, lh, s.hx, s.hy, cfg.equation_alpha)
        hoist = outer_prologue(t, u, f, sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e2, ed2)
        runs = {"chain": lambda: jacobi_sweep_chain(t, u, hoist, inner),
                "ksweep": lambda: jacobi_sweeps(t, u, hoist, inner)}
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            ms[name].append(graph_ms(runs[name], calls=10, replays=3))
        work = [kernel_work("jacobi_sweeps", lh, lw, **kw) for kw in loop]
        rows.append([lh, lw, min(ms["chain"]), min(ms["ksweep"]),
                     sum(wk["bound_ms"] for wk in work), sum(wk["design_bytes"] for wk in work)])
    return {"shape": [h, w], "preset": preset, "outer": outer, "inner": inner,
            "pair_ms": {k: outer * sum(r[2 + i] for r in rows)
                        for i, k in enumerate(("chain", "ksweep"))},
            "pair_bound_ms": outer * sum(r[4] for r in rows), "levels": rows,
            "columns": ["h", "w", "chain_ms", "ksweep_ms", "bound_ms", "design_bytes"],
            "timing": "CUDA-graph replay (roofline.graph_ms), the least of two runs in turns",
            "device": device_info()}


def relax_by_level(w: int, h: int, preset: str = "full_model", seed: int = 0,
                   reps: int = 5) -> dict:
    """A level's relaxation at every level of one pair that
    ``kernel_halo_applicable(h, 1, cfg)`` admits, on seeded fields cut from
    level-0-sized ones: per level [level, h, w, relax ms, one-launch ms],
    each the least of two runs of ``reps`` calls in turns (relax, one
    launch, one launch, relax), host-paced as the main path runs them; the
    sums over those levels; and the largest level (by pixels) where the one
    launch is faster."""
    if not torch.cuda.is_available():
        raise RuntimeError("relax_by_level times a CUDA card, and none is available")
    cfg = getattr(models, preset)()
    tensor = cfg.data_constancy != DataConstancy.GREY
    x = _level_fields(w, h, seed)
    mesh = make_mesh(1)
    rows = []
    for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
        lh, lw = s.height, s.width
        if not kernel_halo_applicable(lh, 1, cfg):
            continue
        u, f, j = (x[k][:, :lh, :lw].contiguous() for k in ("uv", "fxyz", "J"))
        J = j if tensor else None
        sc = LevelScalars.make(lw, lh, s.hx, s.hy, cfg.equation_alpha)
        runs = {"relax": lambda: relax(f, u, sc, cfg, J=J),
                "one_launch": lambda: relax_sharded_kernel(f, u, sc, cfg, mesh, J=J)}
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            ms[name].append(cuda_ms(runs[name], reps))
        rows.append([s.level, lh, lw, min(ms["relax"]), min(ms["one_launch"])])
    wins = [r for r in rows if r[4] < r[3]]
    largest = max(wins, key=lambda r: r[1] * r[2]) if wins else None
    return {"shape": [h, w], "preset": preset, "constancy": cfg.data_constancy.value,
            "levels": rows, "columns": ["level", "h", "w", "relax_ms", "one_launch_ms"],
            "sum_ms": {"relax": sum(r[3] for r in rows), "one_launch": sum(r[4] for r in rows)},
            "levels_where_one_launch_wins": [r[0] for r in wins],
            "largest_level_where_one_launch_wins": largest,
            "timing": f"CUDA events over {reps} host-paced calls, the least of two runs in turns",
            "device": device_info()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", default="3840x2160", help="WxH")
    parser.add_argument("--preset", default="full_model", help="a function of tpuflow_torch.models")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--prologue-levels", action="store_true",
                      help="time the outer prologue at every level instead of profiling")
    mode.add_argument("--sweep-levels", action="store_true",
                      help="time the inner sweeps at every level instead of profiling")
    mode.add_argument("--relax-levels", action="store_true",
                      help="time relax against the one-shard sharded kernel at every level")
    args = parser.parse_args(argv)
    w, h = (int(x) for x in args.size.lower().split("x"))
    run = (prologue_by_level if args.prologue_levels
           else sweeps_by_level if args.sweep_levels
           else relax_by_level if args.relax_levels else profile_pair)
    print(json.dumps(run(w, h, args.preset)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

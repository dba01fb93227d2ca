"""Where the device time of one frame pair goes, by kernel and by layer.

    python -m tpuflow_torch.profile_pair --size 3840x2160 --preset full_model

Runs ``compute_flow(..., device="cuda")`` on the seeded textured pair of
``synthetic.py``: one warm-up pair, ``REPS`` unprofiled pairs timed on the
host clock, then one pair under ``torch.profiler``. Prints one JSON line:
the wall ms, the device busy ms (the sum of the device time of every kernel
and copy), the idle share, the device ms by kernel name, and the device ms
of the layers ``gaussian`` (presmooth) and ``resample`` (frames and flow),
read from the ``record_function`` ranges that ``ops/gaussian.py`` and
``ops/resample.py`` open. Needs a CUDA device, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpuflow_torch import compute_flow, models
from tpuflow_torch.synthetic import textured_pair

REPS = 3
LAYERS = ("gaussian", "resample")
PROFILER_OVERHEAD = ("Activity Buffer Request",)  # CUPTI's own device records


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
    run()  # warm-up: builds the kernels and the resample weights
    wall = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        wall.append((time.perf_counter() - t0) * 1e3)
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
    return {"shape": [h, w], "preset": preset, "constancy": cfg.data_constancy.value,
            "wall_ms_unprofiled": wall, "wall_ms_profiled": profiled_ms,
            "device_busy_ms": busy, "idle_share_of_profiled_wall": 1.0 - busy / profiled_ms,
            "layer_device_ms": layers,
            "layer_share_of_busy": {k: v / busy for k, v in layers.items()} if busy else {},
            "by_kernel_top15": top}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", default="3840x2160", help="WxH")
    parser.add_argument("--preset", default="full_model", help="a function of tpuflow_torch.models")
    args = parser.parse_args(argv)
    w, h = (int(x) for x in args.size.lower().split("x"))
    print(json.dumps(profile_pair(w, h, args.preset)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

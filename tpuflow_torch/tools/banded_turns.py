"""Device time of one pair's banded launches, to compare two checkouts of
the port in turns on one card.

    python -m tpuflow_torch.tools.banded_turns --size 3840x2160 [--size ...] [--peak] [--host]

or, from the root of another checkout (one older than this tool):

    PYTHONPATH=. python PATH/TO/tpuflow_torch/tools/banded_turns.py --size 3840x2160

For each size, on a seeded pair (2, h, w) of intensities and a seeded flow
a level (``models.full_model()``), times by CUDA-graph replay
(``roofline.graph_ms``, best of REPLAYS) whatever ``tpuflow_torch`` is
imported: the presmooth (``gaussian_smooth`` of the pair) and the resample
as that checkout's solve makes it (every level's frames from the smoothed
pair: through ``resample_levels`` in one call, each distinct size once,
where the checkout has it, else one ``resample`` call for every level but
level 0, as the solve before it made them; then each level's flow from the
level before). With ``--peak``, also the peak device memory
(``torch.cuda.max_memory_allocated``) of one ``compute_flow`` pair after a
warm-up one. With ``--host``, also the host's µs a banded launch and ms a
pair: the wall of issuing HOST_PAIRS pairs' calls of each wrapper without
waiting (fewer launches than the card's queue holds), over the launches
counted (``ops.level.launch_counts``) and the pairs, the best of
HOST_ROUNDS rounds (the host's cores are shared, so its clock is noisy). Prints one JSON line a size, with the card's
name and power limit and the package's path. CUDA only: raises without a
card. Run the checkouts in turns (parent, this, this, parent), each in its
own process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

REPLAYS = 5
ROUNDS = 3
HOST_PAIRS = {"presmooth": 200, "resample": 4}  # at most 800 launches queued
HOST_ROUNDS = 7


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pair_calls(w: int, h: int, seed: int = 2):
    """(presmooth, resample) functions making one pair's calls."""
    import tpuflow_torch.ops.resample as R
    from tpuflow_torch import models
    from tpuflow_torch.ops.gaussian import gaussian_smooth
    from tpuflow_torch.pyramid import level_schedule

    cfg = models.full_model()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    pair = t(rng.random((2, h, w)) * 255.0)
    flows = [t(rng.standard_normal((2, a.height, a.width)) * 4.0) for a in specs[:-1]]
    smoothed = gaussian_smooth(pair, cfg.gaussian_sigma)
    sizes = tuple(dict.fromkeys((s.width, s.height) for s in specs
                                if s.level != 0 and (s.width, s.height) != (w, h)))

    def frames():
        if hasattr(R, "resample_levels"):
            return R.resample_levels(smoothed, sizes)
        return [R.resample(smoothed, s.width, s.height) for s in specs if s.level != 0]

    def resample():
        out = frames()
        out += [R.resample(f, s.width, s.height) for f, s in zip(flows, specs[1:])]
        return out

    return (lambda: gaussian_smooth(pair, cfg.gaussian_sigma)), resample


def host_us(fn, pairs: int) -> dict:
    """The host's µs a banded launch of ``fn`` and ms a pair: the wall of
    issuing ``pairs`` calls, after a warm one, over the launches they
    counted and over ``pairs``; the best of HOST_ROUNDS rounds."""
    from tpuflow_torch.ops.level import launch_counts

    def banded():
        c = launch_counts()
        return c["gaussian_smooth"] + c["resample"]

    fn()
    walls = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        n0, t0 = banded(), time.perf_counter()
        for _ in range(pairs):
            fn()
        walls.append(time.perf_counter() - t0)
        launches = banded() - n0
    torch.cuda.synchronize()
    return {"launches_per_pair": launches // pairs, "pairs": pairs,
            "us_per_launch": min(walls) / launches * 1e6,
            "ms_per_pair": min(walls) / pairs * 1e3,
            "us_per_launch_all": [t / launches * 1e6 for t in walls]}


def peak_bytes(w: int, h: int) -> int:
    from tpuflow_torch import compute_flow, models
    from tpuflow_torch.synthetic import textured_pair

    f0, f1 = textured_pair(w, h)
    cfg = models.full_model()
    compute_flow(f0, f1, cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    compute_flow(f0, f1, cfg, device="cuda")
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", action="append", default=None, help="WxH (repeatable)")
    ap.add_argument("--peak", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("banded_turns times a CUDA card, and none is available")
    import tpuflow_torch
    from tpuflow_torch.tools.roofline import graph_ms

    name = card()
    for size in args.size or ["3840x2160"]:
        w, h = (int(v) for v in size.lower().split("x"))
        smooth, resample = pair_calls(w, h)
        ms = {"presmooth": [], "resample": []}
        for _ in range(ROUNDS):
            ms["presmooth"].append(graph_ms(smooth, calls=1, replays=REPLAYS))
            ms["resample"].append(graph_ms(resample, calls=1, replays=REPLAYS))
        row = {"tool": "banded_turns", "shape": [h, w], "config": "models.full_model()",
               "card": name, "package": str(tpuflow_torch.__file__),
               "timing": f"CUDA-graph replay of one pair's calls, {REPLAYS} replays, "
                         f"{ROUNDS} rounds", "presmooth_ms": min(ms["presmooth"]),
               "resample_ms": min(ms["resample"]), "ms_all": ms}
        if args.host:
            row["host"] = {"presmooth": host_us(smooth, HOST_PAIRS["presmooth"]),
                           "resample": host_us(resample, HOST_PAIRS["resample"])}
        del smooth, resample
        torch.cuda.empty_cache()
        if args.peak:
            row["compute_flow_peak_bytes"] = peak_bytes(w, h)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Benchmark harness of the port (the port of bench.py): the full
coarse-to-fine solve on one H100, one JSON line.

    python -m tpuflow_torch.bench [--size WxH] [--preset grey|full_model|xray_log]
                                  [--runs N] [--pairs K] [--epe]

The line carries bench.py's keys (``metric``, ``value``, ``unit`` Mpix/s,
``vs_baseline`` against its self-defined 1.0 Mpix/s, ``mpix_s_min``,
``mpix_s_median``, ``mpix_s_max``, ``epe_px``, ``epe_ok``), the card's name
and power limit as nvidia-smi prints them, and ``pair_ms_median``: the
median wall time of ``compute_flow`` on one pair, host arrays in and out.

Throughput is bench.py's k-slope: each run times a chain of ``k_lo = K // 4``
pairs and a chain of K pairs of ``compute_flow_async`` (host frames in, the
flow left on the card), each chain fenced once by fetching its last flow,
and takes (t_K - t_k_lo) / (K - k_lo) per pair, which cancels the fence and
the last download. ``value`` is the median over runs (bench.py took the
best, for a pooled TPU; one H100 is not pooled). One warm-up pair comes
first.

Frames: the rub pair (``data/rub1.raw``, ``data/rub2.raw``, 584x388 u8)
where it exists, else bench.py's synthetic fallback at the asked size
(numpy seed 0: noise and a Gaussian blob moved by (2, 3) px). ``epe_px``
is the grey flow's mean EPE against the oracle golden
``data/oracle_rub_default.npz``, on the rub pair only; otherwise it is null
and ``epe_reason`` says why.

``--epe`` adds the full-schedule mean EPE of ``compute_flow`` against
``oracle_np.compute_flow`` on ``synthetic.textured_pair(584, 388)`` for
``FlowConfig()`` (grey), ``models.full_model()`` and
``models.xray_log(alpha=1e-3)`` (at the preset's alpha of 35 the log term
moves no flow on 8-bit frames), gated at 0.05 px; the three oracles run in
three spawned processes, so a script that calls ``main(["--epe"])`` does it
under ``if __name__ == "__main__":``. A failed gate prints the line and
exits 1. The bench needs CUDA: without it, it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF_BASELINE_MPIX_S = 1.0   # bench.py's self-defined baseline
EPE_TARGET_PX = 0.05         # the parity contract against the oracle
RUB = (os.path.join(REPO, "data", "rub1.raw"), os.path.join(REPO, "data", "rub2.raw"))
RUB_SIZE = (584, 388)
ORACLE_GOLDEN = os.path.join(REPO, "data", "oracle_rub_default.npz")
PRESETS = ("grey", "full_model", "xray_log")
# --epe: the three constancies at 584x388 on the default schedule
EPE_SIZE = (584, 388)
EPE_LOG_ALPHA = 1e-3
# bench.py's keys, in its order
KEYS = ("metric", "value", "unit", "vs_baseline", "mpix_s_min", "mpix_s_median",
        "mpix_s_max", "epe_px", "epe_ok")


def preset_config(preset: str):
    from tpuflow_torch import FlowConfig, models

    if preset == "grey":
        return FlowConfig()
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; one of {PRESETS}")
    return getattr(models, preset)()


def fallback_frames(w: int, h: int):
    """bench.py's synthetic pair at (w, h): seeded noise at 0.3 of 0-255 and
    an 80-high Gaussian blob (sigma 40) at the centre, moved by (2, 3) px in
    the second frame. At 584x388 the frames are bench.py's."""
    rng = np.random.default_rng(0)
    base = rng.random((h, w), dtype=np.float32) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = 80.0 * np.exp(-((ys - h // 2) ** 2 + (xs - w // 2) ** 2) / (2 * 40.0 ** 2))
    return ((base * 0.3 + blob).astype(np.float32),
            (base * 0.3 + np.roll(blob, (2, 3), axis=(0, 1))).astype(np.float32))


def load_frames(w: int, h: int):
    """(f0, f1, is_rub): the rub pair at 584x388 where its raws exist, else
    the fallback frames."""
    from tpuflow_torch.io import read_raw_u8

    if (w, h) == RUB_SIZE and all(os.path.exists(p) for p in RUB):
        return read_raw_u8(RUB[0], w, h), read_raw_u8(RUB[1], w, h), True
    return (*fallback_frames(w, h), False)


def rub_epe(u, v, is_rub: bool, preset: str):
    """(epe_px, epe_ok, epe_reason) against the rub golden; null with a
    reason where it does not apply."""
    from tpuflow_torch import endpoint_error

    if not is_rub:
        return None, None, ("the rub raws (data/rub1.raw, data/rub2.raw, 584x388) are absent "
                            "or the size differs: the frames are bench.py's synthetic fallback, "
                            "which has no golden flow")
    if preset != "grey":
        return None, None, f"the rub golden is the grey FlowConfig() flow, not {preset}"
    if not os.path.exists(ORACLE_GOLDEN):
        return None, None, "data/oracle_rub_default.npz is absent"
    golden = np.load(ORACLE_GOLDEN)
    epe = endpoint_error(u, v, golden["u"], golden["v"])
    return epe, bool(epe <= EPE_TARGET_PX), None


def make_record(w: int, h: int, preset: str, slopes, pair_ms, card: str, *,
                epe=(None, None, None), k: int, k_lo: int) -> dict:
    """The JSON line from measured seconds per pair (``slopes``, one per
    run; inverted runs already dropped), wall ms per ``compute_flow`` pair
    and the card's nvidia-smi line."""
    mpix = sorted(w * h / s / 1e6 for s in slopes)
    median = statistics.median(mpix)
    epe_px, epe_ok, reason = epe
    record = {
        "metric": (f"{w}x{h} {preset}: full coarse-to-fine solve, default schedule, "
                   "Mpix/s per pair (k-slope of chained compute_flow_async)"),
        "value": median,
        "unit": "Mpix/s",
        "vs_baseline": median / SELF_BASELINE_MPIX_S,
        "mpix_s_min": mpix[0],
        "mpix_s_median": median,
        "mpix_s_max": mpix[-1],
        "epe_px": epe_px,
        "epe_ok": epe_ok,
        "pair_ms_median": statistics.median(pair_ms),
        "pair_ms_all": list(pair_ms),
        "card": card,
        "size": [w, h],
        "preset": preset,
        "runs": len(slopes),
        "pairs": k,
        "pairs_lo": k_lo,
    }
    if epe_px is None:
        record["epe_reason"] = reason
    return record


def k_slope(f0, f1, cfg, runs: int, k: int, k_lo: int) -> list:
    """Seconds per pair of each run, (t_k - t_k_lo) / (k - k_lo), each chain
    of compute_flow_async pairs fenced once; runs whose slope is not
    positive are dropped, and if all are, t_k / k of the last run."""
    from tpuflow_torch import compute_flow_async

    slopes, t = [], {}
    for _ in range(runs):
        for kk in (k_lo, k):
            t0 = time.perf_counter()
            for _ in range(kk):
                uv = compute_flow_async(f0, f1, cfg, device="cuda")
            uv.cpu()
            t[kk] = time.perf_counter() - t0
        slope = (t[k] - t[k_lo]) / (k - k_lo)
        if slope > 0:
            slopes.append(slope)
    return slopes or [t[k] / k]


def _oracle_flow(f0, f1, constancy: str, alpha: float):
    from tpuflow_torch import oracle_np

    t0 = time.perf_counter()
    u, v = oracle_np.compute_flow(f0, f1, data_constancy=constancy, equation_alpha=alpha)
    return u, v, time.perf_counter() - t0


def full_schedule_epe() -> dict:
    """Mean EPE of compute_flow on the card against the oracle, both on the
    default schedule, at EPE_SIZE for grey, full_model() and
    xray_log(alpha=EPE_LOG_ALPHA); the oracles in three processes."""
    from tpuflow_torch import compute_flow, endpoint_error, models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.synthetic import textured_pair

    cfgs = {"grey": FlowConfig(), "gradient": models.full_model(),
            "log": models.xray_log(alpha=EPE_LOG_ALPHA)}
    f0, f1 = textured_pair(*EPE_SIZE)
    with ProcessPoolExecutor(max_workers=len(cfgs), mp_context=get_context("spawn")) as pool:
        oracles = {name: pool.submit(_oracle_flow, f0, f1, name, cfg.equation_alpha)
                   for name, cfg in cfgs.items()}
        flows = {name: compute_flow(f0, f1, cfg, device="cuda") for name, cfg in cfgs.items()}
        oracles = {name: f.result() for name, f in oracles.items()}
    epe = {name: endpoint_error(flows[name].u, flows[name].v, *oracles[name][:2])
           for name in cfgs}
    return {"epe_oracle_full_schedule": epe, "epe_oracle_bound": EPE_TARGET_PX,
            "epe_oracle_ok": all(e <= EPE_TARGET_PX for e in epe.values()),
            "epe_oracle_frames": f"synthetic.textured_pair{EPE_SIZE}",
            "epe_oracle_configs": {"grey": "FlowConfig()", "gradient": "models.full_model()",
                                   "log": f"models.xray_log(alpha={EPE_LOG_ALPHA})"},
            "oracle_seconds": {name: o[2] for name, o in oracles.items()}}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpuflow_torch.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", default="584x388", metavar="WxH")
    parser.add_argument("--preset", default="grey", choices=PRESETS)
    parser.add_argument("--runs", type=int, default=6, metavar="N")
    parser.add_argument("--pairs", type=int, default=96, metavar="K",
                        help="pairs in the long chain; the short one has K // 4")
    parser.add_argument("--epe", action="store_true",
                        help="add the full-schedule EPE against the oracle, three constancies")
    args = parser.parse_args(argv)
    args.width, args.height = (int(x) for x in args.size.lower().split("x"))
    if args.pairs < 2 or args.runs < 1:
        parser.error("--pairs must be at least 2 and --runs at least 1")
    return args


def main(argv=None) -> dict:
    """Run the bench, print its line and return it. Raises without CUDA."""
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA GPU; CUDA is not available")
    from tpuflow_torch import compute_flow
    from tpuflow_torch.tools.roofline import device_info

    w, h = args.width, args.height
    cfg = preset_config(args.preset)
    f0, f1, is_rub = load_frames(w, h)
    warm = compute_flow(f0, f1, cfg, device="cuda")   # warm-up pair: builds, caches
    if not (np.isfinite(warm.u).all() and np.isfinite(warm.v).all()):
        raise AssertionError("the warm-up pair's flow is not finite")
    k, k_lo = args.pairs, max(1, args.pairs // 4)
    slopes = k_slope(f0, f1, cfg, args.runs, k, k_lo)
    pair_ms = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        res = compute_flow(f0, f1, cfg, device="cuda")
        pair_ms.append((time.perf_counter() - t0) * 1e3)
    record = make_record(w, h, args.preset, slopes, pair_ms, device_info()["nvidia_smi"],
                         epe=rub_epe(res.u, res.v, is_rub, args.preset), k=k, k_lo=k_lo)
    if args.epe:
        record.update(full_schedule_epe())
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    rec = main()
    sys.exit(1 if rec["epe_ok"] is False or rec.get("epe_oracle_ok") is False else 0)

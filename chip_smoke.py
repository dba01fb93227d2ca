#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tpuflow_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with one CUDA GPU

Phases, one JSON line each; any failure raises and the exit code is not 0:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds tpuflow_torch/csrc into tpuflow_torch/_build
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              on seeded inputs at the 584x388 and 1920x1080 finest-level shapes
  4. e2e      compute_flow(FlowConfig()) at 584x388 on a textured pair shifted
              by (+1.25, -0.75) px: kernel path vs plain path, the recovered
              shift, and the NumPy oracle on a reduced schedule
  5. e2e      the same at 1920x1080 (no oracle: it would take hours)
  6. launches each kernel's launch count in the main-path runs of phases 4-5
              against what the level schedule implies
  7. times    median ms per pair and Mpix/s of both paths, CUDA events

Then the kernels table as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or run outside a checkout
of the repo, it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZES = ((584, 388), (1920, 1080))   # (width, height)
SHIFT = (1.25, -0.75)                 # true (u, v) of the textured pair, px
MARGIN = 24                           # border px left out of the shift check
# The reduced schedule the oracle finishes in seconds at 584x388.
ORACLE_KW = dict(warp_levels_count=8, warp_scale_factor=0.7,
                 outer_iterations_count=10, inner_iterations_count=5,
                 equation_alpha=35.0, median_radius=5, gaussian_sigma=1.5)
# Kernel vs plain on the card. Both sides round every operation as IEEE
# float32 in the same association (no FMA contraction in the kernels), so
# these bounds are loose; warp's taps gather differently-rounded weights.
BOUNDS = {"warp": 1e-4, "level_derivs": 1e-5, "outer_prologue": 1e-5,
          "jacobi_sweep": 1e-5, "add_median": 0.0}
REPLACES = {
    "warp": "tpuflow/ops/pallas/level_fused.py:179 (_warp_shift_sum in "
            "level_fused_whole); tpuflow/solver/bucketed.py:266",
    "level_derivs": "tpuflow/ops/pallas/level_fused.py:526 (level_fused_whole, "
                    "phase A :285); tpuflow/ops/pallas/level_fused.py:472",
    "outer_prologue": "tpuflow/ops/pallas/level_fused.py:526; "
                      "tpuflow/ops/pallas/relax_bucket.py:400; "
                      "tpuflow/ops/pallas/relax_du.py:457",
    "jacobi_sweep": "tpuflow/ops/pallas/level_fused.py:526; "
                    "tpuflow/ops/pallas/level_fused.py:472; "
                    "tpuflow/ops/pallas/relax_bucket.py:400; "
                    "tpuflow/ops/pallas/relax_du.py:457",
    "add_median": "tpuflow/ops/pallas/level_fused.py:526 (phase C :432); "
                  "tpuflow/ops/pallas/level_fused.py:472",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def textured_pair(w: int, h: int, shift=SHIFT, seed: int = 0, corr: float = 2.5):
    """Gaussian-filtered noise scaled to 0-255 and its copy translated by
    ``shift`` (band-limited, periodic, so the translation is exact)."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.fftfreq(w)[None, :]
    spec = np.fft.fft2(rng.standard_normal((h, w)))
    spec *= np.exp(-2.0 * (np.pi * corr) ** 2 * (kx ** 2 + ky ** 2))
    t0 = np.real(np.fft.ifft2(spec))
    t1 = np.real(np.fft.ifft2(spec * np.exp(-2j * np.pi * (kx * shift[0] + ky * shift[1]))))
    lo, hi = t0.min(), t0.max()
    scale = lambda t: ((t - lo) / (hi - lo) * 255.0).astype(np.float32)  # noqa: E731
    return scale(t0), scale(t1)


def shift_epe(u, v, shift=SHIFT, margin=MARGIN) -> float:
    m = (slice(margin, -margin), slice(margin, -margin))
    return float(np.mean(np.hypot(u[m] - shift[0], v[m] - shift[1])))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(w: int, h: int, seed: int = 1):
    """Seeded level fields at (h, w) on the card: frames, a flow with a few
    out-of-bounds and NaN pixels, an iterate, derivatives and hoists."""
    import torch

    from tpuflow_torch.ops.level import level_derivs_plain, outer_prologue_plain
    from tpuflow_torch.solver.level import LevelScalars

    rng = np.random.default_rng(seed)
    f0, f1 = textured_pair(w, h, seed=seed)
    uv = (rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)
    uv[0, :, :3] = -40.0          # out of bounds: copies f0
    uv[1, 5, 7] = np.nan          # NaN target: copies f0
    d = (rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f0, f1, uv, d = t(f0), t(f1), t(uv), t(d)
    uv_finite = torch.nan_to_num(uv)
    T = uv_finite + d
    sc = LevelScalars.make(w, h, 1.0, 1.0, 35.0)
    e2 = float(np.float32(0.001) * np.float32(0.001))
    fxyz = level_derivs_plain(f0, f1, sc.div4hx, sc.div4hy)
    pro = (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e2, e2)
    hoist = outer_prologue_plain(T, uv_finite, fxyz, *pro)
    return dict(f0=f0, f1=f1, uv=uv, uvf=uv_finite, T=T, fxyz=fxyz, hoist=hoist,
                sc=sc, pro=pro)


def phase_kernels():
    """Each kernel vs its plain version at both finest-level shapes; times
    at the 1920x1080 shape. Returns {name: {max_abs_err, ms, plain_ms}}."""
    import torch

    from tpuflow_torch.ops import level as L
    from tpuflow_torch.ops.warp import warp, warp_plain

    table = {}
    for w, h in SIZES:
        x = kernel_inputs(w, h)
        sc, pro = x["sc"], x["pro"]
        pairs = {
            "warp": (lambda: warp(x["f0"], x["f1"], x["uv"], sc.inv_hx, sc.inv_hy),
                     lambda: warp_plain(x["f0"], x["f1"], x["uv"], sc.inv_hx, sc.inv_hy)),
            "level_derivs": (lambda: L.level_derivs(x["f0"], x["f1"], sc.div4hx, sc.div4hy),
                             lambda: L.level_derivs_plain(x["f0"], x["f1"], sc.div4hx, sc.div4hy)),
            "outer_prologue": (lambda: L.outer_prologue(x["T"], x["uvf"], x["fxyz"], *pro),
                               lambda: L.outer_prologue_plain(x["T"], x["uvf"], x["fxyz"], *pro)),
            "jacobi_sweep": (lambda: L.jacobi_sweep(x["T"], x["uvf"], x["hoist"]),
                             lambda: L.jacobi_sweep_plain(x["T"], x["uvf"], x["hoist"])),
            "add_median": (lambda: L.add_median(x["T"], x["uvf"], 5),
                           lambda: L.add_median_plain(x["T"], x["uvf"], 5)),
        }
        for name, (kern, plain) in pairs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} at {w}x{h}: non-finite output")
            err = float((got - want).abs().max())
            if name in ("level_derivs", "outer_prologue"):
                # relative: |got - want| <= rtol * |want| elementwise
                rel = (got - want).abs() / want.abs().clamp_min(1e-30)
                check = float(rel.max())
            else:
                check = err
            ok = check <= BOUNDS[name]
            row = {"phase": "kernel", "name": name, "shape": [h, w],
                   "max_abs_err": err, "checked": check, "bound": BOUNDS[name], "ok": ok}
            if (w, h) == SIZES[-1]:
                row["ms"] = cuda_ms(kern, 20)
                row["plain_ms"] = cuda_ms(plain, 5)
                table[name] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms")}
            else:
                table[name] = {"max_abs_err": err}
            emit(row)
            if not ok:
                raise AssertionError(f"{name} at {w}x{h}: {check} > {BOUNDS[name]}")
    return table


def expected_launches(w: int, h: int, cfg) -> dict:
    from tpuflow_torch.pyramid import level_schedule

    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    outer, inner = cfg.outer_iterations_count, cfg.inner_iterations_count
    return {"warp": n, "level_derivs": n, "outer_prologue": n * outer,
            "jacobi_sweep": n * outer * inner, "add_median": n, "levels": n}


def phase_e2e(w: int, h: int, counts_total: dict):
    """The main path at (w, h) with FlowConfig(); checks it and returns the
    pair for the timing phase."""
    import torch

    from tpuflow_torch import FlowConfig, compute_flow, endpoint_error
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.solver.level import PLAIN_STEPS, solve

    cfg = FlowConfig()
    f0, f1 = textured_pair(w, h)

    reset_launch_counts()
    res = compute_flow(f0, f1, cfg, device="cuda")
    counts = launch_counts()
    want = expected_launches(w, h, cfg)
    emit({"phase": "launches", "shape": [h, w], "levels": want["levels"],
          "counts": counts, "expected": {k: want[k] for k in counts}})
    for name, n in counts.items():
        if n == 0 or n != want[name]:
            raise AssertionError(f"{name}: {n} launches at {w}x{h}, expected {want[name]}")
        counts_total[name] = counts_total.get(name, 0) + n

    if res.u.shape != (h, w) or not (np.isfinite(res.u).all() and np.isfinite(res.v).all()):
        raise AssertionError(f"bad output at {w}x{h}: shape {res.u.shape}, or non-finite")
    with torch.cuda.device(0):
        uv = solve(torch.from_numpy(f0).cuda(), torch.from_numpy(f1).cuda(), cfg,
                   _steps=PLAIN_STEPS).cpu().numpy()
    epe_plain = endpoint_error(res.u, res.v, uv[0], uv[1])
    epe_shift = shift_epe(res.u, res.v)
    row = {"phase": "e2e", "shape": [h, w], "config": "FlowConfig()",
           "epe_kernel_vs_plain": epe_plain, "epe_vs_true_shift": epe_shift,
           "mean_u": float(res.u.mean()), "mean_v": float(res.v.mean())}
    checks = [("kernel_vs_plain", epe_plain, 1e-3), ("true_shift", epe_shift, 0.3)]
    if (w, h) == SIZES[0]:
        from tpuflow_torch import oracle_np

        t0 = time.perf_counter()
        ou, ov = oracle_np.compute_flow(f0, f1, **ORACLE_KW)
        row["oracle_seconds"] = time.perf_counter() - t0
        red = compute_flow(f0, f1, FlowConfig(**ORACLE_KW), device="cuda")
        row["epe_vs_oracle_reduced"] = endpoint_error(red.u, red.v, ou, ov)
        checks.append(("oracle_reduced", row["epe_vs_oracle_reduced"], 0.05))
    row["ok"] = all(v <= b for _, v, b in checks)
    emit(row)
    for name, v, b in checks:
        if not v <= b:
            raise AssertionError(f"{name} at {w}x{h}: {v} > {b}")
    return f0, f1


def phase_times(w: int, h: int, f0, f1, card: str):
    import torch

    from tpuflow_torch import FlowConfig, compute_flow
    from tpuflow_torch.solver.level import PLAIN_STEPS, solve

    cfg = FlowConfig()
    t0, t1 = torch.from_numpy(f0).cuda(), torch.from_numpy(f1).cuda()

    def kernel_pair():
        compute_flow(f0, f1, cfg, device="cuda")

    def plain_pair():
        solve(t0, t1, cfg, _steps=PLAIN_STEPS).cpu()

    row = {"phase": "times", "shape": [h, w], "card": card, "config": "FlowConfig()"}
    for label, fn, reps in (("kernel", kernel_pair, 5), ("plain", plain_pair, 3)):
        fn()  # warm-up pair
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        med = statistics.median(ms)
        row[f"{label}_ms_median"] = med
        row[f"{label}_ms_all"] = ms
        row[f"{label}_mpix_per_s"] = w * h / (med * 1e-3) / 1e6
    emit(row)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tpuflow_torch")):
        print("chip_smoke: run it from a checkout of the repo (tpuflow_torch/ is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    card = card_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    torch.cuda.set_device(0)

    from tpuflow_torch.ops.cuda_lib import load_library

    lib = load_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": lib.build_seconds, "library": os.path.relpath(lib.path, REPO),
          "ptxas": ptxas})

    table = phase_kernels()
    counts, pairs = {}, {}
    for w, h in SIZES:
        pairs[(w, h)] = phase_e2e(w, h, counts)
    emit({"phase": "launch_totals", "counts": counts})
    for w, h in SIZES:
        phase_times(w, h, *pairs[(w, h)], card)

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": "tpuflow_torch/csrc/level.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": table[name]["max_abs_err"], "ms": table[name]["ms"],
         "plain_ms": table[name]["plain_ms"]}
        for name in BOUNDS]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

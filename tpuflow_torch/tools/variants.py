"""Time three kernels against the design choices they did not take, on the card.

    python -m tpuflow_torch.tools.variants [--only NAME ...] [--out FILE]   # on a CUDA card

The kernels are the row-sharded relaxation (csrc/sharded.cu), the log
tensor (csrc/level.cu: level_tensor_log_kernel) and the banded X pass
(csrc/banded.cu: banded_x_kernel); one variant takes out the sharded
kernel's count of its grid syncs, to time what counting costs. ``--only``
runs the variants named (each time with its source's kernels alone). Each variant is this
package with a few named edits to its CUDA sources (``VARIANTS``): a
variant that no longer applies to the sources raises instead of timing the
shipped code. The script copies the package into ``_build/variants/<name>/``
(ignored by git), edits the copy, and runs ``measure`` in a process of its
own from there, which builds that copy's kernels. The processes run in
turns, the shipped package first and last (shipped, each variant, each
variant again in reverse order, shipped), so that a drift of the card over
the run shows. Each prints one JSON line: the card's name and power limit;
the ms of ``relax_sharded_kernel`` (grey ``FlowConfig()``, k = 1) on the
level-0 fields of 1920x1080 and 3840x2160 at 1 and 4 shards, by CUDA events
over 3 calls, twice; the ms of the log tensor at the same sizes by
CUDA-graph replay, twice; the ms of the banded X launch of a 3840x2160
``models.full_model()`` pair's frame pyramid and of its presmooth, by
CUDA-graph replay, twice; and a hash of each output. A variant is another
schedule of the same arithmetic, so its hashes must be the shipped ones.
The last line holds every time of each variant beside the shipped ones.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.ops.cuda_lib import BUILD_DIR

_PKG = Path(__file__).resolve().parent.parent
SIZES = ((1920, 1080), (3840, 2160))
N_Y = (1, 4)

# The sharded kernel's prologue tiles as shipped: each one staged by
# cp.async while the one before finishes ...
_STAGED_FROM = "    // The block's prologue tiles, each staged while the one before finishes.\n"
_STAGED_TO = "    grid_sync(grid, syncs);\n    for (int done = 0;"
# ... and one after another, staged and finished in turn (no tile in flight).
_IN_TURN = """\
    const float* T = buf + cur * n;
    for (int t = bis; t < pro_tiles; t += bps) {
      const int ty = t / pro_x, tx = t - ty * pro_x;
      tf_body::prologue_tile<SH_PRO_TW, TENSOR>(sm.pro[0], T, uv, fxyz, J, hoist,
                                                tx * SH_PRO_TW, ty * PRO_TH, prow, w, gy0, h,
                                                div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2,
                                                e_d2);
      __syncthreads();
    }
"""
# name: edits, each (source in csrc/, start, stop, replacement). The text
# from `start` up to the next `stop` (or `start` alone, where `stop` is
# None) is replaced; `start` must occur exactly once.
VARIANTS = {
    # two 512-thread blocks an SM: 64 registers a thread, a grid twice as large
    "two_blocks_an_sm": (("sharded.cu", "__launch_bounds__(THREADS, 1)", None,
                          "__launch_bounds__(THREADS, 2)"),),
    # the prologue tiles staged and finished in turn (tf_body::prologue_tile)
    "no_staging": (("sharded.cu", _STAGED_FROM, _STAGED_TO, _IN_TURN),),
    # no count of the grid syncs (the shipped kernel tests a null pointer)
    "no_sync_counter": (("sharded.cu", "  if (syncs != nullptr && blockIdx.x == 0", "}\n", ""),),
    # the log tensor's tile as tall as its 32 x 8 block
    "log_tile_8_rows": (("level.cu", "constexpr int LT_TH = 16;", None,
                         "constexpr int LT_TH = 8;"),),
    # rows too wide for two buffers of 8 (4K's) staged as two buffers of 4
    # rows, the same bytes, in place of one buffer of 8
    "x_four_rows_two_buffers": (("banded.cu", "launch_x<true, 8>(dev, card, a, 1,", None,
                                 "launch_x<true, 4>(dev, card, a, 2,"),),
}
# the kernels ``measure`` times for a variant of each source
PARTS = {"sharded.cu": "sharded", "level.cu": "log", "banded.cu": "banded"}


def apply_edits(text: str, edits) -> str:
    """``text`` with each (start, stop, replacement) of ``VARIANTS``
    applied; raises where one does not apply."""
    for start, stop, new in edits:
        if text.count(start) != 1:
            raise ValueError(f"the variant's edit does not apply: {start!r} occurs "
                             f"{text.count(start)} times")
        i = text.index(start)
        j = i + len(start) if stop is None else text.index(stop, i + len(start))
        text = text[:i] + new + text[j:]
    return text


def make_copy(name: str, edits) -> Path:
    """The package copied to _build/variants/<name>/tpuflow_torch with
    ``edits`` applied to its csrc/; returns the directory that holds it."""
    root = BUILD_DIR / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, root / "tpuflow_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = root / "tpuflow_torch" / "csrc"
    for src in sorted({e[0] for e in edits}):
        path = csrc / src
        path.write_text(apply_edits(path.read_text(), [e[1:] for e in edits if e[0] == src]))
    return root


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def measure(parts) -> dict:
    """The times and output hashes of the package this process imports, of
    the kernels named in ``parts`` (``PARTS``' values)."""
    import tpuflow_torch
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import level_derivs, level_tensor
    from tpuflow_torch.parallel import make_mesh, relax_sharded_kernel
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import cuda_ms, device_info, graph_ms

    torch.cuda.set_device(0)
    cfg, dev = FlowConfig(), torch.device("cuda")
    row = {"package": str(Path(tpuflow_torch.__file__).resolve().parent),
           "card": device_info()["nvidia_smi"], "ms": {}, "hash": {}}
    if "banded" in parts:
        _measure_banded(row)
    for w, h in SIZES if {"log", "sharded"} & set(parts) else ():
        rng = np.random.default_rng(1)
        f0, f1 = (torch.from_numpy(np.clip(f, 0.0, 255.0)).to(dev)
                  for f in textured_pair(w, h, seed=1))
        uv = torch.from_numpy((rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)).to(dev)
        sc = LevelScalars.make(w, h, 1.0, 1.0, cfg.equation_alpha)
        fxyz = level_derivs(f0, f1, sc.div4hx, sc.div4hy)
        log = lambda: level_tensor(f0, f1, fxyz, sc, True)  # noqa: E731
        if "log" in parts:
            row["hash"][f"log_{w}x{h}"] = _digest(log())
            row["ms"][f"log_{w}x{h}"] = [graph_ms(log, calls=20, replays=5) for _ in range(2)]
        for n_y in N_Y if "sharded" in parts else ():
            fn = lambda m=make_mesh(n_y): relax_sharded_kernel(fxyz, uv, sc, cfg, m)  # noqa: E731
            row["hash"][f"sharded_{w}x{h}_{n_y}"] = _digest(fn())
            row["ms"][f"sharded_{w}x{h}_{n_y}"] = [cuda_ms(fn, 3) for _ in range(2)]
        del f0, f1, uv, fxyz
        torch.cuda.empty_cache()
    return row


def _measure_banded(row: dict) -> None:
    """The banded X launches of a 3840x2160 ``full_model()`` pair: its frame
    pyramid's (from the smoothed pair) and its presmooth's, into ``row``."""
    from tpuflow_torch import models
    from tpuflow_torch.ops.banded import banded_x
    from tpuflow_torch.ops.gaussian import gaussian_band, gaussian_smooth
    from tpuflow_torch.ops.resample import resample_band
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.tools.roofline import graph_ms

    w, h = SIZES[-1]
    cfg = models.full_model()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    sizes = dict.fromkeys((s.width, s.height) for s in specs
                          if s.level != 0 and (s.width, s.height) != (w, h))
    rng = np.random.default_rng(2)
    pair = torch.from_numpy((rng.random((2, h, w)) * 255.0).astype(np.float32)).cuda()
    smoothed = gaussian_smooth(pair, cfg.gaussian_sigma)
    calls = {"pyramid_x": (smoothed, tuple((resample_band, w, ow) for ow, _ in sizes)),
             "presmooth_x": (pair, ((gaussian_band, w, cfg.gaussian_sigma),))}
    for name, (img, xs) in calls.items():
        fn = lambda img=img, xs=xs: banded_x(img, xs)  # noqa: E731
        row["hash"][f"banded_{name}_{w}x{h}"] = _digest(fn())
        row["ms"][f"banded_{name}_{w}x{h}"] = [graph_ms(fn, calls=1, replays=5)
                                               for _ in range(2)]
    del pair, smoothed, calls
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), help="these variants alone")
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tools.variants times a CUDA card, and none is available")
    if args.measure is not None:
        print(json.dumps(measure(args.measure.split(","))), flush=True)
        return 0
    chosen = {n: VARIANTS[n] for n in args.only or VARIANTS}
    parts = ",".join(sorted({PARTS[e[0]] for edits in chosen.values() for e in edits}))
    roots = {"shipped": _PKG.parent, **{n: make_copy(n, e) for n, e in chosen.items()}}
    order = ["shipped", *chosen, *reversed(chosen), "shipped"]
    lines, runs = [], {name: [] for name in roots}
    for name in order:
        env = {**os.environ, "PYTHONPATH": str(roots[name])}
        out = subprocess.run([sys.executable, "-m", "tpuflow_torch.tools.variants", "--measure",
                              parts], cwd=roots[name], env=env, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{out.stdout}\n{out.stderr}")
        row = {"variant": name, **json.loads(out.stdout.strip().splitlines()[-1])}
        if Path(row["package"]) != (roots[name] / "tpuflow_torch").resolve():
            raise RuntimeError(f"variant {name} imported {row['package']}")
        runs[name].append(row)
        lines.append(row)
        print(json.dumps(row), flush=True)
    shipped = runs["shipped"][0]["hash"]
    differs = {name: [k for r in rs for k, v in r["hash"].items() if v != shipped[k]]
               for name, rs in runs.items()}
    summary = {"card": runs["shipped"][0]["card"], "bitwise": {n: not d for n, d in differs.items()},
               "ms": {k: {name: [t for r in rs for t in r["ms"][k]] for name, rs in runs.items()}
                      for k in shipped}}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    if any(differs.values()):
        raise AssertionError(f"a variant's output differs from the shipped kernels': {differs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

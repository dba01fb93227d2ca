"""Roofline accounting for the production relaxation sweep on one H100.

    python -m tpuflow_torch.tools.roofline [K_lo K_hi rounds]   # on a CUDA card; raises without one

The port of tools/roofline.py. It decomposes what bounds the sweep:

1. Component microkernels on a (392, 640) field: the per-pass cost of a
   streaming add, an x-shifted add, a y-shifted add, a multiply-add, a
   divide and the phi transcendental 1/(2 sqrt). Each is one launch of
   ``roofline_micro`` (csrc/probes.cu), which keeps 8 read-only fields in
   shared memory and carries x in registers through ``PASSES`` passes, so
   the rates are those of shared-memory loads and of the arithmetic, the
   on-chip store a k-sweep relaxation would run from. Times are the slope
   over K chained calls, by CUDA events.
2. The production T-form sweep, measured by differencing: the port's own
   ``solver/level.py::relax`` on exact-size fields at inner = 5 and inner =
   2 gives 3 x outer extra sweeps; the slope is the per-sweep device cost
   with the prologue and launch costs cancelled. It runs at 584x388 and
   3840x2160, once with the one-sweep kernel chained (``CHAIN_STEPS``, one
   launch per sweep) and once with the main path's k-sweep kernel (one
   launch per outer). At 584x388 a sweep is a few microseconds of device
   time against tens of host microseconds per launch, so each chain is
   captured in a CUDA graph and replayed: the events then time the device.
3. A sweep time predicted from the component rates and the one-sweep
   kernel's per-pixel operand counts (``SWEEP_COUNTS``, counted from
   ``jacobi_sweep_kernel``), printed against the measurement.

``kernel_work`` gives every kernel of the port its bytes, operations and
bound on this card, and ``pair_bounds`` its sum over one pair's levels.
``graph_ms`` times a kernel of a few µs on the device, by CUDA-graph
replay. Prints the component lines and one final JSON line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from typing import Callable

import numpy as np
import torch

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.cuda_lib import launch, on_cuda

HB, WB = 392, 640          # the probe's field (the TPU's 584x388 bucket)
N_IN = 8                   # input fields cycled by the bodies
UNROLL = 8
T_LOOP = 1024              # loop trips -> 8192 passes per call
PASSES = T_LOOP * UNROLL
FIELD_BYTES = HB * WB * 4
MAX_WIDTH = 1024           # one thread per column in the kernel's blocks
BAND = 3                   # rows per block of roofline_micro_kernel (csrc/probes.cu)

# The card's published peaks (H100 SXM, 700 W): device memory, float32
# outside the tensor cores. 67 TFLOP/s counts an FFMA as 2; every float32
# instruction, an add or a min as much as an FFMA, takes one of half as many
# issue slots (132 SMs x 128 lanes x 1.98 GHz). Shared memory moves 128 B
# per SM per clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
F32_ISSUE_PER_S = PEAK_FLOPS / 2
SHARED_BYTES_PER_S = 132 * 128 * 1.98e9
# NVLink 4 between the H100s of one host: 450 GB/s each way (published).
NVLINK_BYTES_PER_S = 450e9


def _shift_xp(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, 1:], a[:, -2:-1]], dim=1)


def _shift_yp(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[1:, :], a[-2:-1, :]], dim=0)


# name -> (body(x, a_j), accounting dict). Accounting is per pass per pixel
# of the Hopper kernel: shared-memory loads and stores, plain flops, shifted
# reads, divides, sqrts. The carry x lives in a register, so a pass loads
# one value (a_j) and stores none; the TPU kernel loaded x and a_j from VMEM
# and stored x.
BODIES = {
    "stream": (lambda x, a: x + a,
               dict(loads=1, stores=0, flops=1, rot=0, div=0, sqrt=0)),
    "shift_x": (lambda x, a: x + _shift_xp(a),
                dict(loads=1, stores=0, flops=1, rot=1, div=0, sqrt=0)),
    "shift_y": (lambda x, a: x + _shift_yp(a),
                dict(loads=1, stores=0, flops=1, rot=1, div=0, sqrt=0)),
    "fma": (lambda x, a: x * a + 1.25,
            dict(loads=1, stores=0, flops=2, rot=0, div=0, sqrt=0)),
    "div": (lambda x, a: a / (x + 1.0),
            dict(loads=1, stores=0, flops=1, rot=0, div=1, sqrt=0)),
    "phi": (lambda x, a: 1.0 / (2.0 * torch.sqrt(x * x + a)),
            dict(loads=1, stores=0, flops=2, rot=0, div=1, sqrt=1)),
}

# The production T-form sweep's per-pixel operand counts, from
# jacobi_sweep_kernel (csrc/level.cu): 8 shifted reads (tu, tv at 4
# neighbours) + 1 centre (tv) + 11 plain reads (u, v, 9 hoists), 2 writes;
# 33 flops besides the 2 divides. The TPU's kernel read both centres.
SWEEP_COUNTS = dict(loads=20, stores=2, flops=33, rot=8, div=2, sqrt=0)


# ---------------------------------------------------------------------------
# The roofline microkernel (tools/roofline.py:88) and its plain version
# ---------------------------------------------------------------------------


def roofline_micro_plain(name: str, x0: torch.Tensor, rest: torch.Tensor,
                         t_loop: int) -> torch.Tensor:
    """``t_loop * UNROLL`` passes x = body(x, a_j) from x = a_0 * 0.5, where
    a_0 = x0 and a_1..a_7 = rest; pass j of each group reads a_j."""
    body = BODIES[name][0]
    ins = [x0, *rest]
    x = x0 * 0.5
    for _ in range(t_loop):
        for j in range(UNROLL):
            x = body(x, ins[j])
    return x


def roofline_micro(name: str, x0: torch.Tensor, rest: torch.Tensor,
                   t_loop: int) -> torch.Tensor:
    """The (h, w) result of ``t_loop * UNROLL`` passes of body ``name``: the
    kernel on CUDA tensors, the plain version on CPU tensors. x0 is (h, w),
    rest (N_IN - 1, h, w)."""
    h, w = x0.shape
    if rest.shape != (N_IN - 1, h, w):
        raise ValueError(f"rest: expected {(N_IN - 1, h, w)}, got {tuple(rest.shape)}")
    if not 2 <= h or not 2 <= w <= MAX_WIDTH:
        raise ValueError(f"field must be at least 2x2 and at most {MAX_WIDTH} wide, got {h}x{w}")
    if t_loop < 0:
        raise ValueError(f"t_loop must be >= 0, got {t_loop}")
    if not on_cuda(x0, rest):
        return roofline_micro_plain(name, x0, rest, t_loop)
    out = torch.empty_like(x0)
    launch("tf_roofline_micro", x0.data_ptr(), rest.data_ptr(), out.data_ptr(), h, w,
           int(t_loop), list(BODIES).index(name))
    roofline_micro.launches += 1
    return out


roofline_micro.launches = 0


def microkernel(name: str) -> Callable:
    """``chained(ins, k)``: k chained calls of body ``name`` over ``ins``
    (N_IN, h, w), each feeding the next, data-dependent to defeat reuse
    (tools/roofline.py:113-124). Reads ``T_LOOP`` when called."""
    if name not in BODIES:
        raise KeyError(f"unknown body {name!r}; one of {list(BODIES)}")

    def chained(ins: torch.Tensor, k: int) -> torch.Tensor:
        x, rest = ins[0], ins[1:]
        for _ in range(k):
            y = roofline_micro(name, x, rest, T_LOOP)
            x = x + 0.0001 * y
        return x

    return chained


# ---------------------------------------------------------------------------
# Work and bound of every kernel
# ---------------------------------------------------------------------------

# Float32 (instructions, flops) of one call of the library routines as the
# kernels use them (IEEE, no fast math): the arithmetic of their common
# path in the kernels' sm_90a code (``sass_counts``; nvcc of CUDA 12.8), an
# FFMA one instruction and 2 flops. A divide is MUFU.RCP, 5 FFMA and FCHK;
# 1/x is MUFU.RCP, 2 FFMA and FADD; sqrtf MUFU.RSQ, 2 FMUL and 2 FFMA;
# log1pf 11 FFMA and 7 other instructions.
LIBRARY_OPS = {"div": (7, 12), "rcp": (4, 6), "sqrt": (5, 7), "log1p": (18, 29)}

# The work each function needs, per pixel: its arithmetic as the kernel's
# source in csrc/level.cu writes it (no multiply-add is contracted, so
# "plain" operations are one instruction and one flop each), except where
# a kernel recomputes a value that a neighbour's thread also computes: phi
# and log1pf count once per pixel, and the median is one selection network.
# phi: 4 differences (sub, divide), |grad|^2 (4 mul, 4 add), 1/(2 sqrt)
_PHI = Counter(plain=4 + 8 + 1, div=4, sqrt=1, rcp=1)
# outer_prologue: phi, 4 edge weights, 4 pw (add, 2 mul), their sum, du
# and dv, the ksi quadratic (25), max, ksi (add, sqrt, mul, 1/x),
# a12/a13/a23, dnu/dnv (mul, add)
_PROLOGUE = _PHI + Counter(plain=4 + 12 + 3 + 2 + 25 + 1 + 2 + 3 + 4, sqrt=1, rcp=1)
# name -> (planes read, planes written, operations per pixel)
_LEVEL_WORK = {
    # 2 coordinates (mul, add), 4 bounds tests, 2 floors, 2 fractions,
    # 2 complements, 4 weights, 4 taps summed
    "warp": (4, 1, Counter(plain=4 + 4 + 2 + 2 + 2 + 4 + 7)),
    # fx, fy: 3 adds and a divide each; ft: 1
    "level_derivs": (2, 3, Counter(plain=7, div=2)),
    # 5 second differences (sub, mul), 5 products of two terms
    "level_tensor_gradient": (3, 5, Counter(plain=10 + 15)),
    # the same over the level_derivs stencil of log1pf of the two frames:
    # 2 log1pf per pixel (the kernel evaluates 32, at the 4 clamped
    # neighbours)
    "level_tensor_log": (2, 5, Counter(plain=10 + 15 + 7, div=2, log1p=2)),
    # T x2, u, v, fxyz read, 9 hoists written; the grey J (5 mul)
    "outer_prologue": (7, 9, _PROLOGUE + Counter(plain=5)),
    # the same reading J (5 planes) instead of forming the grey products
    "outer_prologue_tensor": (12, 9, _PROLOGUE),
    # T x2, u, v, 9 hoists read, T' x2 written
    "jacobi_sweep": (15, 2, Counter(plain=SWEEP_COUNTS["flops"], div=SWEEP_COUNTS["div"])),
}
# Compare-exchanges of the smallest known median network over N values
# (Paeth's 3x3, Devillard's 5x5); the kernel runs a full odd-even
# transposition sort, N(N-1)/2.
MEDIAN_NETWORK = {1: 0, 9: 19, 25: 99}
# roofline_micro per pass per pixel, from each body's expression
_BODY_OPS = {"stream": Counter(plain=1), "shift_x": Counter(plain=1),
             "shift_y": Counter(plain=1), "fma": Counter(plain=2),
             "div": Counter(plain=1, div=1), "phi": Counter(plain=3, sqrt=1, rcp=1)}


def _median_work(radius: int) -> tuple:
    """add_median<R>: T and u read, the 2 planes written; per plane the sum
    u + (T - u) once (sub, add) and the median network (a min and a max per
    compare-exchange)."""
    n = radius * radius
    if n not in MEDIAN_NETWORK:
        raise KeyError(f"no median network counted for a {radius}x{radius} window")
    return 4, 2, Counter(plain=2 * (2 + 2 * MEDIAN_NETWORK[n]))


def _instructions_and_flops(ops: Counter) -> tuple:
    instr = ops["plain"] + sum(ops[k] * n for k, (n, _) in LIBRARY_OPS.items())
    flops = ops["plain"] + sum(ops[k] * f for k, (_, f) in LIBRARY_OPS.items())
    return instr, flops


def _sharded_work(h: int, w: int, n_y: int, k: int, cfg: FlowConfig) -> tuple:
    """(bytes, instructions, flops, design bytes) of one relax_sharded
    launch under ``cfg``. What the function needs: uv, fxyz and, with the
    gradient/log tensor, J read once, T written once, and ``outer``
    prologues and ``outer * inner`` sweeps of arithmetic over the h x w
    owned pixels, whatever the shard count. The design bytes are what the
    kernel streams (csrc/sharded.cu): the copy-in and copy-out of the owned
    rows; per outer, over every shard's padded rows (halo = k (inner + 1)
    rows toward each neighbour shard), its prologue tiles
    (``_prologue_design_bytes``, 64 wide) and ceil(inner / KMAX) passes of
    k-sweep regions (``_ksweep_design_bytes``); and the pushes: the
    iterate's halos (2 planes, each way across each of the n_y - 1 shard
    boundaries, read and written) once every k outers, the constants' (uv,
    fxyz, J) once."""
    from tpuflow_torch.ops.level import KMAX
    from tpuflow_torch.parallel.halo import row_split
    from tpuflow_torch.parallel.halo_kernel import SHARDED_PROLOGUE_TW

    outer, inner = cfg.outer_iterations_count, cfg.inner_iterations_count
    tensor = cfg.data_constancy != DataConstancy.GREY
    halo = k * (inner + 1)
    consts = 2 + 3 + (5 if tensor else 0)
    passes = [min(KMAX, inner - done) for done in range(0, inner, KMAX)]
    design = (consts + (consts + 2) + 2 + 2) * h * w * 4   # copy-in, copy-out
    for sh in row_split(h, n_y, halo):
        design += outer * (_prologue_design_bytes(sh.padded, w, tensor, SHARDED_PROLOGUE_TW)
                           + sum(_ksweep_design_bytes(sh.padded, w, kk) for kk in passes))
    plane_halos = (n_y - 1) * 2 * halo * w * 4 * 2   # boundaries x ways x rows x w x 4 B, r + w
    design += -(-outer // k) * 2 * plane_halos + consts * plane_halos
    nbytes = (consts + 2) * h * w * 4
    pro_ops = _LEVEL_WORK["outer_prologue_tensor" if tensor else "outer_prologue"][2]
    pro_i, pro_f = _instructions_and_flops(pro_ops)
    sw_i, sw_f = _instructions_and_flops(_LEVEL_WORK["jacobi_sweep"][2])
    return (nbytes, h * w * outer * (pro_i + inner * sw_i),
            h * w * outer * (pro_f + inner * sw_f), design)


def _prologue_design_bytes(h: int, w: int, tensor: bool, tw: int) -> int:
    """The bytes one pass of tw x 8 prologue tiles over an (h, w) block
    streams: per tile T's 2 planes over the tile and its 2-pixel ring, the
    5 (grey) or 10 (with J) planes read once over the tile, the 9 hoists
    written."""
    from tpuflow_torch.ops.level import prologue_tiles

    once = 5 + (5 if tensor else 0) + 9
    total = 0
    for (sy0, sy1, sx0, sx1), (y0, y1, x0, x1) in prologue_tiles(h, w, tw):
        total += 2 * (sy1 - sy0) * (sx1 - sx0) + once * (y1 - y0) * (x1 - x0)
    return total * 4


def _ksweep_design_bytes(h: int, w: int, inner: int) -> int:
    """The bytes one jacobi_sweeps launch of ``inner`` sweeps streams: per
    block T's 2 planes over its region (the tile and a k-pixel ring), u, v
    and the 9 hoists over the pixels its first sweep updates (the region
    less one pixel on each side that is not an image edge), the 2 planes of
    its tile written."""
    from tpuflow_torch.ops.level import ksweep_tiles

    total = 0
    for (ry0, ry1, rx0, rx1), (ty0, ty1, tx0, tx1) in ksweep_tiles(h, w, inner):
        first = ((ry1 - ry0 - (ry0 > 0) - (ry1 < h)) * (rx1 - rx0 - (rx0 > 0) - (rx1 < w)))
        total += 2 * (ry1 - ry0) * (rx1 - rx0) + 11 * first + 2 * (ty1 - ty0) * (tx1 - tx0)
    return total * 4


def _banded_work(name: str, h: int, w: int, out_n, sigma: float | None, planes: int,
                 widths: tuple | None = None) -> tuple:
    """(bytes, instructions) of one banded launch over (planes, h, w): the
    input and the launch's plan (``ops/banded.py``) read once, every
    output written once; a multiply and an add per term of each output's
    window and one multiply by norm, counted from the bands' own windows.
    ``banded_x`` sums every width of ``out_n`` (an int or a tuple, one a
    level) from the same rows; ``banded_y`` sums level l's ``widths[l]``
    columns (default w) to ``out_n[l]`` rows, each level reading its own
    columns; with ``sigma`` the Gaussian's band, one level."""
    from tpuflow_torch.ops.banded import x_plan, y_plan
    from tpuflow_torch.ops.gaussian import gaussian_band
    from tpuflow_torch.ops.resample import resample_band

    along = w if name == "banded_x" else h
    if sigma:
        specs = ((gaussian_band, along, float(sigma)),)
    else:
        outs = out_n if isinstance(out_n, tuple) else (out_n,)
        specs = tuple((resample_band, along, o) for o in outs)
    bands = [build(n, a) for build, n, a in specs]
    if name == "banded_x":
        plan = x_plan(specs)
        nbytes = planes * h * (w + sum(b.out_n for b in bands)) * 4
        instr = sum(planes * h * (2 * int(b.count.sum()) + b.out_n) for b in bands)
    else:
        widths = widths or (w,) * len(bands)
        plan = y_plan(specs, widths, planes)
        nbytes = sum(planes * (h + b.out_n) * cols for b, cols in zip(bands, widths)) * 4
        instr = sum(planes * cols * (2 * int(b.count.sum()) + b.out_n)
                    for b, cols in zip(bands, widths))
    return nbytes + plan.nbytes, instr


def kernel_work(name: str, h: int, w: int, radius: int = 5, *, n_y: int = 1, k: int = 1,
                cfg: FlowConfig | None = None, inner: int = 5, cards: int = 1,
                out_n: int | tuple | None = None, sigma: float | None = None,
                planes: int = 2, widths: tuple | None = None) -> dict:
    """What one launch of kernel ``name`` on an (h, w) level needs, and its
    bound on this card: the largest of device-memory bytes over the memory
    rate (each input byte read once, each output byte written once),
    shared-memory bytes over the shared-memory rate, and float32
    instructions over the issue rate, in ms. ``bound_by`` is "bytes" for
    either memory, "operations" for the issue rate; ``resource`` names it.

    Names: the keys of ``_LEVEL_WORK``, ``add_median`` (window side
    ``radius``), ``jacobi_sweeps`` (one launch of ``inner`` <= KMAX sweeps:
    13 planes read and 2 written once, ``inner`` sweeps of arithmetic; its
    ``design_bytes`` are what the kernel's overlapping tiles stream),
    ``relax_sharded`` (one level's relaxation under ``cfg``,
    default ``FlowConfig()``, over ``n_y`` shards, halos every ``k`` outers:
    ``_sharded_work``; its ``design_bytes`` are the bytes the kernel streams:
    its tiles, regions, pushes and copies; over ``cards`` cards its bound is
    the arithmetic and the planes split ``cards`` ways plus ``nvlink_bytes``,
    the halos one card sends one neighbour card, at NVLINK_BYTES_PER_S),
    ``roofline_micro_<body>`` (one call of
    ``PASSES`` passes on an (h, w) field, one shared-memory load per pass by
    the probe's design), ``probe_matmul`` ((h, H0) @ (H0, w), one FFMA
    per product) and ``banded_x``/``banded_y`` (one banded launch over
    ``planes`` (h, w) planes along x or y: the resample's to ``out_n``, a
    tuple for every level of the frame pyramid (with ``widths``, each
    level's columns, along y), or with ``sigma`` the Gaussian's;
    ``_banded_work``)."""
    npix = h * w
    shared = 0
    extra = {}
    if name == "relax_sharded":
        nbytes, instr, flops, extra["design_bytes"] = _sharded_work(h, w, n_y, k,
                                                                    cfg or FlowConfig())
    elif name == "jacobi_sweeps":
        from tpuflow_torch.ops.level import KMAX

        if not 1 <= inner <= KMAX:
            raise ValueError(f"one jacobi_sweeps launch runs 1..{KMAX} sweeps, not {inner}")
        nbytes = (13 + 2) * npix * 4   # a sweep's planes, each moved once
        ops = _LEVEL_WORK["jacobi_sweep"][2]
        instr, flops = (inner * npix * n for n in _instructions_and_flops(ops))
        extra["design_bytes"] = _ksweep_design_bytes(h, w, inner)
    elif name in _LEVEL_WORK or name == "add_median":
        planes_in, planes_out, ops = (_LEVEL_WORK[name] if name in _LEVEL_WORK
                                      else _median_work(radius))
        nbytes = (planes_in + planes_out) * npix * 4
        instr, flops = (npix * n for n in _instructions_and_flops(ops))
    elif name.startswith("roofline_micro_"):
        body = name[len("roofline_micro_"):]
        nbytes = (N_IN + 1) * npix * 4
        shared = PASSES * npix * BODIES[body][1]["loads"] * 4
        instr, flops = (PASSES * npix * n for n in _instructions_and_flops(_BODY_OPS[body]))
    elif name in ("banded_x", "banded_y"):
        nbytes, instr = _banded_work(name, h, w, out_n, sigma, planes, widths)
        flops = instr
    elif name == "probe_matmul":
        from tpuflow_torch.tools.probe_kernel_matmul import H0

        nbytes = (h * H0 + H0 * w + h * w) * 4
        instr, flops = h * w * H0, 2 * h * w * H0
    else:
        raise KeyError(f"no work count for kernel {name!r}")
    if cards > 1 and name != "relax_sharded":
        raise ValueError(f"only relax_sharded runs over several cards, not {name!r}")
    times = {"device memory": nbytes / cards / PEAK_BYTES_PER_S * 1e3,
             "shared memory": shared / SHARED_BYTES_PER_S * 1e3,
             "float32 issue": instr / cards / F32_ISSUE_PER_S * 1e3}
    resource = max(times, key=times.get)
    link_ms = 0.0
    if cards > 1:
        cfg = cfg or FlowConfig()
        consts = 5 if cfg.data_constancy == DataConstancy.GREY else 10
        halo = k * (cfg.inner_iterations_count + 1)
        exchanges = -(-cfg.outer_iterations_count // k)
        extra["nvlink_bytes"] = (consts + 2 * exchanges) * halo * w * 4
        link_ms = extra["nvlink_bytes"] / NVLINK_BYTES_PER_S * 1e3
        extra.update(cards=cards, nvlink_ms=link_ms)
    return {"bytes": nbytes, "shared_bytes": shared, "instructions": instr, "flops": flops,
            "bound_ms": times[resource] + link_ms, "resource": resource,
            "bound_by": "operations" if resource == "float32 issue" else "bytes", **extra}


def level_launches(cfg: FlowConfig | None = None) -> list:
    """The launches one level of the level path (``solver/level.py``) makes
    under ``cfg`` (default ``FlowConfig()``), as (``kernel_work`` name,
    launches, ``kernel_work`` keyword arguments): the inner loop of each
    outer iteration is ceil(inner / KMAX) jacobi_sweeps launches of at most
    KMAX sweeps each, none for ``inner`` = 0."""
    from tpuflow_torch.ops.level import KMAX
    from tpuflow_torch.ops.median import effective_radius

    cfg = cfg or FlowConfig()
    outer, inner = cfg.outer_iterations_count, cfg.inner_iterations_count
    tensor = cfg.data_constancy != DataConstancy.GREY
    out = [("warp", 1, {}), ("level_derivs", 1, {}),
           ("add_median", 1, {"radius": effective_radius(cfg.median_radius)}),
           ("outer_prologue_tensor" if tensor else "outer_prologue", outer, {})]
    out += [("jacobi_sweeps", outer, {"inner": min(KMAX, inner - done)})
            for done in range(0, inner, KMAX)]
    if tensor:
        log = cfg.data_constancy == DataConstancy.LOG_DERIVATIVES
        out.append(("level_tensor_log" if log else "level_tensor_gradient", 1, {}))
    return out


def level_bound_ms(h: int, w: int, cfg: FlowConfig | None = None) -> float:
    """The sum of launches x bound of the launches of one (h, w) level
    (``level_launches``)."""
    return sum(n * kernel_work(name, h, w, **kw)["bound_ms"]
               for name, n, kw in level_launches(cfg))


def banded_launches(w: int, h: int, cfg: FlowConfig | None = None,
                    levels: range | None = None, smooth: bool = True) -> list:
    """The banded kernels' launches of one (w, h) pair (``solver/level.py``)
    under ``cfg``, or of the positions ``levels`` of its schedule, as
    (``kernel_work`` name, h, w, keyword arguments), in the solve's order:
    the presmooth's two passes over the full-size pair (none at sigma <= 0
    or without ``smooth``); the frame pyramid, one X launch (every level's
    width from the pair's rows) and one Y launch (each level's columns to
    its height), for each distinct size of the levels but level 0 and the
    full size (none if there is none); then each level's flow from the level
    before (not at the coarsest, nor where the size stays), X then Y."""
    from tpuflow_torch.pyramid import level_schedule

    cfg = cfg or FlowConfig()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    levels = range(len(specs)) if levels is None else levels
    out = []
    if smooth and cfg.gaussian_sigma > 0.0:
        sigma = float(cfg.gaussian_sigma)
        out += [("banded_x", h, w, {"sigma": sigma}), ("banded_y", h, w, {"sigma": sigma})]
    sizes = tuple(dict.fromkeys((specs[p].width, specs[p].height) for p in levels
                                if specs[p].level != 0
                                and (specs[p].width, specs[p].height) != (w, h)))
    if sizes:
        widths, heights = zip(*sizes)
        out += [("banded_x", h, w, {"out_n": widths}),
                ("banded_y", h, w, {"out_n": heights, "widths": widths})]
    for p in levels:
        prev, s = (specs[p - 1] if p > 0 else None), specs[p]
        if prev is not None and (prev.height, prev.width) != (s.height, s.width):
            out += [("banded_x", prev.height, prev.width, {"out_n": s.width}),
                    ("banded_y", prev.height, s.width, {"out_n": s.height})]
    return out


def pair_bounds(w: int, h: int, cfg: FlowConfig | None = None) -> dict:
    """{kernel: {"launches", "bound_ms"}} of one (w, h) pair of the level
    path (``solver/level.py``) under ``cfg`` (default ``FlowConfig()``):
    each level kernel's launches over the level schedule, and the sum over
    the levels of launches x ``kernel_work`` at the level's own size; and
    the banded kernels' launches along x and y (``banded_launches``: the
    presmooth, the frame pyramid and every level's flow), each at its own
    sizes. The
    pyramid's levels are smaller than level 0, so this is the bound a pair's
    device time by kernel (``profile_pair``) is read against, not launches
    x the level-0 bound."""
    from tpuflow_torch.pyramid import level_schedule

    cfg = cfg or FlowConfig()
    per_level = level_launches(cfg)
    out = {name: {"launches": 0, "bound_ms": 0.0} for name, _, _ in per_level}
    for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
        for name, n, kw in per_level:
            out[name]["launches"] += n
            out[name]["bound_ms"] += n * kernel_work(name, s.height, s.width, **kw)["bound_ms"]
    for name, lh, lw, kw in banded_launches(w, h, cfg):
        entry = out.setdefault(name, {"launches": 0, "bound_ms": 0.0})
        entry["launches"] += 1
        entry["bound_ms"] += kernel_work(name, lh, lw, **kw)["bound_ms"]
    return out


# ---------------------------------------------------------------------------
# Measurement helpers (CUDA only)
# ---------------------------------------------------------------------------


def device_info() -> dict:
    """The card's name and power limit; ``nvidia_smi`` is the line as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.split(","))
    return {"name": name, "power_limit": power, "torch_name": torch.cuda.get_device_name(0),
            "nvidia_smi": line}


def cuda_ms(fn: Callable, reps: int, warmup: bool = True) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls between
    two CUDA events, after one warm-up call unless ``warmup`` is false.
    The host issues the calls as the events run, so a call shorter than
    its host cost (allocation, launch, dispatch: tens of µs) reads the
    host's pace; ``graph_ms`` reads the device's."""
    if warmup:
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


def slope_time(call: Callable, k_lo: int, k_hi: int, rounds: int, arg) -> float:
    """Per-unit seconds from the K-slope, (t(k_hi) - t(k_lo)) / (k_hi - k_lo),
    of the medians of interleaved rounds, each timed by CUDA events."""
    ts = {k_lo: [], k_hi: []}
    for _ in range(rounds):
        for k in (k_lo, k_hi):
            ts[k].append(cuda_ms(lambda k=k: call(arg, k), 1, warmup=False) * 1e-3)
    med = {k: sorted(v)[len(v) // 2] for k, v in ts.items()}
    return (med[k_hi] - med[k_lo]) / (k_hi - k_lo)


def _graph(fn: Callable) -> torch.cuda.CUDAGraph:
    """``fn()`` captured in a CUDA graph on a side stream, after one run on
    that same stream (a library such as cuBLAS sets up its per-stream
    workspace there, outside the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def graph_ms(fn: Callable, calls: int = 50, replays: int = 20) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph (after running them once, uncaptured, on the capture stream), one
    replay to warm up, then ``replays`` replays between two CUDA events.
    The calls are back to back on the device, each input as warm in L2 as
    the last call left it. The host issues
    one replay per ``calls`` calls, so the events time the device, not the
    host's allocation, launch and dispatch."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms times a CUDA card, and none is available")

    def many():
        for _ in range(calls):
            fn()

    graph = _graph(many)
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: [graph.replay() for _ in range(replays)], 1, warmup=False)
    del graph
    return ms / (replays * calls)


def level_chain_seconds(w: int, h: int, inner: int, k_lo: int, k_hi: int, rounds: int,
                        seed: int = 0, chained: bool = False) -> float:
    """Device seconds of one 40 x ``inner`` relaxation (``solver.level.relax``,
    grey) on seeded (h, w) fields: the slope over chains of k relaxations,
    u += 0.001 du between them, each chain a replayed CUDA graph. With
    ``chained``, the sweeps are one-sweep launches (``CHAIN_STEPS``)."""
    from tpuflow_torch.ops.level import level_derivs
    from tpuflow_torch.solver.level import CHAIN_STEPS, KERNEL_STEPS, LevelScalars, relax

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    f0 = torch.from_numpy(rng.random((h, w), np.float32) * 200).to(dev)
    f1 = torch.from_numpy(rng.random((h, w), np.float32) * 200).to(dev)
    uv0 = torch.from_numpy((rng.random((2, h, w), np.float32) - 0.5) * 2).to(dev)
    cfg = FlowConfig(inner_iterations_count=inner)
    sc = LevelScalars.make(w, h, 1.0, 1.0, cfg.equation_alpha)
    fxyz = level_derivs(f0, f1, sc.div4hx, sc.div4hy)
    steps = CHAIN_STEPS if chained else KERNEL_STEPS

    def chain(k: int) -> torch.Tensor:
        uv = uv0
        for _ in range(k):
            uv = uv + 0.001 * (relax(fxyz, uv, sc, cfg, _steps=steps) - uv)
        return uv

    graphs = {k: _graph(lambda k=k: chain(k)) for k in (k_lo, k_hi)}
    seconds = slope_time(lambda _, k: graphs[k].replay(), k_lo, k_hi, rounds, None)
    del graphs
    torch.cuda.empty_cache()
    return seconds


def sass_counts(lib_path: str) -> dict:
    """{kernel symbol: Counter of SASS opcodes} of the built library, from
    ``cuobjdump -sass``: the check that the microkernel's pass loop still
    holds its shared-memory loads, and the instruction counts behind
    LIBRARY_OPS."""
    from tpuflow_torch.ops.cuda_lib import _nvcc

    cuobjdump = _nvcc()[:-len("nvcc")] + "cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, fn = {}, None
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = Counter()
        elif fn is not None and (m := op.search(line)):
            counts[fn][m.group(1)] += 1
    return counts


# ---------------------------------------------------------------------------
# The measurement
# ---------------------------------------------------------------------------


def measure(k_lo: int = 4, k_hi: int = 16, rounds: int = 5, log=print) -> dict:
    """Component rates, surcharges, the measured and predicted sweep; the
    final JSON object. ``log`` takes the human-readable lines."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline tool measures a CUDA card, and none is available")
    rng = np.random.default_rng(0)
    ins = torch.from_numpy(rng.random((N_IN, HB, WB), np.float32) + 0.5).cuda()

    # ---- component rates -------------------------------------------
    comp_us, gbs = {}, {}
    for name, (_, acc) in BODIES.items():
        per_call = slope_time(microkernel(name), k_lo, k_hi, rounds, ins)
        comp_us[name] = per_call / PASSES * 1e6
        gbs[name] = (acc["loads"] + acc["stores"]) * FIELD_BYTES / (per_call / PASSES) / 1e9
        log(f"{name:8s} {comp_us[name]:7.4f} us/pass  "
            f"({gbs[name]:8.1f} GB/s of shared-memory loads at its op mix)")

    # Per-resource surcharges from the component mix:
    #   stream  = base (1 shared load + 1 flop)
    #   shift_* = base + shifted read     -> c_rot
    #   fma     = base + 1 flop           -> c_flop
    #   div     = base + divide           -> c_div
    #   phi     = base + div + sqrt + 1f  -> c_sqrt
    base = comp_us["stream"]
    c_rot = max(0.0, (comp_us["shift_x"] + comp_us["shift_y"]) / 2 - base)
    c_flop = max(0.0, comp_us["fma"] - base)
    c_div = max(0.0, comp_us["div"] - base)
    c_sqrt = max(0.0, comp_us["phi"] - comp_us["div"] - c_flop)
    c_access = base / 2  # base = 1 load + 1 flop ~ 2 issue slots

    # ---- measured production sweep (config differencing) ------------
    # one-sweep launches chained (the twin), then the main path's k-sweep
    # kernel, whose sweeps 3..5 are the marginal cost of a sweep in shared
    # memory
    outer = 40
    sizes = {(584, 388): (k_lo, k_hi, rounds), (3840, 2160): (1, 3, 3)}
    lvl_s, sweep_us, klvl_s, ksweep_us = {}, {}, {}, {}
    for (w, h), (lo, hi, rr) in sizes.items():
        key = f"{w}x{h}"
        for chained, levels, per_sweep in ((True, lvl_s, sweep_us), (False, klvl_s, ksweep_us)):
            levels[key] = {inner: level_chain_seconds(w, h, inner, lo, hi, rr, chained=chained)
                           for inner in (2, 5)}
            for inner, s in levels[key].items():
                log(f"{key} level inner={inner} ({'chained' if chained else 'k-sweep'}): "
                    f"{s * 1e3:8.3f} ms per 40x{inner} relaxation")
            per_sweep[key] = (levels[key][5] - levels[key][2]) / (outer * 3) * 1e6

    # ---- predicted sweep from components (per 392x640 field) ---------
    c = SWEEP_COUNTS
    parts = {
        "access": (c["loads"] + c["stores"]) * c_access,
        "flops": c["flops"] * c_flop,
        "rotates": c["rot"] * c_rot,
        "divides": c["div"] * c_div,
        "sqrts": c["sqrt"] * c_sqrt,
    }
    pred = sum(parts.values())
    pred_by_size = {f"{w}x{h}": pred * (w * h) / (HB * WB) for w, h in sizes}
    for key, meas in sweep_us.items():
        log(f"\n{key}: measured sweep {meas:.3f} us   predicted from components "
            f"{pred_by_size[key]:.3f} us")
    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"  {k:8s} {v:7.4f} us ({v / pred * 100 if pred else 0.0:4.1f}% of prediction)")
    per_outer_fixed_us = lvl_s["584x388"][5] / outer * 1e6 - 5 * sweep_us["584x388"]
    log(f"per-outer fixed at 584x388 (prologue and the sweeps' overlap): "
        f"{per_outer_fixed_us:.2f} us")

    return {
        "component_us_per_pass": comp_us,
        "shared_gb_per_s": gbs,
        "surcharges_us": {"access": c_access, "flop": c_flop, "rotate": c_rot,
                          "divide": c_div, "sqrt": c_sqrt},
        "sweep_measured_us": sweep_us["584x388"],
        "sweep_predicted_us": pred_by_size["584x388"],
        "sweep_measured_us_by_size": sweep_us,
        "sweep_predicted_us_by_size": pred_by_size,
        "prediction_parts_us": parts,
        "level_ms": {str(k): v * 1e3 for k, v in lvl_s["584x388"].items()},
        "level_ms_by_size": {s: {str(k): v * 1e3 for k, v in d.items()}
                             for s, d in lvl_s.items()},
        "ksweep_marginal_us_by_size": ksweep_us,
        "ksweep_level_ms_by_size": {s: {str(k): v * 1e3 for k, v in d.items()}
                                    for s, d in klvl_s.items()},
        "bucket": [HB, WB],
        "passes_per_call": PASSES,
        "timing": "CUDA events; components: K-chained launches; sweep: replayed CUDA graphs; "
                  "sweep_* one-sweep launches chained, ksweep_* the k-sweep kernel",
        "device": device_info(),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    k_lo = int(argv[0]) if len(argv) > 0 else 4
    k_hi = int(argv[1]) if len(argv) > 1 else 16
    rounds = int(argv[2]) if len(argv) > 2 else 5
    print(json.dumps(measure(k_lo, k_hi, rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

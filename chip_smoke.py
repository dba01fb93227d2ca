#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tpuflow_torch``).

    python3 chip_smoke.py          # from the repo root, on a machine with one CUDA GPU

Phases, one JSON line each; any failure raises and the exit code is not 0:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds tpuflow_torch/csrc into tpuflow_torch/_build
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              on seeded inputs at 584x388, 1920x1080 and 3840x2160, the two
              prologue rows and the log tensor bitwise and also at the edge
              shapes of their tiles (PROLOGUE_SHAPES, and LOG_TILE_SHAPES for
              the log tensor's taller tile); times at 1920x1080 and
              3840x2160 (the log tensor also by CUDA-graph replay).
              Then jacobi_sweeps (the k-sweep kernel) at inner 1, 2, 5 and
              7 > KMAX: bitwise against as many chained launches of the
              one-sweep kernel and within 1e-5 of its plain version, at those
              shapes and at KSWEEP_SHAPES (narrower and shorter than its
              region); five sweeps timed in turns with five chained launches
              (and the kernel's other region height and layout) by
              CUDA-graph replay; and
              add_median at R = 3, 5, 7 bitwise at every shape its window fits
 3b. banded   both banded kernels (csrc/banded.cu: banded_x_kernel,
              banded_y_kernel) under their wrappers, bitwise against their
              plain versions: gaussian_smooth at 584x388, 1920x1080 and
              3840x2160 and at 4x4 and 7x5 (sigma 0.5, 1.5 and 8); the frame
              pyramid of those sizes' full_model() schedules in its one X
              and one Y launch (each level, and each level's X output alone)
              and each level's flow from the level before; rows too wide for
              one staged buffer of 8 rows (BANDED_WIDE, unstaged); per pair,
              each wrapper's device ms by CUDA-graph replay in turns with
              the dense torch.matmul pair of the same weights (TF32 off), its
              X and Y launches alone, its plain ms, its bound, and the dense
              matrices' bytes against the plans'
 3c. rows     the whole-field stages over output row ranges (ROW_SIZES, the
              first and last rows, bands at both edges and inside; warp,
              level_derivs, the gradient and log tensors, add_median at
              R = 1, 3, 5, 7, the flow's resample): bitwise the whole
              launch's rows, the plain version's within phase 3's bounds,
              no row outside written; then one process's band path at 1920x1080 for grey,
              full_model() and xray_log, emulated on the card for each shard
              of 4 under the kernel and explicit routes (every other row of
              each stage NaN): owned rows bitwise, rows per stage the plan's
  4. e2e      compute_flow(FlowConfig()) (grey) at 584x388 and 1920x1080 on
              a textured pair shifted by (+1.25, -0.75) px: kernel path vs
              plain path, the recovered shift, and at 584x388 the NumPy
              oracle on a reduced schedule; each run's launch counts; the
              flow bit for bit that of the one-sweep chain (CHAIN_STEPS)
  5. e2e      models.full_model() (gradient) and models.xray_log(alpha=1e-3)
              (log) at 584x388, with the same checks
  6. e2e      models.full_model() at 3840x2160 (the size class the TPU sends
              to _relax_du_streamed): kernel path vs one plain run, the
              shift (better than zero flow), the launch counts, the peak
              device memory
  7. cli      python -m tpuflow_torch.cli on u8 RAW files at 584x388 with
              --constancy log and alpha 1e-3; its flow files bytewise
              against compute_flow, and the shift they recover
  8. times    ms per pair and Mpix/s by CUDA events: grey kernel and plain
              paths at 584x388 and 1920x1080; the gradient kernel path at
              584x388, 1920x1080 and 3840x2160, its plain path at 584x388
  9. probes   the measurement path (tpuflow_torch.tools): roofline_micro,
              all six bodies, against its plain fold at 16 passes, and the
              shared-memory loads of its pass loop in the SASS; probe_matmul
              against its plain sum and torch.matmul at the probe's shape and
              two odd ones (MATMUL_SHAPES); then roofline.measure()
              (component rates, surcharges, the production sweep by
              differencing at 584x388 and 3840x2160 against its prediction)
              and probe_kernel_matmul.run() (device times of the kernel and
              torch.matmul by CUDA-graph replay), with their launch counts
 10. bounds   each level kernel's bytes, operations and bound
              (roofline.kernel_work) at 1920x1080 and 3840x2160 beside its
              time from phase 3, and the library call where one exists; the
              static SASS counts of the k-sweep kernel and the median
 11. trace    compute_flow(full_model(), collect_trace=True) at 3840x2160:
              the per-level ms against the per-level bound, the flow bit for
              bit against an untraced run; profiling.trace at 584x388
 12. sharded  the row-sharded relaxation kernel (csrc/sharded.cu) bitwise
              against its plain version and against the unsharded kernels at
              SHARDED_CHECKS (584x388 to 3840x2160; 1 to 8 shards; k = 1, 2,
              3; inner 1, 5, 7; grey, gradient and log; a level whose edge
              shards hold fewer rows than a k-sweep region), each launch's
              grid syncs, counted on the card, equal to
              halo_kernel.grid_syncs; its ms at 1, 2 and 4 shards on the
              level-0 shapes of 1920x1080 and 3840x2160 beside its bound,
              its counted syncs, the bytes it streams, and the unsharded
              relax;
              compute_flow_sharded(full_model()) at
              1920x1080 on 4 shards and on 1 against compute_flow, the shift
              and the launch counts, timed in turns with compute_flow; grey
              584x388 on 4 shards against the oracle (reduced schedule).
              Where the machine has several cards, also the kernel with the
              shards spread over them (one launch a card, halos stored
              through peer pointers, flag barriers between the cards):
              every SHARDED_CHECKS case over 2 cards, over 4 and with 8
              shards dealt over 4, bitwise, each card's grid syncs and row
              barriers equal to the formulas; a race case (one card's launch
              held back about 0.1 s); one card's launch left out in a child
              process, which must fail within the spin limit; the 1080p and
              4K level-0 launches over 4 cards in turns with one card's,
              beside the cards=4 bound. On one card it prints that it did
              not run.
 13. sequence process_sequence on 6 pairs of seeded 1920x1080 f32 RAW frames
              (FlowConfig()) with chain=1 and chain=3, byte for byte against
              compute_flow per pair followed by the same writers; a resume
              from a manifest of the first three pairs (exactly the other
              three complete); the wall per pair of each mode
 14. batch    compute_flow on a (3, 388, 584) stack, bitwise three single calls
 15. warp     compute_flow_warp_report on the blobs of tests/test_bucketed.py
              at 584x388 moved by 0.8 px (every tier 0) and 6.5 px (tier 1 at
              least once), the flow bitwise compute_flow's
 16. async    with a 3840x2160 full_model() pair and a 0.5 s device sleep
              queued, the next pair's staged upload returns while they still
              run, where a pageable upload waits; the banded kernels' plans
              come from the device cache (one hit a launch, no upload); how
              many launches the host queues ahead of the card before one
              waits
 17. bench    python -m tpuflow_torch.bench's line (bench.main, in this
              process) for 584x388 grey (with --epe: the full-schedule EPE
              against the oracle for grey, full_model() and
              xray_log(alpha=1e-3), gated at 0.05 px), 1920x1080 grey and
              3840x2160 full_model()
 18. mesh_explicit  relax_sharded_explicit (one stream a shard, halos copied
              after CUDA events) bitwise against relax_sharded and relax in
              the SHARDED_CHECKS cases on 4 positions of cuda:0 (and dealt
              over the cards where there are several), launches and copies
              exact; a race case with a device sleep queued on one shard's
              stream before each of its sweeps; where the positions span
              several cards the kernel on the same mesh, bitwise, counts
              exact; the prologue kernel on row blocks (row0, height)
              bitwise against its plain version
 19. mesh_e2e a 1920x1080 full_model() pair through compute_flow(...,
              mesh=make_mesh(4, ["cuda:0"] * 4)) and compute_flow_sharded
              with halo explicit, kernel and auto: bitwise compute_flow,
              counts exact, the auto plan by level, timed in turns; the
              same with the positions dealt over the cards where there are
              several
 20. mesh_dp  a (4, 388, 584) grey stack through compute_flow(..., mesh=)
              on 4 data positions and compute_flow_hybrid on 4 y positions,
              and a ragged B of 3: bitwise per-pair compute_flow, counts
              exact; timed against the stack without a mesh
 21. mesh_sequence  process_sequence(mesh=) on phase 13's six pairs, byte
              for byte the files of chain=1; a resume
 22. report_scaling  the cost model's constants measured on the card
              (--link), the --project table, the measured dp and sp line
              with its count of distinct cards; "auto" routes no level of a
              one-card mesh to the explicit route
 23. crosscard_e2e  where the machine has several cards: a 3840x2160
              full_model() pair through compute_flow(..., mesh=) and
              compute_flow_sharded with halo explicit, kernel and auto over
              4 positions dealt over the cards, bitwise compute_flow, counts
              exact (one relax_sharded launch a card a level), timed in
              turns; on one card it prints that it did not run
 24. procmesh PROC_N processes joined by initialize_distributed (this
              script run with --proc-worker; on one card all on cuda:0, else
              one a card), a mesh over them: (a) a (4, 388, 584) grey stack
              on (PROC_N, 1), each process's pairs bitwise its own
              compute_flow, ``pairs`` exact; (b) a 1920x1080 full_model()
              pair on the row (1, PROC_N) with halo kernel and auto (the
              sharded kernel one launch a process, halos and T stored into
              the other processes' arenas through CUDA IPC handles), bitwise
              compute_flow, counts exact, and the level-0 launch's grid syncs
              and row barriers counted on the card against the formulas;
              with a card a process also the kernel at k = 2; each case
              prints its path (with a card a process, each process
              computes only its band plan's rows of the sharded levels'
              whole-field stages and the finest flow is gathered once,
              counted in the messages; where the processes share a card,
              the whole field) and the rows each row stage computed beside
              the plan's;
              (c) the race case (the last process held back about 0.1 s);
              (d) the same pair on the row with halo="explicit" at k = 1 and
              2 and "auto" (the explicit route in its choice) beside the
              kernel: each process its own shard, halos and owned rows sent
              by NCCL; bitwise compute_flow, launches, copies and messages
              exact, timed in turns with compute_flow and the kernel route;
              (e) compute_flow_hybrid on a (4, 388, 584) grey stack on
              (PROC_N, 1) (no pair moves) and on (1, PROC_N) (each pair's
              working set sent to the row by NCCL): each process's pairs
              bitwise, ``pairs``, launches and messages exact, timed in
              turns with the stack's compute_flow, dp and, with the row's
              hybrid, the stack on the row. NCCL refuses two ranks on one
              card, so where the processes share one, (d) and the row's
              hybrid must raise before any message, naming NCCL, and the
              phase prints that they need a card a process; the spin limit
              with one process never launching

``python3 chip_smoke.py --procs N [--link]`` runs, on a machine with N
cards, phase 24 alone over N processes one a card, then (d) over two
processes, (d) at 3840x2160, (e) on a (4, 1080, 1920) full_model() stack
over N and, with four or more, that stack through compute_flow on a (2,
N / 2) mesh, each as a JSON line; with ``--link``, first ``report_scaling
--procs N --link``. It ends with the same two last lines.

Each main-path run of phases 4-6, 11-15, 17, 19-21, 23 and 24 (in each worker), and the measurement
path of phase 9, sets every launch count to 0 just before it and reads the
counts just after. The one-sweep kernel (jacobi_sweep) is off the main path: its
launches are those of phase 9's measurement path, which differences the
relaxation with it chained. Then come the kernels table as one JSON line, the done line with the
total seconds, the nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Without CUDA, or run outside a checkout of the repo, it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZES = ((584, 388), (1920, 1080))   # (width, height) of the grey runs
SIZE_4K = (3840, 2160)
# The reduced schedule the oracle finishes in seconds at 584x388.
ORACLE_KW = dict(warp_levels_count=8, warp_scale_factor=0.7,
                 outer_iterations_count=10, inner_iterations_count=5,
                 equation_alpha=35.0, median_radius=5, gaussian_sigma=1.5)
# The log runs use xray_log(alpha=LOG_ALPHA). Its tensor holds squared second
# derivatives of log1p of 8-bit frames, about 1e-3 here: at the preset's
# alpha of 35 the solve stays at zero flow (1e-4 px), where a wrong log
# kernel would pass unseen; at 1e-3 the log term recovers the shift.
LOG_ALPHA = 1e-3
# The true-shift EPE the JAX package itself reaches on the 584x388 textured
# pair, full schedule (tpuflow.compute_flow on a CPU): full_model() 0.4876,
# xray_log(alpha=LOG_ALPHA) 0.0254 px. The bounds are max(0.3, 1.5x that),
# well below the 1.458 px of zero flow.
SHIFT_BOUNDS = {"grey": 0.3, "gradient": max(0.3, 1.5 * 0.4875621199607849),
                "log": max(0.3, 1.5 * 0.025402741506695747)}
# At 3840x2160 there is no JAX measurement to scale (a full-size solve is
# too large for a CPU); the check there is that the flow beats zero flow,
# whose EPE is |shift|.
ZERO_FLOW_EPE = float(np.hypot(1.25, -0.75))
# Kernel vs plain on the card. Both sides round every operation as IEEE
# float32 in the same association (no FMA contraction in the kernels), so
# these bounds are loose; warp's taps gather differently-rounded weights.
# level_derivs is bounded elementwise relative, the gradient tensor relative
# to max|plain| over the whole field. A bound of 0.0 is bitwise (max abs):
# the median selects, and the tiles of the prologues and of the log tensor
# must give every value that the plain version computes (the log tensor: the
# same log1pf of the same float in the same expression). One bound a row of
# phase 3; the level tensor's two rows are one kernel's two constancies.
BOUNDS = {"warp": 1e-4, "level_derivs": 1e-5, "level_tensor_gradient": 1e-5,
          "level_tensor_log": 0.0, "outer_prologue": 0.0, "outer_prologue_tensor": 0.0,
          "jacobi_sweep": 1e-5, "jacobi_sweeps": 1e-5, "add_median": 0.0}
# The kernels by the names of their launch counts (the kernels line's rows).
KERNELS = ("gaussian_smooth", "resample", "warp", "level_derivs", "level_tensor",
           "outer_prologue", "outer_prologue_tensor", "jacobi_sweep", "jacobi_sweeps",
           "add_median")
# The banded kernels' two wrappers (phase 3b); the rest are the level kernels.
BANDED = ("gaussian_smooth", "resample")
# jacobi_sweeps against as many chained one-sweep launches: the same
# expression on the same operands, bitwise.
CHAIN_BOUND = 0.0
# The kernels of the main path; the one-sweep kernel is the k-sweep kernel's
# twin and runs on phase 9's measurement path.
MAIN_PATH = tuple(name for name in KERNELS if name != "jacobi_sweep")
ELEMENTWISE_RELATIVE = ("level_derivs",)
FIELD_RELATIVE = ("level_tensor_gradient",)
# The prologue rows and the log tensor also run at the edge shapes of the
# prologue's 32 x 8 tile (w = 2 and h = 2 among them; the default schedule's
# coarsest level is 22 x 13) and at 2268 x 1276, a level of the 4K schedule
# whose h * w is odd; the log tensor also at the edges of its 32 x 16 tile
# (csrc/level.cu: LT_TH): one row short, one tile, one row more, two tiles
# and one more.
PROLOGUE_ROWS = ("outer_prologue", "outer_prologue_tensor", "level_tensor_log")
PROLOGUE_SHAPES = ((2, 2), (5, 3), (22, 13), (33, 9), (65, 17), (97, 31), (2268, 1276))
LOG_TILE_SHAPES = ((31, 15), (33, 16), (32, 17), (2, 32), (65, 33))
# The k-sweep kernel's region is 64 x 32 (a 54 x 22 tile at 5 sweeps): levels
# narrower and shorter than a region, one tile exactly, one pixel more or less
# in each direction, and the same about a 54 x 14 tile
KSWEEP_SHAPES = ((40, 300), (300, 20), (54, 22), (55, 23), (53, 21), (63, 31), (54, 14),
                 (55, 15), (53, 13), (63, 23))
KSWEEP_INNERS = (1, 2, 5, 7)
MEDIAN_RADII = (3, 5, 7)
# Phase 3b: the banded kernels (csrc/banded.cu) against their plain versions.
# Both add the same terms in the same order, each operation rounded as
# float32 (--fmad=false): bitwise. The presmooth also where its radius
# (4 at sigma 1.5, 24 at 8) exceeds the frame.
BANDED_BOUND = 0.0
BANDED_SIZES = (SIZES[0], SIZES[1], SIZE_4K)
BANDED_SMALL = ((4, 4), (7, 5))
# Rows too wide for one staged buffer of 8 rows in shared memory (the
# unstaged instantiation), as w x h.
BANDED_WIDE = ((9001, 6),)
# 0.5: three taps, one interior weight shared by every window (not 1: a
# taps level); 8: a radius over the frame.
BANDED_SIGMAS = (0.5, 1.5, 8.0)
BANDED_REPLAYS = 5
# Phase 3c: the whole-field stages over output row ranges, bitwise the whole
# launch's rows, at every median radius (1 copies), and the band path of one
# process emulated for each shard of ROW_SHARDS.
ROW_SIZES = (SIZES[0], SIZES[1], SIZE_4K)
ROW_MEDIAN_RADII = (1, 3, 5, 7)
ROW_SHARDS = 4
# The kernels redesigned since their first port, and what changed. The
# earlier kernels are gone from the tree, so their times are in PERF.md, not
# in the kernels line, which holds only what this run measured.
PHI_TILE = "phi once per pixel from a shared-memory tile"
REDESIGNED = {"outer_prologue": PHI_TILE, "outer_prologue_tensor": PHI_TILE,
              "probe_matmul": "128 CTAs and a cp.async ring",
              "jacobi_sweeps": "the inner loop in one launch: k sweeps of a shared-memory tile "
                               "and its ring, replacing k one-sweep launches",
              "add_median": "a 99-exchange selection (19 at 3x3) over a shared tile of the sum, "
                            "replacing a 300-exchange sort over device memory",
              "level_tensor_log": "log1pf once per staged frame value from a 32 x 16 shared "
                                  "tile, where the stencil of each neighbour evaluated it "
                                  "anew",
              "relax_sharded": "the prologue's phi tiles and the k-sweep's regions inside the "
                               "cooperative launch: 2 grid syncs an outer (3 with a push) in "
                               "place of 6, loops over tiles in place of pixels"}
RELAX = ("tpuflow/ops/pallas/relax_bucket.py:400; tpuflow/ops/pallas/relax_bucket.py:176; "
         "tpuflow/ops/pallas/relax_du.py:457; tpuflow/ops/pallas/relax_du.py:874; "
         "tpuflow/ops/pallas/relax_du.py:241")
REPLACES = {
    "gaussian_smooth": "tpuflow/ops/gaussian.py:92 (gaussian_smooth: two banded Toeplitz "
                       "matmuls, not a pallas_call)",
    "resample": "tpuflow/ops/resample.py:233,252 (resample_rows_blocked, "
                "resample_cols_blocked: block-banded matmuls, not a pallas_call) via "
                "tpuflow/solver/bucketed.py:903 (_resample_trim) and :588 (_resample_top)",
    "warp": "tpuflow/ops/pallas/level_fused.py:179 (_warp_shift_sum in "
            "level_fused_whole); tpuflow/solver/bucketed.py:266",
    "level_derivs": "tpuflow/ops/pallas/level_fused.py:526 (level_fused_whole, "
                    "phase A :285); tpuflow/ops/pallas/level_fused.py:472",
    "level_tensor": "tpuflow/ops/pallas/level_fused.py:526 and :472 (the grad/log tensor "
                    ":291-322); tpuflow/solver/bucketed.py:422 (the tensor= input of "
                    "relax_bucket.py:400,176 and relax_du.py:457,874,241)",
    "outer_prologue": "tpuflow/ops/pallas/level_fused.py:526; "
                      "tpuflow/ops/pallas/level_fused.py:472; " + RELAX,
    "outer_prologue_tensor": "tpuflow/ops/pallas/level_fused.py:526 and :472 (the prologue "
                             "with the tensor, :379-392); with tensor=: " + RELAX,
    "jacobi_sweep": "tpuflow/ops/pallas/level_fused.py:526; "
                    "tpuflow/ops/pallas/level_fused.py:472; " + RELAX,
    "jacobi_sweeps": "tpuflow/ops/pallas/level_fused.py:526 and :472 (the sweeps :328-341); "
                     + RELAX,
    "add_median": "tpuflow/ops/pallas/level_fused.py:526 (phase C :432); "
                  "tpuflow/ops/pallas/level_fused.py:472",
    "roofline_micro": "tools/roofline.py:88 (microkernel; pl.pallas_call :104)",
    "probe_matmul": "tools/probe_kernel_matmul.py:26 (in_kernel; pl.pallas_call :27)",
}
# The probes against their plain versions: roofline_micro at 16 passes,
# where every body stays finite, is bitwise (both round each operation as
# IEEE float32); probe_matmul sums in k order with fused multiply-adds where
# the plain version rounds each product, so relative to max |plain|.
PROBE_PASSES_CHECK = 2          # loop trips: 16 passes
MATMUL_REL_BOUND = 1e-5
# against torch.matmul (TF32 off), which sums in another order
MATMUL_LIB_REL_BOUND = 1e-6
# (M, K, N) of the matmul checks: the probe's shape, then odd ones that take
# the kernel's 4-byte copies and partial tiles and chunks
MATMUL_SHAPES = ((64, 448, 640), (5, 449, 7), (65, 17, 641))
# The library call each level kernel's function has, if any. None computes
# the same function; warp's near twin uses another boundary rule.
WARP_TWIN = ("torch.nn.functional.grid_sample, bilinear, align_corners, border padding "
             "(a near twin: out-of-range targets clamp instead of copying f0)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_inputs(w: int, h: int, seed: int = 1):
    """Seeded level fields at (h, w) on the card: frames, a flow with a few
    out-of-bounds and NaN pixels, an iterate, derivatives, the gradient
    tensor and hoists."""
    import torch

    from tpuflow_torch.ops.level import (
        level_derivs_plain, level_tensor_plain, outer_prologue_plain,
    )
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.synthetic import textured_pair

    rng = np.random.default_rng(seed)
    # Intensities of an image, 0-255: the shifted copy's band-limited values
    # overshoot a little, and log1p is NaN below -1.
    f0, f1 = (np.clip(f, 0.0, 255.0) for f in textured_pair(w, h, seed=seed))
    uv = (rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)
    uv[0, :, :3] = -40.0          # out of bounds: copies f0
    uv[1, min(5, h - 1), min(7, w - 1)] = np.nan   # NaN target: copies f0
    d = (rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f0, f1, uv, d = t(f0), t(f1), t(uv), t(d)
    uv_finite = torch.nan_to_num(uv)
    T = uv_finite + d
    sc = LevelScalars.make(w, h, 1.0, 1.0, 35.0)
    e2 = float(np.float32(0.001) * np.float32(0.001))
    fxyz = level_derivs_plain(f0, f1, sc.div4hx, sc.div4hy)
    J = level_tensor_plain(f0, f1, fxyz, sc, False)
    pro = (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e2, e2)
    hoist = outer_prologue_plain(T, uv_finite, fxyz, *pro)
    return dict(f0=f0, f1=f1, uv=uv, uvf=uv_finite, T=T, fxyz=fxyz, J=J, hoist=hoist,
                sc=sc, pro=pro)


def kernel_pairs(x: dict) -> dict:
    """{row name: (kernel call, plain call)} on the inputs ``x``."""
    from tpuflow_torch.ops import level as L
    from tpuflow_torch.ops.warp import warp, warp_plain

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
        "jacobi_sweeps": (lambda: L.jacobi_sweeps(x["T"], x["uvf"], x["hoist"], 5),
                          lambda: L.jacobi_sweeps_plain(x["T"], x["uvf"], x["hoist"], 5)),
        "add_median": (lambda: L.add_median(x["T"], x["uvf"], 5),
                       lambda: L.add_median_plain(x["T"], x["uvf"], 5)),
    }
    for log in (False, True):
        pairs["level_tensor_" + ("log" if log else "gradient")] = (
            lambda log=log: L.level_tensor(x["f0"], x["f1"], x["fxyz"], sc, log),
            lambda log=log: L.level_tensor_plain(x["f0"], x["f1"], x["fxyz"], sc, log))
    pairs["outer_prologue_tensor"] = (
        lambda: L.outer_prologue(x["T"], x["uvf"], x["fxyz"], *pro, J=x["J"]),
        lambda: L.outer_prologue_plain(x["T"], x["uvf"], x["fxyz"], *pro, J=x["J"]))
    return pairs


def warp_twin(x: dict):
    """One grid_sample call on the warp's inputs: its near twin, timed as a
    yardstick only."""
    import torch
    import torch.nn.functional as F

    f1, uv, sc = x["f1"], x["uvf"], x["sc"]
    h, w = f1.shape
    xs = torch.arange(w, dtype=torch.float32, device=f1.device)[None, :] + uv[0] * sc.inv_hx
    ys = torch.arange(h, dtype=torch.float32, device=f1.device)[:, None] + uv[1] * sc.inv_hy
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], dim=-1)[None]
    return lambda: F.grid_sample(f1[None, None], grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)


def phase_kernels(shapes=(SIZES[0], SIZES[1], SIZE_4K), timed=(SIZES[1], SIZE_4K)):
    """Each kernel vs its plain version at ``shapes``, and the prologue rows
    also at PROLOGUE_SHAPES (the log tensor also at LOG_TILE_SHAPES); timed
    at ``timed``. Returns {row name: {max_abs_err, ms, plain_ms, ms_4k,
    plain_ms_4k}}: the times at 1920x1080 and 3840x2160, the largest error
    over the shapes; for warp also its near twin's (``near_twin_ms``)."""
    import torch

    from tpuflow_torch.tools.roofline import cuda_ms, graph_ms

    table = {}
    runs = ([(s, None) for s in shapes] + [(s, PROLOGUE_ROWS) for s in PROLOGUE_SHAPES]
            + [(s, ("level_tensor_log",)) for s in LOG_TILE_SHAPES])
    for (w, h), only in runs:
        x = kernel_inputs(w, h)
        for name, (kern, plain) in kernel_pairs(x).items():
            if only is not None and name not in only:
                continue
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} at {w}x{h}: non-finite output")
            err = float((got - want).abs().max())
            if name in ELEMENTWISE_RELATIVE:
                # |got - want| <= rtol * |want| elementwise
                check = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            elif name in FIELD_RELATIVE:
                check = err / max(float(want.abs().max()), 1e-30)
            else:
                check = err
            bound = BOUNDS[name]
            row = {"phase": "kernel", "name": name, "shape": [h, w], "max_abs_err": err,
                   "checked": check, "bound": bound, "ok": check <= bound}
            entry = table.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if (w, h) in timed:
                suffix = "" if (w, h) == SIZES[1] else "_4k"
                row["ms"] = entry["ms" + suffix] = cuda_ms(kern, 20)
                row["plain_ms"] = entry["plain_ms" + suffix] = cuda_ms(plain, 5)
                if name == "warp":
                    row["near_twin_ms"] = entry["near_twin_ms" + suffix] = cuda_ms(
                        warp_twin(x), 20)
                if name == "level_tensor_log":
                    row["graph_ms"] = entry["graph_ms" + suffix] = graph_ms(kern, calls=20,
                                                                           replays=5)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"{name} at {w}x{h}: {check} > {bound}")
        del x
        torch.cuda.empty_cache()
    return table


def phase_ksweep(card: str, shapes=(SIZES[0], SIZES[1], SIZE_4K) + PROLOGUE_SHAPES
                 + KSWEEP_SHAPES) -> dict:
    """jacobi_sweeps at KSWEEP_INNERS against as many chained one-sweep
    launches (CHAIN_BOUND) and its plain version (BOUNDS), at ``shapes``;
    then five sweeps at 1920x1080 and 3840x2160 timed in turns by CUDA-graph
    replay (chain, k-sweep, k-sweep, chain) beside the bound of the function.
    Returns {max_abs_err, max_abs_vs_chain, device: {shape: times}} (launches
    here are not counted)."""
    import torch

    from tpuflow_torch.ops import level as L
    from tpuflow_torch.tools.roofline import graph_ms, kernel_work

    out = {"max_abs_err": 0.0, "max_abs_vs_chain": 0.0, "device": {}}
    for w, h in shapes:
        x = kernel_inputs(w, h)
        T, uv, hoist = x["T"], x["uvf"], x["hoist"]
        for inner in KSWEEP_INNERS:
            got = L.jacobi_sweeps(T, uv, hoist, inner)
            chain = L.jacobi_sweep_chain(T, uv, hoist, inner)
            plain = L.jacobi_sweeps_plain(T, uv, hoist, inner)
            torch.cuda.synchronize()
            row = {"phase": "ksweep", "shape": [h, w], "inner": inner,
                   "launches_per_call": -(-inner // L.KMAX),
                   "max_abs_vs_chain": float((got - chain).abs().max()),
                   "chain_bound": CHAIN_BOUND, "max_abs_err": float((got - plain).abs().max()),
                   "bound": BOUNDS["jacobi_sweeps"], "finite": bool(torch.isfinite(got).all())}
            row["ok"] = (row["finite"] and row["max_abs_vs_chain"] <= CHAIN_BOUND
                         and row["max_abs_err"] <= row["bound"])
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"jacobi_sweeps at {w}x{h}, inner {inner}: {row}")
            out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
            out["max_abs_vs_chain"] = max(out["max_abs_vs_chain"], row["max_abs_vs_chain"])
        if (w, h) in (SIZES[1], SIZE_4K):
            runs = {"chain": lambda: L.jacobi_sweep_chain(T, uv, hoist, 5),
                    "ksweep": lambda: L.jacobi_sweeps(T, uv, hoist, 5)}
            ms = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                ms[name].append(graph_ms(runs[name], calls=20, replays=5))
            work = kernel_work("jacobi_sweeps", h, w, inner=5)
            row = {"phase": "ksweep_time", "shape": [h, w], "inner": 5, "card": card,
                   "timing": "CUDA-graph replay, in turns", "ms": ms,
                   "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                   "design_bytes": work["design_bytes"],
                   "share": work["bound_ms"] / min(ms["ksweep"]),
                   "chain_share": work["bound_ms"] / min(ms["chain"]),
                   "speedup_over_chain": min(ms["chain"]) / min(ms["ksweep"])}
            emit(row)
            out["device"][f"{w}x{h}"] = {k: min(v) for k, v in ms.items()}
        del x, T, uv, hoist
        torch.cuda.empty_cache()
    return out


def phase_median(card: str, shapes=(SIZES[0], SIZES[1], SIZE_4K) + PROLOGUE_SHAPES
                 + KSWEEP_SHAPES) -> dict:
    """add_median at MEDIAN_RADII against its plain version, bitwise, at
    every shape of ``shapes`` its reflected window fits (min(h, w) > R/2);
    the 5x5 at 1920x1080 and 3840x2160 by CUDA-graph replay. Returns
    {max_abs_err, device: {shape: ms}}."""
    import torch

    from tpuflow_torch.ops import level as L
    from tpuflow_torch.tools.roofline import graph_ms, kernel_work

    out = {"max_abs_err": 0.0, "device": {}}
    for w, h in shapes:
        x = kernel_inputs(w, h)
        for r in MEDIAN_RADII:
            if min(h, w) <= r // 2:
                continue
            got = L.add_median(x["T"], x["uvf"], r)
            want = L.add_median_plain(x["T"], x["uvf"], r)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            row = {"phase": "median", "shape": [h, w], "radius": r, "max_abs_err": err,
                   "bound": BOUNDS["add_median"], "ok": err <= BOUNDS["add_median"]}
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"add_median at {w}x{h}, R={r}: {err}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
        if (w, h) in (SIZES[1], SIZE_4K):
            ms = graph_ms(lambda: L.add_median(x["T"], x["uvf"], 5), calls=20, replays=5)
            work = kernel_work("add_median", h, w)
            emit({"phase": "median_time", "shape": [h, w], "radius": 5, "card": card,
                  "timing": "CUDA-graph replay", "ms": ms, "bound_ms": work["bound_ms"],
                  "bound_by": work["bound_by"], "share": work["bound_ms"] / ms})
            out["device"][f"{w}x{h}"] = ms
        del x
        torch.cuda.empty_cache()
    return out


def banded_inputs(w: int, h: int, seed: int = 2) -> dict:
    """A seeded frame pair (2, h, w) of intensities and, for each level of
    the full_model() schedule after the coarsest, a flow at the size of the
    level before it, all on the card."""
    import torch

    from tpuflow_torch import models
    from tpuflow_torch.pyramid import level_schedule

    cfg = models.full_model()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    flows = [t(rng.standard_normal((2, a.height, a.width)) * 4.0) for a in specs[:-1]]
    return {"cfg": cfg, "specs": specs, "pair": t(rng.random((2, h, w)) * 255.0),
            "flows": flows}


def frame_sizes(specs, w: int, h: int) -> tuple:
    """The frame pyramid's sizes as the solve takes them: each distinct size
    of the levels but level 0 and the full size."""
    return tuple(dict.fromkeys((s.width, s.height) for s in specs
                               if s.level != 0 and (s.width, s.height) != (w, h)))


def banded_calls(x: dict, smoothed) -> dict:
    """One pair's calls of the banded kernels as the solve makes them, by
    wrapper: the presmooth of the pair; the frame pyramid of ``smoothed``
    (every level's frames, one call); each level's flow from the level
    before where the size changes: {wrapper: [(kind, input, specs along x,
    specs along y)]}, kind "gaussian", "levels" or "resample"
    (``banded_runner`` makes them)."""
    from tpuflow_torch.ops.gaussian import gaussian_band
    from tpuflow_torch.ops.resample import resample_band

    sigma = float(x["cfg"].gaussian_sigma)
    h, w = x["pair"].shape[-2:]
    calls = {"gaussian_smooth": [("gaussian", x["pair"], ((gaussian_band, w, sigma),),
                                  ((gaussian_band, h, sigma),))], "resample": []}
    sizes = frame_sizes(x["specs"], w, h)
    if sizes:
        calls["resample"].append(("levels", smoothed,
                                  tuple((resample_band, w, a) for a, _ in sizes),
                                  tuple((resample_band, h, b) for _, b in sizes)))
    for p, s in enumerate(x["specs"][1:], 1):
        flow = x["flows"][p - 1]
        ih, iw = flow.shape[-2:]
        if (ih, iw) != (s.height, s.width):
            calls["resample"].append(("resample", flow, ((resample_band, iw, s.width),),
                                      ((resample_band, ih, s.height),)))
    return calls


def banded_runner(calls: list, form: str):
    """A function that makes ``calls`` in ``form``: "kernel" (the wrapper),
    "plain" (its plain version), "x" or "y" (only the X, or only the Y,
    launches of the wrapper's kernels; "y" reads X's outputs, made here
    once) or "dense" (the dense torch.matmul pair of the same weights, the
    library yardstick; its matrices are uploaded here, once)."""
    import torch

    from tpuflow_torch.ops import banded as B
    from tpuflow_torch.ops.gaussian import conv_matrix, gaussian_smooth, gaussian_smooth_plain
    from tpuflow_torch.ops.resample import (
        resample, resample_levels, resample_levels_plain, resample_plain, resample_weights,
    )

    def sizes(xs, ys):
        return tuple((bx[2], by[2]) for bx, by in zip(xs, ys))

    if form in ("kernel", "plain"):
        kernel = form == "kernel"

        def one(kind, img, xs, ys):
            if kind == "gaussian":
                return (gaussian_smooth if kernel else gaussian_smooth_plain)(img, xs[0][2])
            if kind == "levels":
                return (resample_levels if kernel else resample_levels_plain)(img, sizes(xs, ys))
            return (resample if kernel else resample_plain)(img, xs[0][2], ys[0][2])
        return lambda: [one(*c) for c in calls]
    if form == "x":
        return lambda: [B.banded_x(img, xs) for _, img, xs, _ in calls]
    if form == "y":
        tmps = [(B.banded_x(img, xs), tuple(img.shape[:-2]), img.shape[-2],
                 tuple(b.out_n for b in B.bands(xs)), ys) for _, img, xs, ys in calls]
        return lambda: [B.banded_y(tmp, lead, h, ys, widths)
                        for tmp, lead, h, widths, ys in tmps]
    mats = []
    for kind, img, xs, ys in calls:
        ih, iw = img.shape[-2:]
        for (_, _, a), (_, _, b) in zip(xs, ys):
            if kind == "gaussian":
                mx, my = conv_matrix(iw, float(a)), conv_matrix(ih, float(a))
            else:
                mx, my = resample_weights(iw, a), resample_weights(ih, b)
            mats.append((img, torch.from_numpy(mx).cuda(), torch.from_numpy(my).cuda()))
    return lambda: [torch.matmul(my, torch.matmul(img, mx.T)) for img, mx, my in mats]


def banded_time(x: dict, smoothed, card: str) -> dict:
    """Per pair of ``x``'s size: each wrapper's device ms by CUDA-graph replay
    of the pair's calls, in turns with the dense torch.matmul pair of the
    same weights (TF32 off; the library yardstick, which the port does not
    call), its X and Y launches alone, the plain version's ms, and the
    bounds; and the dense matrices' bytes against the plans'. Emits the row
    and returns it."""
    import torch

    from tpuflow_torch.ops import banded as B
    from tpuflow_torch.tools.roofline import (
        F32_ISSUE_PER_S, PEAK_BYTES_PER_S, banded_launches, cuda_ms, graph_ms, kernel_work,
    )

    h, w = x["pair"].shape[-2:]
    calls = banded_calls(x, smoothed)
    launches = banded_launches(w, h, x["cfg"])
    bounds = {"gaussian_smooth": launches[:2], "resample": launches[2:]}
    row = {"phase": "banded_time", "shape": [h, w], "config": "models.full_model()",
           "card": card, "timing": "CUDA-graph replay of one pair's calls, in turns "
           "(kernel, dense, dense, kernel; then X alone, Y alone); plain: CUDA events over "
           "one call, host-paced"}
    for name in BANDED:
        runs = {form: banded_runner(calls[name], form) for form in ("kernel", "dense")}
        ms = {form: [] for form in runs}
        for form in ("kernel", "dense", "dense", "kernel"):
            ms[form].append(graph_ms(runs[form], calls=1, replays=BANDED_REPLAYS))
        del runs
        works = [(n, kernel_work(n, lh, lw, **kw)) for n, lh, lw, kw in bounds[name]]
        t_bytes = sum(k["bytes"] for _, k in works) / PEAK_BYTES_PER_S * 1e3
        t_ops = sum(k["instructions"] for _, k in works) / F32_ISSUE_PER_S * 1e3
        row[name] = {"launches_per_pair": len(works), "ms": min(ms["kernel"]),
                     "ms_all": ms["kernel"], "library_ms": min(ms["dense"]),
                     "library_ms_all": ms["dense"],
                     "plain_ms": cuda_ms(banded_runner(calls[name], "plain"), 1),
                     "bound_ms": sum(k["bound_ms"] for _, k in works),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes_per_pair": sum(k["bytes"] for _, k in works), "passes": {}}
        for axis, kernel in (("x", "banded_x_kernel"), ("y", "banded_y_kernel")):
            mine = [k for n, k in works if n == f"banded_{axis}"]
            run = banded_runner(calls[name], axis)
            t = graph_ms(run, calls=1, replays=BANDED_REPLAYS)
            bound = sum(k["bound_ms"] for k in mine)
            row[name]["passes"][kernel] = {"launches_per_pair": len(mine), "ms": t,
                                           "bound_ms": bound, "share": bound / t}
            del run
        row[name]["share"] = row[name]["bound_ms"] / row[name]["ms"]
        row[name]["speedup_over_dense"] = row[name]["library_ms"] / row[name]["ms"]
        torch.cuda.empty_cache()
    # what each form keeps on the card: every dense matrix of a pair against
    # every plan
    dense_keys, plan_bytes = set(), 0
    for kind, img, xs, ys in calls["gaussian_smooth"] + calls["resample"]:
        ih, iw = img.shape[-2:]
        for (_, _, a), (_, _, b) in zip(xs, ys):
            dense_keys |= ({("g", iw), ("g", ih)} if kind == "gaussian"
                           else {("r", iw, a), ("r", ih, b)})
        widths = tuple(bd.out_n for bd in B.bands(xs))
        planes = int(np.prod(img.shape[:-2]))
        plan_bytes += (B.plan_table(B.AXIS_X, xs, (), 0, img.device).nbytes
                       + B.plan_table(B.AXIS_Y, ys, widths, planes, img.device).nbytes)
    row["dense_matrix_bytes"] = sum(4 * k[1] * (k[1] if k[0] == "g" else k[2])
                                    for k in dense_keys)
    row["table_bytes"] = plan_bytes
    row["plans"] = 2 * len(calls["gaussian_smooth"] + calls["resample"])
    emit(row)
    return row


def phase_banded(card: str) -> dict:
    """Phase 3b: both banded kernels under both wrappers, bitwise
    (BANDED_BOUND) against their plain versions: the presmooth at
    BANDED_SIZES (sigma 1.5) and at BANDED_SMALL (BANDED_SIGMAS); the frame pyramid of their full_model() schedules from
    the smoothed pair in its one X and one Y launch (every level's X output
    against banded_plain along x, every level against resample_plain), and
    every level's flow from the level before; rows too wide for one staged
    buffer of 8 rows (BANDED_WIDE); then ``banded_time`` at each of
    BANDED_SIZES. Returns {wrapper: kernels-line numbers at 3840x2160}, with
    the dense matrices' and the plans' bytes there. Launches here are not
    counted on the main path."""
    import torch

    from tpuflow_torch.ops import banded as B
    from tpuflow_torch.ops.gaussian import gaussian_smooth, gaussian_smooth_plain
    from tpuflow_torch.ops.resample import (
        resample, resample_band, resample_levels, resample_levels_plain, resample_plain,
    )

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for matmuls: the dense yardstick would not be float32")
    out = {name: {"max_abs_err": 0.0, "checks": 0} for name in BANDED}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        entry = out[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["checks"] += 1
        if not (err <= BANDED_BOUND and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} {what}: max abs {err} > {BANDED_BOUND}, or non-finite")

    def pyramid(img, sizes, what):
        """The frame pyramid in its two launches, level by level, and the X
        launch's intermediate."""
        h, w = img.shape[-2:]
        for (ow, oh), got, want in zip(sizes, resample_levels(img, sizes),
                                       resample_levels_plain(img, sizes)):
            check("resample", got, want, f"{what} {tuple(img.shape)} -> {oh}x{ow}")
        xs = tuple((resample_band, w, ow) for ow, _ in sizes)
        tmp = B.banded_x(img, xs)
        for (ow, _), band, got in zip(sizes, B.bands(xs), B.x_views(
                tmp, tuple(img.shape[:-2]), h, tuple(ow for ow, _ in sizes))):
            check("resample", got, B.banded_plain(img, band, B.AXIS_X),
                  f"{what} X pass {tuple(img.shape)} -> {ow} wide")

    for w, h in BANDED_SMALL:
        pair = torch.from_numpy(np.random.default_rng(w).random((2, h, w), np.float32)).cuda()
        for sigma in BANDED_SIGMAS:
            check("gaussian_smooth", gaussian_smooth(pair, sigma),
                  gaussian_smooth_plain(pair, sigma), f"at {w}x{h}, sigma {sigma}")
    for w, h in BANDED_WIDE:
        pair = torch.from_numpy(np.random.default_rng(h).random((2, h, w), np.float32)).cuda()
        check("gaussian_smooth", gaussian_smooth(pair, 1.5), gaussian_smooth_plain(pair, 1.5),
              f"a row of {w} floats")
        pyramid(pair, ((w // 2 + 1, h), (w // 7, max(1, h // 2)), (5, 1)), "a wide row:")
    for w, h in BANDED_SIZES:
        x = banded_inputs(w, h)
        sigma = x["cfg"].gaussian_sigma
        sm = gaussian_smooth(x["pair"], sigma)
        check("gaussian_smooth", sm, gaussian_smooth_plain(x["pair"], sigma), f"at {w}x{h}")
        pyramid(sm, frame_sizes(x["specs"], w, h), "frames")
        for kind, img, xs, ys in banded_calls(x, sm)["resample"][1:]:
            check("resample", resample(img, xs[0][2], ys[0][2]),
                  resample_plain(img, xs[0][2], ys[0][2]),
                  f"flow {tuple(img.shape)} -> {ys[0][2]}x{xs[0][2]}")
        emit({"phase": "banded", "shape": [h, w], "config": "models.full_model()",
              "levels": len(x["specs"]), "checks": {k: v["checks"] for k, v in out.items()},
              "max_abs_err": {k: v["max_abs_err"] for k, v in out.items()},
              "bound": BANDED_BOUND, "ok": True})
        row = banded_time(x, sm, card)
        for name in BANDED:
            out[name].setdefault("ms_by_shape", {})[f"{w}x{h}"] = {
                k: row[name][k] for k in ("ms", "library_ms", "plain_ms", "bound_ms", "passes")}
        del x, sm
        torch.cuda.empty_cache()
    for name in BANDED:        # the kernels line's numbers: the last size, 3840x2160
        out[name].update({k: row[name][k] for k in (
            "ms", "library_ms", "plain_ms", "bound_ms", "bound_by", "share",
            "launches_per_pair", "bytes_per_pair", "passes")})
    out["dense_matrix_bytes"], out["table_bytes"] = row["dense_matrix_bytes"], row["table_bytes"]
    return out


def row_ranges(h: int) -> tuple:
    """Output row ranges of an h-row level: the first and last row alone,
    bands at both edges, a band inside, and the whole level."""
    third = max(1, h // 3)
    return ((0, 1), (0, third), (third, min(h, 2 * third + 5)), (h - third, h), (h - 1, h),
            (0, h))


def phase_rows(card: str) -> dict:
    """Phase 3c: the row ranges of the whole-field stages (warp,
    level_derivs, level_tensor gradient and log, add_median at every
    radius, the flow's resample) at ROW_SIZES over ``row_ranges``: each
    range's rows bitwise those of the whole-field launch and of the plain
    version's range, the output's other rows untouched (a NaN-filled
    ``out``). Then the band path of one process at 1920x1080 for each
    constancy, emulated on this card (``solver.bands.emulate_shard``: the
    plan's rows alone, every other row of each stage's buffer NaN): each
    shard of ROW_SHARDS under the kernel and the explicit routes, its owned
    rows bitwise the whole solve's, its rows per stage the plan's.
    Launches here are not counted on the main path."""
    import torch

    from tpuflow_torch import models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops import level as L
    from tpuflow_torch.ops.resample import resample, resample_plain
    from tpuflow_torch.ops.warp import warp, warp_plain
    from tpuflow_torch.parallel.mesh import Mesh
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.solver.bands import band_plan, emulate_shard, stage_rows
    from tpuflow_torch.solver.sharded import sharded_plan

    t0 = time.perf_counter()
    checks = {}
    nan = float("nan")

    def check(name, kern, plain, shape, lo, hi, whole, what):
        """Rows lo..hi-1 into a NaN-filled whole-size output: bitwise the
        whole launch's, the plain version's rows within phase 3's bound (0
        for the median and the resample), and no other row written."""
        out = torch.full(shape, nan, device="cuda")
        got = kern(rows=(lo, hi), out=out)
        want = plain(rows=(lo, hi))[..., lo:hi, :]
        torch.cuda.synchronize()
        inside = got[..., lo:hi, :]
        err = float((inside - want).abs().max())
        base = name.rsplit("_", 1)[0] if name.startswith("add_median") else name
        if base in ELEMENTWISE_RELATIVE:
            checked = float(((inside - want).abs() / want.abs().clamp_min(1e-30)).max())
        elif base in FIELD_RELATIVE:
            checked = err / max(float(want.abs().max()), 1e-30)
        else:
            checked = err
        bound = BANDED_BOUND if base == "resample" else BOUNDS[base]
        entry = checks.setdefault(name, {"checks": 0, "plain_max_abs_err": 0.0, "bound": bound})
        entry["checks"] += 1
        entry["plain_max_abs_err"] = max(entry["plain_max_abs_err"], err)
        if not (got is out and torch.equal(inside, whole[..., lo:hi, :]) and checked <= bound
                and bool(torch.isnan(got[..., :lo, :]).all()
                         and torch.isnan(got[..., hi:, :]).all())):
            raise AssertionError(f"{name} rows {lo}..{hi - 1} {what}: not bitwise the whole "
                                 f"launch's, {checked} > {bound} against the plain version, or "
                                 "a row outside written")

    for w, h in ROW_SIZES:
        x = kernel_inputs(w, h)
        sc, uvf = x["sc"], x["uvf"]
        f1w = warp(x["f0"], x["f1"], uvf, sc.inv_hx, sc.inv_hy)
        fxyz = L.level_derivs(x["f0"], f1w, sc.div4hx, sc.div4hy)
        calls = {
            "warp": ((h, w), lambda **kw: warp(x["f0"], x["f1"], uvf, sc.inv_hx, sc.inv_hy, **kw),
                     lambda **kw: warp_plain(x["f0"], x["f1"], uvf, sc.inv_hx, sc.inv_hy, **kw)),
            "level_derivs": ((3, h, w),
                             lambda **kw: L.level_derivs(x["f0"], f1w, sc.div4hx, sc.div4hy, **kw),
                             lambda **kw: L.level_derivs_plain(x["f0"], f1w, sc.div4hx,
                                                               sc.div4hy, **kw))}
        for log in (False, True):
            calls["level_tensor_" + ("log" if log else "gradient")] = (
                (5, h, w), lambda log=log, **kw: L.level_tensor(x["f0"], f1w, fxyz, sc, log, **kw),
                lambda log=log, **kw: L.level_tensor_plain(x["f0"], f1w, fxyz, sc, log, **kw))
        for r in ROW_MEDIAN_RADII:
            calls[f"add_median_{r}"] = (
                (2, h, w), lambda r=r, **kw: L.add_median(x["T"], uvf, r, **kw),
                lambda r=r, **kw: L.add_median_plain(x["T"], uvf, r, **kw))
        for name, (shape, kern, plain) in calls.items():
            whole = kern()
            for lo, hi in row_ranges(h):
                check(name, kern, plain, shape, lo, hi, whole, f"at {w}x{h}")
        cfg = models.full_model()
        specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
        rng = np.random.default_rng(h)
        steps = [(a, b) for a, b in zip(specs, specs[1:])
                 if (a.width, a.height) != (b.width, b.height)]
        for a, b in steps[:1] + steps[-3:]:     # the coarsest and the finest levels' flow
            flow = torch.from_numpy((rng.standard_normal((2, a.height, a.width)) * 4.0)
                                    .astype(np.float32)).cuda()
            shape = (2, b.height, b.width)
            whole = resample(flow, b.width, b.height)
            for lo, hi in row_ranges(b.height):
                check("resample", lambda **kw: resample(flow, b.width, b.height, **kw),
                      lambda **kw: resample_plain(flow, b.width, b.height, **kw), shape, lo, hi,
                      whole, f"{a.width}x{a.height} -> {b.width}x{b.height}")
        del x
        torch.cuda.empty_cache()
    emit({"phase": "rows", "sizes": [[h, w] for w, h in ROW_SIZES], "checks": checks,
          "median_radii": list(ROW_MEDIAN_RADII), "whole_launch_bound": 0.0, "ok": True})

    from tpuflow_torch.synthetic import textured_pair

    w, h = SIZES[1]
    f0, f1 = (torch.from_numpy(np.clip(f, 0.0, 255.0)).cuda() for f in textured_pair(w, h))
    cfgs = {"grey": FlowConfig(), "gradient": models.full_model(),
            "log": models.xray_log(alpha=LOG_ALPHA)}
    for name, cfg in cfgs.items():
        for halo in ("kernel", "explicit"):
            routes = [(r, k) for _, _, r, k in sharded_plan(w, h, cfg, Mesh(ROW_SHARDS, "cuda"),
                                                            halo)]
            for shard in range(ROW_SHARDS):
                plan = band_plan(w, h, cfg, routes, ROW_SHARDS, shard)
                L.reset_row_counts()
                banded, whole = emulate_shard(f0, f1, cfg, plan, fill=nan)
                rows = L.row_counts()
                lo, hi = plan.owned[shard]
                want = stage_rows(w, h, cfg, plan)
                full = stage_rows(w, h, cfg, None)
                row = {"phase": "rows_emulated", "config": name, "route": halo,
                       "shards": ROW_SHARDS, "shard": shard, "banded_levels": len(plan.levels),
                       "levels": len(routes), "rows": {k: rows[k] - full[k] for k in rows},
                       "rows_whole_field": full,
                       "owned_bitwise": bool(torch.equal(banded[:, lo:hi], whole[:, lo:hi])),
                       "others_unwritten": bool(torch.isnan(banded[:, :lo]).all()
                                                and torch.isnan(banded[:, hi:]).all())}
                row["rows_ok"] = row["rows"] == want
                row["ok"] = row["owned_bitwise"] and row["others_unwritten"] and row["rows_ok"]
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"the band path of shard {shard}: {row}")
    phase_rows_lanes(card)
    emit({"phase": "rows_done", "seconds": time.perf_counter() - t0})
    return checks


def phase_rows_lanes(card: str) -> None:
    """Phase 3c, the lanes: the level driver of one process over ROW_SHARDS
    cards (``solve(..., bands=lanes)``), every lane on this card, through
    the emulation seam (``solver.bands.emulate_lanes``: every banded stage
    and the hand-over into a buffer of NaN outside the lane's plan, the
    relaxation the plain ``relax_sharded`` over the owned rows each lane
    holds) for a full_model() pair at 1920x1080 and 3840x2160 on the kernel
    route: the gathered flow bitwise ``compute_flow``'s, each lane's rows
    (``ops.level.row_counts(lane)``) its plan's, the peer copies
    ``bands.lane_copies``."""
    import torch

    from tpuflow_torch import compute_flow, models
    from tpuflow_torch.ops import level as L
    from tpuflow_torch.parallel.mesh import Mesh, peer_copy
    from tpuflow_torch.solver.bands import emulate_lanes, lane_copies, stage_rows
    from tpuflow_torch.solver.sharded import sharded_plan
    from tpuflow_torch.synthetic import textured_pair

    cfg = models.full_model()
    for w, h in (SIZES[1], SIZE_4K):
        t0 = time.perf_counter()
        f0n, f1n = (np.clip(f, 0.0, 255.0).astype(np.float32) for f in textured_pair(w, h))
        base = compute_flow(f0n, f1n, cfg, device="cuda")
        routes = [(r, k) for _, _, r, k in sharded_plan(
            w, h, cfg, Mesh(ROW_SHARDS, "cuda"), "kernel")]
        L.reset_row_counts()
        peer_copy.messages = peer_copy.bytes = 0
        flow, plans = emulate_lanes(torch.from_numpy(f0n).cuda(), torch.from_numpy(f1n).cuda(),
                                    cfg, routes, ROW_SHARDS, fill=float("nan"))
        got = flow.cpu().numpy()
        rows = [L.row_counts(i) for i in range(len(plans))]
        want = [stage_rows(w, h, cfg, p, prefix=i == 0) for i, p in enumerate(plans)]
        row = {"phase": "rows_lanes", "card": card, "shape": [h, w],
               "config": "models.full_model()", "route": "kernel", "lanes": len(plans),
               "banded_levels": len(plans[0].levels), "levels": len(routes),
               "bitwise_compute_flow": got[0].tobytes() == base.u.tobytes()
               and got[1].tobytes() == base.v.tobytes(),
               "rows_by_lane": rows, "rows_expected": want,
               "rows_whole_field": stage_rows(w, h, cfg, None),
               "peer_copies": {"messages": peer_copy.messages, "bytes": peer_copy.bytes},
               "peer_copies_expected": lane_copies(w, h, cfg, plans),
               "seconds": time.perf_counter() - t0}
        row["ok"] = (row["bitwise_compute_flow"] and rows == want
                     and row["peer_copies"] == row["peer_copies_expected"])
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"the lanes emulated at {w}x{h}: {row}")
        del flow
        torch.cuda.empty_cache()


def expected_launches(w: int, h: int, cfg, levels: range = None, smooth: bool = True) -> dict:
    """The solve's launches of a w x h pair, or of the positions ``levels``
    of its schedule (``smooth``: with the presmooth). The banded kernels
    (``roofline.banded_launches``): two (X, then Y) for the presmooth, two
    for the frame pyramid of the levels (every level but level 0 and the
    full size, at once; none if there is none) and two for the flow at every
    level after the coarsest whose size differs from the level before."""
    from tpuflow_torch.config import DataConstancy
    from tpuflow_torch.ops.level import KMAX
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.tools.roofline import banded_launches

    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    levels = range(len(specs)) if levels is None else levels
    n = len(levels)
    smoothing = 2 if smooth and cfg.gaussian_sigma > 0 else 0
    outer, inner = cfg.outer_iterations_count, cfg.inner_iterations_count
    tensor = cfg.data_constancy != DataConstancy.GREY
    return {"gaussian_smooth": smoothing,
            "resample": len(banded_launches(w, h, cfg, levels, smooth)) - smoothing,
            "warp": n, "level_derivs": n, "level_tensor": n if tensor else 0,
            "outer_prologue": 0 if tensor else n * outer,
            "outer_prologue_tensor": n * outer if tensor else 0, "jacobi_sweep": 0,
            "jacobi_sweeps": n * outer * -(-inner // KMAX), "add_median": n, "levels": n}


def phase_e2e(w: int, h: int, preset: str, counts_total: dict, oracle: bool = False,
              shift_bound: float | None = None, **preset_kw):
    """The main path at (w, h) with ``models.<preset>(**preset_kw)``; checks
    it against the plain path, the true shift (within ``shift_bound``, by
    default SHIFT_BOUNDS of the constancy) and (``oracle``) the NumPy oracle
    on the reduced schedule at the preset's alpha. Returns the pair for the
    timing phase."""
    import torch

    from tpuflow_torch import FlowConfig, compute_flow, endpoint_error, models
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.solver.level import CHAIN_STEPS, PLAIN_STEPS, solve
    from tpuflow_torch.synthetic import shift_epe, textured_pair

    cfg = getattr(models, preset)(**preset_kw)
    label = f"models.{preset}({', '.join(f'{k}={v}' for k, v in preset_kw.items())})"
    constancy = cfg.data_constancy.value
    shift_bound = SHIFT_BOUNDS[constancy] if shift_bound is None else shift_bound
    f0, f1 = textured_pair(w, h)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = compute_flow(f0, f1, cfg, device="cuda")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(w, h, cfg)
    emit({"phase": "launches", "shape": [h, w], "config": label,
          "levels": want["levels"], "counts": counts,
          "expected": {k: want[k] for k in counts}})
    for name, n in counts.items():
        if n != want[name]:
            raise AssertionError(f"{name}: {n} launches at {w}x{h}, expected {want[name]}")
        counts_total[name] = counts_total.get(name, 0) + n

    if res.u.shape != (h, w) or not (np.isfinite(res.u).all() and np.isfinite(res.v).all()):
        raise AssertionError(f"bad output at {w}x{h}: shape {res.u.shape}, or non-finite")
    t0 = time.perf_counter()
    with torch.cuda.device(0):
        frames = torch.from_numpy(f0).cuda(), torch.from_numpy(f1).cuda()
        uv = solve(*frames, cfg, _steps=PLAIN_STEPS).cpu().numpy()
        plain_s = time.perf_counter() - t0
        chain = solve(*frames, cfg, _steps=CHAIN_STEPS).cpu().numpy()
    chain_same = res.u.tobytes() == chain[0].tobytes() and res.v.tobytes() == chain[1].tobytes()
    epe_plain = endpoint_error(res.u, res.v, uv[0], uv[1])
    epe_shift = shift_epe(res.u, res.v)
    row = {"phase": "e2e", "shape": [h, w], "config": label,
           "constancy": constancy, "epe_kernel_vs_plain": epe_plain,
           "epe_vs_true_shift": epe_shift, "true_shift_bound": shift_bound,
           "flow_bitwise_equal_to_one_sweep_chain": chain_same,
           "kernel_wall_s": res.seconds, "plain_wall_s": plain_s,
           "max_memory_allocated_bytes": peak,
           "mean_u": float(res.u.mean()), "mean_v": float(res.v.mean())}
    checks = [("kernel_vs_plain", epe_plain, 1e-3),
              ("true_shift", epe_shift, shift_bound)]
    if oracle:
        from tpuflow_torch import oracle_np

        kw = dict(ORACLE_KW, equation_alpha=cfg.equation_alpha)
        t0 = time.perf_counter()
        ou, ov = oracle_np.compute_flow(f0, f1, data_constancy=constancy, **kw)
        row["oracle_seconds"] = time.perf_counter() - t0
        red = compute_flow(f0, f1, FlowConfig(data_constancy=cfg.data_constancy, **kw),
                           device="cuda")
        row["epe_vs_oracle_reduced"] = endpoint_error(red.u, red.v, ou, ov)
        checks.append(("oracle_reduced", row["epe_vs_oracle_reduced"], 0.05))
    row["ok"] = all(v <= b for _, v, b in checks) and chain_same
    emit(row)
    for name, v, b in checks:
        if not v <= b:
            raise AssertionError(f"{name} at {w}x{h}, {preset}: {v} > {b}")
    if not chain_same:
        raise AssertionError(f"the flow at {w}x{h}, {preset} differs from the one-sweep chain's")
    return f0, f1


def phase_cli(w: int = 584, h: int = 388):
    """The CLI on the card in a subprocess at xray_log(alpha=LOG_ALPHA),
    against compute_flow in this one and against the true shift."""
    from tpuflow_torch import compute_flow, models
    from tpuflow_torch.io import read_frame, read_raw_f32, write_raw_u8
    from tpuflow_torch.synthetic import shift_epe, textured_pair

    f0, f1 = textured_pair(w, h)
    cfg = models.xray_log(alpha=LOG_ALPHA)
    sweep = [str(cfg.equation_alpha), str(cfg.gaussian_sigma)]
    prefix = f"alpha{sweep[0]}_sigma{sweep[1]}_"   # the CLI's names for a sweep run
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("f1.raw", "f2.raw")]
        write_raw_u8(paths[0], f0)
        write_raw_u8(paths[1], f1)
        out = os.path.join(tmp, "out")
        # A sweep run takes a counter too, and names its outputs by the sweep.
        cmd = [sys.executable, "-m", "tpuflow_torch.cli", *paths, str(w), str(h), "0", out,
               *sweep, "--constancy", "log"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        header = len(f"P6 \n{w} {h} \n255\n")
        flow = {c: f"{prefix}flow-{c}-{w}-{h}.raw" for c in "uv"}
        sizes = {flow["u"]: w * h * 4, flow["v"]: w * h * 4,
                 f"{prefix}res.pgm": header + w * h * 3, f"{prefix}amp-{w}-{h}.raw": w * h * 4}
        got_sizes = {n: os.path.getsize(os.path.join(out, n))
                     for n in sizes if os.path.exists(os.path.join(out, n))}
        if got_sizes != sizes:
            raise AssertionError(f"cli outputs wrong: {got_sizes}, expected {sizes}")
        res = compute_flow(read_frame(paths[0], w, h), read_frame(paths[1], w, h), cfg,
                           device="cuda")
        same = {c: open(os.path.join(out, flow[c]), "rb").read()
                == np.asarray(getattr(res, c), "<f4").tobytes() for c in "uv"}
        epe_shift = shift_epe(*(read_raw_f32(os.path.join(out, flow[c]), w, h) for c in "uv"))
    row = {"phase": "cli", "shape": [h, w], "argv": cmd[3:], "seconds": cli_s,
           "stdout": proc.stdout.strip().splitlines(), "sizes": got_sizes,
           "flow_bytewise_equal": same, "epe_vs_true_shift": epe_shift,
           "true_shift_bound": SHIFT_BOUNDS["log"]}
    row["ok"] = same == {"u": True, "v": True} and epe_shift <= SHIFT_BOUNDS["log"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"cli outputs wrong: bytewise {same}, shift EPE {epe_shift}")


def phase_times(w: int, h: int, f0, f1, card: str, preset: str, reps: dict):
    """Median ms per pair by CUDA events after one warm-up pair, for the
    paths named in ``reps`` ({"kernel": n, "plain": n}); returns the row."""
    import torch

    from tpuflow_torch import compute_flow, models
    from tpuflow_torch.solver.level import PLAIN_STEPS, solve
    from tpuflow_torch.tools.roofline import cuda_ms

    cfg = getattr(models, preset)()
    t0, t1 = torch.from_numpy(f0).cuda(), torch.from_numpy(f1).cuda()
    paths = {"kernel": lambda: compute_flow(f0, f1, cfg, device="cuda"),
             "plain": lambda: solve(t0, t1, cfg, _steps=PLAIN_STEPS).cpu()}

    row = {"phase": "times", "shape": [h, w], "card": card, "config": f"models.{preset}()",
           "constancy": cfg.data_constancy.value}
    for label, n in reps.items():
        fn = paths[label]
        fn()  # warm-up pair
        ms = [cuda_ms(fn, 1, warmup=False) for _ in range(n)]
        med = statistics.median(ms)
        row[f"{label}_ms_median"] = med
        row[f"{label}_ms_all"] = ms
        row[f"{label}_mpix_per_s"] = w * h / (med * 1e-3) / 1e6
    emit(row)
    return row


def sass_loads_in_loop(lib_path) -> dict:
    """{body: ld.shared instructions in roofline_micro_kernel<body>'s SASS}."""
    from tpuflow_torch.tools.roofline import BODIES, sass_counts

    counts = sass_counts(lib_path)
    return {name: sum(c.get("LDS", 0) for fn, c in counts.items()
                      if f"roofline_micro_kernelILi{i}E" in fn)
            for i, name in enumerate(BODIES)}


def phase_probes(lib_path) -> dict:
    """The probe kernels against their plain versions, then the measurement
    path with its launch counts. Returns the one-sweep kernel's launches on
    that path and the kernels-line rows of both probes."""
    import torch

    from tpuflow_torch.tools import probe_kernel_matmul as P
    from tpuflow_torch.tools import roofline as R

    # --- each kernel against its plain version (launches not counted below)
    rng = np.random.default_rng(0)
    ins = torch.from_numpy(rng.random((R.N_IN, R.HB, R.WB), np.float32) + 0.5).cuda()
    loads = sass_loads_in_loop(lib_path)
    micro_err = 0.0
    for name in R.BODIES:
        got = R.roofline_micro(name, ins[0], ins[1:], PROBE_PASSES_CHECK)
        want = R.roofline_micro_plain(name, ins[0], ins[1:], PROBE_PASSES_CHECK)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        micro_err = max(micro_err, err)
        # one ld.shared per pixel per pass: UNROLL x BAND in the loop body
        row = {"phase": "probe_kernel", "name": f"roofline_micro_{name}",
               "passes": PROBE_PASSES_CHECK * R.UNROLL, "max_abs_err": err, "bound": 0.0,
               "finite": bool(torch.isfinite(got).all()), "sass_lds": loads[name],
               "sass_lds_needed": R.UNROLL * R.BAND}
        row["ok"] = err <= 0.0 and row["finite"] and loads[name] >= R.UNROLL * R.BAND
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"roofline_micro {name}: {row}")
    torch.backends.cuda.matmul.allow_tf32 = False
    mm_err = 0.0
    for m, k, n in MATMUL_SHAPES:
        a_np, b_np = P.probe_inputs(m, k, n)
        a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
        got, plain = P.probe_matmul(a, b), P.probe_matmul_plain(a, b)
        err = float((got - plain).abs().max())
        mm_err = max(mm_err, err)
        rel = err / float(plain.abs().max())
        vs_lib = P.compare(got.cpu().numpy(), torch.matmul(a, b).cpu().numpy())
        row = {"phase": "probe_kernel", "name": "probe_matmul", "shape": [[m, k], [k, n]],
               "max_abs_err": err, "checked": rel, "bound": MATMUL_REL_BOUND,
               "vs_torch_matmul": vs_lib, "vs_torch_matmul_bound": MATMUL_LIB_REL_BOUND,
               "ok": rel <= MATMUL_REL_BOUND and vs_lib["rel"] <= MATMUL_LIB_REL_BOUND}
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"probe_matmul at {m}x{k}x{n}: {row}")

    # --- the measurement path: counts 0 just before, read just after. It
    # differences the relaxation with the one-sweep kernel chained, the only
    # path that kernel is on.
    from tpuflow_torch.ops import level as L

    R.roofline_micro.launches = P.probe_matmul.launches = L.jacobi_sweep.launches = 0
    roof = R.measure(log=lambda line: emit({"phase": "roofline_log", "line": line}))
    probe = P.run()
    launches = {"roofline_micro": R.roofline_micro.launches,
                "probe_matmul": P.probe_matmul.launches,
                "jacobi_sweep": L.jacobi_sweep.launches}
    emit({"phase": "roofline", **roof})
    emit({"phase": "probe_matmul", **probe})
    emit({"phase": "probe_launches", "counts": launches})
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe kernel was never launched on its path: {launches}")

    # --- times for the kernels line (not counted)
    micro_ms = {name: R.cuda_ms(
        lambda n=name: R.roofline_micro(n, ins[0], ins[1:], R.T_LOOP), 5) for name in R.BODIES}
    micro_plain_ms = {name: R.cuda_ms(
        lambda n=name: R.roofline_micro_plain(n, ins[0], ins[1:], R.T_LOOP), 1)
        for name in ("stream", "phi")}
    body_work = {n: R.kernel_work(f"roofline_micro_{n}", R.HB, R.WB) for n in R.BODIES}
    work = body_work["stream"]
    mm_work = R.kernel_work("probe_matmul", P.HB, P.W0)
    a, b = (torch.from_numpy(t).cuda() for t in P.probe_inputs())
    return launches["jacobi_sweep"], {
        "roofline_micro": {
            "source": "tpuflow_torch/csrc/probes.cu", "launches": launches["roofline_micro"],
            "max_abs_err": micro_err, "shape": [R.HB, R.WB], "passes": R.PASSES,
            "ms": micro_ms["stream"], "plain_ms": micro_plain_ms["stream"],
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "resource": work["resource"], "share": work["bound_ms"] / micro_ms["stream"],
            "library_ms": None, "library": "none", "body": "stream", "ms_by_body": micro_ms,
            "phi_plain_ms": micro_plain_ms["phi"],
            "bound_by_body": {n: {k: v[k] for k in ("bound_ms", "resource")}
                              for n, v in body_work.items()},
            "share_by_body": {n: body_work[n]["bound_ms"] / micro_ms[n] for n in R.BODIES}},
        "probe_matmul": {
            "source": "tpuflow_torch/csrc/probes.cu", "launches": launches["probe_matmul"],
            "max_abs_err": mm_err, "shape": [[P.HB, P.H0], [P.H0, P.W0]], "ms": probe["ms"],
            "plain_ms": R.cuda_ms(lambda: P.probe_matmul_plain(a, b), 3),
            "bound_ms": mm_work["bound_ms"], "bound_by": mm_work["bound_by"],
            "resource": mm_work["resource"], "share": mm_work["bound_ms"] / probe["ms"],
            "library_ms": probe["library_ms"], "library": probe["library"],
            "timing": probe["timing"], "host_paced_ms": probe["host_paced_ms"],
            "library_host_paced_ms": probe["library_host_paced_ms"],
            "launch_floor_ms": probe["launch_floor_ms"], "ms_unaligned": probe["ms_unaligned"],
            "redesigned": REDESIGNED["probe_matmul"]},
    }


LEVEL_WORK = ("warp", "level_derivs", "level_tensor_gradient", "level_tensor_log",
              "outer_prologue", "outer_prologue_tensor", "jacobi_sweep", "jacobi_sweeps",
              "add_median")


def phase_sass(lib_path) -> None:
    """Static SASS counts (roofline.sass_counts) of the k-sweep kernel (5
    sweeps), the 5x5 median, the log tensor and the sharded kernel: all
    instructions, the float32 arithmetic (FADD, FMUL, FFMA, MUFU), FMNMX,
    shared-memory loads and stores, and per unit of the code that one thread
    runs, every branch counted once: a pixel-sweep for the k-sweep, a pixel
    (two planes) for the median; the whole kernel for the other two, whose
    loops run a data-dependent number of times."""
    from tpuflow_torch.ops.level import KMAX, KSWEEP_RH
    from tpuflow_torch.tools.roofline import sass_counts

    kinds = {"float32": ("FADD", "FMUL", "FFMA", "MUFU"), "mufu": ("MUFU",),
             "fmnmx": ("FMNMX",), "shared": ("LDS", "STS")}
    # a k-sweep thread sweeps KSWEEP_RH / 8 pixels (csrc/level_body.cuh: KS_TY)
    wanted = {f"jacobi_sweeps_kernelILi{KMAX}E": KSWEEP_RH // 8 * KMAX,
              "add_median_kernelILi5E": 1, "level_tensor_log_kernel": 1,
              "relax_sharded_kernelILb0E": 1, "relax_sharded_kernelILb1E": 1}
    for fn, c in sass_counts(lib_path).items():
        for key, units in wanted.items():
            if key in fn:
                total = sum(c.values())
                row = {"phase": "sass", "kernel": key, "instructions": total,
                       **{k: sum(c.get(op, 0) for op in ops) for k, ops in kinds.items()},
                       "units": units, "instructions_per_unit": total / units}
                emit(row)


def phase_bounds(table: dict) -> dict:
    """Each level kernel's work and bound at 1920x1080 and 3840x2160 beside
    its measured ms; returns {name: bound row at 3840x2160}."""
    from tpuflow_torch.tools.roofline import kernel_work

    at_4k = {}
    for (w, h), suffix in ((SIZES[1], ""), (SIZE_4K, "_4k")):
        for name in LEVEL_WORK:
            work = kernel_work(name, h, w)
            ms = table[name]["ms" + suffix]
            row = {"phase": "bound", "name": name, "shape": [h, w], **work, "ms": ms,
                   "share": work["bound_ms"] / ms, "library_ms": None, "library": "none"}
            if name == "warp":
                row["near_twin_ms"] = table[name]["near_twin_ms" + suffix]
                row["near_twin"] = WARP_TWIN
            emit(row)
            if suffix:
                at_4k[name] = row
    return at_4k


def phase_trace(w: int, h: int, bounds: dict):
    """compute_flow(full_model(), collect_trace=True): one record per level,
    the flow bit for bit equal to an untraced run, the per-level ms beside
    the per-level sum of bound x launches of the level kernels."""
    import torch

    from tpuflow_torch import compute_flow, models
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import level_bound_ms
    from tpuflow_torch.utils import profiling
    from tpuflow_torch.utils.timing import format_level_table

    cfg = models.full_model()
    f0, f1 = textured_pair(w, h)
    plain = compute_flow(f0, f1, cfg, device="cuda")
    reset_launch_counts()
    traced = compute_flow(f0, f1, cfg, collect_trace=True, device="cuda")
    counts = launch_counts()
    want = expected_launches(w, h, cfg)
    if any(counts[k] != want[k] for k in counts):
        raise AssertionError(f"traced run launches {counts}, expected {want}")
    levels = [{"level": t.level, "width": t.width, "height": t.height, "ms": t.seconds * 1e3,
               "bound_ms": level_bound_ms(t.height, t.width, cfg)} for t in traced.levels]
    same = (traced.u.tobytes() == plain.u.tobytes() and traced.v.tobytes() == plain.v.tobytes())
    sum_ms = sum(lv["ms"] for lv in levels)
    row = {"phase": "trace", "shape": [h, w], "config": "models.full_model()",
           "records": len(levels), "expected_records": want["levels"],
           "flow_bitwise_equal_to_untraced": same, "sum_level_ms": sum_ms,
           "pair_ms": traced.seconds * 1e3, "untraced_pair_ms": plain.seconds * 1e3,
           "sum_level_bound_ms": sum(lv["bound_ms"] for lv in levels), "levels": levels,
           "bound_4k_by_kernel": {k: bounds[k]["bound_ms"] for k in bounds}}
    with tempfile.TemporaryDirectory() as tmp:
        small = textured_pair(*SIZES[0])
        with profiling.trace(tmp):
            compute_flow(*small, cfg, device="cuda")
            torch.cuda.synchronize()
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as fh:
            events = json.load(fh).get("traceEvents", [])
    row["profiling_trace_kernel_events"] = sum(1 for e in events if e.get("cat") == "kernel")
    row["ok"] = (same and len(levels) == want["levels"]
                 and row["profiling_trace_kernel_events"] > 0)
    emit(row)
    print(format_level_table(traced.levels), file=sys.stderr, flush=True)
    if not row["ok"]:
        raise AssertionError(f"trace at {w}x{h}: records {len(levels)}, bitwise {same}, "
                             f"profiler kernels {row['profiling_trace_kernel_events']}")


# Phase 12: (width, height, shards, k, constancy, inner) of the
# kernel-vs-plain checks, 40 outers each; log at xray_log(alpha=LOG_ALPHA).
# At 300 x 64 on 4 shards every shard owns the gate's 16 rows: the edge
# shards' padded rows are 22 and the inner ones' 28, fewer than a k-sweep
# region's 32. Inner 7 runs a pass of 5 sweeps and one of 2.
SHARDED_CHECKS = ((584, 388, 4, 1, "grey", 5), (584, 388, 4, 1, "grey", 1),
                  (584, 388, 4, 1, "gradient", 7), (584, 388, 3, 2, "grey", 7),
                  (300, 64, 4, 1, "grey", 5), (300, 64, 4, 1, "log", 5),
                  (1920, 1080, 4, 1, "grey", 5), (1920, 1080, 3, 2, "grey", 5),
                  (1920, 1080, 3, 3, "grey", 5), (1920, 1080, 8, 1, "grey", 5),
                  (1920, 1080, 4, 1, "gradient", 5), (1920, 1080, 4, 1, "log", 5),
                  (3840, 2160, 4, 1, "grey", 5))
# The owned rows are bitwise those of the plain version and of relax.
SHARDED_BOUND = 0.0
SHARDED_TIMED_N_Y = (1, 2, 4)
# rounds of the 1920x1080 pairs timed in turns
SHARDED_ROUNDS = 5
SHARDED_REPLACES = "tpuflow/parallel/halo_kernel.py:100 (relax_sharded_kernel; pl.pallas_call :384)"


def expected_sharded_launches(w: int, h: int, cfg, n_y: int) -> dict:
    """Launch counts of compute_flow_sharded at k = 1: the admitted levels
    make one relax_sharded launch each, the others outer prologues and
    outer k-sweep launches."""
    from tpuflow_torch.parallel import kernel_halo_applicable
    from tpuflow_torch.pyramid import level_schedule

    levels = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    sharded = sum(1 for s in levels if kernel_halo_applicable(s.height, n_y, cfg))
    want = expected_launches(w, h, cfg)
    unsharded = len(levels) - sharded
    prologue = "outer_prologue" if want["outer_prologue"] else "outer_prologue_tensor"
    per_level = want["jacobi_sweeps"] // len(levels)
    want.update({prologue: unsharded * cfg.outer_iterations_count,
                 "jacobi_sweeps": unsharded * per_level, "relax_sharded": sharded})
    return want


def phase_sharded_kernel(card: str) -> dict:
    """relax_sharded_kernel against its plain version and against the
    unsharded kernels (launches not counted on the main path), and the
    kernel's times. Returns the kernels-line row without ``launches``."""
    import dataclasses

    import torch

    from tpuflow_torch import models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import level_tensor_plain
    from tpuflow_torch.parallel import make_mesh, relax_sharded, relax_sharded_kernel
    from tpuflow_torch.parallel.halo_kernel import grid_syncs
    from tpuflow_torch.solver.level import relax
    from tpuflow_torch.tools.roofline import PEAK_BYTES_PER_S, cuda_ms, kernel_work

    bound = SHARDED_BOUND
    max_err, inputs = 0.0, {}
    for w, h, n_y, k, constancy, inner in SHARDED_CHECKS:
        if (w, h) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, h)] = kernel_inputs(w, h)
        x = inputs[(w, h)]
        cfg = {"grey": FlowConfig(), "gradient": models.full_model(),
               "log": models.xray_log(alpha=LOG_ALPHA)}[constancy]
        cfg = dataclasses.replace(cfg, inner_iterations_count=inner)
        J = {"grey": None, "gradient": x["J"],
             "log": level_tensor_plain(x["f0"], x["f1"], x["fxyz"], x["sc"], True)}[constancy]
        mesh = make_mesh(n_y)
        args = (x["fxyz"], x["uvf"], x["sc"], cfg, mesh, k)
        syncs = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = relax_sharded_kernel(*args, J=J, syncs=syncs)
        plain = relax_sharded(*args, J=J)
        unsharded = relax(x["fxyz"], x["uvf"], x["sc"], cfg, J=J)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        vs_relax = float((got - unsharded).abs().max())
        max_err = max(max_err, err, vs_relax)
        row = {"phase": "sharded_kernel", "shape": [h, w], "n_y": n_y, "k": k,
               "constancy": constancy, "inner": inner, "grid_syncs": int(syncs.item()),
               "grid_syncs_expected": grid_syncs(cfg, n_y, k),
               "max_abs_err": err, "bound": bound,
               "bitwise_plain": bool(torch.equal(got, plain)),
               "max_abs_vs_unsharded_kernels": vs_relax,
               "finite": bool(torch.isfinite(got).all())}
        row["ok"] = (row["finite"] and err <= bound and vs_relax <= bound
                     and row["grid_syncs"] == row["grid_syncs_expected"])
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"relax_sharded at {w}x{h}, {n_y} shards, k={k}: {row}")

    # Times on the level-0 shapes (grey, k = 1), beside the bound, the share
    # of the device-memory rate that the bytes the kernel streams reach
    # (``design_share``), and the unsharded relax (40 prologue and 200 sweep
    # launches).
    cfg, times = FlowConfig(), {}
    for w, h in (SIZES[1], SIZE_4K):
        inputs.clear()
        torch.cuda.empty_cache()
        x = kernel_inputs(w, h)
        relax_ms = cuda_ms(lambda: relax(x["fxyz"], x["uvf"], x["sc"], cfg), 3)
        for n_y in SHARDED_TIMED_N_Y:
            args = (x["fxyz"], x["uvf"], x["sc"], cfg, make_mesh(n_y))
            work = kernel_work("relax_sharded", h, w, n_y=n_y)
            syncs = torch.zeros(1, dtype=torch.int32, device="cuda")
            relax_sharded_kernel(*args, syncs=syncs)
            ms = cuda_ms(lambda: relax_sharded_kernel(*args), 3)
            row = {"phase": "sharded_time", "shape": [h, w], "n_y": n_y, "k": 1, "card": card,
                   "ms": ms, "plain_ms": cuda_ms(lambda: relax_sharded(*args), 1, warmup=False),
                   "unsharded_relax_ms": relax_ms, **work, "share": work["bound_ms"] / ms,
                   "design_share": work["design_bytes"] / PEAK_BYTES_PER_S * 1e3 / ms,
                   "grid_syncs": int(syncs.item()), "grid_syncs_expected": grid_syncs(cfg, n_y)}
            times[(w, h, n_y)] = row
            emit(row)
            if row["grid_syncs"] != row["grid_syncs_expected"]:
                raise AssertionError(f"relax_sharded at {w}x{h}, {n_y} shards: {row}")
        if (w, h) == SIZES[1]:
            pair = sharded_pair_levels(x, card)
    del x
    torch.cuda.empty_cache()
    at_4k, at_1080p = times[SIZE_4K + (4,)], times[SIZES[1] + (4,)]
    return {"name": "relax_sharded", "route": "cuda", "source": "tpuflow_torch/csrc/sharded.cu",
            "replaces": SHARDED_REPLACES, "max_abs_err": max_err, "shape": list(SIZE_4K[::-1]),
            "n_y": 4, "k": 1, "ms": at_4k["ms"], "plain_ms": at_4k["plain_ms"],
            "bound_ms": at_4k["bound_ms"], "bound_by": at_4k["bound_by"],
            "resource": at_4k["resource"], "share": at_4k["share"],
            "design_bytes": at_4k["design_bytes"], "design_share": at_4k["design_share"],
            "library_ms": None,
            "library": "none", "ms_1080p": at_1080p["ms"], "plain_ms_1080p": at_1080p["plain_ms"],
            "design_share_1080p": at_1080p["design_share"],
            "unsharded_relax_ms": at_4k["unsharded_relax_ms"],
            "grid_syncs_counted": {n: times[SIZE_4K + (n,)]["grid_syncs"]
                                   for n in SHARDED_TIMED_N_Y},
            "redesigned": REDESIGNED["relax_sharded"],
            "ms_by_n_y": {f"{w}x{h}": {n: times[(w, h, n)]["ms"] for n in SHARDED_TIMED_N_Y}
                          for w, h in (SIZES[1], SIZE_4K)},
            "pair_ms_sum": pair["ms_sum"], "pair_bound_ms_sum": pair["bound_ms_sum"],
            "pair_design_share": pair["design_share"]}


def sharded_pair_levels(x: dict, card: str) -> dict:
    """relax_sharded_kernel under full_model() on 4 shards at each level
    shape that compute_flow_sharded shards at 1920x1080, on the top-left
    corner of the level-0 fields ``x``: ms by CUDA events and the bound,
    summed over the pair's launches."""
    from tpuflow_torch.models import full_model
    from tpuflow_torch.parallel import kernel_halo_applicable, make_mesh, relax_sharded_kernel
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.solver.level import LevelScalars
    from tpuflow_torch.tools.roofline import PEAK_BYTES_PER_S, cuda_ms, kernel_work

    cfg, mesh = full_model(), make_mesh(4)
    levels = [s for s in level_schedule(*SIZES[1], cfg.warp_levels_count, cfg.warp_scale_factor)
              if kernel_halo_applicable(s.height, mesh.n_y, cfg)]
    ms = bound = design = 0.0
    for s in levels:
        h, w = s.height, s.width
        fields = [x[key][:, :h, :w].contiguous() for key in ("fxyz", "uvf", "J")]
        sc = LevelScalars.make(w, h, 1.0, 1.0, cfg.equation_alpha)
        ms += cuda_ms(lambda: relax_sharded_kernel(fields[0], fields[1], sc, cfg, mesh,
                                                   J=fields[2]), 3)
        work = kernel_work("relax_sharded", h, w, n_y=mesh.n_y, cfg=cfg)
        bound += work["bound_ms"]
        design += work["design_bytes"] / PEAK_BYTES_PER_S * 1e3
    row = {"phase": "sharded_pair_levels", "shape": list(SIZES[1][::-1]), "card": card,
           "config": "models.full_model()", "n_y": mesh.n_y, "sharded_levels": len(levels),
           "ms_sum": ms, "bound_ms_sum": bound, "share": bound / ms,
           "design_ms_sum": design, "design_share": design / ms}
    emit(row)
    return row


def phase_sharded_e2e(card: str, unsharded_times: dict) -> int:
    """compute_flow_sharded(full_model()) at 1920x1080 on 4 shards and on 1
    (main path: counts 0 just before, read just after) against compute_flow,
    the true shift and the expected launch counts; the three paths timed in
    turns; then grey 584x388 on 4 shards against the oracle. Returns the 4-shard
    run's relax_sharded launches."""
    import torch

    from tpuflow_torch import (
        FlowConfig, compute_flow, compute_flow_sharded, endpoint_error, make_mesh, models,
    )
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.synthetic import shift_epe, textured_pair
    from tpuflow_torch.tools.roofline import cuda_ms

    w, h = SIZES[1]
    cfg = models.full_model()
    f0, f1 = textured_pair(w, h)
    base = compute_flow(f0, f1, cfg, device="cuda")
    runs, launches = {}, 0
    for n_y in (4, 1):
        mesh = make_mesh(n_y)
        sharded.reset_launch_counts()
        res = compute_flow_sharded(f0, f1, cfg, mesh=mesh, device="cuda")
        counts = sharded.launch_counts()
        want = expected_sharded_launches(w, h, cfg, n_y)
        epe = endpoint_error(res.u, res.v, base.u, base.v)
        row = {"phase": "sharded_e2e", "shape": [h, w], "config": "models.full_model()",
               "n_y": n_y, "counts": counts, "expected": {k: want[k] for k in counts},
               "epe_vs_compute_flow": epe,
               "bitwise_equal_to_compute_flow": (res.u.tobytes() == base.u.tobytes()
                                                 and res.v.tobytes() == base.v.tobytes()),
               "epe_vs_true_shift": shift_epe(res.u, res.v), "zero_flow_epe": ZERO_FLOW_EPE}
        row["ok"] = bool(counts == row["expected"] and epe <= 1e-5
                         and row["epe_vs_true_shift"] < ZERO_FLOW_EPE
                         and np.isfinite(res.u).all() and np.isfinite(res.v).all())
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"compute_flow_sharded at {w}x{h} on {n_y} shards: {row}")
        if n_y == 4:
            launches = counts["relax_sharded"]
        runs[n_y] = mesh

    # Pairs timed in turns: unsharded, 4 shards, 1 shard, SHARDED_ROUNDS rounds.
    paths = {"unsharded": lambda: compute_flow(f0, f1, cfg, device="cuda")}
    for n_y, mesh in runs.items():
        paths[f"sharded_{n_y}"] = lambda m=mesh: compute_flow_sharded(f0, f1, cfg, mesh=m,
                                                                      device="cuda")
    for fn in paths.values():
        fn()  # warm-up pair
    ms = {name: [] for name in paths}
    for _ in range(SHARDED_ROUNDS):
        for name, fn in paths.items():
            ms[name].append(cuda_ms(fn, 1, warmup=False))
    row = {"phase": "sharded_times", "shape": [h, w], "card": card,
           "config": "models.full_model()",
           "phase8_unsharded_ms_median": unsharded_times["kernel_ms_median"]}
    for name, v in ms.items():
        row[f"{name}_ms_median"] = statistics.median(v)
        row[f"{name}_ms_all"] = v
    # a gap the host's spread between runs cannot explain
    row["sharded_4_below_every_unsharded"] = max(ms["sharded_4"]) < min(ms["unsharded"])
    emit(row)

    # Grey 584x388, reduced schedule, 4 shards, against the oracle.
    from tpuflow_torch import oracle_np

    w, h = SIZES[0]
    f0, f1 = textured_pair(w, h)
    ou, ov = oracle_np.compute_flow(f0, f1, data_constancy="grey", **ORACLE_KW)
    red_cfg = FlowConfig(**ORACLE_KW)
    res = compute_flow_sharded(f0, f1, red_cfg, mesh=make_mesh(4), device="cuda")
    plain = compute_flow(f0, f1, red_cfg, device="cuda")
    row = {"phase": "sharded_oracle", "shape": [h, w], "config": "FlowConfig(reduced)", "n_y": 4,
           "sharded_levels": expected_sharded_launches(w, h, red_cfg, 4)["relax_sharded"],
           "epe_vs_oracle_reduced": endpoint_error(res.u, res.v, ou, ov),
           "epe_vs_compute_flow": endpoint_error(res.u, res.v, plain.u, plain.v)}
    row["ok"] = row["epe_vs_oracle_reduced"] <= 0.05 and row["epe_vs_compute_flow"] <= 1e-5
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"compute_flow_sharded at {w}x{h} vs the oracle: {row}")
    torch.cuda.empty_cache()
    return launches


# Phase 12 across cards, where the machine has several: the kernel with the
# row's shards spread over the cards, one cooperative launch a card, halos
# stored through peer pointers, flag barriers between the cards.
# Cycles of torch.cuda._sleep queued on one card's launch stream before its
# launch in the race case (about 0.1 s on an H100; the others wait at their
# first row barrier).
CROSS_RACE_SLEEP_CYCLES = 200_000_000
# The spin-limit case: a child process leaves one card's launch out; it must
# exit non-zero within the kernel's spin limit and this margin.
CROSS_TIMEOUT_MARGIN_S = 60
CROSS_TIMED_CARDS = 4
CROSS_ROUNDS = 3
CROSS_TIMEOUT_CHILD = """
import sys
import torch
sys.path.insert(0, {repo!r})
from tpuflow_torch.config import FlowConfig
from tpuflow_torch.parallel import make_mesh, relax_sharded_kernel
from tpuflow_torch.solver.level import LevelScalars
torch.cuda.set_device(0)
sc = LevelScalars.make(300, 64, 1.0, 1.0, 35.0)
T, fxyz = torch.rand((2, 64, 300), device="cuda"), torch.rand((3, 64, 300), device="cuda")
relax_sharded_kernel(fxyz, T, sc, FlowConfig(), make_mesh(2, ["cuda:0", "cuda:1"]),
                     _skip_card=1)
try:
    for d in range(2):
        torch.cuda.synchronize(d)
except RuntimeError as err:
    print("trapped:", err, flush=True)
    sys.exit(3)
print("no trap: the launch of cuda:0 ended without its neighbour", flush=True)
"""


def spin_limit_s() -> float:
    """SPIN_LIMIT_NS of csrc/sharded.cu, in seconds."""
    import re

    src = open(os.path.join(REPO, "tpuflow_torch", "csrc", "sharded.cu")).read()
    return int(re.search(r"SPIN_LIMIT_NS = (\d+)ull;", src).group(1)) * 1e-9


def card_layouts(n_y: int, cards: int) -> list:
    """The devices of n_y shards spread over the cards: in contiguous blocks
    over 2 cards and over min(4, n_y), and dealt i % 4 where that differs."""
    out = [[f"cuda:{i * c // n_y}" for i in range(n_y)]
           for c in sorted({2, min(CROSS_TIMED_CARDS, n_y)}) if c <= cards]
    if cards >= CROSS_TIMED_CARDS and n_y > CROSS_TIMED_CARDS:
        out.append([f"cuda:{i % CROSS_TIMED_CARDS}" for i in range(n_y)])
    return out


def sync_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def crosscard_check(row: dict, got, plain, unsharded, syncs, barriers, want_syncs,
                    want_barriers) -> dict:
    """Fill and check one cross-card row: bitwise both ways, finite, every
    card's counts equal to the formulas."""
    import torch

    row.update(max_abs_err=float((got - plain).abs().max()),
               max_abs_vs_unsharded_kernels=float((got - unsharded).abs().max()),
               finite=bool(torch.isfinite(got).all()), grid_syncs=syncs.tolist(),
               grid_syncs_expected=want_syncs, row_barriers=barriers.tolist(),
               row_barriers_expected=want_barriers)
    row["ok"] = (row["finite"] and row["max_abs_err"] <= SHARDED_BOUND
                 and row["max_abs_vs_unsharded_kernels"] <= SHARDED_BOUND
                 and row["grid_syncs"] == want_syncs and row["row_barriers"] == want_barriers)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"relax_sharded across cards: {row}")
    return row


def phase_crosscard_kernel(card: str) -> dict:
    """Phase 12 across cards: relax_sharded_kernel with the shards spread
    over the cards (card_layouts) bitwise against its plain version and
    relax in every SHARDED_CHECKS case, each card's grid syncs and row
    barriers counted on the card equal to the formulas, and the same given
    one field set a card (the lanes' form: each card's T bitwise, its
    counts those of ``processes=True``); the race case; the
    spin-limit case in a child process; the 4K and 1080p level-0 launches
    over 4 cards timed in turns with the one-card launch, beside the
    cards=4 bound. On a machine with one card it prints that it did not
    run and returns {}; else the kernels line's keys for it."""
    import dataclasses

    import torch

    from tpuflow_torch import models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import level_tensor_plain
    from tpuflow_torch.parallel import make_mesh, relax_sharded, relax_sharded_kernel
    from tpuflow_torch.parallel.halo_kernel import grid_syncs, row_barriers
    from tpuflow_torch.parallel.mesh import card_stream
    from tpuflow_torch.solver.level import relax
    from tpuflow_torch.tools.roofline import cuda_ms, kernel_work

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "crosscard_kernel", "ran": False, "cards": cards,
              "reason": "the kernel across cards needs at least 2; this machine has 1"})
        return {}
    t0 = time.perf_counter()
    max_err, cases, inputs = 0.0, 0, {}
    for check in SHARDED_CHECKS + (RACE_CASE + ("race",),):
        w, h, n_y, k, constancy, inner = check[:6]
        race = len(check) > 6
        if (w, h) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, h)] = kernel_inputs(w, h)
        x = inputs[(w, h)]
        cfg = {"grey": FlowConfig(), "gradient": models.full_model(),
               "log": models.xray_log(alpha=LOG_ALPHA)}[constancy]
        cfg = dataclasses.replace(cfg, inner_iterations_count=inner)
        J = {"grey": None, "gradient": x["J"],
             "log": level_tensor_plain(x["f0"], x["f1"], x["fxyz"], x["sc"], True)}[constancy]
        args = (x["fxyz"], x["uvf"], x["sc"], cfg)
        plain = relax_sharded(*args, make_mesh(n_y), k, J=J)
        unsharded = relax(*args, J=J)
        layouts = card_layouts(n_y, cards)[-1:] if race else card_layouts(n_y, cards)
        for devices in layouts:
            mesh = make_mesh(n_y, devices)
            n = mesh.row_cards()
            syncs = torch.zeros(n, dtype=torch.int32, device="cuda")
            barriers = torch.zeros_like(syncs)
            sync_all()
            if race:   # the second card starts about 0.1 s after the others
                with torch.cuda.device(1), torch.cuda.stream(card_stream(torch.device(
                        "cuda", 1))):
                    torch.cuda._sleep(CROSS_RACE_SLEEP_CYCLES)
            before = relax_sharded_kernel.launches
            got = relax_sharded_kernel(*args, mesh, k, J=J, syncs=syncs, barriers=barriers)
            sync_all()
            launched = relax_sharded_kernel.launches - before
            row = crosscard_check(
                {"phase": "crosscard_kernel", "shape": [h, w], "n_y": n_y, "k": k,
                 "constancy": constancy, "inner": inner, "race": race, "devices": devices,
                 "cards": n, "launches": launched, "bound": SHARDED_BOUND},
                got, plain, unsharded, syncs, barriers, [grid_syncs(cfg, n_y, k, n)] * n,
                [row_barriers(cfg, n_y, n, k)] * n)
            if launched != n:
                raise AssertionError(f"{launched} launches over {n} cards: {row}")
            max_err = max(max_err, row["max_abs_err"], row["max_abs_vs_unsharded_kernels"])
            cases += 1
            if race:
                continue
            # one field set a card (the lanes' form): every card's T
            cards_of = [dev for dev, _ in mesh.row_groups()]

            def per_card(t):
                return None if t is None else tuple(t.to(dev) for dev in cards_of)

            syncs.zero_()
            barriers.zero_()
            sync_all()
            before = relax_sharded_kernel.launches
            Ts = relax_sharded_kernel(per_card(x["fxyz"]), per_card(x["uvf"]), x["sc"], cfg,
                                      mesh, k, J=per_card(J), syncs=syncs, barriers=barriers)
            sync_all()
            launched = relax_sharded_kernel.launches - before
            row = crosscard_check(
                {"phase": "crosscard_kernel_card_fields", "shape": [h, w], "n_y": n_y, "k": k,
                 "constancy": constancy, "inner": inner, "devices": devices, "cards": n,
                 "launches": launched, "T_devices": [str(T.device) for T in Ts],
                 "bound": SHARDED_BOUND},
                torch.stack([T.to(plain.device) for T in Ts]), plain, unsharded, syncs,
                barriers, [grid_syncs(cfg, n_y, k, n, processes=True)] * n,
                [row_barriers(cfg, n_y, n, k, processes=True)] * n)
            if launched != n or [T.device for T in Ts] != cards_of:
                raise AssertionError(f"{launched} launches over {n} cards, T on "
                                     f"{row['T_devices']}: {row}")
            max_err = max(max_err, row["max_abs_err"], row["max_abs_vs_unsharded_kernels"])
            cases += 1
    inputs.clear()
    torch.cuda.empty_cache()

    # The spin limit: one card's launch left out, in a child process.
    limit = spin_limit_s()
    t1 = time.perf_counter()
    try:
        child = subprocess.run([sys.executable, "-c", CROSS_TIMEOUT_CHILD.format(repo=REPO)],
                               capture_output=True, text=True, cwd=REPO,
                               timeout=limit + CROSS_TIMEOUT_MARGIN_S)
        rc, out = child.returncode, (child.stdout + child.stderr)[-600:]
    except subprocess.TimeoutExpired:
        rc, out = None, "hung past the spin limit and the margin; killed"
    stuck = {"phase": "crosscard_timeout", "spin_limit_s": limit,
             "margin_s": CROSS_TIMEOUT_MARGIN_S, "seconds": time.perf_counter() - t1,
             "returncode": rc, "output_tail": out}
    stuck["ok"] = rc not in (None, 0) and "trapped" in out
    emit(stuck)
    if not stuck["ok"]:
        raise AssertionError(f"the spin limit: {stuck}")

    # Times: level 0 (grey, k = 1, 4 shards) over 4 cards against the same
    # launch on one card, in turns, beside the bounds.
    timed = min(CROSS_TIMED_CARDS, cards)
    cfg, times = FlowConfig(), {}
    for w, h in (SIZES[1], SIZE_4K):
        x = kernel_inputs(w, h)
        args = (x["fxyz"], x["uvf"], x["sc"], cfg)
        meshes = {"one_card": make_mesh(4), "cards": make_mesh(4, [f"cuda:{i * timed // 4}"
                                                                   for i in range(4)])}
        ms = {name: [] for name in meshes}
        for _ in range(CROSS_ROUNDS):
            for name in ("one_card", "cards", "cards", "one_card"):
                ms[name].append(cuda_ms(lambda m=meshes[name]: relax_sharded_kernel(*args, m),
                                        3))
        work = kernel_work("relax_sharded", h, w, n_y=4, cards=timed)
        row = {"phase": "crosscard_time", "shape": [h, w], "n_y": 4, "cards": timed, "k": 1,
               "card": card, "ms": statistics.median(ms["cards"]), "ms_all": ms["cards"],
               "one_card_ms": statistics.median(ms["one_card"]),
               "one_card_ms_all": ms["one_card"], **work}
        row["share"] = work["bound_ms"] / row["ms"]
        times[(w, h)] = row
        emit(row)
        del x
        torch.cuda.empty_cache()
    at_4k, at_1080p = times[SIZE_4K], times[SIZES[1]]
    emit({"phase": "crosscard_done", "cards": cards, "cases": cases, "max_abs_err": max_err,
          "seconds": time.perf_counter() - t0})
    return {"across_cards": {
        "cards": timed, "cases": cases, "max_abs_err": max_err, "ms": at_4k["ms"],
        "one_card_ms": at_4k["one_card_ms"], "bound_ms": at_4k["bound_ms"],
        "bound_by": at_4k["bound_by"], "nvlink_bytes": at_4k["nvlink_bytes"],
        "share": at_4k["share"], "ms_1080p": at_1080p["ms"],
        "one_card_ms_1080p": at_1080p["one_card_ms"], "bound_ms_1080p": at_1080p["bound_ms"],
        "spin_limit_case_s": stuck["seconds"]}}


# Phases 13-17: the streaming path. The sequence: SEQ_FRAMES seeded 1920x1080
# textured frames, each moved by SEQ_STEP px from the one before, as f32 RAW.
SEQ_FRAMES = 7
SEQ_STEP = (0.6, -0.4)
SEQ_CHAINS = (1, 3)
BATCH = 3
# The warp report on the blobs of tests/test_bucketed.py:365-400 at 584x388,
# moved by 0.8 px (every tier 0) and by 6.5 px (tier 1 at a fine level),
# with that test's schedule, which tracks the motion.
WARP_SHIFTS = (0.8, 6.5)
WARP_CFG = dict(warp_levels_count=8, warp_scale_factor=0.6, outer_iterations_count=30,
                inner_iterations_count=5, equation_alpha=10.0, median_radius=3,
                gaussian_sigma=1.5)
# The bench's cells (PERF.md section 4), cut in runs and chain lengths to fit
# the smoke run; the 584x388 grey cell also takes --epe.
BENCH_CELLS = (("584x388", "grey", 5, 16, True), ("1920x1080", "grey", 3, 12, False),
               ("3840x2160", "full_model", 3, 8, False))


def check_counts(label: str, counts: dict, want: dict, counts_total: dict) -> None:
    """The main path's counts of one run against ``want``; added to the totals."""
    emit({"phase": "launches", "run": label, "counts": counts,
          "expected": {k: want.get(k, 0) for k in counts}})
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")
        counts_total[name] = counts_total.get(name, 0) + n


def scaled(want: dict, n: int) -> dict:
    return {k: v * n for k, v in want.items()}


def same_files(a: str, b: str, names) -> bool:
    import filecmp

    return all(filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
               for n in names)


def phase_sequence(card: str, counts_total: dict, tmp: str) -> list:
    """process_sequence at 1920x1080 grey with chain 1 and chain 3 against
    compute_flow per pair followed by the same writers, byte for byte; a
    resume from a manifest of the first three pairs; the wall per pair of
    each mode. The frames and each mode's files stay in ``tmp``; returns
    the pairs of frame files."""
    from tpuflow_torch import FlowConfig, compute_flow
    from tpuflow_torch.io import read_frame, write_raw_f32
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.parallel.multihost import SequenceManifest, process_sequence, write_pair
    from tpuflow_torch.synthetic import textured_frames

    w, h = SIZES[1]
    cfg = FlowConfig()
    frames = textured_frames(w, h, [(i * SEQ_STEP[0], i * SEQ_STEP[1])
                                    for i in range(SEQ_FRAMES)])
    n = SEQ_FRAMES - 1
    ids = [f"{i:05d}_" for i in range(n)]
    per_pair = expected_launches(w, h, cfg)
    paths = [os.path.join(tmp, f"frame_{i:03d}.raw") for i in range(SEQ_FRAMES)]
    for p, f in zip(paths, frames):
        write_raw_f32(p, f)
    pairs = list(zip(paths[:-1], paths[1:]))
    ref = os.path.join(tmp, "per_pair")
    os.makedirs(ref)
    solve_s = 0.0
    t0 = time.perf_counter()
    for pid, (p0, p1) in zip(ids, pairs):
        res = compute_flow(read_frame(p0, w, h), read_frame(p1, w, h), cfg, device="cuda")
        solve_s += res.seconds
        write_pair(ref, pid, res.u, res.v, w, h)
    ref_s = time.perf_counter() - t0
    names = sorted(os.listdir(ref))
    row = {"phase": "sequence", "shape": [h, w], "config": "FlowConfig()", "pairs": n,
           "card": card, "files": len(names),
           "compute_flow_ms_per_pair": solve_s / n * 1e3,
           "compute_flow_and_writers_ms_per_pair": ref_s / n * 1e3}
    ok = True
    for chain in SEQ_CHAINS:
        out = os.path.join(tmp, f"chain{chain}")
        reset_launch_counts()
        t0 = time.perf_counter()
        done = process_sequence(pairs, w, h, out, cfg, chain=chain, device="cuda")
        row[f"chain{chain}_ms_per_pair"] = (time.perf_counter() - t0) / n * 1e3
        check_counts(f"sequence chain={chain}", launch_counts(), scaled(per_pair, n),
                     counts_total)
        row[f"chain{chain}_completed"] = done
        row[f"chain{chain}_bytewise_equal"] = same_files(ref, out, names)
        row[f"chain{chain}_manifest"] = sorted(SequenceManifest(
            os.path.join(out, "manifest.jsonl")).done())
        ok &= (done == ids and row[f"chain{chain}_bytewise_equal"]
               and row[f"chain{chain}_manifest"] == ids)
    # Resume: a manifest that holds the first three pairs.
    out = os.path.join(tmp, "resume")
    os.makedirs(out)
    manifest = SequenceManifest(os.path.join(out, "manifest.jsonl"))
    for pid in ids[:3]:
        manifest.record(pid, 0.0)
    reset_launch_counts()
    done = process_sequence(pairs, w, h, out, cfg, chain=SEQ_CHAINS[-1], device="cuda")
    check_counts("sequence resume", launch_counts(), scaled(per_pair, n - 3), counts_total)
    rest = [nm for nm in names if nm[:6] in ids[3:]]
    row.update(resume_completed=done, resume_bytewise_equal=same_files(ref, out, rest),
               resume_rewrote_none=not any(nm[:6] in ids[:3] for nm in os.listdir(out)))
    ok &= done == ids[3:] and row["resume_bytewise_equal"] and row["resume_rewrote_none"]
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"sequence: {row}")
    return pairs


def phase_batch(counts_total: dict) -> None:
    """compute_flow on a (BATCH, 388, 584) stack, bitwise three single calls."""
    from tpuflow_torch import FlowConfig, compute_flow
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.synthetic import textured_frames

    w, h = SIZES[0]
    cfg = FlowConfig()
    frames = np.stack(textured_frames(w, h, [(i * 1.25, i * -0.75) for i in range(BATCH + 1)]))
    reset_launch_counts()
    res = compute_flow(frames[:-1], frames[1:], cfg, device="cuda")
    check_counts("batch", launch_counts(), scaled(expected_launches(w, h, cfg), BATCH),
                 counts_total)
    single = [compute_flow(frames[i], frames[i + 1], cfg, device="cuda") for i in range(BATCH)]
    same = [res.u[i].tobytes() == s.u.tobytes() and res.v[i].tobytes() == s.v.tobytes()
            for i, s in enumerate(single)]
    row = {"phase": "batch", "shape": [BATCH, h, w], "config": "FlowConfig()",
           "out_shape": list(res.u.shape), "bitwise_equal_to_single_calls": same,
           "batch_s": res.seconds, "single_s": [s.seconds for s in single]}
    row["ok"] = all(same) and res.u.shape == (BATCH, h, w)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"batch: {row}")


def phase_warp_report(counts_total: dict) -> None:
    """compute_flow_warp_report on the blobs moved by WARP_SHIFTS: the small
    shift every tier 0, the large one tier 1 at least once, the flow bitwise
    compute_flow's."""
    from tpuflow_torch import FlowConfig, compute_flow, compute_flow_warp_report
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts

    w, h = SIZES[0]
    cfg = FlowConfig(**WARP_CFG)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def blobs(dx):
        return (200.0 * np.exp(-((ys - 36) ** 2 + (xs - 48 - dx) ** 2) / 60.0)
                + 150.0 * np.exp(-((ys - 20) ** 2 + (xs - 20 - dx) ** 2) / 40.0)
                ).astype(np.float32)

    reports = {}
    for dx in WARP_SHIFTS:
        reset_launch_counts()
        u, v, rep = compute_flow_warp_report(blobs(0), blobs(dx), cfg, device="cuda")
        check_counts(f"warp_report dx={dx}", launch_counts(), expected_launches(w, h, cfg),
                     counts_total)
        plain = compute_flow(blobs(0), blobs(dx), cfg, device="cuda")
        reports[dx] = {"tiers": rep["tiers"].tolist(), "levels": rep["levels"],
                       "n_wide": rep["n_wide"], "n_gather": rep["n_gather"],
                       "max_abs_u": float(np.abs(u).max()),
                       "bitwise_equal_to_compute_flow": (u.tobytes() == plain.u.tobytes()
                                                         and v.tobytes() == plain.v.tobytes())}
    small, large = (reports[dx] for dx in WARP_SHIFTS)
    row = {"phase": "warp_report", "shape": [h, w], "config": WARP_CFG,
           "reports": {str(dx): r for dx, r in reports.items()}}
    row["ok"] = (all(t == 0 for t in small["tiers"]) and large["n_wide"] >= 1
                 and all(r["bitwise_equal_to_compute_flow"] for r in reports.values()))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"warp_report: {row}")


# Cycles of torch.cuda._sleep queued behind a pair in phase 16, about 0.5 s
# on an H100: the card stays busy past the next upload whatever the host's
# pace. LAUNCH_PROBE one-element launches behind such a sleep find how many
# launches the host can queue before a launch waits (a pair makes thousands).
SLEEP_CYCLES = 1_000_000_000
LAUNCH_PROBE = 4096


def phase_async(card: str) -> None:
    """compute_flow_async's upload does not wait for the card: with a
    3840x2160 full_model() pair and SLEEP_CYCLES queued, the next pair's
    staged upload returns while they still run, where a pageable upload in
    the same place waits; the banded kernels' plans (presmooth, frame
    pyramid and flows) come from the device cache, one hit a launch and no
    upload;
    the second pair's flow is bitwise the first's. Also how many
    launches the host can queue ahead of the card before a launch waits."""
    import torch

    from tpuflow_torch import compute_flow_async, models
    from tpuflow_torch.ops.banded import plan_table
    from tpuflow_torch.solver import flow2d
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import banded_launches

    w, h = SIZE_4K
    cfg = models.full_model()
    dev = torch.device("cuda", torch.cuda.current_device())
    f0, f1 = textured_pair(w, h)
    compute_flow_async(f0, f1, cfg)          # warm: staging ring, caches
    torch.cuda.synchronize()
    before = plan_table.cache_info()
    queued = torch.cuda.Event()
    t0 = time.perf_counter()
    first = compute_flow_async(f0, f1, cfg)
    t1 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    queued.record()
    t2 = time.perf_counter()
    flow2d._upload(f0, f1, dev)
    t3 = time.perf_counter()
    upload_behind_queue = not queued.query()
    second = compute_flow_async(f0, f1, cfg)
    t4 = time.perf_counter()
    second_behind_queue = not queued.query()
    after = plan_table.cache_info()
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    # the contrast: a pageable upload behind the same queue
    compute_flow_async(f0, f1, cfg)
    torch.cuda._sleep(SLEEP_CYCLES)
    queued.record()
    t5 = time.perf_counter()
    torch.from_numpy(f0).to(dev)
    t6 = time.perf_counter()
    pageable_waited = queued.query()
    torch.cuda.synchronize()
    # how far the host runs ahead: one-element launches behind a sleep
    x = torch.zeros(1, device=dev)
    torch.cuda._sleep(SLEEP_CYCLES)
    depth, last = None, time.perf_counter()
    for i in range(LAUNCH_PROBE):
        x.add_(1.0)
        now = time.perf_counter()
        if now - last > 0.05:
            depth = i
            break
        last = now
    torch.cuda.synchronize()
    row = {"phase": "async", "shape": [h, w], "config": "models.full_model()", "card": card,
           "sleep_cycles": SLEEP_CYCLES, "submit_ms": (t1 - t0) * 1e3,
           "upload_ms": (t3 - t2) * 1e3, "upload_returned_while_queue_ran": upload_behind_queue,
           "pageable_upload_ms": (t6 - t5) * 1e3,
           "pageable_upload_waited_for_the_queue": pageable_waited,
           "second_submit_ms": (t4 - t3) * 1e3,
           "second_submit_returned_while_queue_ran": second_behind_queue,
           "launches_per_pair": sum(expected_launches(w, h, cfg)[k] for k in MAIN_PATH),
           "launches_queued_before_a_launch_waits": depth,
           "second_flow_bitwise_first": same,
           "plan_table_uploads": after.misses - before.misses,
           "plan_table_cache_hits": after.hits - before.hits,
           # one plan a launch of the banded kernels, for each of the two pairs
           "plan_table_cache_hits_expected": 2 * len(banded_launches(w, h, cfg))}
    row["ok"] = (upload_behind_queue and pageable_waited and same
                 and row["plan_table_uploads"] == 0
                 and row["plan_table_cache_hits"] == row["plan_table_cache_hits_expected"])
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"async: {row}")


def phase_bench(card: str, counts_total: dict) -> list:
    """The bench's line for each of BENCH_CELLS (in this process, the main
    path's counts 0 before each and read after), the 584x388 grey cell with
    the full-schedule EPE against the oracle for three constancies."""
    from tpuflow_torch import bench, models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts

    lines = []
    for size, preset, runs, pairs, epe in BENCH_CELLS:
        argv = ["--size", size, "--preset", preset, "--runs", str(runs), "--pairs", str(pairs)]
        reset_launch_counts()
        rec = bench.main(argv + (["--epe"] if epe else []))
        w, h = (int(x) for x in size.split("x"))
        n = 1 + runs * (pairs + max(1, pairs // 4)) + runs
        want = scaled(expected_launches(w, h, bench.preset_config(preset)), n)
        if epe:
            for c in (FlowConfig(), models.full_model(), models.xray_log(alpha=bench.EPE_LOG_ALPHA)):
                for k, v in expected_launches(*bench.EPE_SIZE, c).items():
                    want[k] += v
        check_counts(f"bench {size} {preset}", launch_counts(), want, counts_total)
        ok = (set(bench.KEYS) <= set(rec) and rec["card"] == card and rec["value"] > 0
              and rec["epe_ok"] is not False and (rec["epe_px"] is not None
                                                  or bool(rec.get("epe_reason"))))
        if epe:
            ok &= rec["epe_oracle_ok"] is True
        emit({"phase": "bench", "size": size, "preset": preset, "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"bench {size} {preset}: {rec}")
        lines.append(rec)
    return lines


# Phases 18-22: meshes. Every position has a stream of its own; on one card
# the mesh's positions are streams of cuda:0, and where the machine has
# several cards, phase 18's cases also run with the positions dealt over them.
MESH_N = 4
# Cycles of torch.cuda._sleep queued on one shard's stream before each of its
# sweeps in phase 18's race case (about 1 ms on an H100): its neighbours'
# halo copies must wait for it.
RACE_SLEEP_CYCLES = 2_000_000
RACE_CASE = (1920, 1080, 4, 1, "grey", 5)
# Row blocks of the prologue kernel: the shards of a 4-way split with a
# 6-row halo at these level sizes, and at the prologue tile's edge shapes
# blocks that start at row 0, end at the level's last row, or neither
# (row0, rows below the block).
PROLOGUE_BLOCK_SIZES = (SIZES[0], SIZES[1], SIZE_4K)
PROLOGUE_BLOCK_PLACES = ((0, 5), (5, 0), (3, 4))
MESH_ROUNDS = 5
DP_FRAMES = 5            # phase 20: 4 pairs of 584x388, grey
DP_ROUNDS = 3


def mesh_devices(n: int) -> list:
    """n positions on cuda:0, and n positions dealt over the visible cards
    when there are several."""
    import torch

    cards = torch.cuda.device_count()
    out = [["cuda:0"] * n]
    if cards > 1:
        out.append([f"cuda:{i % cards}" for i in range(n)])
    return out


def prologue_blocks(card: str) -> dict:
    """outer_prologue with row0 and height on row blocks (grey and tensor)
    against outer_prologue_plain, bitwise. Returns the largest error."""
    import torch

    from tpuflow_torch.ops.level import outer_prologue, outer_prologue_plain
    from tpuflow_torch.parallel import row_split

    cases = []
    for w, h in PROLOGUE_BLOCK_SIZES:
        cases += [(w, h, sh.first, sh.padded) for sh in row_split(h, MESH_N, 6)]
    for w, h in PROLOGUE_SHAPES:
        cases += [(w, h + r0 + below, r0, h) for r0, below in PROLOGUE_BLOCK_PLACES]
    err, n = 0.0, 0
    inputs = {}
    for w, height, row0, rows in cases:
        if (w, height) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, height)] = kernel_inputs(w, height)
        x = inputs[(w, height)]
        cut = lambda t: t[:, row0:row0 + rows].contiguous()  # noqa: E731
        T, uv, fxyz, J = cut(x["T"]), cut(x["uvf"]), cut(x["fxyz"]), cut(x["J"])
        for tensor in (None, J):
            got = outer_prologue(T, uv, fxyz, *x["pro"], J=tensor, row0=row0, height=height)
            want = outer_prologue_plain(T, uv, fxyz, *x["pro"], J=tensor, row0=row0,
                                        height=height)
            e = float((got - want).abs().max())
            err, n = max(err, e), n + 1
            if not (e == 0.0 and torch.isfinite(got).all()):
                raise AssertionError(f"outer_prologue on rows {row0}..{row0 + rows} of a "
                                     f"{height}x{w} level (J={tensor is not None}): {e}")
    inputs.clear()
    torch.cuda.empty_cache()
    row = {"phase": "prologue_row_blocks", "card": card, "blocks": n, "max_abs_err": err,
           "bound": 0.0, "ok": err == 0.0}
    emit(row)
    return row


def phase_mesh_explicit(card: str) -> dict:
    """Phase 18: relax_sharded_explicit bitwise against relax_sharded and
    relax in the SHARDED_CHECKS cases, one stream a shard, its launches and
    copies counted exactly, and where the positions span several cards
    relax_sharded_kernel on the same mesh, bitwise with its counts; the
    race case; the prologue on row blocks."""
    import dataclasses

    import torch

    from tpuflow_torch import models
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import (
        KMAX, launch_counts, level_tensor_plain, reset_launch_counts,
    )
    from tpuflow_torch.parallel import halo as halo_mod
    from tpuflow_torch.parallel import make_mesh, relax_sharded, relax_sharded_kernel
    from tpuflow_torch.parallel.halo import explicit_copies, relax_sharded_explicit
    from tpuflow_torch.parallel.halo_kernel import grid_syncs, row_barriers
    from tpuflow_torch.solver.level import relax

    t0 = time.perf_counter()
    max_err, inputs, cases = 0.0, {}, 0
    for case in SHARDED_CHECKS + (RACE_CASE + ("race",),):
        w, h, n_y, k, constancy, inner = case[:6]
        race = len(case) > 6
        if (w, h) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, h)] = kernel_inputs(w, h)
        x = inputs[(w, h)]
        cfg = {"grey": FlowConfig(), "gradient": models.full_model(),
               "log": models.xray_log(alpha=LOG_ALPHA)}[constancy]
        cfg = dataclasses.replace(cfg, inner_iterations_count=inner)
        J = {"grey": None, "gradient": x["J"],
             "log": level_tensor_plain(x["f0"], x["f1"], x["fxyz"], x["sc"], True)}[constancy]
        args = (x["fxyz"], x["uvf"], x["sc"], cfg)
        plain = relax_sharded(*args, make_mesh(n_y), k, J=J)
        unsharded = relax(*args, J=J)
        for devices in mesh_devices(n_y):
            mesh = make_mesh(n_y, devices)
            sweeps = halo_mod.jacobi_sweeps
            if race:
                victim = mesh.stream(mesh.row(0)[1])

                def slow(T, uv, hoist, inner_):
                    if torch.cuda.current_stream() == victim:
                        torch.cuda._sleep(RACE_SLEEP_CYCLES)
                    return sweeps(T, uv, hoist, inner_)

                halo_mod.jacobi_sweeps = slow
            reset_launch_counts()
            relax_sharded_explicit.copies = 0
            try:
                got = relax_sharded_explicit(*args, mesh, k, J=J)
            finally:
                halo_mod.jacobi_sweeps = sweeps
            torch.cuda.synchronize()
            counts = launch_counts()
            outer = cfg.outer_iterations_count
            prologue = "outer_prologue" if J is None else "outer_prologue_tensor"
            want = {prologue: n_y * outer,
                    "jacobi_sweeps": n_y * outer * -(-inner // KMAX),
                    "copies": explicit_copies(h, cfg, n_y, k, J is not None)}
            have = {prologue: counts[prologue], "jacobi_sweeps": counts["jacobi_sweeps"],
                    "copies": relax_sharded_explicit.copies}
            err = float((got - plain).abs().max())
            vs_relax = float((got - unsharded).abs().max())
            max_err = max(max_err, err, vs_relax)
            cases += 1
            row = {"phase": "mesh_explicit", "shape": [h, w], "n_y": n_y, "k": k,
                   "constancy": constancy, "inner": inner, "race": race,
                   "devices": devices, "max_abs_err": err, "bound": SHARDED_BOUND,
                   "max_abs_vs_relax": vs_relax, "counts": have, "expected": want,
                   "finite": bool(torch.isfinite(got).all())}
            row["ok"] = (row["finite"] and err <= SHARDED_BOUND and vs_relax <= SHARDED_BOUND
                         and have == want)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"relax_sharded_explicit: {row}")
            if mesh.cards > 1 and not race:   # the kernel over the same cards
                n = mesh.row_cards()
                syncs = torch.zeros(n, dtype=torch.int32, device="cuda")
                barriers = torch.zeros_like(syncs)
                kernel = relax_sharded_kernel(*args, mesh, k, J=J, syncs=syncs,
                                              barriers=barriers)
                sync_all()
                krow = crosscard_check(
                    {"phase": "mesh_kernel", "shape": [h, w], "n_y": n_y, "k": k,
                     "constancy": constancy, "inner": inner, "devices": devices, "cards": n,
                     "bound": SHARDED_BOUND}, kernel, plain, unsharded, syncs, barriers,
                    [grid_syncs(cfg, n_y, k, n)] * n, [row_barriers(cfg, n_y, n, k)] * n)
                max_err = max(max_err, krow["max_abs_err"], krow["max_abs_vs_unsharded_kernels"])
    inputs.clear()
    torch.cuda.empty_cache()
    blocks = prologue_blocks(card)
    row = {"phase": "mesh_explicit_done", "card": card, "cases": cases,
           "max_abs_err": max_err, "seconds": time.perf_counter() - t0}
    emit(row)
    return {"explicit_max_abs_err": max_err, "prologue_blocks": blocks}


def expected_sharded_counts(w: int, h: int, cfg, mesh, halo: str, k: int = 1, data: int = 0,
                            levels: range = None, smooth: bool = True,
                            gather: bool = True) -> dict:
    """Launch counts of compute_flow_sharded on ``halo``'s routes over data
    row ``data`` (or of ``levels`` of its schedule, with the presmooth if
    ``smooth``), the explicit route's copies and, over processes, this
    process's messages: the explicit route's, and where its levels reach
    the band path's suffix (and ``gather``: a solve with the band plan) the
    finest flow's gather (two planes to each other process of the row)."""
    from tpuflow_torch.ops.level import KMAX
    from tpuflow_torch.parallel.halo import explicit_copies, explicit_sends
    from tpuflow_torch.solver.bands import lane_copies
    from tpuflow_torch.solver.sharded import sharded_bands, sharded_lanes, sharded_plan

    plan = sharded_plan(w, h, cfg, mesh, halo, k, data)
    bands = sharded_bands(w, h, cfg, mesh, halo, k, data)
    lanes = sharded_lanes(w, h, cfg, mesh, halo, k, data) if levels is None else None
    stop = len(plan) if levels is None else levels.stop
    start = 0 if levels is None else levels.start
    if levels is not None:
        plan = plan[levels.start:levels.stop]
    want = expected_launches(w, h, cfg, levels, smooth)
    prologue = "outer_prologue" if want["outer_prologue"] else "outer_prologue_tensor"
    outer, passes = cfg.outer_iterations_count, -(-cfg.inner_iterations_count // KMAX)
    want.update({prologue: 0, "jacobi_sweeps": 0, "relax_sharded": 0, "copies": 0,
                 "messages": 0, "peer_copies": 0, "peer_bytes": 0})
    if lanes:
        # each other card: its presmooth, frame pyramid and stages over the suffix
        for _ in lanes[1:]:
            lane = expected_launches(w, h, cfg, range(lanes[0].plan.start, len(plan)), smooth)
            for key in ("gaussian_smooth", "resample", "warp", "level_derivs", "level_tensor",
                        "add_median"):
                want[key] += lane[key]
        peers = lane_copies(w, h, cfg, [lane.plan for lane in lanes])
        want.update(peer_copies=peers["messages"], peer_bytes=peers["bytes"])
    processes = mesh.row_spans_processes(data)
    shard = mesh.row(data).index(mesh.local_positions()[0]) if processes else None
    for lh, _, route, kk in plan:
        if route == "kernel":
            # one launch a card; over processes, this process's card's one
            want["relax_sharded"] += 1 if processes else mesh.row_cards(data)
            continue
        # the explicit route: every shard here, or this process's one
        n = mesh.n_y if route == "explicit" and not processes else 1
        want[prologue] += n * outer
        want["jacobi_sweeps"] += n * outer * passes
        if route == "explicit":
            want["copies"] += explicit_copies(lh, cfg, mesh.n_y, kk,
                                              prologue != "outer_prologue", shard)
            if processes:
                want["messages"] += explicit_sends(cfg, mesh.n_y, kk, shard)
    if gather and bands is not None and stop == len(bands.levels) + bands.start and stop > max(
            start, bands.start):
        want["messages"] += 2 * (mesh.n_y - 1)
    return want


def band_rows(w: int, h: int, cfg, mesh, halo: str, k: int = 1, data: int = 0) -> dict:
    """Which path a pair on ``mesh``'s row takes (the band path where its
    processes each have a card, lanes where one process drives several
    cards, else the whole field), and the rows each row stage computed
    (``ops.level.row_counts``, read after the run; by lane, one a card,
    for lanes) beside its plan's and the whole field's."""
    from tpuflow_torch.ops.level import row_counts
    from tpuflow_torch.solver.bands import stage_rows
    from tpuflow_torch.solver.sharded import sharded_bands, sharded_lanes

    whole = stage_rows(w, h, cfg, None)
    lanes = sharded_lanes(w, h, cfg, mesh, halo, k, data)
    if lanes:
        got = [row_counts(i) for i in range(len(lanes))]
        want = [stage_rows(w, h, cfg, lane.plan, prefix=i == 0) for i, lane in enumerate(lanes)]
        return {"path": "lanes", "cards": [str(lane.device) for lane in lanes],
                "banded_levels": len(lanes[0].plan.levels), "rows_by_card": got,
                "rows_expected": want, "rows_whole_field": whole, "rows_ok": got == want}
    plan = sharded_bands(w, h, cfg, mesh, halo, k, data)
    got, want = row_counts(), stage_rows(w, h, cfg, plan)
    return {"path": "whole field" if plan is None else "band", "rows": got,
            "rows_expected": want, "rows_whole_field": whole, "rows_ok": got == want}


def sharded_counts() -> dict:
    from tpuflow_torch.parallel.group import row_exchange
    from tpuflow_torch.parallel.halo import relax_sharded_explicit
    from tpuflow_torch.parallel.mesh import peer_copy
    from tpuflow_torch.solver import sharded

    return {**sharded.launch_counts(), "copies": relax_sharded_explicit.copies,
            "messages": row_exchange.sends, "peer_copies": peer_copy.messages,
            "peer_bytes": peer_copy.bytes}


def phase_mesh_e2e(card: str, counts_total: dict) -> dict:
    """Phase 19: a 1920x1080 full_model() pair through compute_flow(...,
    mesh=) and compute_flow_sharded with halo explicit, kernel and auto on
    MESH_N positions of cuda:0, and of the cards where there are several:
    bitwise compute_flow, exact counts, the auto plan, each route's path
    (over several cards the kernel levels by lanes) with the rows each card
    computed against its plan's (``band_rows``) and the peer copies; the
    routes timed in turns with compute_flow. Returns the last mesh's row."""
    from tpuflow_torch import compute_flow, make_mesh, models
    from tpuflow_torch.synthetic import textured_pair

    w, h = SIZES[1]
    cfg = models.full_model()
    f0, f1 = textured_pair(w, h)
    base = compute_flow(f0, f1, cfg, device="cuda")
    for devices in mesh_devices(MESH_N):
        row = mesh_e2e_run(card, counts_total, make_mesh(MESH_N, devices), f0, f1, base)
    return row


def mesh_e2e_run(card: str, counts_total: dict, mesh, f0, f1, base,
                 size=SIZES[1]) -> dict:
    """Phase 19 on one mesh (and phase 23 at 3840x2160 over the cards)."""
    from tpuflow_torch import compute_flow, compute_flow_sharded, models, plan_parallel
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.bands import stage_rows
    from tpuflow_torch.solver.sharded import sharded_plan
    from tpuflow_torch.tools.roofline import cuda_ms

    w, h = size
    cfg = models.full_model()
    route = plan_parallel((h, w), False, cfg, mesh)
    paths = {"mesh": lambda: compute_flow(f0, f1, cfg, mesh=mesh, device="cuda")}
    for halo in ("explicit", "kernel", "auto"):
        paths[halo] = lambda hl=halo: compute_flow_sharded(f0, f1, cfg, mesh=mesh, halo=hl,
                                                           device="cuda")
    row = {"phase": "mesh_e2e", "shape": [h, w], "config": "models.full_model()", "card": card,
           "devices": [str(d) for d in mesh.devices], "plan_parallel": route,
           "rows_whole_field": stage_rows(w, h, cfg, None),
           "auto_plan": [f"{lh}x{lw}:{r}" + (f"@k={k}" if r != "replicated" else "")
                         for lh, lw, r, k in sharded_plan(w, h, cfg, mesh, "auto")]}
    ok = True
    for name, fn in paths.items():
        sharded.reset_launch_counts()
        res = fn()
        counts = sharded_counts()
        halo = {"mesh": "auto" if route == "sp" else None}.get(name, name)
        want = (expected_sharded_counts(w, h, cfg, mesh, halo) if halo
                else dict(expected_launches(w, h, cfg), relax_sharded=0, copies=0))
        want = {key: want.get(key, 0) for key in counts}
        same = res.u.tobytes() == base.u.tobytes() and res.v.tobytes() == base.v.tobytes()
        row[f"{name}_counts"], row[f"{name}_bitwise"] = counts, same
        ok &= same and counts == want
        if counts != want:
            row[f"{name}_expected"] = want
        if halo:
            # the path each route took and the rows each card computed
            rows = band_rows(w, h, cfg, mesh, halo)
            row[f"{name}_path"], row[f"{name}_rows_ok"] = rows["path"], rows["rows_ok"]
            if rows["path"] == "lanes":
                row[f"{name}_rows_by_card"] = rows["rows_by_card"]
                row[f"{name}_card0_rows"] = rows["rows_by_card"][0]
                row[f"{name}_peer_copies"] = [counts["peer_copies"], counts["peer_bytes"]]
            ok &= rows["rows_ok"]
            if not rows["rows_ok"]:
                row[f"{name}_rows"] = rows
        for key in MAIN_PATH:
            counts_total[key] = counts_total.get(key, 0) + counts[key]
    ms = {"compute_flow": [], **{name: [] for name in paths}}
    runs = {"compute_flow": lambda: compute_flow(f0, f1, cfg, device="cuda"), **paths}
    for _ in range(MESH_ROUNDS):
        for name, fn in runs.items():
            ms[name].append(cuda_ms(fn, 1, warmup=False))
    for name, v in ms.items():
        row[f"{name}_ms_median"] = statistics.median(v)
        row[f"{name}_ms_all"] = v
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"mesh_e2e: {row}")
    return row


def phase_crosscard_e2e(card: str, counts_total: dict) -> dict:
    """Phase 23: a 3840x2160 full_model() pair through compute_flow(...,
    mesh=) and compute_flow_sharded with halo explicit, kernel and auto on
    MESH_N positions dealt over the cards (phase 19 does 1920x1080): bitwise
    compute_flow, exact counts, each route's path and each card's rows, the
    routes timed in turns with compute_flow. On one card it prints that it
    did not run."""
    import torch

    from tpuflow_torch import compute_flow, make_mesh, models
    from tpuflow_torch.synthetic import textured_pair

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "crosscard_e2e", "ran": False, "cards": cards,
              "reason": "the kernel across cards needs at least 2; this machine has 1"})
        return {}
    f0, f1 = textured_pair(*SIZE_4K)
    base = compute_flow(f0, f1, models.full_model(), device="cuda")
    row = mesh_e2e_run(card, counts_total, make_mesh(MESH_N, mesh_devices(MESH_N)[-1]), f0, f1,
                       base, size=SIZE_4K)
    torch.cuda.empty_cache()
    return row


def phase_mesh_dp(card: str, counts_total: dict) -> dict:
    """Phase 20: a (4, 388, 584) grey stack through compute_flow(...,
    mesh=) on 4 data positions and through compute_flow_hybrid on 4 y
    positions, of cuda:0 and of the cards where there are several, and a
    ragged B of 3: bitwise per-pair compute_flow, exact counts; timed in
    turns with the stack without a mesh. Returns the last layout's row."""
    from tpuflow_torch import FlowConfig, compute_flow, make_mesh
    from tpuflow_torch.synthetic import textured_frames

    w, h = SIZES[0]
    cfg = FlowConfig()
    frames = np.stack(textured_frames(w, h, [(i * 1.25, i * -0.75) for i in range(DP_FRAMES)]))
    F0, F1 = frames[:-1], frames[1:]
    singles = [compute_flow(a, b, cfg, device="cuda") for a, b in zip(F0, F1)]
    for devices in mesh_devices(MESH_N):
        row = mesh_dp_run(card, counts_total, make_mesh((MESH_N, 1), devices),
                          make_mesh(MESH_N, devices), F0, F1, singles)
    return row


def mesh_dp_run(card: str, counts_total: dict, dp, hyb, F0, F1, singles) -> dict:
    """Phase 20 on one layout of the positions."""
    from tpuflow_torch import FlowConfig, compute_flow, compute_flow_hybrid
    from tpuflow_torch.parallel.hybrid import hybrid_split_level
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.sharded import sharded_plan
    from tpuflow_torch.tools.roofline import cuda_ms

    w, h = SIZES[0]
    cfg = FlowConfig()
    split = hybrid_split_level(w, h, cfg, hyb)
    plan = sharded_plan(w, h, cfg, hyb, "auto")
    per_pair = expected_launches(w, h, cfg)
    # phase A (the presmooth and levels before the split) and phase B: each
    # takes the frame pyramid of its own levels
    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    parts = (expected_sharded_counts(w, h, cfg, hyb, "auto", levels=range(0, split)),
             expected_sharded_counts(w, h, cfg, hyb, "auto", levels=range(split, n),
                                     smooth=False))
    hyb_want = {key: parts[0][key] + parts[1][key] for key in parts[0]}
    row = {"phase": "mesh_dp", "shape": [len(F0), h, w], "config": "FlowConfig()", "card": card,
           "devices": [str(d) for d in hyb.devices], "hybrid_split_level": split,
           "hybrid_phase_b_plan": [f"{lh}x{lw}:{r}" for lh, lw, r, _ in plan[split:]]}
    ok = True
    for b in (len(F0), len(F0) - 1):
        for name, fn, want in (
                ("dp", lambda: compute_flow(F0[:b], F1[:b], cfg, mesh=dp, device="cuda"),
                 dict(scaled(per_pair, b), relax_sharded=0, copies=0)),
                ("hybrid", lambda: compute_flow_hybrid(F0[:b], F1[:b], cfg, mesh=hyb,
                                                       device="cuda"),
                 scaled(hyb_want, b))):
            sharded.reset_launch_counts()
            res = fn()
            counts = sharded_counts()
            want = {key: want.get(key, 0) for key in counts}
            same = [res.u[i].tobytes() == s.u.tobytes() and res.v[i].tobytes() == s.v.tobytes()
                    for i, s in enumerate(singles[:b])]
            row[f"{name}_B{b}_bitwise"], row[f"{name}_B{b}_counts"] = same, counts
            ok &= all(same) and res.u.shape == (b, h, w) and counts == want
            if counts != want:
                row[f"{name}_B{b}_expected"] = want
            for key in MAIN_PATH:
                counts_total[key] = counts_total.get(key, 0) + counts[key]
    runs = {"stack": lambda: compute_flow(F0, F1, cfg, device="cuda"),
            "dp": lambda: compute_flow(F0, F1, cfg, mesh=dp, device="cuda"),
            "hybrid": lambda: compute_flow_hybrid(F0, F1, cfg, mesh=hyb, device="cuda")}
    ms = {name: [] for name in runs}
    for _ in range(DP_ROUNDS):
        for name, fn in runs.items():
            ms[name].append(cuda_ms(fn, 1, warmup=False))
    for name, v in ms.items():
        row[f"{name}_ms_median"] = statistics.median(v)
        row[f"{name}_ms_all"] = v
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"mesh_dp: {row}")
    return row


def phase_mesh_sequence(card: str, counts_total: dict, tmp: str, pairs: list) -> None:
    """Phase 21: process_sequence(mesh=) on phase 13's six 1920x1080 pairs
    over MESH_N data positions of cuda:0 (and of the cards where there are
    several), byte for byte the files of chain=1; a resume from a manifest
    of the first three pairs."""
    from tpuflow_torch import FlowConfig, make_mesh
    from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
    from tpuflow_torch.parallel.multihost import SequenceManifest, process_sequence

    w, h = SIZES[1]
    cfg = FlowConfig()
    layouts = mesh_devices(MESH_N)
    mesh = make_mesh((MESH_N, 1), layouts[0])
    ref = os.path.join(tmp, "chain1")
    names = sorted(nm for nm in os.listdir(ref) if nm != "manifest.jsonl")
    n = len(pairs)
    ids = [f"{i:05d}_" for i in range(n)]
    per_pair = expected_launches(w, h, cfg)
    out = os.path.join(tmp, "mesh")
    reset_launch_counts()
    t0 = time.perf_counter()
    done = process_sequence(pairs, w, h, out, cfg, mesh=mesh, device="cuda")
    row = {"phase": "mesh_sequence", "shape": [h, w], "config": "FlowConfig()", "pairs": n,
           "card": card, "positions": f"{MESH_N} data positions of cuda:0",
           "ms_per_pair": (time.perf_counter() - t0) / n * 1e3, "completed": done,
           "bytewise_equal_chain1": same_files(ref, out, names),
           "manifest": sorted(SequenceManifest(os.path.join(out, "manifest.jsonl")).done())}
    check_counts("mesh sequence", launch_counts(), scaled(per_pair, n), counts_total)
    cards_ok = True
    for devices in layouts[1:]:
        out = os.path.join(tmp, "mesh_cards")
        reset_launch_counts()
        t0 = time.perf_counter()
        done_cards = process_sequence(pairs, w, h, out, cfg, device="cuda",
                                      mesh=make_mesh((MESH_N, 1), devices))
        row.update(cards_devices=devices, cards_completed=done_cards,
                   cards_ms_per_pair=(time.perf_counter() - t0) / n * 1e3,
                   cards_bytewise_equal_chain1=same_files(ref, out, names))
        check_counts("mesh sequence over the cards", launch_counts(), scaled(per_pair, n),
                     counts_total)
        cards_ok = done_cards == ids and row["cards_bytewise_equal_chain1"]
    out = os.path.join(tmp, "mesh_resume")
    os.makedirs(out)
    manifest = SequenceManifest(os.path.join(out, "manifest.jsonl"))
    for pid in ids[:3]:
        manifest.record(pid, 0.0)
    reset_launch_counts()
    resumed = process_sequence(pairs, w, h, out, cfg, mesh=mesh, device="cuda")
    check_counts("mesh sequence resume", launch_counts(), scaled(per_pair, n - 3), counts_total)
    rest = [nm for nm in names if nm[:6] in ids[3:]]
    row.update(resume_completed=resumed, resume_bytewise_equal=same_files(ref, out, rest),
               resume_rewrote_none=not any(nm[:6] in ids[:3] for nm in os.listdir(out)))
    row["ok"] = bool(done == ids and row["bytewise_equal_chain1"] and row["manifest"] == ids
                     and resumed == ids[3:] and row["resume_bytewise_equal"]
                     and row["resume_rewrote_none"] and cards_ok)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"mesh_sequence: {row}")


def phase_report_scaling(card: str) -> dict:
    """Phase 22: report_scaling's --link constants, its --project table
    (summarised), and the measured dp and sp line on MESH_N positions; with
    the measured constants and with the model's own, "auto" routes no level
    of a one-card mesh to the explicit route."""
    from tpuflow_torch import FlowConfig
    from tpuflow_torch.parallel.model import ICIParams, ONE_CARD, plan_level
    from tpuflow_torch.pyramid import level_schedule
    from tpuflow_torch.tools import report_scaling

    link = report_scaling.measure_link()
    emit({"phase": "report_scaling_link", **link})
    measured = ICIParams(bandwidth_bytes_s=link["bandwidth_bytes_s"],
                         hop_latency_s=link["hop_latency_s"], dispatch_s=link["dispatch_s"],
                         launch_s=link["launch_s"])
    cfg = FlowConfig()
    explicit = []
    for ici in (measured, ONE_CARD):
        for w, h in SIZES + (SIZE_4K,):
            for n_y in (2, 4, 8):
                for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
                    path = plan_level(s.height, s.width, cfg, n_y, ici, cards=1)[0]
                    if path == "explicit":
                        explicit.append((w, h, n_y, s.height, s.width))
    summary = [{k: r[k] for k in ("case", "cards", "n_y", "path", "tn_ms", "t1_ms", "efficiency")
                if k in r} for r in report_scaling.project()
               if r["path"] in ("auto", "hybrid", "explicit", "kernel")]
    emit({"phase": "report_scaling_project", "rows": summary})
    line = report_scaling.measure(MESH_N, SIZES[0], reps=3, k=4)
    row = {"phase": "report_scaling", **line, "auto_explicit_levels_one_card": explicit}
    row["ok"] = (not explicit and line["distinct_cards"] >= 1
                 and all(v for key, v in line.items() if key.endswith("_bitwise")))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"report_scaling: {row}")
    return row


# Phase 24: the mesh over processes, one position a process, joined by
# initialize_distributed (NCCL where CUDA is available, with the gloo group
# beside it that carries every host object). The workers are this script
# run with --proc-worker; each prints one PROCRESULT line. On one card the
# PROC_N processes share cuda:0; with several cards each takes its own. The
# explicit route and the hybrid send tensors between the processes by NCCL,
# which refuses two ranks on one card (NCCL 2.28.9: "Duplicate GPU
# detected"), so on one card they must raise.
PROC_N = 2
PROC_TIMEOUT_S = 600
PROC_ROUNDS = 3


def proc_command(case: str) -> list:
    """The command of one worker of ``case``; ``run_processes`` appends its
    address, rank and world size."""
    return [sys.executable, os.path.abspath(__file__), "--proc-worker", case]


def proc_results(world: int, case: str) -> list:
    """Each worker's PROCRESULT; any worker's failure fails the phase."""
    from tpuflow_torch.parallel.multihost import process_results

    return process_results(proc_command(case), world, PROC_TIMEOUT_S, cwd=REPO)


def proc_dp(rank: int, world: int, card: str) -> dict:
    """(a): a (4, 388, 584) grey stack on a (world, 1) mesh over the
    processes: this process's pairs bitwise its own compute_flow of each,
    ``pairs`` exact, the launch counts those of its pairs."""
    import torch

    from tpuflow_torch import FlowConfig, compute_flow, make_mesh
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.synthetic import textured_frames
    from tpuflow_torch.tools.roofline import cuda_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    w, h = SIZES[0]
    cfg = FlowConfig()
    frames = np.stack(textured_frames(w, h, [(i * 1.25, i * -0.75) for i in range(DP_FRAMES)]))
    F0, F1 = frames[:-1], frames[1:]
    dp = make_mesh((world, 1))
    mine = tuple(i for i in range(len(F0)) if i % world == rank)
    singles = {i: compute_flow(F0[i], F1[i], cfg, device=dev) for i in mine}
    sharded.reset_launch_counts()
    res = compute_flow(F0, F1, cfg, mesh=dp, device=dev)
    counts = sharded_counts()
    want = dict(scaled(expected_launches(w, h, cfg), len(mine)), relax_sharded=0, copies=0)
    want = {key: want.get(key, 0) for key in counts}
    bitwise = res.pairs == mine and all(
        res.u[j].tobytes() == singles[i].u.tobytes()
        and res.v[j].tobytes() == singles[i].v.tobytes() for j, i in enumerate(mine))
    ms = [cuda_ms(lambda: compute_flow(F0, F1, cfg, mesh=dp, device=dev), 1, warmup=False)
          for _ in range(PROC_ROUNDS)]
    return {"case": "dp", "rank": rank, "device": str(dev), "pairs": list(res.pairs),
            "bitwise": bitwise, "counts": counts, "counts_ok": counts == want,
            "expected": want, "ms_all": ms, "ms_median": statistics.median(ms)}


def proc_row(rank: int, world: int, card: str) -> dict:
    """(b) and (c): a 1920x1080 full_model() pair on a (1, world) row over
    the processes, halo kernel and auto, bitwise this process's
    compute_flow, counts exact (one relax_sharded launch a process a
    sharded level); the level-0 launch with its grid syncs and row barriers
    counted on the card against the formulas, bitwise relax; the race case
    (the last process held back about 0.1 s before its launch); the routes
    timed in turns with compute_flow."""
    import torch

    from tpuflow_torch import compute_flow, compute_flow_sharded, make_mesh, models
    from tpuflow_torch.parallel import relax_sharded_kernel
    from tpuflow_torch.parallel.halo_kernel import grid_syncs, row_barriers
    from tpuflow_torch.parallel.mesh import card_stream
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.level import relax
    from tpuflow_torch.solver.sharded import sharded_plan
    from tpuflow_torch.synthetic import textured_pair
    from tpuflow_torch.tools.roofline import cuda_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    w, h = SIZES[1]
    cfg = models.full_model()
    f0, f1 = textured_pair(w, h)
    row = make_mesh((1, world))
    base = compute_flow(f0, f1, cfg, device=dev)
    out = {"case": "row", "rank": rank, "device": str(dev), "cards": row.cards,
           "auto_plan": [f"{lh}x{lw}:{r}" + (f"@k={k}" if r != "replicated" else "")
                         for lh, lw, r, k in sharded_plan(w, h, cfg, row, "auto")]}
    ok = True
    runs = {"compute_flow": lambda: compute_flow(f0, f1, cfg, device=dev)}
    # k = 2 where each process has its card (the band path); processes that
    # share one take turns by time slices, 6.4 s a pair on this route
    cases = [("kernel", "kernel", 1), ("auto", "auto", 1)]
    if row.p2p_ok:
        cases.insert(1, ("kernel_k2", "kernel", 2))
    for name, halo, k in cases:
        runs[name] = lambda hl=halo, kk=k: compute_flow_sharded(f0, f1, cfg, mesh=row, halo=hl,
                                                                k_outer=kk, device=dev)
        sharded.reset_launch_counts()
        res = runs[name]()
        counts = sharded_counts()
        want = expected_sharded_counts(w, h, cfg, row, halo, k)
        want = {key: want.get(key, 0) for key in counts}
        same = res.u.tobytes() == base.u.tobytes() and res.v.tobytes() == base.v.tobytes()
        out[f"{name}_bitwise"], out[f"{name}_counts"] = same, counts
        out[f"{name}_counts_ok"] = counts == want
        out[f"{name}_band"] = band_rows(w, h, cfg, row, halo, k)
        if counts != want:
            out[f"{name}_expected"] = want
        ok &= same and counts == want and out[f"{name}_band"]["rows_ok"]
    x = kernel_inputs(w, h)
    args = (x["fxyz"], x["uvf"], x["sc"], cfg)
    unsharded = relax(*args, J=x["J"])
    syncs = torch.zeros(world, dtype=torch.int32, device=dev)
    barriers = torch.zeros_like(syncs)
    got = relax_sharded_kernel(*args, row, 1, J=x["J"], syncs=syncs, barriers=barriers)
    want_syncs = [grid_syncs(cfg, world, 1, world, processes=True) * (c == rank)
                  for c in range(world)]
    want_barriers = [row_barriers(cfg, world, world, 1, processes=True) * (c == rank)
                     for c in range(world)]
    out.update(level_max_abs_err=float((got - unsharded).abs().max()),
               grid_syncs=syncs.tolist(), grid_syncs_expected=want_syncs,
               row_barriers=barriers.tolist(), row_barriers_expected=want_barriers)
    ok &= (out["level_max_abs_err"] <= SHARDED_BOUND and out["grid_syncs"] == want_syncs
           and out["row_barriers"] == want_barriers)
    # (c): the last process starts about 0.1 s after the others
    if rank == world - 1:
        with torch.cuda.stream(card_stream(dev)):
            torch.cuda._sleep(CROSS_RACE_SLEEP_CYCLES)
    raced = relax_sharded_kernel(*args, row, 1, J=x["J"])
    out["race_max_abs_err"] = float((raced - unsharded).abs().max())
    ok &= out["race_max_abs_err"] <= SHARDED_BOUND
    ms = {name: [] for name in ("compute_flow", "kernel", "auto")}
    for _ in range(PROC_ROUNDS):
        for name in ("compute_flow", "kernel", "auto", "auto", "kernel", "compute_flow"):
            ms[name].append(cuda_ms(runs[name], 1, warmup=False))
    for name, v in ms.items():
        out[f"{name}_ms_median"], out[f"{name}_ms_all"] = statistics.median(v), v
    out["ok"] = bool(ok)
    return out


def proc_device():
    """This worker's card, which initialize_distributed set."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def in_turns(runs: dict, out: dict) -> None:
    """Each of ``runs`` timed PROC_ROUNDS times in turns (forward, then
    backward), every process at once: its median and all its times."""
    from tpuflow_torch.tools.roofline import cuda_ms

    ms = {name: [] for name in runs}
    for r in range(PROC_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            ms[name].append(cuda_ms(runs[name], 1, warmup=False))
    for name, v in ms.items():
        out[f"{name}_ms_median"], out[f"{name}_ms_all"] = statistics.median(v), v


def shared_card_raise(fn, out: dict, key: str) -> bool:
    """Where the processes share a card, ``fn`` must raise before any
    message, naming NCCL and the shared card: records it under ``key``."""
    try:
        fn()
    except RuntimeError as err:
        out[f"{key}_raised"] = str(err)
        out[f"{key}_ran"] = False
        out[f"{key}_reason"] = NEEDS_A_CARD_EACH
        return "NCCL" in str(err) and "share card" in str(err)
    out[f"{key}_raised"] = None
    return False


NEEDS_A_CARD_EACH = ("not run: NCCL refuses two ranks on one card, so it needs a card a "
                     "process (a machine with several cards)")
EXPLICIT_ROUTES = {"kernel": ("kernel", 1), "explicit_k1": ("explicit", 1),
                   "explicit_k2": ("explicit", 2), "auto": ("auto", 1)}


def proc_explicit(rank: int, world: int, card: str, size=SIZES[1]) -> dict:
    """(d): a full_model() pair (1920x1080 unless ``size``) on the row (1,
    world) over the processes with halo="explicit" at k = 1 and 2 and
    "auto" (the explicit route in its choice), and halo="kernel": bitwise
    this process's compute_flow, launches, copies and messages exact; timed
    in turns with compute_flow. Where the processes share a card the
    explicit route must raise, naming NCCL, before any message."""
    from tpuflow_torch import compute_flow, compute_flow_sharded, make_mesh, models
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.sharded import sharded_plan
    from tpuflow_torch.synthetic import textured_pair

    dev = proc_device()
    w, h = size
    cfg = models.full_model()
    f0, f1 = textured_pair(w, h)
    row = make_mesh((1, world), dev)
    out = {"case": "explicit", "rank": rank, "device": str(dev), "shape": [h, w],
           "config": "models.full_model()", "cards": row.cards}
    if not row.p2p_ok:
        out["ok"] = shared_card_raise(lambda: compute_flow_sharded(
            f0, f1, cfg, mesh=row, halo="explicit", device=dev), out, "explicit")
        return out
    out["auto_plan"] = [f"{lh}x{lw}:{r}" + (f"@k={k}" if r != "replicated" else "")
                        for lh, lw, r, k in sharded_plan(w, h, cfg, row, "auto")]
    base = compute_flow(f0, f1, cfg, device=dev)
    runs = {"compute_flow": lambda: compute_flow(f0, f1, cfg, device=dev)}
    ok = True
    for name, (halo, k) in EXPLICIT_ROUTES.items():
        runs[name] = lambda hl=halo, kk=k: compute_flow_sharded(f0, f1, cfg, mesh=row, halo=hl,
                                                                k_outer=kk, device=dev)
        sharded.reset_launch_counts()
        res = runs[name]()
        counts = sharded_counts()
        want = expected_sharded_counts(w, h, cfg, row, halo, k)
        want = {key: want.get(key, 0) for key in counts}
        same = res.u.tobytes() == base.u.tobytes() and res.v.tobytes() == base.v.tobytes()
        out[f"{name}_bitwise"], out[f"{name}_counts"] = same, counts
        out[f"{name}_counts_ok"] = counts == want
        out[f"{name}_band"] = band_rows(w, h, cfg, row, halo, k)
        if counts != want:
            out[f"{name}_expected"] = want
        ok &= same and counts == want and out[f"{name}_band"]["rows_ok"]
    in_turns(runs, out)
    out["explicit_ran"], out["ok"] = True, bool(ok)
    return out


def expected_hybrid_counts(w: int, h: int, cfg, mesh, b: int) -> dict:
    """compute_flow_hybrid's counts in this process on a mesh over
    processes: the coarse levels of the pairs it owns, its row's pairs'
    fine levels on the router's routes, and its messages (each pair it owns
    sent to the other processes of its row, the explicit route's sends)."""
    from tpuflow_torch.parallel.hybrid import hybrid_moves, hybrid_split_level
    from tpuflow_torch.pyramid import level_schedule

    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    g0 = hybrid_split_level(w, h, cfg, mesh)
    me, data = mesh.local_positions()[0], mesh.local_row()
    coarse = scaled(expected_sharded_counts(w, h, cfg, mesh, "auto", data=data,
                                            levels=range(0, g0), gather=False),
                    len(range(me, b, mesh.size)))
    fine = scaled(expected_sharded_counts(w, h, cfg, mesh, "auto", data=data,
                                          levels=range(g0, n), smooth=False),
                  sum(i % mesh.n_data == data for i in range(b)))
    want = {key: coarse[key] + fine[key] for key in coarse}
    want["messages"] += sum(len(to) * (1 + (g0 > 0)) for _, owner, to in hybrid_moves(b, mesh)
                            if owner == me)
    return want


def proc_hybrid(rank: int, world: int, card: str, size=SIZES[0],
                preset: str = "reference_default") -> dict:
    """(e): compute_flow_hybrid on a (4, H, W) stack (584x388 grey unless
    ``size`` and ``preset``) on (world, 1), where no pair moves, and on (1,
    world), where each pair's owner sends its working set to the row by
    NCCL: this process's pairs bitwise its own compute_flow of each,
    ``pairs`` exact, launches and messages exact; timed in turns with the
    stack's compute_flow, dp over the processes and, with the row's
    hybrid, the stack on the row (each pair sharded by the router). Where
    the processes share a card the row's hybrid must raise, naming NCCL,
    before any message."""
    from tpuflow_torch import compute_flow, compute_flow_hybrid, make_mesh, models
    from tpuflow_torch.parallel.hybrid import hybrid_moves, hybrid_split_level
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.sharded import sharded_bands
    from tpuflow_torch.synthetic import textured_frames

    dev = proc_device()
    w, h = size
    cfg = getattr(models, preset)()
    frames = np.stack(textured_frames(w, h, [(i * 1.25, i * -0.75) for i in range(DP_FRAMES)]))
    F0, F1 = frames[:-1], frames[1:]
    b = len(F0)
    meshes = {"dp": make_mesh((world, 1), dev), "row": make_mesh((1, world), dev)}
    singles = [compute_flow(F0[i], F1[i], cfg, device=dev) for i in range(b)]
    out = {"case": "hybrid", "rank": rank, "device": str(dev), "shape": [b, h, w],
           "config": f"models.{preset}()", "cards": meshes["row"].cards}
    runs = {"stack": lambda: compute_flow(F0, F1, cfg, device=dev),
            "dp": lambda: compute_flow(F0, F1, cfg, mesh=meshes["dp"], device=dev)}
    ok = True
    for name, mesh in meshes.items():
        key = f"hybrid_{name}"
        run = (lambda m=mesh: compute_flow_hybrid(F0, F1, cfg, mesh=m, device=dev))
        out[f"{key}_split_level"] = hybrid_split_level(w, h, cfg, mesh)
        if hybrid_moves(b, mesh) and not mesh.p2p_ok:
            ok &= shared_card_raise(run, out, key)
            continue
        sharded.reset_launch_counts()
        res = run()
        counts = sharded_counts()
        want = expected_hybrid_counts(w, h, cfg, mesh, b)
        want = {k: want.get(k, 0) for k in counts}
        mine = tuple(i for i in range(b) if i % mesh.n_data == mesh.local_row())
        same = res.pairs == mine and all(
            res.u[j].tobytes() == singles[i].u.tobytes()
            and res.v[j].tobytes() == singles[i].v.tobytes() for j, i in enumerate(mine))
        out.update({f"{key}_ran": True, f"{key}_pairs": list(res.pairs),
                    f"{key}_bitwise": same, f"{key}_counts": counts,
                    f"{key}_counts_ok": counts == want,
                    f"{key}_path": "band" if sharded_bands(w, h, cfg, mesh, "auto",
                                                           data=mesh.local_row())
                    else "whole field"})
        if counts != want:
            out[f"{key}_expected"] = want
        ok &= same and counts == want
        if name == "row":
            runs["row"] = lambda: compute_flow(F0, F1, cfg, mesh=meshes["row"], device=dev)
        runs[key] = run
    in_turns(runs, out)
    out["ok"] = bool(ok)
    return out


def proc_stack(rank: int, world: int, card: str) -> dict:
    """A (4, 1080, 1920) full_model() stack on a (2, world / 2) mesh over the
    processes: pair i on data row i % 2, sharded over the row's processes
    by the router, each process computing its band plan's rows of the
    sharded levels; its row's pairs bitwise its own compute_flow of each,
    ``pairs``, launches and messages (one gather a pair) exact."""
    from tpuflow_torch import compute_flow, make_mesh, models
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.sharded import sharded_bands
    from tpuflow_torch.synthetic import textured_frames

    dev = proc_device()
    w, h = SIZES[1]
    cfg = models.full_model()
    frames = np.stack(textured_frames(w, h, [(i * 1.25, i * -0.75) for i in range(DP_FRAMES)]))
    F0, F1 = frames[:-1], frames[1:]
    mesh = make_mesh((2, world // 2), dev)
    data = mesh.local_row()
    mine = tuple(i for i in range(len(F0)) if i % 2 == data)
    singles = {i: compute_flow(F0[i], F1[i], cfg, device=dev) for i in mine}
    sharded.reset_launch_counts()
    res = compute_flow(F0, F1, cfg, mesh=mesh, device=dev)
    counts = sharded_counts()
    want = scaled(expected_sharded_counts(w, h, cfg, mesh, "auto", data=data), len(mine))
    want = {key: want.get(key, 0) for key in counts}
    same = res.pairs == mine and all(
        res.u[j].tobytes() == singles[i].u.tobytes()
        and res.v[j].tobytes() == singles[i].v.tobytes() for j, i in enumerate(mine))
    path = "band" if sharded_bands(w, h, cfg, mesh, "auto", data=data) else "whole field"
    return {"case": "stack", "rank": rank, "device": str(dev), "mesh": [2, world // 2],
            "shape": [len(F0), h, w], "config": "models.full_model()", "pairs": list(res.pairs),
            "path": path, "bitwise": same, "counts": counts, "counts_ok": counts == want,
            "expected": want, "ok": bool(same and counts == want)}


def proc_spin(rank: int, world: int) -> None:
    """The spin limit across processes: the last process joins the row's
    arenas but never launches; the others must trap at the kernel's spin
    limit. The last process stays alive past the limit, so that its arena
    is still open while they spin."""
    import torch

    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.parallel import make_mesh, relax_sharded_kernel
    from tpuflow_torch.solver.level import LevelScalars

    dev = torch.device("cuda", torch.cuda.current_device())
    sc = LevelScalars.make(300, 64, 1.0, 1.0, 35.0)
    T = torch.rand((2, 64, 300), device=dev)
    fxyz = torch.rand((3, 64, 300), device=dev)
    relax_sharded_kernel(fxyz, T, sc, FlowConfig(), make_mesh((1, world)), _skip_card=world - 1)
    if rank == world - 1:
        time.sleep(spin_limit_s() + 5)
        print("PROCRESULT " + json.dumps({"case": "spin", "rank": rank, "left_out": True}),
              flush=True)
        os._exit(0)
    try:
        torch.cuda.synchronize(dev)
    except RuntimeError as err:
        print("PROCRESULT " + json.dumps({"case": "spin", "rank": rank, "trapped": str(err)}),
              flush=True)
        os._exit(3)
    print("PROCRESULT " + json.dumps({"case": "spin", "rank": rank, "trapped": None}),
          flush=True)
    os._exit(0)


def proc_worker(argv) -> int:
    """One process of phase 24 (``--proc-worker CASE HOST:PORT RANK WORLD``;
    CASE is dp, row, spin, or explicit or hybrid with ``@WxH[@PRESET]`` for
    another size)."""
    import torch

    sys.path.insert(0, REPO)
    from tpuflow_torch.parallel.group import process_group
    from tpuflow_torch.parallel.multihost import initialize_distributed
    from tpuflow_torch.tools.roofline import device_info

    case, address, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    initialize_distributed(address, num_processes=world, process_id=rank)
    if case == "spin":
        proc_spin(rank, world)
    card = device_info()["nvidia_smi"]
    # CASE[@WxH[@PRESET]]: the explicit and hybrid cases at another size
    name, *rest = case.split("@")
    kw = {}
    if rest:
        kw["size"] = tuple(int(x) for x in rest[0].split("x"))
    if rest[1:]:
        kw["preset"] = rest[1]
    out = {"dp": proc_dp, "row": proc_row, "explicit": proc_explicit,
           "hybrid": proc_hybrid, "stack": proc_stack}[name](rank, world, card, **kw)
    out["backend"] = torch.distributed.get_backend()
    print("PROCRESULT " + json.dumps(out), flush=True)
    torch.distributed.barrier(group=process_group())
    torch.distributed.destroy_process_group()
    return 0


def phase_procmesh(card: str, world: int = PROC_N) -> dict:
    """Phase 24: ``world`` processes (one a card, or all on cuda:0 on one
    card): (a) dp, (b) a row over the processes with halo kernel and auto,
    (c) the race case, (d) the explicit route on the row, (e) the hybrid on
    (world, 1) and (1, world), and the spin-limit case; each bitwise with
    exact counts, or, for (d) and the row's hybrid where the processes
    share a card, the raise that says they need a card a process. Returns
    the kernels line's keys for it."""
    import torch

    from tpuflow_torch.parallel.multihost import run_processes

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    layout = [f"cuda:{r % cards}" for r in range(world)]
    dp = proc_results(world, "dp")
    row = {"phase": "procmesh_dp", "processes": world, "devices": layout, "card": card,
           "ranks": dp}
    row["ok"] = all(r["bitwise"] and r["counts_ok"] for r in dp) and sorted(
        i for r in dp for i in r["pairs"]) == list(range(DP_FRAMES - 1))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"procmesh dp: {row}")
    rows = proc_results(world, "row")
    row = {"phase": "procmesh_row", "processes": world, "devices": layout, "card": card,
           "ranks": rows}
    row["ok"] = all(r["ok"] for r in rows)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"procmesh row: {row}")
    explicit = proc_results(world, "explicit")
    ran = all(r.get("explicit_ran") for r in explicit)
    row = {"phase": "procmesh_explicit", "processes": world, "devices": layout, "card": card,
           "ran": ran, "ranks": explicit}
    if not ran:
        row["reason"] = NEEDS_A_CARD_EACH
    row["ok"] = all(r["ok"] for r in explicit)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"procmesh explicit: {row}")
    hybrid = proc_results(world, "hybrid")
    row = {"phase": "procmesh_hybrid", "processes": world, "devices": layout, "card": card,
           "ranks": hybrid}
    if not all(r.get("hybrid_row_ran") for r in hybrid):
        row["hybrid_row"] = NEEDS_A_CARD_EACH
    row["ok"] = all(r["ok"] and r["hybrid_dp_ran"] for r in hybrid)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"procmesh hybrid: {row}")
    limit = spin_limit_s()
    t1 = time.perf_counter()
    spun = run_processes(proc_command("spin"), world, limit + CROSS_TIMEOUT_MARGIN_S, cwd=REPO)
    stuck = {"phase": "procmesh_timeout", "processes": world, "spin_limit_s": limit,
             "margin_s": CROSS_TIMEOUT_MARGIN_S, "seconds": time.perf_counter() - t1,
             "returncodes": [rc for rc, _ in spun],
             "output_tails": [text[-400:] for _, text in spun]}
    stuck["ok"] = (all(rc not in (None, 0) and "trapped" in text for rc, text in spun[:-1])
                   and spun[-1][0] == 0)
    emit(stuck)
    if not stuck["ok"]:
        raise AssertionError(f"the spin limit across processes: {stuck}")
    err = max(max(r["level_max_abs_err"], r["race_max_abs_err"]) for r in rows)
    emit({"phase": "procmesh_done", "processes": world, "seconds": time.perf_counter() - t0})
    out = {"processes": world, "process_row_max_abs_err": err,
           "process_row_devices": layout,
           "process_row_kernel_ms": statistics.median(r["kernel_ms_median"] for r in rows),
           "process_row_compute_flow_ms": statistics.median(r["compute_flow_ms_median"]
                                                            for r in rows),
           "process_hybrid_dp_ms": statistics.median(r["hybrid_dp_ms_median"] for r in hybrid)}
    if ran:
        out.update(process_row_explicit_ms=statistics.median(
                       r["explicit_k1_ms_median"] for r in explicit),
                   process_row_explicit_k2_ms=statistics.median(
                       r["explicit_k2_ms_median"] for r in explicit),
                   process_row_explicit_counts=[r["explicit_k1_counts"] for r in explicit])
    else:
        out.update(process_row_explicit_ms=None, process_row_explicit=NEEDS_A_CARD_EACH)
    return out


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

    from tpuflow_torch.tools.roofline import device_info

    card = device_info()["nvidia_smi"]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    torch.cuda.set_device(0)

    from tpuflow_torch.ops.cuda_lib import load_library
    from tpuflow_torch.synthetic import textured_pair

    lib = load_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": lib.build_seconds, "library": os.path.relpath(lib.path, REPO),
          "ptxas": ptxas})

    table = phase_kernels()
    ksweep = phase_ksweep(card)
    median = phase_median(card)
    banded = phase_banded(card)
    phase_rows(card)
    counts, pairs = {}, {}
    for w, h in SIZES:
        pairs[(w, h, "reference_default")] = phase_e2e(w, h, "reference_default", counts,
                                                       oracle=(w, h) == SIZES[0])
    pairs[SIZES[0] + ("full_model",)] = phase_e2e(*SIZES[0], "full_model", counts, oracle=True)
    phase_e2e(*SIZES[0], "xray_log", counts, oracle=True, alpha=LOG_ALPHA)
    pairs[SIZE_4K + ("full_model",)] = phase_e2e(*SIZE_4K, "full_model", counts,
                                                 shift_bound=ZERO_FLOW_EPE)
    emit({"phase": "launch_totals", "counts": counts})
    missing = [name for name in MAIN_PATH if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    phase_cli()

    for w, h in SIZES:
        phase_times(w, h, *pairs[(w, h, "reference_default")], card, "reference_default",
                    {"kernel": 5, "plain": 3})
    phase_times(*SIZES[0], *pairs[SIZES[0] + ("full_model",)], card, "full_model",
                {"kernel": 5, "plain": 3})
    times_1080p = phase_times(*SIZES[1], *textured_pair(*SIZES[1]), card, "full_model",
                              {"kernel": 5})
    phase_times(*SIZE_4K, *pairs[SIZE_4K + ("full_model",)], card, "full_model",
                {"kernel": 3})
    # The measurement path after the main path's times, which it must not disturb.
    chain_launches, probes = phase_probes(lib.path)
    if chain_launches == 0:
        raise AssertionError("the one-sweep kernel was never launched on the measurement path")
    phase_sass(lib.path)
    bounds = phase_bounds(table)
    phase_trace(*SIZE_4K, bounds)
    t_sharded = time.perf_counter()
    sharded_row = phase_sharded_kernel(card)
    sharded_row["launches"] = phase_sharded_e2e(card, times_1080p)
    sharded_row.update(phase_crosscard_kernel(card))
    emit({"phase": "sharded_done", "seconds": time.perf_counter() - t_sharded})
    if sharded_row["launches"] == 0:
        raise AssertionError("relax_sharded was never launched on the sharded path")

    # The streaming path: each run sets the counts to 0 just before it and
    # checks them just after (check_counts); they join the kernels line's.
    t_stream = time.perf_counter()
    with tempfile.TemporaryDirectory() as seq_tmp:
        seq_pairs = phase_sequence(card, counts, seq_tmp)
        phase_batch(counts)
        phase_warp_report(counts)
        phase_async(card)
        phase_bench(card, counts)
        emit({"phase": "streaming_done", "seconds": time.perf_counter() - t_stream})

        # The meshes: the same kernels, driven over MESH_N positions.
        t_mesh = time.perf_counter()
        mesh = phase_mesh_explicit(card)
        phase_mesh_e2e(card, counts)
        phase_mesh_dp(card, counts)
        phase_mesh_sequence(card, counts, seq_tmp, seq_pairs)
        phase_report_scaling(card)
        phase_crosscard_e2e(card, counts)
        emit({"phase": "mesh_done", "seconds": time.perf_counter() - t_mesh})
    sharded_row.update(phase_procmesh(card))

    # The kernels line: times and bounds at 3840x2160 (1920x1080 beside them).
    rows = []
    for name in BANDED:
        b = banded[name]
        rows.append({"name": name, "route": "cuda", "source": "tpuflow_torch/csrc/banded.cu",
                     "replaces": REPLACES[name], "launches": counts[name],
                     "max_abs_err": b["max_abs_err"], "checks": b["checks"],
                     "shape": list(SIZE_4K[::-1]), "per": "one 3840x2160 full_model() pair",
                     "launches_per_pair": b["launches_per_pair"], "ms": b["ms"],
                     "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "resource": "device memory",
                     "share": b["share"], "library_ms": b["library_ms"],
                     "library": "torch.matmul, the dense pair of the same weights (TF32 off)",
                     "dense_matrix_bytes_4k": banded["dense_matrix_bytes"],
                     "table_bytes_4k": banded["table_bytes"],
                     "device_ms_by_shape": b["ms_by_shape"]})
    for name in KERNELS:
        if name in BANDED:
            continue
        t = table["level_tensor_gradient" if name == "level_tensor" else name]
        b = bounds["level_tensor_gradient" if name == "level_tensor" else name]
        row = {"name": name, "route": "cuda", "source": "tpuflow_torch/csrc/level.cu",
               "replaces": REPLACES[name], "launches": counts[name],
               "max_abs_err": t["max_abs_err"], "shape": list(SIZE_4K[::-1]),
               "ms": t["ms_4k"], "plain_ms": t["plain_ms_4k"], "bound_ms": b["bound_ms"],
               "bound_by": b["bound_by"], "resource": b["resource"], "share": b["share"],
               "library_ms": None, "library": "none", "ms_1080p": t["ms"],
               "plain_ms_1080p": t["plain_ms"]}
        if name == "jacobi_sweep":
            row.update(launches=chain_launches,
                       path="measurement (phase 9: roofline.measure differences relax with "
                            "this kernel chained); off the main path since jacobi_sweeps",
                       role="the one-sweep twin jacobi_sweeps is held against, bitwise")
        if name == "jacobi_sweeps":
            row.update(inner=5, design_bytes=b["design_bytes"],
                       max_abs_err=max(t["max_abs_err"], ksweep["max_abs_err"]),
                       max_abs_vs_chain=ksweep["max_abs_vs_chain"],
                       device_ms_by_shape=ksweep["device"])
        if name == "add_median":
            row.update(radius=5, max_abs_err=max(t["max_abs_err"], median["max_abs_err"]),
                       device_ms_by_shape=median["device"])
        if name == "warp":
            row.update(near_twin=WARP_TWIN, near_twin_ms=t["near_twin_ms_4k"])
        if name in REDESIGNED:
            row["redesigned"] = REDESIGNED[name]
        if name in ("outer_prologue", "outer_prologue_tensor"):
            blocks = mesh["prologue_blocks"]
            row.update(row_blocks_checked=blocks["blocks"],
                       row_block_max_abs_err=blocks["max_abs_err"],
                       max_abs_err=max(row["max_abs_err"], blocks["max_abs_err"]))
        if name == "level_tensor":
            log, blog = table["level_tensor_log"], bounds["level_tensor_log"]
            row.update(max_abs_err=max(t["max_abs_err"], log["max_abs_err"]),
                       log_max_abs_err=log["max_abs_err"],
                       log_ms=log["ms_4k"], log_plain_ms=log["plain_ms_4k"],
                       log_graph_ms=log["graph_ms_4k"], log_ms_1080p=log["ms"],
                       log_graph_ms_1080p=log["graph_ms"],
                       log_bound_ms=blog["bound_ms"], log_bound_by=blog["bound_by"],
                       log_resource=blog["resource"], log_share=blog["share"],
                       log_redesigned=REDESIGNED["level_tensor_log"])
        rows.append(row)
    for name, p in probes.items():
        rows.append({"name": name, "route": "cuda", "replaces": REPLACES[name], **p})
    sharded_row["explicit_route_max_abs_err"] = mesh["explicit_max_abs_err"]
    rows.append(sharded_row)
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


PROCS_CASES = ((2, "explicit"), (None, "explicit@3840x2160"),
               (None, "hybrid@1920x1080@full_model"), (4, "stack"))


def procs_main(argv) -> int:
    """``--procs N [--link]`` (module docstring): phase 24 and the larger
    cases over N processes one a card."""
    import torch

    world = int(argv[0])
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke --procs {world}: needs {world} CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpuflow_torch.ops.cuda_lib import load_library
    from tpuflow_torch.tools.roofline import device_info

    t_start = time.perf_counter()
    card = device_info()["nvidia_smi"]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    emit({"phase": "build", "seconds": load_library().build_seconds})
    if "--link" in argv:
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "tpuflow_torch.tools.report_scaling",
                               "--procs", str(world), "--link"], cwd=REPO,
                              capture_output=True, text=True, timeout=PROC_TIMEOUT_S)
        if done.returncode:
            raise RuntimeError(f"report_scaling --procs {world} --link: {done.stderr[-4000:]}")
        emit({"phase": "procs_link", "seconds": time.perf_counter() - t0,
              "report": json.loads(done.stdout.strip().splitlines()[-1])})
    emit({"phase": "procmesh_kernels_keys", **phase_procmesh(card, world)})
    for n, case in PROCS_CASES:
        if (n or world) > world:
            continue
        t0 = time.perf_counter()
        ranks = proc_results(n or world, case)
        row = {"phase": f"procs_{case}", "processes": n or world,
               "seconds": time.perf_counter() - t0, "ranks": ranks,
               "ok": all(r["ok"] for r in ranks)}
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"{case} over {n or world} processes: {row}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--proc-worker"]:
        sys.exit(proc_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--procs"]:
        sys.exit(procs_main(sys.argv[2:]))
    sys.exit(main())

"""The banded kernels' level-table form (ops/banded.py, csrc/banded.cu): the
frames of every level in one X launch and one Y launch, the flow and the
presmooth in one-level plans.

- ``resample_levels_plain`` (the CPU path and the plain version the card
  compares the kernels with) is bitwise a loop of ``resample_plain`` and the
  NumPy oracle at every level of the 584x388, 96x64 and 7x5 schedules, and
  within 1e-6 of max |JAX| of the JAX package's ``resample``.
- A numpy emulation of the two kernels, reading the plans as the kernels
  do (the X kernel's warp runs of 32 lanes over staged rows, the Y
  kernel's block table of 4 columns x up to YR rows a thread), writes every
  output of every level exactly once, each summing its whole window in
  ascending order: index by index at the 4K, 1080p and 584x388 schedules
  and at widths that are not a multiple of 4; value by value, bitwise
  against the plain version, at the small ones.
- ``solve`` on the CPU is bitwise a loop of per-level ``resample`` calls
  (the solve before the pyramid), over a whole schedule, a ``levels=`` split
  in two and ``smoothed=True``.

The kernels themselves run only on the card: chip_smoke.py (phase 3b) holds
them bitwise against these plain versions there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.ops.resample import resample as jresample

from tpuflow_torch import models, oracle_np
from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops import banded as B
from tpuflow_torch.ops.gaussian import gaussian_band, gaussian_kernel_taps
from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
from tpuflow_torch.ops.resample import (
    resample_band, resample_levels, resample_levels_plain, resample_plain,
)
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import LevelScalars, level_step, smooth_pair, solve
from tpuflow_torch.synthetic import textured_pair
from tpuflow_torch.tools import roofline as R

torch.set_num_threads(2)

T = torch.from_numpy
F = np.float32
SMALL = ((584, 388), (96, 64), (7, 5))
LARGE = ((3840, 2160), (1920, 1080), (584, 388))
# widths that are not a multiple of 4, with frames as a stack of one plane
ODD = ((97, 61), (30, 17), (13, 9))


def image(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 40.0).astype(F)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def frame_sizes(w, h, cfg=None):
    """The distinct sizes of a schedule's levels but level 0 and the full
    size, as solve resamples them."""
    cfg = cfg or FlowConfig()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    return tuple(dict.fromkeys((s.width, s.height) for s in specs
                               if s.level != 0 and (s.width, s.height) != (w, h)))


def pyramid_specs(w, h, sizes):
    xs = tuple((resample_band, w, ow) for ow, _ in sizes)
    ys = tuple((resample_band, h, oh) for _, oh in sizes)
    return xs, ys


# ---------------------------------------------------------------------------
# numpy emulations of the kernels, reading the plans as csrc/banded.cu does
# ---------------------------------------------------------------------------


def emulate_x(x, plan, values=True):
    """banded_x_kernel on x (rows, in_n): returns the intermediate (rows,
    pitch) (NaN where nothing was written; None without ``values``) and the
    number of writes of each of its entries. Every row goes through every
    run of the plan's meta region; lane l of a run sums its
    output's window in ascending order, with the head and tail weights and
    an interior of 1s (MODE_BOX) or the taps at origin + o - first - j
    (MODE_TAPS)."""
    rows, in_n = x.shape
    n_levels, n_runs, meta_ints = (int(v) for v in plan[:3])
    meta = plan[B.HEAD:B.HEAD + meta_ints]
    levels = meta[:n_levels * B.XL].reshape(n_levels, B.XL)
    runs = meta[n_levels * B.XL:n_levels * B.XL + 4 * n_runs].reshape(n_runs, 4)
    pitch = int(max(lv[0] + B.pad_line(lv[1]) for lv in levels))
    out = np.full((rows, pitch), np.nan, F) if values else None
    writes = np.zeros((rows, pitch), np.int32)
    lane = np.arange(B.RUN)
    for level, o0, cmax, at in runs:
        out_col, out_n, mode, norm_bits, value, origin = levels[level, :6]
        assert mode in (B.MODE_BOX, B.MODE_TAPS)
        first = plan[at:at + B.RUN]
        count = plan[at + B.RUN:at + 2 * B.RUN]
        on = o0 + lane < out_n
        assert (count[~on] == 0).all() and (count[on] >= 1).all()
        assert (first[on] + count[on] <= in_n).all()
        assert cmax == count.max()                  # every term is summed
        writes[:, out_col + o0 + lane[on]] += 1
        if not values:
            continue
        acc = np.zeros((rows, B.RUN), F)
        for j in range(int(count.max())):          # a lane's terms in ascending order
            act = j < count
            if mode == B.MODE_BOX:
                head = plan[at + 2 * B.RUN:at + 3 * B.RUN].view(F)
                tail = plan[at + 3 * B.RUN:at + 4 * B.RUN].view(F)
                w = np.where(j == 0, head, np.where(j == count - 1, tail, F(1.0)))
            else:
                idx = np.clip(origin + o0 + lane - first - j, 0, meta_ints - value - 1)
                w = meta[value + idx].view(F)
                assert (origin + o0 + lane - first - j)[act].min() >= 0
            k = np.minimum(first + j, in_n - 1)
            acc[:, act] = acc[:, act] + x[:, k[act]] * w[act]
        norm = np.array(norm_bits, np.int32).view(F)
        out[:, out_col + o0 + lane[on]] = acc[:, on] * norm
    return out, writes


def emulate_y(tmp, plan, planes, in_rows, total, values=True):
    """banded_y_kernel over the intermediate tmp (planes * in_rows, pitch):
    returns the output buffer (NaN where nothing was written; None without
    ``values``) and the number of writes of each float of it. Each work
    item is taken once (the kernel's blocks walk them grid-stride), and its
    entry holds what it needs: a thread owns 4 columns of the item's rows,
    stages its input rows [k0, k1) once, and each output row sums its window
    of them in ascending order, with the table's head and tail weights and
    an interior of 1s (MODE_BOX) or the taps at origin + o - k
    (MODE_TAPS)."""
    n_levels, n_blocks, lv_off, blk_off = (int(v) for v in plan[:4])
    levels = plan[lv_off:lv_off + n_levels * B.YL].reshape(n_levels, B.YL).astype(np.int64)
    blocks = plan[blk_off:blk_off + n_blocks * B.YB].reshape(n_blocks, B.YB)
    out = np.full(total, np.nan, F) if values else None
    writes = np.zeros(total, np.int32)
    for level, plane, o0, c0, width, src, k0, k1, tab, stride, nr, _ in blocks:
        out_n, norm_bits, lo, hi, mode, value, origin, _ = levels[level]
        assert mode in (B.MODE_BOX, B.MODE_TAPS)
        off = int((lo & 0xFFFFFFFF) | (hi << 32))
        assert src % 4 == 0 and c0 % 4 == 0                # 16-byte loads
        assert 1 <= nr <= B.YR and o0 + nr <= out_n
        cols = np.arange(c0, min(c0 + B.YC, width))
        rows_t = plan[tab:tab + nr * stride].reshape(nr, stride)
        first, end = rows_t[:, 0], rows_t[:, 0] + rows_t[:, 1]
        assert k0 == first[0] and k1 == end[nr - 1] and k1 <= in_rows
        assert (first >= k0).all() and (end <= k1).all()
        idx = off + (plane * out_n + o0 + np.arange(nr)[:, None]) * width + cols[None, :]
        writes[idx] += 1
        if not values:
            continue
        source = tmp[plane * in_rows:(plane + 1) * in_rows, src - c0 + cols]
        acc = np.zeros((nr, len(cols)), F)
        for r in range(nr):
            for k in range(first[r], end[r]):    # ascending, from the staged rows
                if mode == B.MODE_BOX:
                    j = {first[r]: 2, end[r] - 1: 1 + rows_t[r, 1]}.get(k)
                    bits = rows_t[r, j] if j is not None else B.f32_bits(1.0)
                else:
                    bits = plan[value + origin + o0 + r - k]
                acc[r] = acc[r] + source[k] * np.array(bits, np.int64).astype(np.int32).view(F)
        out[idx] = acc * np.array(norm_bits, np.int64).astype(np.int32).view(F)
    return out, writes


def emulate_levels(x, xs, ys, values=True):
    """Both kernels on x (planes, h, w): each level's output, and the
    write counts of the intermediate's level columns and of the output."""
    planes, h, w = x.shape
    widths = tuple(b.out_n for b in B.bands(xs))
    tmp, xw = emulate_x(x.reshape(planes * h, w) if values else np.empty((planes * h, w), F),
                        B.x_plan(xs), values)
    offs, total = B.y_layout(ys, widths, planes)
    out, yw = emulate_y(tmp, B.y_plan(ys, widths, planes), planes, h, total, values)
    cols, _ = B.x_cols(widths)
    levels = None
    if values:
        levels = [out[o:o + planes * b.out_n * wl].reshape(planes, b.out_n, wl)
                  for o, b, wl in zip(offs, B.bands(ys), widths)]
    xw_levels = [xw[:, c:c + wl] for c, wl in zip(cols, widths)]
    return levels, xw_levels, yw


# ---------------------------------------------------------------------------
# the level-table plain form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SMALL)
def test_levels_plain_is_the_per_level_plain_and_the_oracle(size):
    w, h = size
    img = image((2, h, w), seed=w)
    sizes = frame_sizes(w, h)
    got = resample_levels(T(img), sizes)          # CPU: resample_levels_plain
    assert len(got) == len(sizes)
    for (ow, oh), lvl in zip(sizes, got):
        want = resample_plain(T(img), ow, oh).numpy()
        assert same_bits(lvl.numpy(), want), (ow, oh)
        for p in range(2):
            assert same_bits(want[p], oracle_np.resample(img[p], ow, oh)), (ow, oh, p)
    for (ow, oh), lvl in zip(sizes, resample_levels_plain(T(img), sizes)):
        assert same_bits(lvl.numpy(), resample_plain(T(img), ow, oh).numpy())


@pytest.mark.parametrize("size", SMALL[:2])
def test_levels_close_to_jax(size):
    w, h = size
    img = image((h, w), seed=h)
    for (ow, oh), lvl in zip(frame_sizes(w, h), resample_levels(T(img), frame_sizes(w, h))):
        want = np.asarray(jresample(jnp.asarray(img), ow, oh))
        assert np.abs(lvl.numpy() - want).max() <= 1e-6 * np.abs(want).max(), (ow, oh)


def test_levels_plain_of_no_sizes_and_no_launches():
    reset_launch_counts()
    assert resample_levels(T(image((2, 9, 11), 0)), ()) == []
    resample_levels(T(image((2, 20, 30), 0)), ((11, 7), (5, 4)))
    assert launch_counts()["resample"] == 0       # the CPU launches nothing


# ---------------------------------------------------------------------------
# the plans: every output once, every term in order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", LARGE)
def test_pyramid_plans_write_every_output_once(size):
    """Index by index: the X runs write each level's columns of every row
    once (and nothing between the levels), the Y block table every output of
    every level once; each run and block covers its windows whole."""
    w, h = size
    xs, ys = pyramid_specs(w, h, frame_sizes(w, h, models.full_model()))
    _, xw, yw = emulate_levels(np.empty((2, h, w), F), xs, ys, values=False)
    for lvl in xw:
        assert (lvl == 1).all()
    widths = tuple(b.out_n for b in B.bands(xs))
    assert sum(int(c.sum()) for c in xw) == 2 * h * sum(widths)
    assert (yw == 1).all()
    assert yw.size == 2 * sum(b.out_n * wl for b, wl in zip(B.bands(ys), widths))


@pytest.mark.parametrize("size", LARGE)
def test_flow_and_presmooth_plans_write_every_output_once(size):
    """One-level plans: each level's flow from the level before, and the
    presmooth (its Gaussian band is not a box: every weight from the run)."""
    w, h = size
    cfg = models.full_model()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    pairs = [((resample_band, a.width, b.width), (resample_band, a.height, b.height))
             for a, b in zip(specs, specs[1:]) if (a.width, a.height) != (b.width, b.height)]
    pairs = pairs[::7] + pairs[-2:]
    pairs.append(((gaussian_band, w, 1.5), (gaussian_band, h, 1.5)))
    for bx, by in pairs:
        _, xw, yw = emulate_levels(np.empty((2, by[1], bx[1]), F), (bx,), (by,), values=False)
        assert (xw[0] == 1).all() and (yw == 1).all(), (bx, by)
    assert B.x_plan((pairs[-1][0],))[B.HEAD + 2] == B.MODE_TAPS
    assert B.x_plan((pairs[0][0],))[B.HEAD + 2] == B.MODE_BOX


@pytest.mark.parametrize("size", SMALL + ODD)
def test_emulated_kernels_bitwise_the_plain_version(size):
    """Value by value: the emulated X and Y kernels give every level's
    frames bitwise as resample_plain, and the X intermediate every level's
    banded_plain along x; the flow and the presmooth in one-level plans."""
    w, h = size
    img = image((2, h, w), seed=w + h)
    sizes = frame_sizes(w, h) or ((max(1, w // 2), max(1, h // 2)),)
    xs, ys = pyramid_specs(w, h, sizes)
    widths = tuple(ow for ow, _ in sizes)
    got, xw, yw = emulate_levels(img, xs, ys)
    assert (yw == 1).all() and all((c == 1).all() for c in xw)
    x_out, _ = emulate_x(img.reshape(2 * h, w), B.x_plan(xs))
    cols, _ = B.x_cols(widths)
    for (ow, oh), lvl, c, band in zip(sizes, got, cols, B.bands(xs)):
        assert same_bits(lvl, resample_plain(T(img), ow, oh).numpy()), (ow, oh)
        along_x = x_out[:, c:c + ow].reshape(2, h, ow)
        assert same_bits(np.ascontiguousarray(along_x),
                         B.banded_plain(T(img), band, B.AXIS_X).numpy()), (ow, oh)
    for sigma in (0.5, 1.5, 8.0):
        spec_x, spec_y = (gaussian_band, w, sigma), (gaussian_band, h, sigma)
        (g,), _, _ = emulate_levels(img, (spec_x,), (spec_y,))
        want = B.banded_plain(B.banded_plain(T(img), gaussian_band(w, sigma), B.AXIS_X),
                              gaussian_band(h, sigma), B.AXIS_Y).numpy()
        assert same_bits(g, want), sigma
    up = image((2, max(1, h // 2), max(1, w // 2)), seed=3)
    (u,), _, _ = emulate_levels(up, ((resample_band, up.shape[2], w),),
                                ((resample_band, up.shape[1], h),))
    assert same_bits(u, resample_plain(T(up), w, h).numpy())


def test_box_taps_and_general_modes():
    """The resample's interior weights are all 1 (a box level reads only
    its head and tail); the Gaussian's are its taps at origin + o - first -
    j (a taps level), also where one interior weight is shared (3 taps);
    a band of neither form has no kernel and raises."""
    assert resample_band(3840, 22).is_box() and resample_band(22, 25).is_box()
    assert resample_band(5, 5).is_box() and not gaussian_band(37, 1.5).is_box()
    for in_n, out_n in ((3840, 22), (22, 25), (5, 5), (2160, 1944), (7, 3)):
        assert B.x_mode(resample_band(in_n, out_n))[0] == B.MODE_BOX
    mode, origin, taps = B.x_mode(gaussian_band(37, 1.5))
    assert mode == B.MODE_TAPS and origin == 4
    assert same_bits(taps.view(F), gaussian_kernel_taps(1.5))
    assert B.x_mode(gaussian_band(37, 0.5))[0] == B.MODE_TAPS
    rng = np.random.default_rng(0)
    odd = B.Band(first=np.array([0, 1, 1], np.int32), count=np.array([3, 3, 3], np.int32),
                 weights=rng.random((3, 3)).astype(F), norm=1.0)
    with pytest.raises(ValueError, match="Toeplitz"):
        B.x_mode(odd)
    with pytest.raises(ValueError, match="Toeplitz"):
        B.x_plan(((lambda n, _: odd, 3, 0),))


@pytest.mark.parametrize("in_n,out_n", [(3840, 22), (3840, 3456), (2160, 13), (584, 5),
                                        (3456, 3840)])
def test_runs_cover_each_level_once_costliest_first(in_n, out_n):
    """Each level's outputs in runs of RUN, dealt to the warps with the
    largest window first (the coarse levels' long chains start first)."""
    bx, by = resample_band(in_n, out_n), resample_band(in_n // 2 + 1, 7)
    runs = B.x_runs([bx, by])
    assert sorted((lvl, o0) for lvl, o0, _ in runs) == sorted(
        [(0, o) for o in range(0, out_n, B.RUN)] + [(1, o) for o in range(0, 7, B.RUN)])
    assert [c for _, _, c in runs] == sorted((c for _, _, c in runs), reverse=True)
    for lvl, o0, cmax in runs:
        band = (bx, by)[lvl]
        assert cmax == band.count[o0:o0 + B.RUN].max()


def x_dealing(groups, n_runs, resident, warps=32):
    """csrc/banded.cu's dealing of an X launch: tf_banded_x's grid (whole
    groups while every block has one, the groups left for the last turn in
    slices, one a block; no slices below one whole turn) and
    banded_x_kernel's items, each block's items
    grid-stride, each warp's runs from slice + warp * parts in steps of
    warps * parts. Returns {(group, run): times summed}."""
    whole = groups // resident * resident
    left = groups - whole
    parts = max(1, resident // left) if left and whole else 1
    items = whole + left * parts
    grid = min(resident, items)
    done = {}
    for block in range(grid):
        for it in range(block, items, grid):
            group = it if it < whole else whole + (it - whole) // parts
            slice_, step = (0, warps) if it < whole else ((it - whole) % parts, warps * parts)
            for warp in range(warps):
                for run in range(slice_ + warp * (step // warps), n_runs, step):
                    done[group, run] = done.get((group, run), 0) + 1
    return done, grid, items


@pytest.mark.parametrize("groups,n_runs,resident", [(540, 1097, 132), (540, 120, 132),
                                                    (486, 120, 132), (55, 14, 132),
                                                    (270, 1097, 132), (1, 3, 132),
                                                    (264, 50, 132), (7, 40, 264)])
def test_x_dealing_sums_every_group_and_run_once(groups, n_runs, resident):
    """Every run of every row group is summed once; no block takes more than
    one item beyond the whole turns (at 4K, 540 groups on 132 blocks: four
    whole groups and one slice of a group each, not five groups)."""
    done, grid, items = x_dealing(groups, n_runs, resident)
    assert done == {(g, r): 1 for g in range(groups) for r in range(n_runs)}
    assert grid <= resident and -(-items // grid) <= groups // resident + 1


def test_plan_table_is_cached_per_device():
    cpu = torch.device("cpu")
    specs = ((resample_band, 584, 5),)
    before = B.plan_table.cache_info()
    t = B.plan_table(B.AXIS_X, specs, (), 0, cpu)
    assert B.plan_table(B.AXIS_X, specs, (), 0, cpu) is t
    assert B.plan_table.cache_info().hits - before.hits >= 1
    assert np.array_equal(t.numpy(), B.x_plan(specs))
    y = B.plan_table(B.AXIS_Y, ((resample_band, 388, 4),), (5,), 2, cpu)
    assert np.array_equal(y.numpy(), B.y_plan(((resample_band, 388, 4),), (5,), 2))


def test_y_rows_keep_chains_short():
    """Fine levels give a thread YR rows; the coarsest, one a thread."""
    assert B.y_rows(resample_band(2160, 1944)) == B.YR
    assert B.y_rows(resample_band(2160, 13)) == 1
    assert B.y_rows(gaussian_band(2160, 1.5)) == min(B.YR, B.YCHAIN // 9)
    for out_n in (1944, 900, 163, 47, 13):
        band = resample_band(2160, out_n)
        rows = B.y_rows(band)
        assert 1 <= rows <= B.YR
        assert rows == 1 or rows * int(band.count.max()) <= B.YCHAIN


def test_y_blocks_coarse_levels_first():
    ys = tuple((resample_band, 2160, hl) for hl in (1944, 13, 500))
    blocks = B.y_blocks(B.bands(ys), (3456, 22, 900), 2)
    assert blocks[0, 0] == 1 and blocks[-1, 0] in (0, 2)
    assert blocks.shape[1] == 4 and blocks.dtype == np.int32


def test_y_output_offsets_past_32_bits():
    """A level's output offset is stored as two int32 halves, as y_plan
    writes them and the kernel reads them back."""
    for off in (0, 5, (1 << 31) + 7, 3 * 4 * (1 << 30), (1 << 40) + 123):
        lo, hi = np.int64(B._signed(off)), np.int64(B._signed(off >> 32))
        assert int((lo & 0xFFFFFFFF) | (hi << 32)) == off
    plan = B.y_plan(((resample_band, 8, 4), (resample_band, 8, 2)), (5, 3), 3)
    lv = plan[plan[2] + B.YL:plan[2] + 2 * B.YL].astype(np.int64)
    assert (lv[2] & 0xFFFFFFFF) | (lv[3] << 32) == 3 * 4 * 5


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


def resample_then(img, w, h):
    """The solve's per-level resample before the pyramid: the same size is
    the input itself."""
    return img if tuple(img.shape[-2:]) == (h, w) else resample_plain(img, w, h)


def solve_per_level(f0, f1, cfg, levels=None, uv=None, smoothed=False):
    """The coarse-to-fine loop with one resample call a level (the frames
    from the smoothed pair, the flow from the level before)."""
    h0, w0 = f0.shape
    frames = torch.stack([f0, f1]) if smoothed else smooth_pair(f0, f1, cfg)
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    levels = range(len(specs)) if levels is None else levels
    for spec in specs[levels.start:levels.stop]:
        cw, ch = spec.width, spec.height
        sc = LevelScalars.make(cw, ch, spec.hx, spec.hy, cfg.equation_alpha)
        frames_l = frames if spec.level == 0 else resample_then(frames, cw, ch)
        uv = (torch.zeros((2, ch, cw), dtype=torch.float32) if uv is None
              else resample_then(uv, cw, ch))
        uv = level_step(frames_l, uv, sc, cfg)
    return uv


CFG = FlowConfig(outer_iterations_count=2, inner_iterations_count=3)


@pytest.mark.parametrize("constancy", [DataConstancy.GREY, DataConstancy.GRADIENT])
def test_solve_bitwise_the_per_level_resample(constancy):
    cfg = FlowConfig(outer_iterations_count=2, inner_iterations_count=3,
                     data_constancy=constancy)
    f0, f1 = (T(f) for f in textured_pair(40, 28))
    got = solve(f0, f1, cfg).numpy()
    assert same_bits(got, solve_per_level(f0, f1, cfg).numpy())


@pytest.mark.parametrize("split", [1, 9, 17])
def test_solve_in_two_parts_bitwise_the_per_level_resample(split):
    """The hybrid's split: levels range(split) then range(split, n) on the
    smoothed pair."""
    f0, f1 = (T(f) for f in textured_pair(40, 28, seed=1))
    n = len(level_schedule(40, 28, CFG.warp_levels_count, CFG.warp_scale_factor))
    sm = smooth_pair(f0, f1, CFG)
    uv = solve(sm[0], sm[1], CFG, levels=range(split), smoothed=True)
    got = solve(sm[0], sm[1], CFG, levels=range(split, n), uv=uv, smoothed=True).numpy()
    want_uv = solve_per_level(sm[0], sm[1], CFG, levels=range(split), smoothed=True)
    assert same_bits(uv.numpy(), want_uv.numpy())
    assert same_bits(got, solve_per_level(f0, f1, CFG).numpy())
    assert same_bits(got, solve(f0, f1, CFG).numpy())


def test_solve_trace_has_a_level_for_each_and_the_pyramid_in_the_first():
    f0, f1 = (T(f) for f in textured_pair(40, 28, seed=2))
    trace = []
    solve(f0, f1, CFG, trace=trace)
    n = len(level_schedule(40, 28, CFG.warp_levels_count, CFG.warp_scale_factor))
    assert len(trace) == n and all(t[3] >= 0.0 for t in trace)


@pytest.mark.parametrize("size", LARGE)
def test_banded_launches_a_pair(size):
    """102 at 4K and 1080p, 92 at 584x388: two presmooth, two for the frame
    pyramid, two a level whose flow changes size."""
    w, h = size
    launches = R.banded_launches(w, h, models.full_model())
    assert len(launches) == {(3840, 2160): 102, (1920, 1080): 102, (584, 388): 92}[size]
    assert launches[2][3]["out_n"] == tuple(s[0] for s in frame_sizes(w, h, models.full_model()))
    assert R.banded_launches(w, h, models.full_model(), levels=range(0)) == launches[:2]
    specs = level_schedule(w, h, 50, 0.9)
    flows = sum((a.width, a.height) != (b.width, b.height) for a, b in zip(specs, specs[1:3]))
    assert len(R.banded_launches(w, h, models.full_model(), levels=range(3),
                                 smooth=False)) == 2 + 2 * flows

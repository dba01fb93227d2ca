"""The banded 1-D passes of the presmooth and the resample: each output a
sum over its own window of the input along x or y, in ascending input order,
scaled once (the CUDA kernels ``banded_x_kernel`` and ``banded_y_kernel``,
csrc/banded.cu, and their plain PyTorch version, ``banded_plain``):

    acc = 0;  for j in [0, count): acc = acc + x[first + j] * weight_j;  out = acc * norm

A ``Band`` is one axis's windows: for each output the first input it reads,
how many, their weights, and ``norm`` (the resample's out/in; 1 for the
Gaussian, where the product by 1 is exact). A band is named by a spec
``(build, n_in, arg)``, ``build(n_in, arg)`` giving it.

One launch covers one or more levels (``banded_levels``): an X launch sums
every level's band along x from one read of each input row into an
intermediate (rows, pitch), each level at its own column offset (a multiple
of 32 floats, as the pitch is); a Y launch sums each level's columns along y
into one buffer that holds every level's (..., h_l, w_l) output, contiguous.
The launch's plan (``x_plan``, ``y_plan``: its levels, its work items and
their windows) is built on the host once per shape and kept on the device,
one int32 tensor per device (``plan_table``, ``ops/device_cache.py``), so a
submission makes no upload from pageable memory once the shapes are warm:
one cache hit a launch.

An output's sum depends only on its own window, so a level's result is the
same, bit for bit, whatever other levels, rows or columns its launch
covers: ``banded_plain`` along x, then along y, level by level, is the
plain version of a launch pair. A launch pair may cover some output rows
of each level alone (``rows``): the Y plan then holds only their blocks,
and the X launch only the input rows their windows read (``band_span``),
in whole-size buffers. The wrappers that count launches are
``ops.resample`` and ``ops.gaussian``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from tpuflow_torch.ops.cuda_lib import launch
from tpuflow_torch.ops.device_cache import device_cached

AXIS_X, AXIS_Y = 0, 1    # along the last dim (columns), along the one before (rows)

# csrc/banded.cu's constants
RUN = 32         # banded_x: outputs a warp run, one a lane
YC = 256         # banded_y: columns a block covers (64 threads, 4 columns each)
YR = 4           # banded_y: most output rows a thread owns
YCHAIN = 64      # banded_y: a thread's rows at a level sum windows of about this many rows
HEAD, XL, YL, YB = 4, 8, 8, 12  # ints of a plan's header, of an X and a Y level, of a Y block
MODE_BOX, MODE_TAPS = 1, 2
MAX_TAPS = 1024  # the longest taps of a MODE_TAPS level (an X launch keeps them in shared memory)


def pad_line(n: int) -> int:
    """n rounded up to a multiple of RUN floats: a warp run's 128-byte store
    fills whole lines of the intermediate."""
    return -(-n // RUN) * RUN


def f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


@dataclasses.dataclass(frozen=True, eq=False)
class Band:
    """One axis's windows: ``first`` and ``count`` (out,) int32, ``weights``
    (out, width) float32 (zero beyond each output's count; width is the
    largest count), and ``norm``, a float32 value."""
    first: np.ndarray
    count: np.ndarray
    weights: np.ndarray
    norm: float

    def __post_init__(self):
        end = self.first + self.count
        # a block's or a run's outputs read one contiguous span of the input
        if (np.diff(self.first) < 0).any() or (np.diff(end) < 0).any():
            raise ValueError("a band's windows must not move backwards")

    @property
    def out_n(self) -> int:
        return len(self.first)

    def packed(self) -> np.ndarray:
        """The Y kernel's table: int32 (out, 2 + width), rows [first, count,
        the weights' float32 bits]."""
        t = np.empty((self.out_n, 2 + self.weights.shape[1]), dtype=np.int32)
        t[:, 0] = self.first
        t[:, 1] = self.count
        t[:, 2:] = self.weights.view(np.int32)
        return t

    def is_box(self) -> bool:
        """Whether every window's weights at j = 1 .. count - 2 are 1 (the
        resample's; true where no window has an interior)."""
        j = np.arange(self.weights.shape[1])[None, :]
        inner = (j >= 1) & (j < self.count[:, None] - 1)
        return bool((self.weights[inner] == np.float32(1.0)).all())


@functools.lru_cache(maxsize=256)
def bands(specs: tuple) -> tuple:
    """The bands of a tuple of specs ``(build, n_in, arg)``."""
    return tuple(build(n_in, arg) for build, n_in, arg in specs)


@functools.lru_cache(maxsize=256)
def x_cols(widths: tuple) -> tuple:
    """(column offsets, pitch) of an X launch's intermediate for levels of
    ``widths`` outputs: each level at a multiple of RUN floats (128 bytes),
    the pitch their sum."""
    cols = np.concatenate([[0], np.cumsum([pad_line(w) for w in widths])])
    return tuple(int(c) for c in cols[:-1]), int(cols[-1])


def toeplitz_taps(band: Band) -> Optional[tuple]:
    """(origin, taps) such that weight j of output o is ``taps[origin + o -
    first_o - j]`` for every term of every window (the Gaussian's, whose
    windows are its taps truncated at the edges), or None (MAX_TAPS)."""
    o = np.arange(band.out_n)[:, None]
    j = np.arange(band.weights.shape[1])[None, :]
    live = j < band.count[:, None]
    rel = (o - band.first[:, None] - j)[live]
    if not rel.size:
        return None
    origin = -int(rel.min())
    if int(rel.max()) + origin + 1 > MAX_TAPS:
        return None
    taps = np.zeros(int(rel.max()) + origin + 1, np.int32)
    bits = band.weights.view(np.int32)[live]
    taps[rel + origin] = bits
    if not (taps[rel + origin] == bits).all():
        return None
    return origin, taps


def x_mode(band: Band) -> tuple:
    """(mode, origin, taps) of a band in the kernels: MODE_BOX where every
    interior weight is 1 (or no window has an interior), else MODE_TAPS
    where its weights are a Toeplitz taps vector; raises for any other
    band."""
    if band.is_box():
        return MODE_BOX, 0, None
    toeplitz = toeplitz_taps(band)
    if toeplitz is None:
        raise ValueError("a band's interior weights must all be 1 (a box) or its weights "
                         "a Toeplitz taps vector")
    return MODE_TAPS, toeplitz[0], toeplitz[1]


def x_runs(band_list: list) -> list:
    """The X launch's warp runs as (level, first output, largest count), in
    the order the kernel deals them to its warps: the largest count first,
    each level's in ascending order among equals."""
    runs = [(lvl, o0, int(b.count[o0:o0 + RUN].max()))
            for lvl, b in enumerate(band_list) for o0 in range(0, b.out_n, RUN)]
    return sorted(runs, key=lambda r: -r[2])


@functools.lru_cache(maxsize=256)
def x_plan(specs: tuple) -> np.ndarray:
    """banded_x_kernel's plan (csrc/banded.cu) for the bands of ``specs``:
    [levels, runs, meta ints, 0]; the meta region each block copies to
    shared memory: an XL-int entry a level [column offset, out_n, mode, norm
    bits, taps offset in the meta region (MODE_TAPS; else 0), origin, 0,
    0], an int4 a run [level, first output, largest count, data offset],
    every MODE_TAPS level's taps; then each run's data: first and count a
    lane (count 0 past the level's end), and for MODE_BOX the head and tail
    weights."""
    band_list = bands(specs)
    cols, _ = x_cols(tuple(b.out_n for b in band_list))
    runs = x_runs(band_list)
    levels = np.zeros((len(band_list), XL), np.int32)
    taps, at_taps = [], levels.size + 4 * len(runs)
    for lvl, b in enumerate(band_list):
        mode, origin, tv = x_mode(b)
        value = 0
        if mode == MODE_TAPS:
            value = at_taps
            taps.append(tv)
            at_taps += tv.size
        levels[lvl, :6] = (cols[lvl], b.out_n, mode, f32_bits(b.norm), value, origin)
    meta_ints = at_taps
    table = np.zeros((len(runs), 4), np.int32)
    data, at = [], HEAD + meta_ints
    for i, (lvl, o0, cmax) in enumerate(runs):
        b = band_list[lvl]
        n = min(RUN, b.out_n - o0)
        first = np.zeros(RUN, np.int32)
        count = np.zeros(RUN, np.int32)
        first[:n], count[:n] = b.first[o0:o0 + n], b.count[o0:o0 + n]
        w = b.weights.view(np.int32)[o0:o0 + n]
        chunk = [first, count]
        if levels[lvl, 2] == MODE_BOX:
            head_w, tail_w = np.zeros(RUN, np.int32), np.zeros(RUN, np.int32)
            head_w[:n] = w[:, 0]
            tail_w[:n] = w[np.arange(n), count[:n] - 1]
            chunk += [head_w, tail_w]
        chunk = np.concatenate(chunk)
        table[i] = (lvl, o0, cmax, at)
        data.append(chunk)
        at += chunk.size
    head = np.array([len(band_list), len(runs), meta_ints, 0], np.int32)
    return np.concatenate([head, levels.ravel(), table.ravel(), *taps, *data]).astype(np.int32)


def y_rows(band: Band) -> int:
    """The output rows a banded_y thread owns at a level: up to YR, as many
    as keep their windows' rows within about YCHAIN, at least 1."""
    return max(1, min(YR, YCHAIN // max(1, int(band.count.max()))))


def band_span(band: Band, lo: int, hi: int) -> tuple:
    """[first, end) of the input rows that the windows of outputs lo .. hi - 1
    read (windows never move backwards)."""
    return int(band.first[lo]), int(band.first[hi - 1] + band.count[hi - 1])


def output_rows(band_list: list, rows) -> list:
    """Each level's output rows (lo, hi): ``rows`` (one a level), or every
    row where it is None."""
    return [(0, b.out_n) for b in band_list] if rows is None else list(rows)


def y_blocks(band_list: list, widths: tuple, planes: int, rows=None) -> np.ndarray:
    """The Y launch's blocks as int32 (blocks, 4) [level, plane, first output
    row, first column], every level's (plane, rows, columns) tiles over its
    output rows (``rows``: (lo, hi) a level; None is every row): the levels
    whose blocks walk the most input rows first."""
    spans = output_rows(band_list, rows)

    def span(lvl):
        b, r = band_list[lvl], y_rows(band_list[lvl])
        lo, hi = spans[lvl]
        ends = b.first + b.count
        o0 = np.arange(lo, hi, r)
        return int((ends[np.minimum(o0 + r, hi) - 1] - b.first[o0]).max())

    out = []
    for lvl in sorted(range(len(band_list)), key=lambda lv: -span(lv)):
        b = band_list[lvl]
        p, o, c = np.meshgrid(np.arange(planes), np.arange(*spans[lvl], y_rows(b)),
                              np.arange(0, widths[lvl], YC), indexing="ij")
        out.append(np.stack([np.full(p.size, lvl), p.ravel(), o.ravel(), c.ravel()], 1))
    return np.concatenate(out).astype(np.int32)


@functools.lru_cache(maxsize=256)
def y_layout(specs: tuple, widths: tuple, planes: int) -> tuple:
    """Each level's offset in the Y launch's output (floats), and the total."""
    sizes = [planes * b.out_n * w for b, w in zip(bands(specs), widths)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return tuple(int(o) for o in offs[:-1]), int(offs[-1])


def _signed(v: int) -> int:
    """The int32 holding the low 32 bits of v."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


@functools.lru_cache(maxsize=256)
def y_plan(specs: tuple, widths: tuple, planes: int, rows=None) -> np.ndarray:
    """banded_y_kernel's plan (csrc/banded.cu) for the bands of ``specs``,
    level l over ``widths[l]`` columns of the intermediate at their X
    column offsets (``x_cols``), over its output rows ``rows[l]`` ((lo,
    hi); None is every row) of a whole-size output: [levels, blocks,
    levels' offset, blocks' offset], a YL-int entry a level [out_n, norm
    bits, output offset low, high, mode, the taps' offset in the plan
    (MODE_TAPS; else 0), origin, the taps' length], a YB-int entry a block
    (``y_blocks``: level, plane, first output row, first column; then its
    width, its column of the intermediate, the input rows its windows span
    [first, end), the plan offset of its first row's table row, the table's
    stride, its output rows, 0), each band's packed table, then every
    MODE_TAPS level's taps."""
    band_list = bands(specs)
    cols, _ = x_cols(widths)
    offs, _ = y_layout(specs, widths, planes)
    blocks = y_blocks(band_list, widths, planes, rows)
    spans = output_rows(band_list, rows)
    levels = np.zeros((len(band_list), YL), np.int32)
    at = HEAD + levels.size + YB * len(blocks)
    tables, tab_at, taps = [], [], []
    for b in band_list:
        packed = b.packed()
        tables.append(packed.ravel())
        tab_at.append(at)
        at += packed.size
    for lvl, b in enumerate(band_list):
        mode, origin, tv = x_mode(b)
        value = 0
        if mode == MODE_TAPS:
            value = at
            taps.append(tv)
            at += tv.size
        levels[lvl] = (b.out_n, f32_bits(b.norm), _signed(offs[lvl]),
                       _signed(offs[lvl] >> 32), mode, value, origin,
                       0 if tv is None else tv.size)
    entries = np.zeros((len(blocks), YB), np.int64)
    for lvl, b in enumerate(band_list):
        mine = blocks[:, 0] == lvl
        o0 = blocks[mine, 2].astype(np.int64)
        nr = np.minimum(y_rows(b), spans[lvl][1] - o0)
        stride = 2 + b.weights.shape[1]
        entries[mine, 4] = widths[lvl]
        entries[mine, 5] = cols[lvl] + blocks[mine, 3]
        entries[mine, 6] = b.first[o0]
        entries[mine, 7] = b.first[o0 + nr - 1] + b.count[o0 + nr - 1]
        entries[mine, 8] = tab_at[lvl] + o0 * stride
        entries[mine, 9] = stride
        entries[mine, 10] = nr
    entries[:, :4] = blocks
    if entries.max() >= 1 << 31:
        raise ValueError("a Y plan's offsets must fit in int32")
    head = np.array([len(band_list), len(blocks), HEAD, HEAD + levels.size], np.int32)
    return np.concatenate([head, levels.ravel(), entries.astype(np.int32).ravel(), *tables,
                           *taps]).astype(np.int32)


@functools.lru_cache(maxsize=256)
def x_launch(specs: tuple) -> tuple:
    """(widths, pitch, runs, meta ints) of an X launch over the bands of
    ``specs``: what ``banded_x`` passes beside the plan, found once."""
    widths = tuple(b.out_n for b in bands(specs))
    plan = x_plan(specs)
    return widths, x_cols(widths)[1], int(plan[1]), int(plan[2])


@functools.lru_cache(maxsize=256)
def y_launch(specs: tuple, widths: tuple, planes: int, rows=None) -> tuple:
    """(each level's (offset, out_n), total, levels' offset, blocks' offset,
    blocks) of a Y launch: what ``banded_y`` needs beside the plan, found
    once."""
    offs, total = y_layout(specs, widths, planes)
    plan = y_plan(specs, widths, planes, rows)
    levels = tuple((o, b.out_n) for o, b in zip(offs, bands(specs)))
    return levels, total, int(plan[2]), int(plan[3]), int(plan[1])


@device_cached(maxsize=1024)
def plan_table(axis: int, specs: tuple, widths: tuple, planes: int,
               device: torch.device, rows=None) -> torch.Tensor:
    """The launch's plan (``x_plan`` or ``y_plan``) on ``device``; the X
    plan's key has ``widths`` () and ``planes`` 0. ``rows`` are a Y plan's
    output rows (``y_plan``); a call without them keys every row."""
    plan = x_plan(specs) if axis == AXIS_X else y_plan(specs, widths, planes, rows)
    return torch.from_numpy(plan).to(device)


def banded_x(x: torch.Tensor, specs: tuple, rows=None) -> torch.Tensor:
    """One launch of banded_x_kernel over a contiguous float32 CUDA tensor x
    (..., h, w): every band of ``specs`` along x, over input rows ``rows``
    = (k0, k1) of each (h, w) plane (None: every row). Returns the
    intermediate (planes * h, pitch), level l's outputs in the columns from
    ``x_cols(widths)[0][l]`` on; a row outside ``rows`` is not written. The
    caller counts the launch."""
    h, w = x.shape[-2:]
    _, pitch, n_runs, meta_ints = x_launch(specs)
    rows_all = x.numel() // w
    table = plan_table(AXIS_X, specs, (), 0, x.device)
    out = torch.empty((rows_all, pitch), dtype=torch.float32, device=x.device)
    n, band, plane_rows, row0 = x_rows(rows_all, h, rows)
    launch("tf_banded_x", x.data_ptr(), out.data_ptr(), table.data_ptr(), n, w, w, pitch,
           n_runs, meta_ints, band, plane_rows, row0)
    return out


def x_rows(rows_all: int, h: int, rows=None) -> tuple:
    """(logical rows, band, plane_rows, row0) of an X launch over input
    rows ``rows`` = (k0, k1) of each h-row plane of ``rows_all`` rows (None:
    every row): the kernel's logical row g is row (g // band) plane_rows +
    row0 + g % band of the input and the intermediate."""
    k0, k1 = (0, h) if rows is None else rows
    if (k0, k1) == (0, h):
        return rows_all, rows_all, rows_all, 0
    return rows_all // h * (k1 - k0), k1 - k0, h, k0


def x_views(tmp: torch.Tensor, lead: tuple, h: int, widths: tuple) -> list:
    """Level l's X outputs (*lead, h, widths[l]) as views of the
    intermediate ``tmp`` that ``banded_x`` returned."""
    cols, pitch = x_cols(widths)
    grid = tmp.view(*lead, h, pitch)
    return [grid[..., c:c + w] for c, w in zip(cols, widths)]


def banded_y(tmp: torch.Tensor, lead: tuple, h: int, specs: tuple,
             widths: tuple, rows=None, out: Optional[torch.Tensor] = None) -> list:
    """One launch of banded_y_kernel over ``banded_x``'s intermediate (the
    planes ``lead`` of h rows, level l at ``widths[l]`` columns): every band
    of ``specs`` along y, over output rows ``rows[l]`` of level l (None:
    every row). Returns each level's (*lead, h_l, w_l) as contiguous views
    of one buffer, ``out`` where given (a contiguous float32 buffer of all
    of them); a row outside ``rows`` is not written. The caller counts the
    launch."""
    planes = math.prod(lead)
    levels, total, levels_off, blocks_off, blocks = y_launch(specs, widths, planes, rows)
    table = plan_table(AXIS_Y, specs, widths, planes, tmp.device,
                       *(() if rows is None else (rows,)))
    if out is None:
        out = torch.empty(total, dtype=torch.float32, device=tmp.device)
    elif out.numel() != total or not out.is_contiguous() or out.device != tmp.device:
        raise ValueError(f"out: a contiguous buffer of {total} floats on {tmp.device}, got "
                         f"{tuple(out.shape)} on {out.device}")
    out = out.view(-1)
    launch("tf_banded_y", tmp.data_ptr(), out.data_ptr(), table.data_ptr(), levels_off,
           blocks_off, blocks, h, tmp.shape[1])
    return [out[o:o + planes * n * w].view(*lead, n, w) for (o, n), w in zip(levels, widths)]


def banded_levels(x: torch.Tensor, xs: tuple, ys: tuple, rows=None,
                  out: Optional[torch.Tensor] = None) -> list:
    """Level l of a contiguous float32 CUDA tensor x (..., h, w): band
    ``xs[l]`` along x, then ``ys[l]`` along y, every level in one X launch
    and one Y launch; returns each level's (..., h_l, w_l), contiguous views
    of one buffer (``out`` where given). With ``rows`` (one level): only
    its output rows (lo, hi), the X launch over the input rows their
    windows read. The intermediate goes back to the allocator once the Y
    launch is queued. The caller counts the two launches."""
    h = x.shape[-2]
    lead = tuple(x.shape[:-2])
    span = None
    if rows is not None:
        if len(ys) != 1:
            raise ValueError("output rows are given for a launch of one level")
        span = band_span(bands(ys)[0], *rows)
        rows = (tuple(rows),)
    tmp = banded_x(x, xs, span)
    out = banded_y(tmp, lead, h, ys, x_launch(xs)[0], rows, out)
    del tmp
    return out


def banded_plain(x: torch.Tensor, band: Band, axis: int) -> torch.Tensor:
    """The kernels' sum by gathers, on any device: the terms below each
    output's count only, added in ascending input order (a zero weight times
    a NaN would not be zero)."""
    if axis == AXIS_Y:
        return banded_plain(x.transpose(-1, -2), band, AXIS_X).transpose(-1, -2).contiguous()
    dev = x.device
    count = torch.from_numpy(band.count).to(dev)
    weights = torch.from_numpy(band.weights).to(dev)
    width = weights.shape[1]
    idx = torch.from_numpy(band.first).to(dev, torch.int64)[:, None] + torch.arange(width,
                                                                                     device=dev)
    idx = idx.clamp_(max=x.shape[-1] - 1)
    terms = x.index_select(-1, idx.reshape(-1)).unflatten(-1, idx.shape) * weights
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float32, device=dev)
    for j in range(width):
        acc = torch.where(j < count, acc + terms[..., j], acc)
    return acc * torch.tensor(band.norm, dtype=torch.float32, device=dev)

"""The log-derivative motion tensor's shared-memory tile, emulated in numpy
(csrc/level.cu: ``level_tensor_log_kernel``), against the plain version the
CPU runs (``ops/solver_ops.py::derivative_tensor(..., log=True)``) and the
JAX package's XLA computation (``tpuflow.ops.solver_ops._motion_tensor``).

The emulation follows the kernel index for index: each 32 x 8 block owns a
32 x LT_TH tile (LT_TH read from the source) and stages both frames over it
plus a 2-pixel ring, each entry at its own image
coordinate where that lies in the image (NaN elsewhere, so a read of an
unstaged entry shows); applies log1p in place; forms g = (gx, gy, gt) over
the tile plus a 1-pixel ring, entry q at image coordinate clamp(q), from the
log tile at refl(clamp(q) +- 1); and forms J from the g tile. It asserts that
every coordinate staged or read lies in the frame and in the staged ring.

Shapes: the edge shapes of the prologue's tiles, which the log tile shares
(2 x 2, 5 x 3, 22 x 13, 33 x 9, 65 x 17, 97 x 31, as w x h), and a few more.
Bounds: bitwise against the plain version (the same float32 operations in
the same order; log1p is the same function of the same float); against JAX
max abs <= 1e-6 x max |J|, since XLA on the CPU evaluates log1p and some
products its own way.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.ops.solver_ops import _motion_tensor

from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.cuda_lib import CSRC
from tpuflow_torch.ops.solver_ops import derivative_tensor, first_derivs
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import LevelScalars

torch.set_num_threads(2)

BX = 32   # the kernel's tile columns, one thread each (csrc/level.cu: BX)
# the kernel's tile rows; a shorter tile too, for more tile edges
LT_TH = int(re.search(r"constexpr int LT_TH = (\d+);", (CSRC / "level.cu").read_text()).group(1))
TILE_ROWS = sorted({LT_TH, 8})
# (w, h): the prologue's tile-edge shapes, then a multi-block level with
# one-column and one-row remainders, the widest and tallest of 2, and the
# edges of the kernel's 32 x 16 tile (one row short, one tile, one row more,
# two tiles and one more)
SHAPES = [(2, 2), (5, 3), (22, 13), (33, 9), (65, 17), (97, 31), (3, 5), (2, 40), (70, 2),
          (129, 25), (31, 15), (33, 16), (32, 17), (2, 32), (65, 33)]


def refl(i, n):
    return np.where(i < 0, -i, np.where(i >= n, 2 * n - i - 2, i))


def frames(w, h, seed):
    rng = np.random.default_rng(seed)
    f0 = (rng.random((h, w)) * 255.0).astype(np.float32)
    f1 = (rng.random((h, w)) * 255.0).astype(np.float32)
    return f0, f1


def log_tensor_emulated(f0, f1, sc, th=LT_TH, stats=None):
    """One launch of level_tensor_log_kernel with th-row tiles, block by
    block."""
    h, w = f0.shape
    frames_ = np.stack([f0, f1])
    J = np.full((5, h, w), np.nan, np.float32)
    rr, cc = np.meshgrid(np.arange(th + 4), np.arange(BX + 4), indexing="ij")
    gr, gc = np.meshgrid(np.arange(th + 2), np.arange(BX + 2), indexing="ij")
    logs = 0
    for y0 in range(0, h, th):
        for x0 in range(0, w, BX):
            # 1. stage both frames at image coordinates, 2. log1p in place
            gy, gx = y0 - 2 + rr, x0 - 2 + cc
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            ls = np.full((2, th + 4, BX + 4), np.nan, np.float32)
            ls[:, inside] = frames_[:, gy[inside], gx[inside]]
            ls[:, inside] = torch.log1p(torch.from_numpy(ls[:, inside])).numpy()
            logs += 2 * int(inside.sum())
            # 3. g over the tile and a 1-pixel ring, clamp then reflect
            qy, qx = y0 - 1 + gr, x0 - 1 + gc
            used = (qy <= h) & (qx <= w)
            py, px = np.clip(qy, 0, h - 1), np.clip(qx, 0, w - 1)
            cy, cx = py - y0 + 2, px - x0 + 2
            xp, xm = refl(px + 1, w) - x0 + 2, refl(px - 1, w) - x0 + 2
            yp, ym = refl(py + 1, h) - y0 + 2, refl(py - 1, h) - y0 + 2
            for r_, c_ in ((cy, xp), (cy, xm), (yp, cx), (ym, cx), (cy, cx)):
                r_, c_ = r_[used], c_[used]
                assert (r_ >= 0).all() and (r_ < th + 4).all()
                assert (c_ >= 0).all() and (c_ < BX + 4).all()
                assert inside[r_, c_].all(), "a g entry reads an unstaged coordinate"
            gs = np.full((3, th + 2, BX + 2), np.nan, np.float32)
            with np.errstate(invalid="ignore"):
                gs[0] = (ls[0][cy, xp] - ls[0][cy, xm] + ls[1][cy, xp] - ls[1][cy, xm]) / sc.div4hx
                gs[1] = (ls[0][yp, cx] - ls[0][ym, cx] + ls[1][yp, cx] - ls[1][ym, cx]) / sc.div4hy
                gs[2] = ls[1][cy, cx] - ls[0][cy, cx]
            gs[:, ~used] = np.nan
            # 4. J of the tile's pixels from the g tile's cross
            ty1, tx1 = min(th, h - y0), min(BX, w - x0)
            t = np.s_[:ty1, :tx1]
            g_xp = gs[:, 1:th + 1, 2:BX + 2][(slice(None),) + t]
            g_xm = gs[:, 1:th + 1, 0:BX][(slice(None),) + t]
            g_yp = gs[:, 2:th + 2, 1:BX + 1][(slice(None),) + t]
            g_ym = gs[:, 0:th, 1:BX + 1][(slice(None),) + t]
            fxx = (g_xp[0] - g_xm[0]) * sc.hx_1
            fxy = (g_yp[0] - g_ym[0]) * sc.hy_1
            fyy = (g_yp[1] - g_ym[1]) * sc.hy_1
            fxt = (g_xp[2] - g_xm[2]) * sc.hx_1
            fyt = (g_yp[2] - g_ym[2]) * sc.hy_1
            J[:, y0:y0 + ty1, x0:x0 + tx1] = np.stack([
                fxx * fxx + fxy * fxy, fxy * fxy + fyy * fyy, fxx * fxy + fxy * fyy,
                fxx * fxt + fxy * fyt, fxy * fxt + fyy * fyt])
    if stats is not None:
        stats["log1p_per_pixel"] = logs / (h * w)
    return J


def plain(f0, f1, sc):
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    return derivative_tensor(t0, t1, first_derivs(t0, t1, sc.div4hx, sc.div4hy), sc,
                             log=True).numpy()


@pytest.mark.parametrize("th", TILE_ROWS)
@pytest.mark.parametrize("w,h", SHAPES)
def test_tile_emulation_is_the_plain_tensor_bitwise(w, h, th):
    f0, f1 = frames(w, h, seed=w * 1000 + h)
    sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
    got = log_tensor_emulated(f0, f1, sc, th)
    assert np.isfinite(got).all()
    assert got.tobytes() == plain(f0, f1, sc).tobytes()


@pytest.mark.parametrize("w,h", SHAPES)
def test_tile_emulation_matches_jax(w, h):
    f0, f1 = frames(w, h, seed=w + h)
    hx, hy = 1.3, 1.2
    got = log_tensor_emulated(f0, f1, LevelScalars.make(w, h, hx, hy, 35.0))
    want = np.stack([np.asarray(a) for a in _motion_tensor(
        jnp.asarray(f0), jnp.asarray(f1), hx, hy, JDataConstancy.LOG_DERIVATIVES)])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_log1p_once_per_staged_value():
    """2 x (LT_TH + 4) x 36 / (32 LT_TH) log1p a pixel on whole tiles (2.81
    at 16 rows, 3.375 at 8), where the kernel it replaced evaluated 32."""
    f0, f1 = frames(BX * 4, LT_TH * 4, seed=3)
    stats = {}
    log_tensor_emulated(f0, f1, LevelScalars.make(BX * 4, LT_TH * 4, 1.0, 1.0, 35.0),
                        stats=stats)
    interior = 2 * (BX + 4) * (LT_TH + 4) / (BX * LT_TH)
    assert stats["log1p_per_pixel"] < interior <= 3.375


def test_no_level_narrower_than_two():
    """The pyramid never makes a level with w or h below 2: a 1-wide or
    1-tall frame has no levels at all, and the tile's clamp-then-reflect
    addressing needs 2 (reflecting -1 in a 1-wide image leaves it)."""
    for n in (1, 2, 3, 4, 5, 7, 13, 40):
        assert level_schedule(1, n, 8, 0.7) == [] and level_schedule(n, 1, 8, 0.7) == []
    for w in range(2, 30):
        for h in range(2, 30):
            for s in level_schedule(w, h, 50, 0.7):
                assert min(s.width, s.height) >= 2


def test_wrapper_on_cpu_is_the_plain_tensor():
    f0, f1 = frames(33, 9, seed=1)
    sc = LevelScalars.make(33, 9, 1.0, 1.0, 35.0)
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    fxyz = first_derivs(t0, t1, sc.div4hx, sc.div4hy)
    assert torch.equal(L.level_tensor(t0, t1, fxyz, sc, True),
                       L.level_tensor_plain(t0, t1, fxyz, sc, True))

"""The inner loop of one outer iteration (``ops/level.py::jacobi_sweeps``)
against the JAX package, and the k-sweep kernel's tile geometry emulated.

  * ``jacobi_sweeps_plain`` against a loop of the JAX package's
    ``sweep_update_T`` with its reflect shifts (``tpuflow/ops/solver_ops.py
    ::_shifts``), at inner 0..7 and the edge shapes of the kernel's tiles;
  * ``relax`` (one ``jacobi_sweeps`` call per outer) against the TPU's
    ``_relax_bucket_full`` in Pallas interpret mode at 3 x 5;
  * a numpy emulation of csrc/level.cu's ``jacobi_sweeps_kernel``: each
    block's region (its tile plus a k-pixel ring, clipped to the image),
    the sweeps over the trapezoid that shrinks only at sides that are not
    image edges, the mirror neighbours inside the region, and only the
    tile written. Values the kernel never loads, and a sweep's output
    buffer before it is written, are NaN, so a read of either shows. It
    must equal the plain loop bit for bit, with tiles smaller than the
    level, as the card's kernel equals the chained one-sweep launches.

Tolerance against JAX: max abs 1e-6. Both sides round every operation as
float32 in the same association, so the difference is XLA's CPU code
against PyTorch's; the emulation and the plain loop are both elementwise
float32 and must agree exactly.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops.solver_ops import _shifts
from tpuflow.ops.sweep_core import sweep_update_T

from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.cuda_lib import CSRC

torch.set_num_threads(2)

SHAPES = [(2, 2), (5, 3), (13, 22), (33, 9), (97, 31)]   # (h, w)
INNERS = [0, 1, 2, 5, 7]


def sweep_inputs(h, w, seed=0):
    """Seeded T, uv and 9 hoists of the magnitudes a level holds: positive
    smoothness weights, the diagonal dnu, dnv above their sum."""
    rng = np.random.default_rng(seed)
    uv = (rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)
    T = (uv + rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)
    pw = rng.random((4, h, w), np.float32) * 30.0
    a = (rng.standard_normal((3, h, w)) * 5.0).astype(np.float32)
    dn = (pw.sum(0) + 1.0 + rng.random((2, h, w)) * 20.0).astype(np.float32)
    hoist = np.concatenate([pw, a, dn]).astype(np.float32)
    return T, uv, hoist


def jax_sweeps(T, uv, hoist, inner):
    """``inner`` sweeps of the JAX package's T-form update."""
    tu, tv = jnp.asarray(T[0]), jnp.asarray(T[1])
    u_c, v_c = jnp.asarray(uv[0]), jnp.asarray(uv[1])
    hs = [jnp.asarray(p) for p in hoist]
    for _ in range(inner):
        _, tu_xp, tu_xm, tu_yp, tu_ym = _shifts(tu)
        _, tv_xp, tv_xm, tv_yp, tv_ym = _shifts(tv)
        new_du, new_dv = sweep_update_T((tu_xp, tu_xm, tu_yp, tu_ym),
                                        (tv_xp, tv_xm, tv_yp, tv_ym), u_c, v_c, tv - v_c,
                                        tuple(hs[:4]), *hs[4:])
        tu, tv = u_c + new_du, v_c + new_dv
    return np.stack([np.asarray(tu), np.asarray(tv)])


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_plain_sweeps_match_jax(h, w, inner):
    T, uv, hoist = sweep_inputs(h, w)
    got = L.jacobi_sweeps_plain(torch.from_numpy(T), torch.from_numpy(uv),
                                torch.from_numpy(hoist), inner).numpy()
    want = jax_sweeps(T, uv, hoist, inner)
    assert got.shape == (2, h, w) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6


def test_wrapper_on_cpu_is_the_plain_loop():
    T, uv, hoist = (torch.from_numpy(a) for a in sweep_inputs(13, 22))
    for inner in (0, 3, L.KMAX + 2):
        got = L.jacobi_sweeps(T, uv, hoist, inner)
        assert torch.equal(got, L.jacobi_sweeps_plain(T, uv, hoist, inner))
        assert torch.equal(got, L.jacobi_sweep_chain(T, uv, hoist, inner))
    assert L.jacobi_sweeps(T, uv, hoist, 0) is T
    with pytest.raises(ValueError, match="inner"):
        L.jacobi_sweeps(T, uv, hoist, -1)
    with pytest.raises(ValueError, match="hoist"):
        L.jacobi_sweeps(T, uv, hoist[:8].contiguous(), 1)


# ---------------------------------------------------------------------------
# relax with jacobi_sweeps against _relax_bucket_full (interpret mode)
# ---------------------------------------------------------------------------


def test_relax_matches_relax_bucket_full_at_3x5():
    from test_torch_level import RCH, RCW, cfgs, mean_epe, run_relax

    jcfg, tcfg = cfgs(outer_iterations_count=3, inner_iterations_count=5)
    got, wdu, wdv = run_relax("full", jcfg, tcfg)
    assert mean_epe(got, wdu, wdv, RCH, RCW) <= 1e-3


def test_relax_calls_the_sweeps_once_per_outer():
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.solver.level import KERNEL_STEPS, LevelScalars, relax

    calls = []

    def sweeps(T, uv, hoist, inner):
        calls.append(inner)
        return L.jacobi_sweeps(T, uv, hoist, inner)

    T, uv, _ = sweep_inputs(13, 22)
    uv = torch.from_numpy(uv)
    fxyz = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 13, 22))
                            .astype(np.float32))
    cfg = FlowConfig(outer_iterations_count=4, inner_iterations_count=5)
    sc = LevelScalars.make(22, 13, 1.0, 1.0, cfg.equation_alpha)
    got = relax(fxyz, uv, sc, cfg, _steps=KERNEL_STEPS._replace(jacobi_sweeps=sweeps))
    assert calls == [5] * 4
    assert torch.equal(got, relax(fxyz, uv, sc, cfg))


# ---------------------------------------------------------------------------
# The kernel's tile geometry, emulated in numpy
# ---------------------------------------------------------------------------


def sweep_np(tu_n, tv_n, tv_c, c):
    """tf_body::sweep_vals in numpy float32: tu_n, tv_n are (xp, xm, yp, ym);
    c the 11 values u, v, pw_xp, pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv."""
    u, v, pw_xp, pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv = c
    sum_u = (pw_xp * (tu_n[0] - u) + pw_xm * (tu_n[1] - u) + pw_yp * (tu_n[2] - u)
             + pw_ym * (tu_n[3] - u))
    sum_v = (pw_xp * (tv_n[0] - v) + pw_xm * (tv_n[1] - v) + pw_yp * (tv_n[2] - v)
             + pw_ym * (tv_n[3] - v))
    dv_c = tv_c - v
    new_du = (-a13 - a12 * dv_c + sum_u) / dnu
    new_dv = (-a23 - a12 * new_du + sum_v) / dnv
    return u + new_du, v + new_dv


def ksweep_emulated(T, uv, hoist, k, rw, rh):
    """One jacobi_sweeps_kernel<k> launch with a region of rw x rh pixels,
    index for index as csrc/level.cu writes it."""
    _, h, w = T.shape
    consts = np.concatenate([uv, hoist])
    out = np.full_like(T, np.nan)
    tw, th = rw - 2 * k, rh - 2 * k
    rr, cc = np.meshgrid(np.arange(rh), np.arange(rw), indexing="ij")
    for by in range(-(-h // th)):
        for bx in range(-(-w // tw)):
            rx0, ry0 = bx * tw - k, by * th - k
            gy, gx = ry0 + rr, rx0 + cc
            shrink_l, shrink_r = rx0 > 0, rx0 + rw - 1 < w - 1
            shrink_t, shrink_b = ry0 > 0, ry0 + rh - 1 < h - 1
            c_first, c_last = max(0, -rx0), min(rw - 1, w - 1 - rx0)
            r_first, r_last = max(0, -ry0), min(rh - 1, h - 1 - ry0)

            def updated(s):
                """The pixels sweep s updates: the region shrunk by s on each
                side that is not an image edge; s = 0 the region itself."""
                return ((cc >= (s if shrink_l else c_first))
                        & (cc <= (rw - 1 - s if shrink_r else c_last))
                        & (rr >= (s if shrink_t else r_first))
                        & (rr <= (rh - 1 - s if shrink_b else r_last)))

            gyc, gxc = np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)
            ts = np.full((2, 2, rh, rw), np.nan, np.float32)
            ts[0][:, updated(0)] = T[:, gyc, gxc][:, updated(0)]
            cs = np.full((11, rh, rw), np.nan, np.float32)
            cs[:, updated(1)] = consts[:, gyc, gxc][:, updated(1)]
            # mirror neighbours as region indices (clipped only where unused)
            xp = np.where(gx == w - 1, cc - 1, cc + 1)
            xm = np.where(gx == 0, cc + 1, cc - 1)
            yp = np.where(gy == h - 1, rr - 1, rr + 1)
            ym = np.where(gy == 0, rr + 1, rr - 1)
            nbrs = [(rr, np.clip(xp, 0, rw - 1)), (rr, np.clip(xm, 0, rw - 1)),
                    (np.clip(yp, 0, rh - 1), cc), (np.clip(ym, 0, rh - 1), cc)]
            for s in range(1, k + 1):
                src, dst = ts[(s - 1) & 1], ts[s & 1]
                dst[:] = np.nan
                ok = updated(s)
                tu_n = [src[0][y, x] for y, x in nbrs]
                tv_n = [src[1][y, x] for y, x in nbrs]
                with np.errstate(invalid="ignore"):
                    new = sweep_np(tu_n, tv_n, src[1], cs)
                dst[0][ok], dst[1][ok] = new[0][ok], new[1][ok]
            tile = (cc >= k) & (cc < rw - k) & (rr >= k) & (rr < rh - k) & (gx < w) & (gy < h)
            out[:, gy[tile], gx[tile]] = ts[k & 1][:, tile]
    return out


# (rw, rh, k): the kernel's own regions and far smaller ones, so that the
# edge shapes hold several blocks and tiles down to 1 x 1
GEOMETRIES = [(L.KSWEEP_RW, L.KSWEEP_RH, k) for k in range(1, L.KMAX + 1)] + [
    (12, 9, 1), (12, 9, 3), (13, 11, 5), (11, 11, 5), (20, 12, 4)]


@pytest.mark.parametrize("rw,rh,k", GEOMETRIES)
@pytest.mark.parametrize("h,w", SHAPES + [(22, 13), (9, 33), (31, 97)])
def test_tile_emulation_is_the_plain_loop_bitwise(h, w, rw, rh, k):
    T, uv, hoist = sweep_inputs(h, w, seed=h * 100 + w)
    got = ksweep_emulated(T, uv, hoist, k, rw, rh)
    want = L.jacobi_sweeps_plain(torch.from_numpy(T), torch.from_numpy(uv),
                                 torch.from_numpy(hoist), k).numpy()
    assert np.isfinite(got).all()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("h,w", SHAPES + [(2160, 3840), (1276, 2268)])
@pytest.mark.parametrize("k", range(1, L.KMAX + 1))
def test_tiles_partition_the_level(h, w, k):
    count = np.zeros((h, w), np.int32)
    for (ry0, ry1, rx0, rx1), (ty0, ty1, tx0, tx1) in L.ksweep_tiles(h, w, k):
        assert (ry0, ry1, rx0, rx1) == (max(0, ty0 - k), min(h, ty1 + k),
                                        max(0, tx0 - k), min(w, tx1 + k))
        assert ry1 - ry0 <= L.KSWEEP_RH and rx1 - rx0 <= L.KSWEEP_RW
        count[ty0:ty1, tx0:tx1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("h,w,k,blocks", [(2160, 3840, 5, 72 * 99), (1080, 1920, 5, 36 * 50),
                                          (388, 584, 5, 11 * 18), (13, 22, 5, 1), (2, 2, 5, 1),
                                          (388, 584, 1, 10 * 13), (1080, 1920, 1, 31 * 36),
                                          (237, 421, 5, 8 * 11)])
def test_one_block_per_tile_of_the_launch_grid(h, w, k, blocks):
    """ksweep_tiles lists the blocks of the kernel's grid, (w / tile width)
    x (h / tile height) rounded up; a level no larger than one tile (the
    default schedule's coarsest, 22 x 13) is one block."""
    tiles = list(L.ksweep_tiles(h, w, k))
    assert len(tiles) == blocks
    tw, th = L.KSWEEP_RW - 2 * k, L.KSWEEP_RH - 2 * k
    assert blocks == -(-w // tw) * -(-h // th)
    if h <= th and w <= tw:
        assert tiles == [((0, h, 0, w), (0, h, 0, w))]


def test_geometry_constants_match_the_kernel_source():
    src = (Path(CSRC) / "level_body.cuh").read_text()
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (KS_\w+) = (\d+);", src)}
    assert consts["KS_KMAX"] == L.KMAX
    assert consts["KS_RW"] == L.KSWEEP_RW
    assert consts["KS_RH"] == L.KSWEEP_RH
    # the tile keeps at least one row at KMAX sweeps
    assert L.KSWEEP_RH - 2 * L.KMAX >= 1

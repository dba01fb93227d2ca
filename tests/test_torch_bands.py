"""Each process's rows of a sharded level's whole-field stages
(``tpuflow_torch.solver.bands``) on the CPU.

The row-range plain versions of the warp, the derivatives, the gradient and
log tensors, add + median and the flow's resample are held bitwise against
the rows of the whole-field call (hypothesis over sizes and ranges, the
first and last rows included). The band plan is held by a NaN poison: a
one-process emulation of each shard of 2 and 3 (``emulate_shard``) runs
every banded stage into a whole-size buffer that holds NaN (and then 1e30)
outside the plan's rows, and its owned rows of the flow must still be
bitwise those of the whole solve, while its relaxation checks that the rows
it reads of uv, fxyz and J are the whole solve's; the rows computed per
stage are the plan's. The plan's levels are the schedule's suffix of
sharded levels, which it is in every cell of the port's configurations.
Against the JAX package: the flow stitched from every shard's owned rows
stays within the sharded pipeline's bound of ``compute_flow_bucketed_batch``
(mean EPE 1e-5, max 1e-4, as tests/test_torch_procmesh.py states).

One process over several cards (``emulate_lanes``): a lane a "card" of 2
and 4, each with its own whole-size buffers poisoned with NaN outside its
plan's rows, stepped level by level through ``solve``, the relaxation the
plain ``relax_sharded`` over the owned rows of each lane's fields, the
owned rows joined on the first lane at the end: bitwise the whole solve for
the three constancies on the kernel route and on ``auto``, each lane's rows
its plan's, and within the cross-program class (mean EPE 1e-3) of the JAX
package's ``compute_flow``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.solver.bucketed import compute_flow_bucketed_batch

from tpuflow_torch import models
from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.resample import resample, resample_plain
from tpuflow_torch.ops.solver_ops import clamp, refl
from tpuflow_torch.ops.warp import warp, warp_plain
from tpuflow_torch.parallel.mesh import Mesh
from tpuflow_torch.solver.bands import (
    band_plan, emulate_shard, hull, level_rows, reach, stage_rows,
)
from tpuflow_torch.solver.level import LevelScalars, solve
from tpuflow_torch.solver.sharded import sharded_bands, sharded_plan

torch.set_num_threads(2)

KW = dict(warp_levels_count=3, warp_scale_factor=0.7, outer_iterations_count=4,
          inner_iterations_count=3, median_radius=3, gaussian_sigma=0.8)
H, W = 64, 96
CONSTANCIES = ("grey", "gradient", "log")
SHARDS = [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]
NAN = float("nan")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def cfg_of(constancy: str, **kw) -> FlowConfig:
    return FlowConfig(data_constancy=DataConstancy(constancy), **{**KW, **kw})


def pair():
    """A seeded 96x64 pair: noise with a blob moved by (1, 2) px."""
    rng = np.random.default_rng(11)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    f0 = (rng.random((H, W), np.float32) * 200).astype(np.float32)
    g = 150 * np.exp(-((ys - 30) ** 2 + (xs - 45) ** 2) / 120.0)
    return (f0 + g).astype(np.float32), (f0 + np.roll(g, (1, 2), axis=(0, 1))).astype(np.float32)


def level_fields(h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    f0, f1 = t(rng.random((h, w)) * 200), t(rng.random((h, w)) * 200)
    uv = t(rng.standard_normal((2, h, w)) * 2.0)
    T = uv + t(rng.standard_normal((2, h, w)) * 0.1)
    sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
    return f0, f1, uv, T, sc


@st.composite
def level_and_rows(draw):
    h, w = draw(st.integers(4, 23)), draw(st.integers(4, 19))
    lo = draw(st.sampled_from([0, h - 1]) | st.integers(0, h - 1))
    hi = draw(st.sampled_from([h, lo + 1]) | st.integers(lo + 1, h))
    return h, w, lo, hi, draw(st.integers(0, 2 ** 16))


@settings(max_examples=60, deadline=None)
@given(level_and_rows())
def test_row_range_plain_versions_are_the_whole_calls_rows(case):
    """Every row stage over (lo, hi): the rows of the whole-field call,
    bit for bit, the other rows of a new output NaN; the same into an
    ``out``, whose other rows stay as they were."""
    h, w, lo, hi, seed = case
    f0, f1, uv, T, sc = level_fields(h, w, seed)
    f1w = warp_plain(f0, f1, uv, sc.inv_hx, sc.inv_hy)
    fxyz = L.level_derivs_plain(f0, f1w, sc.div4hx, sc.div4hy)
    calls = {
        "warp": lambda **kw: warp(f0, f1, uv, sc.inv_hx, sc.inv_hy, **kw),
        "level_derivs": lambda **kw: L.level_derivs(f0, f1w, sc.div4hx, sc.div4hy, **kw),
        "level_tensor_gradient": lambda **kw: L.level_tensor(f0, f1w, fxyz, sc, False, **kw),
        "level_tensor_log": lambda **kw: L.level_tensor(f0, f1w, fxyz, sc, True, **kw),
    }
    for r in (1, 3, 5, 7):
        calls[f"add_median_{r}"] = lambda r=r, **kw: L.add_median(T, uv, r, **kw)
    for name, call in calls.items():
        whole, got = call(), call(rows=(lo, hi))
        assert same(got[..., lo:hi, :], whole[..., lo:hi, :]), name
        assert torch.isnan(got[..., :lo, :]).all() and torch.isnan(got[..., hi:, :]).all(), name
        out = torch.full_like(whole, 7.0)
        assert call(rows=(lo, hi), out=out) is out
        assert same(out[..., lo:hi, :], whole[..., lo:hi, :]), name
        assert (out[..., :lo, :] == 7.0).all() and (out[..., hi:, :] == 7.0).all(), name


@settings(max_examples=60, deadline=None)
@given(st.integers(4, 40), st.integers(4, 40), st.integers(1, 60), st.integers(1, 60),
       st.data())
def test_restricted_resample_rows_are_the_whole_resamples(in_h, in_w, out_h, out_w, data):
    """``resample(..., rows=)``: the Y pass over those rows, the X pass over
    the rows their windows read; each row bitwise the whole call's, and the
    input outside those rows is never read (NaN there changes nothing)."""
    lo = data.draw(st.sampled_from([0, out_h - 1]) | st.integers(0, out_h - 1))
    hi = data.draw(st.sampled_from([out_h, lo + 1]) | st.integers(lo + 1, out_h))
    rng = np.random.default_rng(in_h * 1000 + out_h)
    img = torch.from_numpy((rng.standard_normal((2, in_h, in_w)) * 4).astype(np.float32))
    if (in_h, in_w) == (out_h, out_w):
        assert resample(img, out_w, out_h, rows=(lo, hi)) is img
        return
    whole = resample(img, out_w, out_h)
    from tpuflow_torch.ops.banded import band_span
    from tpuflow_torch.ops.resample import resample_band

    k0, k1 = band_span(resample_band(in_h, out_h), lo, hi)
    poisoned = img.clone()
    poisoned[:, :k0], poisoned[:, k1:] = NAN, NAN
    got = resample(poisoned, out_w, out_h, rows=(lo, hi))
    assert same(got[:, lo:hi], whole[:, lo:hi])
    assert torch.isnan(got[:, :lo]).all() and torch.isnan(got[:, hi:]).all()
    assert same(resample_plain(img, out_w, out_h, rows=(lo, hi))[:, lo:hi], whole[:, lo:hi])


@pytest.mark.parametrize("n", [1, 2, 3, 7])
@pytest.mark.parametrize("h", [4, 5, 13])
def test_reach_is_the_hull_of_the_kernels_rules(h, n):
    """``reach`` takes the kernels' own refl and clamp at the level's
    height: brute force over every range of an h-row level."""
    for lo in range(h):
        for hi in range(lo + 1, h + 1):
            for rule in (refl, clamp):
                rows = [int(rule(np.array(y + d), h)) for y in range(lo, hi)
                        for d in range(-min(n, h - 1), min(n, h - 1) + 1)]
                r = min(n, h - 1)
                assert reach((lo, hi), r, h, rule) == (min(rows), max(rows) + 1)


def routes(cfg: FlowConfig, n_y: int, halo: str, k: int):
    return [(r, kk) for _, _, r, kk in sharded_plan(W, H, cfg, Mesh(n_y, "cpu"), halo, k)]


@pytest.mark.parametrize("n_y,shard", SHARDS)
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_nan_poison_band_path_of_each_shard_is_bitwise(constancy, n_y, shard):
    """One process's band path, emulated: every banded stage writes its
    plan's rows into a buffer of NaN (then of 1e30), the relaxation checks
    that the rows it reads of uv, fxyz and J are the whole solve's; the
    shard's owned rows of the flow are bitwise the whole solve's, every
    other row of the finest flow is never written, and each row stage
    computed the plan's rows (``stage_rows``; the emulation also runs the
    whole solve)."""
    cfg = cfg_of(constancy)
    f0, f1 = (torch.from_numpy(f) for f in pair())
    whole_rows = stage_rows(W, H, cfg, None)
    for halo in ("kernel", "explicit"):
        for k in (1, 2):
            for fill in (NAN, 1e30):
                plan = band_plan(W, H, cfg, routes(cfg, n_y, halo, k), n_y, shard)
                assert plan is not None and plan.levels
                L.reset_row_counts()
                banded, whole = emulate_shard(f0, f1, cfg, plan, fill)
                lo, hi = plan.owned[shard]
                assert same(banded[:, lo:hi], whole[:, lo:hi]), (halo, k, fill)
                others = torch.cat([banded[:, :lo], banded[:, hi:]], dim=1)
                assert (torch.isnan(others) if math.isnan(fill) else others == fill).all()
                counts = L.row_counts()
                want = stage_rows(W, H, cfg, plan)
                assert counts == {s: want[s] + whole_rows[s] for s in counts}
                assert sum(want.values()) < sum(whole_rows.values())


def test_a_plan_that_misses_a_reach_is_caught():
    """The poison test has teeth. Finest level, shard 0 of 2, grey, median
    radius 5: uv one row short of the warp's rows makes the relaxation read
    a poisoned fxyz row (its check trips); uv one row short of the
    median's window, but holding the warp's, changes the owned rows."""
    import dataclasses

    f0, f1 = (torch.from_numpy(f) for f in pair())
    cfg = cfg_of("grey", median_radius=5)
    plan = band_plan(W, H, cfg, routes(cfg, 2, "kernel", 1), 2, 0)
    last = plan.levels[-1]
    assert last.uv[1] == last.median[1] + 2 > last.warp[1] == last.J[1] + 1

    def short(uv):
        lv = dataclasses.replace(last, uv=uv)
        return dataclasses.replace(plan, levels=plan.levels[:-1] + (lv,))

    with pytest.raises(AssertionError, match="of fxyz differ"):
        emulate_shard(f0, f1, cfg, short((last.uv[0], last.warp[1] - 1)), 1e30)
    banded, whole = emulate_shard(f0, f1, cfg, short((last.uv[0], last.warp[1])), 1e30)
    lo, hi = plan.owned[0]
    assert not same(banded[:, lo:hi], whole[:, lo:hi])


def test_the_plans_levels_are_the_suffix_of_sharded_levels():
    """The band loop starts after the last level of another route: a
    replicated level after a sharded one moves the start past it; none
    where the finest level is not sharded."""
    cfg = FlowConfig(**{**KW, "warp_levels_count": 4})
    from tpuflow_torch.pyramid import level_schedule

    n = len(level_schedule(W, H, cfg.warp_levels_count, cfg.warp_scale_factor))
    assert n == 4
    mixed = [("kernel", 1), ("replicated", 1), ("kernel", 1), ("explicit", 1)]
    plan = band_plan(W, H, cfg, mixed, 2, 0)
    assert plan.start == 2 and len(plan.levels) == 2
    assert plan.at(1) is None and plan.at(2) is plan.levels[0]
    assert band_plan(W, H, cfg, [("kernel", 1)] * 3 + [("replicated", 1)], 2, 0) is None
    assert band_plan(W, H, cfg, [("replicated", 1)] * 4, 2, 0) is None
    assert band_plan(W, H, cfg, [("kernel", 1)] * 4, 2, 1).start == 0


def test_a_replicated_level_after_a_sharded_one_runs_whole():
    """A plan whose suffix starts after a replicated level: the levels
    before it run over the whole field, the flow's owned rows bitwise."""
    cfg = FlowConfig(**{**KW, "warp_levels_count": 4, "data_constancy": DataConstancy.GRADIENT})
    f0, f1 = (torch.from_numpy(f) for f in pair())
    mixed = [("kernel", 1), ("replicated", 1), ("kernel", 1), ("explicit", 1)]
    for shard in (0, 1):
        plan = band_plan(W, H, cfg, mixed, 2, shard)
        banded, whole = emulate_shard(f0, f1, cfg, plan, NAN)
        lo, hi = plan.owned[shard]
        assert same(banded[:, lo:hi], whole[:, lo:hi])


@pytest.mark.parametrize("route", ["kernel", "explicit"])
def test_the_plans_rows_hold_what_each_stage_reads(route):
    """Per level: J the route's rows (owned, or the explicit route's padded
    block), fxyz and the warp over J, uv over the warp, every range inside
    the level; coarse to fine the median rows end at the owned rows."""
    from tpuflow_torch.parallel.halo import halo_rows, row_split
    from tpuflow_torch.pyramid import level_schedule

    for constancy in CONSTANCIES:
        cfg = cfg_of(constancy)
        specs = level_schedule(W, H, cfg.warp_levels_count, cfg.warp_scale_factor)
        for n_y, shard in SHARDS:
            rts = routes(cfg, n_y, route, 1)
            plan = band_plan(W, H, cfg, rts, n_y, shard)
            for p in range(plan.start, len(specs)):
                lv, h = plan.at(p), specs[p].height
                sh = row_split(h, n_y, halo_rows(cfg, 1))[shard]
                want = ((sh.first, sh.first + sh.padded) if route == "explicit"
                        else (sh.row0, sh.row0 + sh.rows))
                assert lv.J == want
                for inner, outer in ((lv.J, lv.fxyz), (lv.fxyz, lv.warp), (lv.warp, lv.uv),
                                     (lv.J, lv.uv)):
                    assert outer[0] <= inner[0] < inner[1] <= outer[1]
                assert all(0 <= a < b <= h for a, b in (lv.uv, lv.warp, lv.fxyz, lv.J,
                                                         lv.median))
                assert lv == level_rows(h, lv.median, lv.J, cfg)
            assert plan.levels[-1].median == plan.owned[shard]


@pytest.mark.parametrize("procs", [2, 4])
@pytest.mark.parametrize("size", [(584, 388), (1920, 1080), (3840, 2160)])
@pytest.mark.parametrize("preset", ["default", "full_model"])
def test_sharded_levels_are_a_suffix_in_every_cell(preset, size, procs):
    """The router's plan over processes (one card each) shards a suffix of
    the schedule in each cell of the port's configurations, and the band
    plan starts at its first sharded level."""
    cfg = FlowConfig() if preset == "default" else models.full_model()
    w, h = size
    mesh = Mesh(procs, devices=["cpu"] * procs, ranks=range(procs),
                uuids=[f"card{r}" for r in range(procs)])
    plan = sharded_plan(w, h, cfg, mesh, "auto")
    sharded = [route != "replicated" for _, _, route, _ in plan]
    first = sharded.index(True)
    assert all(sharded[first:])
    bands = sharded_bands(w, h, cfg, mesh, "auto")
    assert bands.start == first and bands.ranks == tuple(range(procs)) and bands.shard == 0
    full = stage_rows(w, h, cfg, None)
    mine = stage_rows(w, h, cfg, bands)
    assert all(mine[s] < full[s] for s in ("warp", "level_derivs", "add_median"))


def test_no_band_plan_on_one_process_or_a_shared_card(monkeypatch):
    """One process, dp and processes sharing a card under NCCL (which would
    refuse the gather) take no band plan."""
    from tpuflow_torch.parallel import group

    cfg = models.full_model()
    assert sharded_bands(1920, 1080, cfg, Mesh(4, "cpu"), "kernel") is None
    shared = Mesh(2, devices=["cpu"] * 2, ranks=[0, 1], uuids=["a", "a"])
    monkeypatch.setattr(group, "p2p_backend", lambda: "nccl")
    assert sharded_bands(1920, 1080, cfg, shared, "kernel") is None
    distinct = Mesh(2, devices=["cpu"] * 2, ranks=[0, 1], uuids=["a", "b"])
    assert sharded_bands(1920, 1080, cfg, distinct, "kernel") is not None


def test_a_banded_solve_takes_no_tiers_and_ends_at_the_finest_level():
    cfg = cfg_of("grey")
    f0, f1 = (torch.from_numpy(f) for f in pair())
    plan = band_plan(W, H, cfg, routes(cfg, 2, "kernel", 1), 2, 0)
    with pytest.raises(ValueError, match="no warp tiers"):
        solve(f0, f1, cfg, tiers=[], bands=plan)
    with pytest.raises(ValueError, match="finest level"):
        solve(f0, f1, cfg, levels=range(2), bands=plan)


@pytest.mark.parametrize("constancy", ["grey", "gradient"])
def test_stitched_banded_rows_within_the_bound_of_the_jax_package(constancy):
    """The whole pipeline of a banded row of 3: each shard's owned rows from
    its own emulated band path, stitched, against the JAX package's
    ``compute_flow_bucketed_batch`` within the sharded pipeline's bound."""
    cfg = cfg_of(constancy)
    f0n, f1n = pair()
    f0, f1 = torch.from_numpy(f0n), torch.from_numpy(f1n)
    flow = torch.full((2, H, W), NAN)
    for shard in range(3):
        plan = band_plan(W, H, cfg, routes(cfg, 3, "kernel", 1), 3, shard)
        banded, _ = emulate_shard(f0, f1, cfg, plan, NAN)
        lo, hi = plan.owned[shard]
        flow[:, lo:hi] = banded[:, lo:hi]
    jcfg = JFlowConfig(data_constancy=JDataConstancy(constancy), **KW)
    u, v = compute_flow_bucketed_batch(f0n[None], f1n[None], jcfg)
    epe = np.hypot(flow[0].numpy() - np.asarray(u)[0], flow[1].numpy() - np.asarray(v)[0])
    assert float(epe.mean()) <= 1e-5 and float(epe.max()) <= 1e-4, (epe.mean(), epe.max())


@pytest.mark.parametrize("planes,h", [(2, 4), (2, 31), (1, 9), (3, 17)])
def test_banded_x_row_mapping_covers_the_span_of_each_plane(planes, h):
    """banded_x_kernel's row mapping (csrc/banded.cu: ``at``) over the
    arguments ``banded.x_rows`` gives: the logical rows cover rows k0 .. k1
    - 1 of each plane exactly once, and every row without a span."""
    from tpuflow_torch.ops.banded import x_rows

    for k0 in range(h):
        for k1 in range(k0 + 1, h + 1):
            n, band, plane_rows, row0 = x_rows(planes * h, h, (k0, k1))
            assert n % band == 0 and row0 + band <= plane_rows
            rows = [g // band * plane_rows + row0 + g % band for g in range(n)]
            assert rows == [p * h + r for p in range(planes) for r in range(k0, k1)]
            for xr in (4, 8):       # a group's rows as the kernel steps them (orow)
                for r0 in range(0, n, xr):
                    q, m, orow = r0 // band, r0 % band, []
                    for _ in range(xr):
                        orow.append(q * plane_rows + row0 + m)
                        m += 1
                        if m == band:
                            m, q = 0, q + 1
                    assert orow[:n - r0] == rows[r0:r0 + xr]
    assert x_rows(planes * h, h) == (planes * h,) * 3 + (0,)


@pytest.mark.parametrize("size", [(584, 388), (1920, 1080)])
def test_restricted_y_plans_write_their_rows_once(size):
    """The Y plan over output rows (lo, hi) of each level's flow: emulated
    as the kernel reads it (tests/test_torch_pyramid.py's ``emulate_y``),
    every output of those rows is written once and bitwise the plain
    version's, and no other output is written."""
    from test_torch_pyramid import emulate_y

    from tpuflow_torch.ops import banded as B
    from tpuflow_torch.ops.resample import resample_band
    from tpuflow_torch.pyramid import level_schedule

    w, h = size
    cfg = models.full_model()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    rng = np.random.default_rng(3)
    steps = [(a, b) for a, b in zip(specs, specs[1:]) if a.height != b.height]
    for a, b in steps[:2] + steps[-2:]:
        xs = ((resample_band, a.width, b.width),)
        ys = ((resample_band, a.height, b.height),)
        tmp = B.banded_plain(torch.from_numpy(
            rng.standard_normal((2, a.height, a.width)).astype(np.float32)),
            B.bands(xs)[0], B.AXIS_X)
        whole = B.banded_plain(tmp, B.bands(ys)[0], B.AXIS_Y).numpy()
        pitch = B.x_cols((b.width,))[1]
        grid = np.zeros((2 * a.height, pitch), np.float32)
        grid[:, :b.width] = tmp.reshape(2 * a.height, b.width).numpy()
        for lo, hi in ((0, 1), (0, b.height // 3), (b.height // 2, b.height),
                       (b.height - 1, b.height)):
            hi = max(hi, lo + 1)
            plan = B.y_plan(ys, (b.width,), 2, ((lo, hi),))
            total = 2 * b.height * b.width
            out, writes = emulate_y(grid, plan, 2, a.height, total)
            out, writes = out.reshape(2, b.height, b.width), writes.reshape(2, b.height, b.width)
            assert (writes[:, lo:hi] == 1).all() and writes.sum() == 2 * (hi - lo) * b.width
            assert out[:, lo:hi].tobytes() == whole[:, lo:hi].tobytes()


# ---------------------------------------------------------------------------
# One process over several cards: the lanes, emulated on the CPU
# ---------------------------------------------------------------------------

LANES = [2, 4]


def lane_routes(cfg: FlowConfig, n: int, halo: str, w: int = W, h: int = H):
    """The routes of a one-process row of ``n`` shards on ``n`` cards (the
    cost model's cards are counted by UUID)."""
    mesh = Mesh(n, devices=["cpu"] * n, uuids=[f"card{i}" for i in range(n)])
    return [(r, k) for _, _, r, k in sharded_plan(w, h, cfg, mesh, halo)]


def peer_counts(plans, w: int, h: int, start: int) -> tuple:
    """The peer copies of a lane solve from the coarsest level: the pair to
    each other lane, the flow's entry rows at the suffix's first level (a
    plane a copy), and the finest flow's owned rows of each other lane's
    shards (a plane a copy); (messages, bytes)."""
    messages = nbytes = 0
    for plan in plans[1:]:
        messages, nbytes = messages + 1, nbytes + 2 * h * w * 4
        if start:
            from tpuflow_torch.pyramid import level_schedule

            spec = level_schedule(w, h, KW["warp_levels_count"], KW["warp_scale_factor"])[
                start - 1]
            lo, hi = plan.prior
            messages, nbytes = messages + 2, nbytes + 2 * (hi - lo) * spec.width * 4
        for s in plan.shards:
            lo, hi = plan.owned[s]
            messages, nbytes = messages + 2, nbytes + 2 * (hi - lo) * w * 4
    return messages, nbytes


def run_lanes(cfg, rts, n, groups=None, fill=NAN):
    """emulate_lanes with the row and peer-copy counts read around it."""
    from tpuflow_torch.parallel.mesh import peer_copy
    from tpuflow_torch.solver.bands import emulate_lanes

    f0, f1 = (torch.from_numpy(f) for f in pair())
    L.reset_row_counts()
    peer_copy.messages = peer_copy.bytes = 0
    flow, plans = emulate_lanes(f0, f1, cfg, rts, n, groups, fill)
    rows = [L.row_counts(i) for i in range(len(plans))]
    return flow, plans, rows, (peer_copy.messages, peer_copy.bytes), solve(f0, f1, cfg)


@pytest.mark.parametrize("route", ["kernel", "auto"])
@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_lane_emulation_is_bitwise_the_whole_solve(constancy, n, route):
    """A one-process row of n cards, a lane a card stepped level by level
    (``bands.emulate_lanes``): every banded stage into a buffer of NaN
    outside the lane's plan, the relaxation the plain ``relax_sharded``
    over the owned rows each card's fields hold; the flow gathered on the
    first lane is bitwise the whole solve's, each lane computed its plan's
    rows (the first lane also every row of the levels before the suffix),
    and the peer copies are the pair, the entry rows and the owned rows."""
    cfg = cfg_of(constancy, **({"equation_alpha": 1e-3} if constancy == "log" else {}))
    rts = lane_routes(cfg, n, route)
    flow, plans, rows, peers, whole = run_lanes(cfg, rts, n)
    assert same(flow, whole)
    assert len(plans) == n and all(p.start == plans[0].start for p in plans)
    for i, plan in enumerate(plans):
        assert rows[i] == stage_rows(W, H, cfg, plan, prefix=i == 0)
    assert rows[1]["warp"] < stage_rows(W, H, cfg, None)["warp"]
    assert peers == peer_counts(plans, W, H, plans[0].start)


@pytest.mark.parametrize("groups", [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0,), (1, 2, 3))])
def test_lanes_of_cards_holding_several_shards(groups):
    """A card holding several shards of the row takes the hull of their
    rows (contiguous or dealt); the flow stays bitwise, the rows the
    plans', and each other card sends its own shards' owned rows alone."""
    cfg = cfg_of("gradient")
    rts = routes(cfg, 4, "kernel", 1)
    flow, plans, rows, peers, whole = run_lanes(cfg, rts, 4, groups)
    assert same(flow, whole)
    for i, (plan, ys) in enumerate(zip(plans, groups)):
        assert plan.shards == ys
        assert plan.levels[-1].median == hull(*(plan.owned[y] for y in ys))
        assert rows[i] == stage_rows(W, H, cfg, plan, prefix=i == 0)
    assert peers == peer_counts(plans, W, H, plans[0].start)


def test_lane_suffix_is_the_kernel_levels_alone():
    """Over processes the kernel and the explicit route are banded; in one
    process the kernel alone: its suffix starts after the last level of
    any other route, and there is none where the finest level is explicit.
    A row on one card, or over processes, takes no lanes."""
    from tpuflow_torch.solver.bands import LANE_ROUTES, SHARDED_ROUTES, lane_plans
    from tpuflow_torch.solver.sharded import sharded_lanes

    cfg = FlowConfig(**{**KW, "warp_levels_count": 4})
    mixed = [("kernel", 1), ("explicit", 1), ("kernel", 2), ("kernel", 1)]
    assert band_plan(W, H, cfg, mixed, 2, 0).start == 0
    assert band_plan(W, H, cfg, mixed, 2, 0, banded=LANE_ROUTES).start == 2
    assert band_plan(W, H, cfg, mixed, 2, 0, banded=SHARDED_ROUTES).start == 0
    plans = lane_plans(W, H, cfg, mixed, 2, [(0,), (1,)])
    assert [p.start for p in plans] == [2, 2] and [p.shards for p in plans] == [(0,), (1,)]
    assert plans[0].prior == plans[0].entry(2) and plans[0].entry(3) == plans[0].levels[0].median
    assert lane_plans(W, H, cfg, mixed[:3] + [("explicit", 1)], 2, [(0,), (1,)]) is None
    assert lane_plans(W, H, cfg, [("kernel", 1)] * 4, 2, [(0,), (1,)])[1].prior is None
    assert sharded_lanes(1920, 1080, models.full_model(), Mesh(4, "cpu"), "kernel") is None
    procs = Mesh(2, devices=["cpu"] * 2, ranks=[0, 1], uuids=["a", "b"])
    assert sharded_lanes(1920, 1080, models.full_model(), procs, "kernel") is None


def test_an_explicit_level_keeps_the_whole_field_on_the_first_card():
    """An explicit level in the one-process suffix of sharded levels: it and
    every level before it run over the whole field on the first lane
    alone, the kernel levels after it by lanes; bitwise the whole solve."""
    cfg = FlowConfig(**{**KW, "warp_levels_count": 4, "data_constancy": DataConstancy.GRADIENT})
    mixed = [("kernel", 1), ("kernel", 1), ("explicit", 1), ("kernel", 1)]
    flow, plans, rows, _, whole = run_lanes(cfg, mixed, 2)
    assert same(flow, whole) and plans[0].start == 3
    from tpuflow_torch.pyramid import level_schedule

    specs = level_schedule(W, H, cfg.warp_levels_count, cfg.warp_scale_factor)
    assert rows[0]["warp"] == sum(s.height for s in specs[:3]) + plans[0].levels[0].warp[1] - \
        plans[0].levels[0].warp[0]
    assert rows[1]["warp"] == plans[1].levels[0].warp[1] - plans[1].levels[0].warp[0]


def test_a_lane_needs_every_entry_row(monkeypatch):
    """The poison has teeth at the hand-over: a lane that receives one row
    less of the flow before the suffix than its plan reads gets a flow that
    is not the whole solve's."""
    import dataclasses

    from tpuflow_torch.solver import bands

    cfg = cfg_of("grey")
    rts = lane_routes(cfg, 4, "kernel")
    real = bands.lane_plans

    def short(*args):
        plans = real(*args)
        lo, hi = plans[1].prior
        return (plans[0], dataclasses.replace(plans[1], prior=(lo, hi - 1))) + plans[2:]

    monkeypatch.setattr(bands, "lane_plans", short)
    flow, plans, _, _, whole = run_lanes(cfg, rts, 4)
    assert plans[1].start > 0
    lo, hi = plans[1].owned[1]
    assert not same(flow[:, lo:hi].contiguous(), whole[:, lo:hi].contiguous())


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_lane_flow_within_the_cross_program_class_of_the_jax_package(constancy):
    """Four lanes' gathered flow against the JAX package's ``compute_flow``
    on the same seeded pair: mean EPE within the cross-program class
    (1e-3 px)."""
    from tpuflow import compute_flow as jax_compute_flow

    extra = {"equation_alpha": 1e-3} if constancy == "log" else {}
    cfg = cfg_of(constancy, **extra)
    flow, *_ = run_lanes(cfg, lane_routes(cfg, 4, "kernel"), 4)
    f0n, f1n = pair()
    res = jax_compute_flow(f0n, f1n, JFlowConfig(data_constancy=JDataConstancy(constancy),
                                                 **{**KW, **extra}))
    epe = np.hypot(flow[0].numpy() - np.asarray(res.u), flow[1].numpy() - np.asarray(res.v))
    assert float(epe.mean()) <= 1e-3, float(epe.mean())


def test_per_card_fields_relax_the_owned_rows_each_card_holds():
    """``relax_sharded_kernel`` given one field set a card: on CPU tensors
    the plain version relaxes the owned rows each card holds (NaN in every
    other row of a card's copy changes nothing) and returns one T a card;
    a count of fields that is not the row's cards raises."""
    from tpuflow_torch.parallel.halo_kernel import owned_rows, relax_sharded_kernel
    from tpuflow_torch.parallel.halo import halo_rows, relax_sharded, row_split

    cfg = cfg_of("gradient")
    h, w = 64, 40
    f0, f1, uv, T, sc = level_fields(h, w, 5)
    fxyz = L.level_derivs_plain(f0, f1, sc.div4hx, sc.div4hy)
    J = L.level_tensor_plain(f0, f1, fxyz, sc, False)
    split = row_split(h, 4, halo_rows(cfg, 1))
    groups = [("cpu", (0, 2)), ("cpu", (1, 3))]

    def copies(x):
        out = []
        for _, ys in groups:
            c = torch.full_like(x, NAN)
            for y in ys:
                c[:, split[y].row0:split[y].row0 + split[y].rows] = x[:, split[y].row0:
                                                                      split[y].row0 + split[y].rows]
            out.append(c)
        return tuple(out)

    for x in (uv, fxyz, J):
        assert same(owned_rows(copies(x), groups, split), x)
    mesh = Mesh(4, "cpu")
    want = relax_sharded(fxyz, uv, sc, cfg, mesh, 1, J)
    got = relax_sharded_kernel((fxyz,), (uv,), sc, cfg, mesh, J=(J,))
    assert isinstance(got, tuple) and len(got) == 1 and same(got[0], want)
    with pytest.raises(ValueError, match="one tensor a card"):
        relax_sharded_kernel((fxyz, fxyz), (uv, uv), sc, cfg, mesh, J=(J, J))


class CpuCards(Mesh):
    """A one-process row whose CPU positions count as one card each: the
    routing of ``compute_flow_sharded`` over several cards, on the CPU."""

    def row_cards(self, data: int = 0) -> int:
        return len(self.row(data))

    def row_groups(self, data: int = 0):
        return [(self.devices[p], (y,)) for y, p in enumerate(self.row(data))]


@pytest.mark.parametrize("halo", ["kernel", "auto", "explicit"])
def test_compute_flow_sharded_runs_lanes_over_several_cards(halo):
    """``compute_flow_sharded`` on a one-process row of 4 "cards": the kernel
    route and auto by lanes (``sharded_lanes``; each lane's rows its plan's,
    the peer copies ``lane_copies``), the explicit route over the whole
    field on the first card (no lanes, no peer copy); every flow bitwise
    ``compute_flow``'s."""
    import dataclasses

    from tpuflow_torch import compute_flow, compute_flow_sharded
    from tpuflow_torch.parallel.mesh import peer_copy
    from tpuflow_torch.solver import sharded
    from tpuflow_torch.solver.bands import lane_copies
    from tpuflow_torch.synthetic import textured_pair

    w, h = 160, 128
    cfg = dataclasses.replace(models.full_model(), warp_levels_count=6, outer_iterations_count=6)
    f0, f1 = textured_pair(w, h)
    base = compute_flow(f0, f1, cfg, device="cpu")
    mesh = CpuCards(4, "cpu")
    sharded.reset_launch_counts()
    res = compute_flow_sharded(f0, f1, cfg, mesh=mesh, halo=halo, device="cpu")
    assert res.u.tobytes() == base.u.tobytes() and res.v.tobytes() == base.v.tobytes()
    lanes = sharded.sharded_lanes(w, h, cfg, mesh, halo)
    if halo == "explicit":
        assert lanes is None and peer_copy.messages == 0
        assert L.row_counts(0) == stage_rows(w, h, cfg, None)
        return
    assert [lane.plan.shards for lane in lanes] == [(0,), (1,), (2,), (3,)]
    for i, lane in enumerate(lanes):
        assert L.row_counts(i) == stage_rows(w, h, cfg, lane.plan, prefix=i == 0)
    assert lane_copies(w, h, cfg, [lane.plan for lane in lanes]) == {
        "messages": peer_copy.messages, "bytes": peer_copy.bytes}

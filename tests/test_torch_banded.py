"""The banded pass of the presmooth and the resample (ops/banded.py): the
plain versions the CPU runs against the NumPy oracle (bitwise: the same
terms added in the same order, each rounded as float32) and against the
JAX package (within 1e-6 of max |JAX|: its matmuls sum the same products
in another order), the tables against the dense matrices, and the bounds'
byte counts.

The CUDA kernels (csrc/banded.cu) are held bitwise against these plain
versions on the card by chip_smoke.py (phase 3b); tests/test_torch_pyramid.py
emulates them over their plans.

    PYTHONPATH=. python tests/test_torch_banded.py

prints, for the gradient constancy on 24x16 blob frames at the default
schedule (the frames of tests/test_torch_cli.py's sequence), the mean EPE
between the port, the JAX package and the oracle at 5 to 160 outer
iterations, where the solve amplifies rounding (about 5 minutes on a CPU,
JAX's compiles included)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.ops.gaussian import _conv_matrix as jconv_matrix
from tpuflow.ops.gaussian import gaussian_smooth as jgaussian_smooth
from tpuflow.ops.resample import resample as jresample
from tpuflow.ops.resample import resample_cols_blocked, resample_rows_blocked
from tpuflow.ops.resample import resample_weights as jresample_weights

from tpuflow_torch import oracle_np
from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.banded import (
    AXIS_X, AXIS_Y, Band, banded_plain, plan_table, x_plan, y_plan,
)
from tpuflow_torch.ops.gaussian import (
    conv_matrix, gaussian_band, gaussian_kernel_taps, gaussian_smooth, gaussian_smooth_plain,
)
from tpuflow_torch.ops.level import launch_counts, reset_launch_counts
from tpuflow_torch.ops.resample import resample, resample_band, resample_plain, resample_weights
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.tools import roofline as R

torch.set_num_threads(2)

T = torch.from_numpy
JAX_REL = 1e-6
SCHEDULES = ((584, 388), (96, 64))
# (in_h, in_w, out_h, out_w): ratios near 1, 2, ceil(in/out) >= 100, out = in
# (one axis and both), upsampling
RATIOS = ((64, 96, 63, 95), (64, 96, 65, 97), (64, 96, 32, 48), (65, 97, 33, 49),
          (388, 584, 3, 5), (1080, 300, 10, 2), (40, 60, 40, 30), (40, 60, 20, 60),
          (13, 7, 13, 7), (24, 21, 36, 32))


def image(shape, seed):
    """Signed values with a spread of magnitudes, as a flow or a frame's
    derivative has."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 40.0).astype(np.float32)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def levels(w, h):
    cfg = FlowConfig()
    return level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)


@pytest.mark.parametrize("size", SCHEDULES)
@pytest.mark.parametrize("axis", ["x", "y", "xy"])
def test_frames_bitwise_the_oracle_at_every_level(size, axis):
    """Every level's frames, from the full-size frame, along x, along y and
    both (resample_plain against oracle_np.resample)."""
    w, h = size
    img = image((h, w), seed=w)
    for s in levels(w, h):
        if s.level == 0:
            continue
        if axis == "x":
            got = banded_plain(T(img), resample_band(w, s.width), AXIS_X).numpy()
            want = oracle_np.resample_x(img, s.width)
        elif axis == "y":
            got = banded_plain(T(img), resample_band(h, s.height), AXIS_Y).numpy()
            want = oracle_np.resample_y(img, s.height)
        else:
            got = resample_plain(T(img), s.width, s.height).numpy()
            want = oracle_np.resample(img, s.width, s.height)
        assert same_bits(got, want), (axis, s)


@pytest.mark.parametrize("size", SCHEDULES)
def test_flow_bitwise_the_oracle_from_the_level_before(size):
    """The flow's resample at every level, from the level before, on a
    (2, h, w) stack through the wrapper (the CPU runs the plain version)."""
    w, h = size
    specs = levels(w, h)
    for prev, s in zip(specs, specs[1:]):
        uv = image((2, prev.height, prev.width), seed=s.level)
        got = resample(T(uv), s.width, s.height).numpy()
        for p in range(2):
            want = oracle_np.resample(uv[p], s.width, s.height)
            assert same_bits(got[p], want), (prev, s)


@pytest.mark.parametrize("shape", RATIOS)
def test_ratios_bitwise_the_oracle_and_close_to_jax(shape):
    ih, iw, oh, ow = shape
    img = image((ih, iw), seed=ih + ow)
    got = resample(T(img), ow, oh).numpy()
    if (ih, iw) == (oh, ow):
        assert same_bits(got, img)
        return
    assert same_bits(got, oracle_np.resample(img, ow, oh))
    assert same_bits(banded_plain(T(img), resample_band(iw, ow), AXIS_X).numpy(),
                     oracle_np.resample_x(img, ow))
    assert same_bits(banded_plain(T(img), resample_band(ih, oh), AXIS_Y).numpy(),
                     oracle_np.resample_y(img, oh))
    want = np.asarray(jresample(jnp.asarray(img), ow, oh))
    assert np.abs(got - want).max() <= JAX_REL * np.abs(want).max()


@pytest.mark.parametrize("in_hw,out_hw", [((1040, 1100), (13, 22)), ((1040, 1100), (936, 990)),
                                          ((1200, 1030), (600, 515))])
def test_blocked_contractions_close_to_jax(in_hw, out_hw):
    """At a contraction of BLOCK_BANDED_MIN_K or more the JAX main path
    resamples block-banded (resample_cols_blocked, then
    resample_rows_blocked): each pass within 1e-6 of it."""
    (ih, iw), (oh, ow) = in_hw, out_hw
    img = image((ih, iw), seed=oh)
    got_x = banded_plain(T(img), resample_band(iw, ow), AXIS_X).numpy()
    want_x = np.asarray(resample_cols_blocked(jnp.asarray(img), ow, ow, iw))
    assert np.abs(got_x - want_x).max() <= JAX_REL * np.abs(want_x).max()
    got = banded_plain(T(got_x), resample_band(ih, oh), AXIS_Y).numpy()
    want = np.asarray(resample_rows_blocked(jnp.asarray(got_x), oh, oh, ih))
    assert np.abs(got - want).max() <= JAX_REL * np.abs(want).max()
    assert same_bits(got, resample_plain(T(img), ow, oh).numpy())


@pytest.mark.parametrize("sigma,h,w", [(1.5, 388, 584), (1.5, 64, 96), (1.5, 48, 72),
                                       (0.8, 40, 33), (3.0, 61, 50), (8.0, 4, 4),
                                       (8.0, 5, 7)])
def test_gaussian_bitwise_the_oracle_and_close_to_jax(sigma, h, w):
    """At 4x4 and 7x5 the radius (24) exceeds the frame: every window is
    the whole axis."""
    img = (np.random.default_rng(h).random((h, w)) * 255).astype(np.float32)
    got = gaussian_smooth_plain(T(img), sigma).numpy()
    assert same_bits(got, oracle_np.convolve_separable(img, oracle_np.gaussian_kernel(sigma)))
    assert same_bits(gaussian_smooth(T(img), sigma).numpy(), got)
    stack = gaussian_smooth(T(np.stack([img, img[::-1].copy()])), sigma).numpy()
    assert same_bits(stack[0], got)
    want = np.asarray(jgaussian_smooth(jnp.asarray(img), sigma))
    assert np.abs(got - want).max() <= JAX_REL * np.abs(want).max()


def _windows(band: Band):
    return [range(f, f + c) for f, c in zip(band.first, band.count)]


@pytest.mark.parametrize("axis", [AXIS_X, AXIS_Y])
@pytest.mark.parametrize("kind", ["resample", "gaussian"])
def test_nan_outside_a_window_stays_out(axis, kind):
    """A NaN reaches exactly the outputs whose windows hold it."""
    h, w = 40, 300
    n = w if axis == AXIS_X else h
    band = resample_band(n, 7) if kind == "resample" else gaussian_band(n, 1.5)
    for at in (0, n // 2, n - 1):
        img = image((h, w), seed=at)
        if axis == AXIS_X:
            img[3, at] = np.nan
        else:
            img[at, 3] = np.nan
        got = banded_plain(T(img), band, axis).numpy()
        hit = np.array([at in win for win in _windows(band)])
        line = got[3] if axis == AXIS_X else got[:, 3]
        assert np.array_equal(np.isnan(line), hit), (kind, axis, at)
        assert np.isnan(got).sum() == hit.sum()


@pytest.mark.parametrize("in_n,out_n", [(584, 5), (584, 526), (388, 350), (96, 90), (3840, 22),
                                        (2160, 13), (37, 100), (7, 7), (1080, 1000)])
def test_resample_table_is_the_dense_matrix(in_n, out_n):
    """Each window scattered back as F(frac * norm) is resample_weights,
    and that is the JAX package's, byte for byte."""
    band = resample_band(in_n, out_n)
    dense = np.zeros((out_n, in_n), np.float32)
    for o, win in enumerate(_windows(band)):
        dense[o, win.start:win.stop] = band.weights[o, :len(win)] * np.float32(band.norm)
    assert same_bits(dense, resample_weights(in_n, out_n))
    assert same_bits(dense, jresample_weights(in_n, out_n))
    assert band.norm == float(np.float32(np.float32(out_n) / np.float32(in_n)))
    assert (band.weights[np.arange(band.weights.shape[1])[None, :]
                         >= band.count[:, None]] == 0).all()


@pytest.mark.parametrize("n,sigma", [(37, 1.5), (5, 1.5), (4, 8.0), (61, 3.0)])
def test_gaussian_table_is_the_toeplitz_matrix(n, sigma):
    band = gaussian_band(n, sigma)
    dense = np.zeros((n, n), np.float32)
    for o, win in enumerate(_windows(band)):
        dense[o, win.start:win.stop] = band.weights[o, :len(win)]
    assert same_bits(dense, conv_matrix(n, sigma))
    assert same_bits(dense, jconv_matrix(n, sigma))
    assert band.norm == 1.0
    radius = (len(gaussian_kernel_taps(sigma)) - 1) // 2
    assert band.weights.shape[1] == min(n, 2 * radius + 1)


def test_packed_table_and_its_cache():
    band = resample_band(584, 5)
    packed = band.packed()
    assert packed.dtype == np.int32 and packed.shape == (5, 2 + band.weights.shape[1])
    assert np.array_equal(packed[:, 0], band.first) and np.array_equal(packed[:, 1], band.count)
    assert same_bits(np.ascontiguousarray(packed[:, 2:]).view(np.float32), band.weights)
    cpu = torch.device("cpu")
    specs = ((resample_band, 584, 5),)
    before = plan_table.cache_info()
    t = plan_table(AXIS_Y, specs, (7,), 2, cpu)
    assert plan_table(AXIS_Y, specs, (7,), 2, cpu) is t
    after = plan_table.cache_info()
    assert after.hits - before.hits >= 1
    # the Y plan holds the band's packed table whole; its first block's
    # entry points at the table's first row
    plan = t.numpy()
    entry = plan[plan[3]:plan[3] + 12]
    assert tuple(entry[:4]) == (0, 0, 0, 0)
    at, stride = entry[8], entry[9]
    assert stride == packed.shape[1]
    assert np.array_equal(plan[at:at + packed.size].reshape(packed.shape), packed)


def test_bands_never_move_backwards():
    with pytest.raises(ValueError, match="backwards"):
        Band(first=np.array([0, 2, 1], np.int32), count=np.ones(3, np.int32),
             weights=np.ones((3, 1), np.float32), norm=1.0)


def test_cpu_runs_count_no_launches():
    reset_launch_counts()
    resample(T(image((2, 20, 30), 0)), 11, 7)
    gaussian_smooth(T(image((2, 20, 30), 1)), 1.5)
    counts = launch_counts()
    assert counts["resample"] == 0 and counts["gaussian_smooth"] == 0


@pytest.mark.parametrize("h,w", [(2160, 3840), (388, 584)])
def test_kernel_work_of_the_banded_passes(h, w):
    """Each pass reads its input and its table once and writes its output
    once; a multiply and an add a term and one multiply by norm an output."""
    ow, oh = w // 2 - 3, h // 3 + 1
    bx, by = resample_band(w, ow), resample_band(h, oh)
    x = R.kernel_work("banded_x", h, w, out_n=ow)
    assert x["bytes"] == 2 * (h * w + h * ow) * 4 + x_plan(((resample_band, w, ow),)).nbytes
    assert x["instructions"] == x["flops"] == 2 * h * (2 * int(bx.count.sum()) + ow)
    y = R.kernel_work("banded_y", h, ow, out_n=oh)
    assert y["bytes"] == (2 * (h * ow + oh * ow) * 4
                          + y_plan(((resample_band, h, oh),), (ow,), 2).nbytes)
    assert y["instructions"] == 2 * ow * (2 * int(by.count.sum()) + oh)
    g = R.kernel_work("banded_y", h, w, sigma=1.5)
    assert g["bytes"] == (2 * 2 * h * w * 4
                          + y_plan(((gaussian_band, h, 1.5),), (w,), 2).nbytes)
    # the frame pyramid: the pair read once by X for every level's width;
    # each level's own columns read by Y
    ws, hs = (ow, w // 5), (oh, h // 7)
    xp = R.kernel_work("banded_x", h, w, out_n=ws)
    specs_x = tuple((resample_band, w, a) for a in ws)
    assert xp["bytes"] == 2 * h * (w + sum(ws)) * 4 + x_plan(specs_x).nbytes
    yp = R.kernel_work("banded_y", h, w, out_n=hs, widths=ws)
    specs_y = tuple((resample_band, h, b) for b in hs)
    assert yp["bytes"] == (2 * sum((h + b) * a for a, b in zip(ws, hs)) * 4
                           + y_plan(specs_y, ws, 2).nbytes)
    for work in (x, y, g, xp, yp):
        assert work["bound_by"] == "bytes"
        assert work["bound_ms"] == work["bytes"] / R.PEAK_BYTES_PER_S * 1e3


@pytest.mark.parametrize("size", SCHEDULES)
def test_pair_bounds_count_every_banded_launch(size):
    """Two presmooth launches, two for the frames of every level but level 0
    (the frame pyramid), then two for the flow at every level after the
    coarsest whose size changes."""
    w, h = size
    cfg = FlowConfig()
    specs = levels(w, h)
    flows = sum((a.height, a.width) != (b.height, b.width) for a, b in zip(specs, specs[1:]))
    want = 1 + 1 + flows
    pb = R.pair_bounds(w, h, cfg)
    assert pb["banded_x"]["launches"] == pb["banded_y"]["launches"] == want
    launches = R.banded_launches(w, h, cfg)
    assert len(launches) == 2 * want
    assert pb["banded_x"]["bound_ms"] == pytest.approx(
        sum(R.kernel_work(n, lh, lw, **kw)["bound_ms"] for n, lh, lw, kw in launches
            if n == "banded_x"), rel=1e-12)
    assert R.banded_launches(w, h, FlowConfig(gaussian_sigma=0.0))[:2] == launches[2:4]


def test_profiles_name_both_passes():
    from tpuflow_torch.profile_pair import LEVEL_KERNELS

    for axis, args in (("x", "<true>"), ("x", "<false>"), ("y", "")):
        name = f"void (anonymous namespace)::banded_{axis}_kernel{args}(const float*, float*, ...)"
        assert [k for k, pattern in LEVEL_KERNELS.items() if pattern in name] == [f"banded_{axis}"]


def gradient_24x16_epe(outers=(5, 10, 20, 40, 160)) -> list:
    """[(outer, port-JAX, port-oracle, JAX-oracle)] mean EPE, gradient
    constancy, default schedule, on the 24x16 blob pair (u8 frames)."""
    import tpuflow
    from tpuflow.config import DataConstancy as JDataConstancy
    from tpuflow.config import FlowConfig as JFlowConfig
    from tpuflow_torch import compute_flow, endpoint_error
    from tpuflow_torch.config import DataConstancy

    ys, xs = np.mgrid[0:16, 0:24].astype(np.float32)
    f0, f1 = (np.clip(200.0 * np.exp(-((ys - 8) ** 2 + (xs - 12 - 0.5 * i) ** 2) / 18.0),
                      0.0, 255.0).astype(np.uint8).astype(np.float32) for i in range(2))
    rows = []
    for outer in outers:
        port = compute_flow(f0, f1, FlowConfig(data_constancy=DataConstancy.GRADIENT,
                                               outer_iterations_count=outer), device="cpu")
        jax = tpuflow.compute_flow(f0, f1, JFlowConfig(data_constancy=JDataConstancy.GRADIENT,
                                                       outer_iterations_count=outer))
        ju, jv = np.asarray(jax.u), np.asarray(jax.v)
        ou, ov = oracle_np.compute_flow(f0, f1, data_constancy="gradient",
                                        outer_iterations_count=outer)
        rows.append((outer, endpoint_error(port.u, port.v, ju, jv),
                     endpoint_error(port.u, port.v, ou, ov), endpoint_error(ju, jv, ou, ov)))
    return rows


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print("outer  port-JAX  port-oracle  JAX-oracle (mean EPE, px)")
    for outer, pj, po, jo in gradient_24x16_epe():
        print(f"{outer:5d}  {pj:.3g}  {po:.3g}  {jo:.3g}", flush=True)

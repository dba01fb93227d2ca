"""tpuflow_torch.compute_flow end to end on the CPU (the plain versions of
the kernels) against the NumPy oracle, tpuflow's XLA pipeline and tpuflow's
whole-level kernel pipeline in interpret mode, on the blob pairs of
tests/test_pipeline.py, for all three data constancies; plus physical
probes, the device contract, the textured pair of the GPU smoke run and the
profiler ranges of the layers."""

import numpy as np
import pytest
import torch

import tpuflow
import tpuflow.oracle as oracle
from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.solver.bucketed import compiled_full_pipeline

from tpuflow_torch import DataConstancy, FlowConfig, compute_flow, endpoint_error
from tpuflow_torch.profile_pair import profile_pair
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.synthetic import shift_epe, textured_pair

torch.set_num_threads(2)


def gaussian_blob(h, w, cy, cx, sigma=4.0, amp=200.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))).astype(
        np.float32)


SMALL_CFG = dict(
    warp_levels_count=3, warp_scale_factor=0.7, outer_iterations_count=6,
    inner_iterations_count=3, equation_alpha=35.0, equation_smoothness=0.001,
    equation_data=0.001, median_radius=3, gaussian_sigma=0.8,
)
WHOLE_CFG = dict(
    warp_levels_count=4, warp_scale_factor=0.6, outer_iterations_count=4,
    inner_iterations_count=3, median_radius=5, gaussian_sigma=1.0,
)


def two_blob_pair():
    h, w = 25, 31
    f0 = gaussian_blob(h, w, 12.0, 15.0) + gaussian_blob(h, w, 5.0, 6.0, 2.0, 80.0)
    f1 = gaussian_blob(h, w, 13.1, 14.2) + gaussian_blob(h, w, 6.1, 5.2, 2.0, 80.0)
    return f0, f1


def wide_blob_pair():
    h, w = 52, 60
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f0 = 200.0 * np.exp(-((ys - 26) ** 2 + (xs - 30) ** 2) / 50.0)
    f1 = 200.0 * np.exp(-((ys - 25.2) ** 2 + (xs - 31.1) ** 2) / 50.0)
    return f0.astype(np.float32), f1.astype(np.float32)


def test_matches_oracle():
    f0, f1 = two_blob_pair()
    want_u, want_v = oracle.compute_flow(f0, f1, **SMALL_CFG)
    res = compute_flow(f0, f1, FlowConfig(**SMALL_CFG), device="cpu")
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 1e-3


@pytest.mark.parametrize("pair,kw", [(two_blob_pair, SMALL_CFG), (wide_blob_pair, WHOLE_CFG)])
def test_matches_tpuflow_xla(pair, kw):
    f0, f1 = pair()
    want = tpuflow.compute_flow(f0, f1, JFlowConfig(**kw))
    res = compute_flow(f0, f1, FlowConfig(**kw), device="cpu")
    assert res.u.shape == f0.shape
    assert endpoint_error(res.u, res.v, np.asarray(want.u), np.asarray(want.v)) <= 1e-3


def test_matches_whole_level_pipeline_interpret(monkeypatch):
    # tpuflow's production pipeline with level_fused_whole in interpret mode
    # (the wiring of tests/test_pipeline.py:124-149).
    f0, f1 = wide_blob_pair()
    monkeypatch.setenv("TPUFLOW_WHOLE_LEVEL", "interpret")
    want_u, want_v = compiled_full_pipeline(f0.shape, JFlowConfig(**WHOLE_CFG),
                                            unroll=True)(f0, f1)
    res = compute_flow(f0, f1, FlowConfig(**WHOLE_CFG), device="cpu")
    assert endpoint_error(res.u, res.v, np.asarray(want_u), np.asarray(want_v)) <= 1e-3


TENSOR = ["gradient", "log"]
# The whole-level pipeline at fewer levels: each level compiles its own
# interpret-mode kernel, and that is most of the test's time.
WHOLE_TENSOR_CFG = dict(WHOLE_CFG, warp_levels_count=2, outer_iterations_count=3,
                        inner_iterations_count=2)


@pytest.mark.parametrize("constancy", TENSOR)
@pytest.mark.parametrize("pair", [two_blob_pair, wide_blob_pair])
def test_constancy_matches_oracle(pair, constancy):
    f0, f1 = pair()
    want_u, want_v = oracle.compute_flow(f0, f1, data_constancy=constancy, **SMALL_CFG)
    res = compute_flow(f0, f1, FlowConfig(data_constancy=DataConstancy(constancy), **SMALL_CFG),
                       device="cpu")
    assert np.isfinite(res.u).all() and np.isfinite(res.v).all()
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 1e-3


@pytest.mark.parametrize("constancy", TENSOR)
@pytest.mark.parametrize("pair,kw", [(two_blob_pair, SMALL_CFG), (wide_blob_pair, WHOLE_CFG)])
def test_constancy_matches_tpuflow_xla(pair, kw, constancy):
    f0, f1 = pair()
    want = tpuflow.compute_flow(f0, f1, JFlowConfig(data_constancy=JDataConstancy(constancy), **kw))
    res = compute_flow(f0, f1, FlowConfig(data_constancy=DataConstancy(constancy), **kw),
                       device="cpu")
    assert endpoint_error(res.u, res.v, np.asarray(want.u), np.asarray(want.v)) <= 1e-3


@pytest.mark.parametrize("constancy", TENSOR)
def test_constancy_matches_whole_level_pipeline_interpret(monkeypatch, constancy):
    f0, f1 = wide_blob_pair()
    monkeypatch.setenv("TPUFLOW_WHOLE_LEVEL", "interpret")
    jcfg = JFlowConfig(data_constancy=JDataConstancy(constancy), **WHOLE_TENSOR_CFG)
    want_u, want_v = compiled_full_pipeline(f0.shape, jcfg, unroll=True)(f0, f1)
    res = compute_flow(f0, f1, FlowConfig(data_constancy=DataConstancy(constancy),
                                          **WHOLE_TENSOR_CFG), device="cpu")
    assert endpoint_error(res.u, res.v, np.asarray(want_u), np.asarray(want_v)) <= 1e-3


@pytest.mark.parametrize("constancy", TENSOR)
def test_constancy_zero_motion_gives_zero_flow(constancy):
    f0, _ = two_blob_pair()
    res = compute_flow(f0, f0.copy(), FlowConfig(data_constancy=DataConstancy(constancy),
                                                 **SMALL_CFG), device="cpu")
    assert np.abs(res.u).max() < 1e-6 and np.abs(res.v).max() < 1e-6


def test_log_at_small_alpha_recovers_shift():
    # The log tensor of 8-bit frames is about 1e-3, so at alpha 35 the log
    # solve stays at zero flow; at alpha 1e-3 it recovers most of the shift.
    # The solve is then ill-conditioned: two correct float32 solvers differ
    # by about 1e-2 px mean EPE (port vs tpuflow's XLA path 0.012, vs the
    # oracle 0.013 at this size), hence the oracle bound of 0.05.
    f0, f1 = textured_pair(96, 64)
    kw = dict(warp_levels_count=6, warp_scale_factor=0.7, outer_iterations_count=10,
              inner_iterations_count=5, equation_alpha=1e-3, median_radius=5,
              gaussian_sigma=1.5)
    want_u, want_v = oracle.compute_flow(f0, f1, data_constancy="log", **kw)
    res = compute_flow(f0, f1, FlowConfig(data_constancy=DataConstancy.LOG_DERIVATIVES, **kw),
                       device="cpu")
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 0.05
    zero_flow_epe = shift_epe(0.0 * res.u, 0.0 * res.v, margin=8)
    assert shift_epe(res.u, res.v, margin=8) < 0.6 * zero_flow_epe


def test_zero_motion_gives_zero_flow():
    f0, _ = two_blob_pair()
    res = compute_flow(f0, f0.copy(), FlowConfig(**SMALL_CFG), device="cpu")
    assert np.abs(res.u).max() < 1e-6 and np.abs(res.v).max() < 1e-6


TRANSLATION_CFG = dict(warp_levels_count=5, warp_scale_factor=0.8, outer_iterations_count=20,
                       inner_iterations_count=5, equation_alpha=10.0, median_radius=3,
                       gaussian_sigma=1.0)


def translated_blob_pair():
    # A blob translated by (+1.5, -1.0) px (tests/test_pipeline.py:47-71).
    h, w = 40, 48
    return gaussian_blob(h, w, 20.0, 24.0, 5.0), gaussian_blob(h, w, 19.0, 25.5, 5.0)


def test_recovers_translation():
    f0, f1 = translated_blob_pair()
    res = compute_flow(f0, f1, FlowConfig(**TRANSLATION_CFG), device="cpu")
    core = (slice(16, 24), slice(20, 28))
    assert 1.0 < float(np.median(res.u[core])) < 2.0
    assert -1.5 < float(np.median(res.v[core])) < -0.5


def test_reversed_pair_negates_flow():
    f0, f1 = translated_blob_pair()
    cfg = FlowConfig(**TRANSLATION_CFG)
    fwd = compute_flow(f0, f1, cfg, device="cpu")
    bwd = compute_flow(f1, f0, cfg, device="cpu")
    mask = np.hypot(fwd.u, fwd.v) > 0.3
    assert mask.sum() > 50
    corr = np.corrcoef(np.concatenate([fwd.u[mask], fwd.v[mask]]),
                       np.concatenate([bwd.u[mask], bwd.v[mask]]))[0, 1]
    assert corr < -0.9


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is for machines without it")
    f0, f1 = two_blob_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow(f0, f1, FlowConfig(**SMALL_CFG))


def test_rejects_bad_frames():
    with pytest.raises(ValueError):
        compute_flow(np.zeros((8, 8)), np.zeros((8, 9)), device="cpu")
    with pytest.raises(ValueError):
        compute_flow(np.zeros((3, 8)), np.zeros((3, 8)), device="cpu")


@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False)])
def test_compute_flow_leaves_the_tf32_flags_as_the_caller_set_them(flags):
    """compute_flow turns TF32 off for its solve only, and gives both
    process-wide flags back, on return and on raise."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        f0, f1 = two_blob_pair()
        res = compute_flow(f0, f1, FlowConfig(**SMALL_CFG), device="cpu")
        assert np.isfinite(res.u).all()
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
        # frames smaller than 4x4 raise inside the solve, after the flags were switched
        with pytest.raises(ValueError, match="4x4"):
            compute_flow(np.zeros((3, 8)), np.zeros((3, 8)), device="cpu")
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_compute_flow_solves_without_tf32(monkeypatch):
    import tpuflow_torch.solver.flow2d as flow2d

    seen, real = [], flow2d.solve

    def spy(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kw)

    monkeypatch.setattr(flow2d, "solve", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    compute_flow(*two_blob_pair(), FlowConfig(**SMALL_CFG), device="cpu")
    assert seen == [(False, False)]


def test_textured_pair_is_an_exact_shift():
    f0, f1 = textured_pair(64, 48, shift=(2.0, -1.0))
    assert f0.dtype == np.float32 and f0.min() == 0.0 and f0.max() == 255.0
    np.testing.assert_allclose(f1, np.roll(f0, (-1, 2), axis=(0, 1)), atol=1e-3)
    u, v = np.full((64, 64), 1.25, np.float32), np.full((64, 64), -0.75, np.float32)
    assert shift_epe(u, v) == 0.0
    assert shift_epe(u * 0.0, v * 0.0) == pytest.approx(np.hypot(1.25, 0.75))


def test_profile_pair_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_pair(40, 30, "horn_schunck")


def test_layer_ranges_are_recorded():
    # profile_pair reads the gaussian and resample layers from these ranges:
    # one presmooth per pair, one resample of every level's frames at once
    # (the frame pyramid), and one of the flow at every level after the
    # first whose size changes.
    f0, f1 = two_blob_pair()
    cfg = FlowConfig(**SMALL_CFG)
    h0, w0 = f0.shape
    levels = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    pyramid = any(s.level != 0 and (s.width, s.height) != (w0, h0) for s in levels)
    flows = sum((a.width, a.height) != (b.width, b.height) for a, b in zip(levels, levels[1:]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        compute_flow(f0, f1, cfg, device="cpu")
    calls = {e.key: e.count for e in prof.key_averages() if e.key in ("gaussian", "resample")}
    assert pyramid and flows == len(levels) - 1
    assert calls == {"gaussian": 1, "resample": 1 + flows}

"""One pyramid level of tpuflow_torch (the plain versions of its kernels,
as the CPU runs them) against the TPU level kernels it replaces, run in
Pallas interpret mode on the same seeded numpy inputs:

  * the whole level vs ``bucketed_level_step_trim`` (``level_fused_whole``);
  * the level tail without the warp vs ``level_fused``;
  * the relaxation (du, dv) vs all five relaxation kernels:
    ``_relax_bucket_full``, ``_relax_bucket_chunked``, ``_relax_du_full``,
    ``_relax_du_chunked`` and ``_relax_du_streamed``;

for grey constancy, and for the gradient and log constancies, whose
second-order tensor the TPU kernels build in-kernel (level_fused.py:291-322)
or take through ``tensor=``.

The whole level takes its resampled frames and flow from the JAX step's
own resample (``_resample_trim``), against which the port's resample is
held within 1e-6 of max |value|.

Bounds: 1 outer x 1 inner agrees to max abs 1e-4 (the class of
tests/test_level_fused.py:205); more iterations are bounded on mean EPE
1e-3, because the lagged nonlinearity amplifies cross-program ulp noise at
phi-sensitive pixels (tests/test_level_fused.py:228), most of all for the
gradient tensor (tests/test_relax_du.py:38-42).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.ops.pallas.level_fused import level_fused
from tpuflow.ops.pallas.relax_bucket import relax_bucket_fused
from tpuflow.ops.pallas.relax_du import relax_du_fused
from tpuflow.solver.bucketed import (
    LevelScalars as JLevelScalars, _resample_trim, _trim_eff, bucket_dims,
    bucketed_level_step_trim,
    level_constants, maintain_mirror1, maintain_mirror2,
)

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops.level import level_derivs, level_tensor
from tpuflow_torch.ops.resample import resample
from tpuflow_torch.solver.level import LevelScalars, level_step, level_tail, relax

torch.set_num_threads(2)

T = torch.from_numpy


def cfgs(constancy="grey", **kw):
    return (JFlowConfig(data_constancy=JDataConstancy(constancy), **kw),
            FlowConfig(data_constancy=DataConstancy(constancy), **kw))


TENSOR = ["gradient", "log"]
# the port's resample against JAX's matmuls: the same products, summed in
# another order (tests/test_torch_banded.py)
RESAMPLE_REL = 1e-6


def max_abs(got_uv, want_u, want_v, ch, cw):
    return max(np.abs(got_uv[0][:ch, :cw] - np.asarray(want_u)[:ch, :cw]).max(),
               np.abs(got_uv[1][:ch, :cw] - np.asarray(want_v)[:ch, :cw]).max())


def mean_epe(got_uv, want_u, want_v, ch, cw):
    return np.hypot(got_uv[0][:ch, :cw] - np.asarray(want_u)[:ch, :cw],
                    got_uv[1][:ch, :cw] - np.asarray(want_v)[:ch, :cw]).mean()


# ---------------------------------------------------------------------------
# Whole level vs level_fused_whole (through bucketed_level_step_trim)
# ---------------------------------------------------------------------------


def whole_setup(seed=7, flow_scale=0.4, h0=48, w0=72, prev=(32, 21), level=(36, 24)):
    """Full-res frames at the top bucket + the previous level's trimmed flow
    (the pattern of tests/test_level_fused.py:127-159)."""
    rng = np.random.default_rng(seed)
    cw, ch = level
    prev_cw, prev_ch = prev
    h0b, w0b = top_bucket = bucket_dims(w0, h0)
    f = np.zeros((2, h0b, w0b), np.float32)
    f[:, :h0, :w0] = np.abs(rng.standard_normal((2, h0, w0))).astype(np.float32) * 60.0 + 20.0
    prev_eff = (-(-(prev_ch + 2) // 8) * 8, -(-(prev_cw + 2) // 128) * 128)
    uv_t = np.zeros((2,) + prev_eff, np.float32)
    uv_t[:, :prev_ch, :prev_cw] = (
        rng.standard_normal((2, prev_ch, prev_cw)).astype(np.float32) * flow_scale)
    return dict(f=f, uv_t=uv_t, top_bucket=top_bucket, h0=h0, w0=w0, cw=cw, ch=ch,
                prev_cw=prev_cw, prev_ch=prev_ch)


def run_whole(s, jcfg, tcfg, finest=False):
    cw, ch, w0, h0 = s["cw"], s["ch"], s["w0"], s["h0"]
    jsc = JLevelScalars.make(cw, ch, w0 / cw, h0 / ch, 35.0, w0, h0,
                             s["prev_cw"], s["prev_ch"]).tree()
    eff = _trim_eff(bucket_dims(cw, ch), jsc, jcfg)
    want_u, want_v = bucketed_level_step_trim(
        jnp.asarray(s["f"]), jnp.asarray(s["uv_t"][0]), jnp.asarray(s["uv_t"][1]),
        jsc, eff, s["top_bucket"], finest, jcfg, interpret=True)

    frames = T(np.ascontiguousarray(s["f"][:, :h0, :w0]))
    uv_prev = T(np.ascontiguousarray(s["uv_t"][:, :s["prev_ch"], :s["prev_cw"]]))
    sc = LevelScalars.make(cw, ch, w0 / cw, h0 / ch, 35.0)
    frames_l = frames if finest else resample(frames, cw, ch)
    uv_l = resample(uv_prev, cw, ch)
    # The level's inputs as the JAX step resamples them. The port's resample
    # adds each window in the reference's order (bitwise oracle_np.resample),
    # JAX's box matmuls in another; a 24 px random flow carries that last-bit
    # difference through the warp. So the port's resample is held to JAX's
    # here, and the level step is given JAX's.
    jres = np.asarray(_resample_trim(
        jnp.asarray(s["f"]), jnp.asarray(s["uv_t"][0]), jnp.asarray(s["uv_t"][1]), jsc, eff,
        s["top_bucket"], finest))[:, :ch, :cw]
    for mine, theirs in ((frames_l.numpy(), jres[:2]), (uv_l.numpy(), jres[2:])):
        assert np.abs(mine - theirs).max() <= RESAMPLE_REL * np.abs(theirs).max()
    got = level_step(T(jres[:2].copy()), T(jres[2:].copy()), sc, tcfg).numpy()
    return got, want_u, want_v


@pytest.mark.parametrize("flow_scale", [0.4, 24.0])
def test_whole_level_single_sweep(flow_scale):
    # flow_scale 24 sends the TPU path to its XLA slow tail (gather warp).
    s = whole_setup(flow_scale=flow_scale)
    jcfg, tcfg = cfgs(outer_iterations_count=1, inner_iterations_count=1, median_radius=5)
    got, wu, wv = run_whole(s, jcfg, tcfg)
    assert np.isfinite(got).all()
    assert max_abs(got, wu, wv, s["ch"], s["cw"]) <= 1e-4


@pytest.mark.parametrize("outer,inner,radius", [(3, 5, 5), (2, 2, 3)])
def test_whole_level_multi_iteration(outer, inner, radius):
    s = whole_setup()
    jcfg, tcfg = cfgs(outer_iterations_count=outer, inner_iterations_count=inner,
                      median_radius=radius)
    got, wu, wv = run_whole(s, jcfg, tcfg)
    assert mean_epe(got, wu, wv, s["ch"], s["cw"]) <= 1e-3


def test_whole_level_finest_identity():
    s = whole_setup(h0=40, w0=56, prev=(50, 36), level=(56, 40))
    jcfg, tcfg = cfgs(outer_iterations_count=2, inner_iterations_count=3, median_radius=5)
    got, wu, wv = run_whole(s, jcfg, tcfg, finest=True)
    assert mean_epe(got, wu, wv, s["ch"], s["cw"]) <= 1e-3


@pytest.mark.parametrize("constancy", TENSOR)
@pytest.mark.parametrize("flow_scale", [0.4, 24.0])
def test_whole_level_tensor_single_sweep(constancy, flow_scale):
    s = whole_setup(flow_scale=flow_scale)
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=1, inner_iterations_count=1,
                      median_radius=5)
    got, wu, wv = run_whole(s, jcfg, tcfg)
    assert np.isfinite(got).all()
    assert max_abs(got, wu, wv, s["ch"], s["cw"]) <= 1e-4


@pytest.mark.parametrize("constancy", TENSOR)
def test_whole_level_tensor_multi_iteration(constancy):
    s = whole_setup()
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=3, inner_iterations_count=5,
                      median_radius=5)
    got, wu, wv = run_whole(s, jcfg, tcfg)
    assert mean_epe(got, wu, wv, s["ch"], s["cw"]) <= 1e-3


# ---------------------------------------------------------------------------
# Level tail (no warp) vs level_fused
# ---------------------------------------------------------------------------

CW, CH, HB, WB = 101, 59, 64, 128


def tail_setup(seed=3):
    rng = np.random.default_rng(seed)

    def mk(scale, pos=False):
        a = np.zeros((HB, WB), np.float32)
        val = rng.standard_normal((CH, CW)).astype(np.float32) * scale
        a[:CH, :CW] = np.abs(val) + 1.0 if pos else val
        return jnp.asarray(a)

    f0 = maintain_mirror1(mk(20.0, True), CW, CH)
    f1 = maintain_mirror1(mk(20.0, True), CW, CH)
    u = maintain_mirror2(mk(0.5), CW, CH)
    v = maintain_mirror2(mk(0.5), CW, CH)
    return f0, f1, u, v


def run_tail(jcfg, tcfg):
    f0, f1, u, v = tail_setup()
    jsc = JLevelScalars.make(CW, CH, 1.3, 1.2, 35.0, CW, CH, CW, CH).tree()
    want_u, want_v = level_fused(f0, f1, u, v, jsc, jcfg, interpret=True)
    valid = lambda a: T(np.ascontiguousarray(np.asarray(a)[:CH, :CW]))  # noqa: E731
    uv = torch.stack([valid(u), valid(v)])
    got = level_tail(valid(f0), valid(f1), uv, LevelScalars.make(CW, CH, 1.3, 1.2, 35.0),
                     tcfg).numpy()
    return got, want_u, want_v


@pytest.mark.parametrize("radius", [1, 3, 5, 7])
def test_level_tail_single_sweep(radius):
    jcfg, tcfg = cfgs(outer_iterations_count=1, inner_iterations_count=1,
                      median_radius=radius)
    got, wu, wv = run_tail(jcfg, tcfg)
    assert max_abs(got, wu, wv, CH, CW) <= 1e-4


def test_level_tail_multi_iteration():
    jcfg, tcfg = cfgs(outer_iterations_count=3, inner_iterations_count=5, median_radius=5)
    got, wu, wv = run_tail(jcfg, tcfg)
    assert mean_epe(got, wu, wv, CH, CW) <= 1e-3


@pytest.mark.parametrize("constancy", TENSOR)
@pytest.mark.parametrize("radius", [3, 5])
def test_level_tail_tensor_single_sweep(constancy, radius):
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=1, inner_iterations_count=1,
                      median_radius=radius)
    got, wu, wv = run_tail(jcfg, tcfg)
    assert max_abs(got, wu, wv, CH, CW) <= 1e-4


@pytest.mark.parametrize("constancy", TENSOR)
def test_level_tail_tensor_multi_iteration(constancy):
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=3, inner_iterations_count=5,
                      median_radius=5)
    got, wu, wv = run_tail(jcfg, tcfg)
    assert mean_epe(got, wu, wv, CH, CW) <= 1e-3


# ---------------------------------------------------------------------------
# Relaxation (du, dv) vs _relax_bucket_full and _relax_du_chunked
# ---------------------------------------------------------------------------

RHB, RWB, RCW, RCH = 64, 128, 100, 52


def relax_inputs(seed=0):
    """The inputs of tests/test_relax_du.py:46-56."""
    rng = np.random.default_rng(seed)
    f0 = rng.random((RHB, RWB), np.float32) * 200
    f1 = rng.random((RHB, RWB), np.float32) * 200
    u = (rng.random((RHB, RWB), np.float32) - 0.5) * 2
    v = (rng.random((RHB, RWB), np.float32) - 0.5) * 2
    return (maintain_mirror1(f0, RCW, RCH), maintain_mirror1(f1, RCW, RCH),
            maintain_mirror2(u, RCW, RCH), maintain_mirror2(v, RCW, RCH))


# The five TPU relaxation kernels: (entry point, force_mode) by test kind.
RELAX_KINDS = {
    "full": (relax_bucket_fused, "full"),             # _relax_bucket_full
    "chunked": (relax_bucket_fused, "chunked"),       # _relax_bucket_chunked
    "du_full": (relax_du_fused, "full"),              # _relax_du_full
    "du_chunked": (relax_du_fused, "chunked"),        # _relax_du_chunked
    "du_streamed": (relax_du_fused, "streamed"),      # _relax_du_streamed
}


def run_relax(kind, jcfg, tcfg):
    f0, f1, u, v = relax_inputs()
    jsc = JLevelScalars.make(RCW, RCH, 1.3, 1.2, 35.0, 120, 60, 90, 48).tree()
    fx, fy, ft, J = level_constants(f0, f1, jsc, jcfg)
    grey = tcfg.data_constancy == DataConstancy.GREY
    fused, mode = RELAX_KINDS[kind]
    want_du, want_dv = fused(fx, fy, ft, u, v, jsc, jcfg, tensor=None if grey else J,
                             interpret=True, force_mode=mode)
    valid = lambda a: T(np.ascontiguousarray(np.asarray(a)[:RCH, :RCW]))  # noqa: E731
    sc = LevelScalars.make(RCW, RCH, 1.3, 1.2, 35.0)
    uv = torch.stack([valid(u), valid(v)])
    fxyz = level_derivs(valid(f0), valid(f1), sc.div4hx, sc.div4hy)
    J_t = None if grey else level_tensor(
        valid(f0), valid(f1), fxyz, sc, tcfg.data_constancy == DataConstancy.LOG_DERIVATIVES)
    got = (relax(fxyz, uv, sc, tcfg, J=J_t) - uv).numpy()
    return got, want_du, want_dv


@pytest.mark.parametrize("kind", ["full", "du_chunked", "chunked", "du_full", "du_streamed"])
def test_relax_single_sweep(kind):
    jcfg, tcfg = cfgs(outer_iterations_count=1, inner_iterations_count=1)
    got, wdu, wdv = run_relax(kind, jcfg, tcfg)
    assert max_abs(got, wdu, wdv, RCH, RCW) <= 1e-4


@pytest.mark.parametrize("kind", ["full", "du_chunked", "chunked", "du_full", "du_streamed"])
@pytest.mark.parametrize("outer,inner", [(3, 2), (2, 3)])
def test_relax_multi_iteration(kind, outer, inner):
    jcfg, tcfg = cfgs(outer_iterations_count=outer, inner_iterations_count=inner)
    got, wdu, wdv = run_relax(kind, jcfg, tcfg)
    assert mean_epe(got, wdu, wdv, RCH, RCW) <= 1e-3


# Grey is already held against full and du_chunked above.
CONSTANCY_KINDS = [("grey", k) for k in ("chunked", "du_full", "du_streamed")] + [
    (c, k) for c in TENSOR for k in RELAX_KINDS]


@pytest.mark.parametrize("constancy,kind", CONSTANCY_KINDS)
def test_relax_constancy_multi_iteration(constancy, kind):
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=3, inner_iterations_count=2)
    got, wdu, wdv = run_relax(kind, jcfg, tcfg)
    assert mean_epe(got, wdu, wdv, RCH, RCW) <= 1e-3

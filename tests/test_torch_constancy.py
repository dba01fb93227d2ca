"""The gradient and log-derivative data terms of tpuflow_torch (the plain
versions the CPU runs) against the JAX package on the same seeded numpy
inputs:

  * ``LevelScalars.hx_1``/``hy_1`` bitwise equal to JAX's;
  * the replicate shifts against ``solver_ops._shifts_edge``;
  * ``level_tensor_plain`` and ``motion_tensor`` against
    ``bucketed.level_constants`` (bucket arrays with maintained ghosts,
    the path the TPU kernels are fed from) and ``solver_ops._motion_tensor``
    (exact-size arrays), over the whole field, borders included;
  * ``outer_prologue_plain`` with a tensor: the grey products given as a
    tensor reproduce the grey prologue bitwise, and ksi stays grey.

Bound for the tensor: max abs <= 1e-5 * max|J| over the whole field. The
second differences multiply by the float64-rounded ``hx_1``; dividing by
``div2hx`` instead would differ by an ulp in places.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.ops.solver_ops import _motion_tensor, _shifts_edge
from tpuflow.solver.bucketed import LevelScalars as JLevelScalars
from tpuflow.solver.bucketed import level_constants, maintain_mirror1

from tpuflow_torch.config import DataConstancy
from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.solver_ops import (
    first_derivs, ksi_grey, motion_tensor, second_order_tensor, shifts_edge,
)
from tpuflow_torch.solver.level import LevelScalars

torch.set_num_threads(2)

T = torch.from_numpy
TENSOR = ["gradient", "log"]
# Odd valid shapes (ch, cw) inside a (64, 128) bucket, with odd spacings.
SHAPES = [((37, 101), (1.3, 1.2)), ((59, 83), (1.11, 1.37))]
HB, WB = 64, 128


def frames(h, w, seed):
    rng = np.random.default_rng(seed)
    f0 = (rng.random((h, w)) * 200.0 + 5.0).astype(np.float32)
    f1 = (rng.random((h, w)) * 200.0 + 5.0).astype(np.float32)
    return f0, f1


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("h", [1.0, 1.1111111111111112, 1.3, 7.012345, 43.5])
def test_hx1_bitwise_equal_jax(h):
    got = LevelScalars.make(30, 20, h, h * 1.07, 35.0)
    want = JLevelScalars.make(30, 20, h, h * 1.07, 35.0, 40, 30, 25, 18)
    for name in ("hx_1", "hy_1"):
        a, b = getattr(got, name), getattr(want, name)
        assert isinstance(a, np.float32)
        assert a.tobytes() == np.float32(b).tobytes(), (name, a, b)
    assert got.hx_1 == np.float32(1.0 / (2.0 * h))


def test_shifts_edge_equals_jax():
    a = np.random.default_rng(0).standard_normal((9, 13)).astype(np.float32)
    for got, want in zip(shifts_edge(T(a)), _shifts_edge(jnp.asarray(a))):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("constancy", TENSOR)
@pytest.mark.parametrize("shape,hxy", SHAPES)
def test_level_tensor_plain_matches_level_constants(constancy, shape, hxy):
    """Against the bucketed level constants on (64, 128) buckets whose
    ghost line is maintained, compared over the whole valid field."""
    (ch, cw), (hx, hy) = shape, hxy
    f0, f1 = frames(HB, WB, seed=ch)
    jf0 = maintain_mirror1(jnp.asarray(f0), cw, ch)
    jf1 = maintain_mirror1(jnp.asarray(f1), cw, ch)
    jsc = JLevelScalars.make(cw, ch, hx, hy, 35.0, 120, 60, 90, 48).tree()
    jcfg = JFlowConfig(data_constancy=JDataConstancy(constancy))
    fx, fy, ft, J_want = level_constants(jf0, jf1, jsc, jcfg)

    sc = LevelScalars.make(cw, ch, hx, hy, 35.0)
    g0 = T(np.ascontiguousarray(f0[:ch, :cw]))
    g1 = T(np.ascontiguousarray(f1[:ch, :cw]))
    fxyz = L.level_derivs_plain(g0, g1, sc.div4hx, sc.div4hy)
    for got, want in zip(fxyz, (fx, fy, ft)):
        assert got.numpy().tobytes() == np.ascontiguousarray(
            np.asarray(want)[:ch, :cw]).tobytes()
    J = L.level_tensor_plain(g0, g1, fxyz, sc, constancy == "log")
    assert J.shape == (5, ch, cw) and torch.isfinite(J).all()
    for k, want in enumerate(J_want):
        assert rel_err(J[k], np.asarray(want)[:ch, :cw]) <= 1e-5, k


@pytest.mark.parametrize("constancy", ["grey"] + TENSOR)
@pytest.mark.parametrize("shape,hxy", SHAPES)
def test_motion_tensor_matches_solver_ops(constancy, shape, hxy):
    """motion_tensor on exact-size frames against _motion_tensor."""
    (h, w), (hx, hy) = shape, hxy
    f0, f1 = frames(h, w, seed=w)
    J_want = _motion_tensor(jnp.asarray(f0), jnp.asarray(f1), hx, hy,
                            JDataConstancy(constancy))
    sc = LevelScalars.make(w, h, hx, hy, 35.0)
    fxyz, J = motion_tensor(T(f0), T(f1), sc, DataConstancy(constancy))
    assert fxyz.shape == (3, h, w) and J.shape == (5, h, w)
    for k, want in enumerate(J_want):
        assert rel_err(J[k], want) <= 1e-5, k
    # fxyz is the grey derivatives whatever the constancy (ksi reads them).
    want_fxyz = first_derivs(T(f0), T(f1), sc.div4hx, sc.div4hy)
    assert torch.equal(fxyz, want_fxyz)


def test_tensor_border_rows_replicate():
    """The stencil over derivative fields replicates at the border: a
    field that is linear in x has a second difference at the first and last
    column of half the interior's, which reflect indexing would make 0."""
    h, w = 5, 7
    gx = torch.arange(w, dtype=torch.float32).repeat(h, 1) * 2.0
    zero = torch.zeros((h, w))
    J = second_order_tensor(gx, zero, zero, np.float32(0.5), np.float32(0.5))
    fxx = torch.sqrt(J[0])  # J11 = fxx^2 with fxy = 0
    assert torch.allclose(fxx[:, 1:-1], torch.full((h, w - 2), 2.0))
    assert torch.allclose(fxx[:, [0, -1]], torch.full((h, 2), 1.0))


@pytest.mark.parametrize("constancy", TENSOR)
def test_motion_tensor_gradient_is_level_tensor(constancy):
    f0, f1 = frames(23, 31, seed=5)
    sc = LevelScalars.make(31, 23, 1.2, 1.4, 35.0)
    fxyz, J = motion_tensor(T(f0), T(f1), sc, DataConstancy(constancy))
    J2 = L.level_tensor(T(f0), T(f1), fxyz, sc, constancy == "log")
    assert torch.equal(J, J2)


def prologue_inputs(h=19, w=27, seed=2):
    rng = np.random.default_rng(seed)
    f0, f1 = frames(h, w, seed)
    uv = T((rng.standard_normal((2, h, w)) * 0.5).astype(np.float32))
    Tit = uv + T((rng.standard_normal((2, h, w)) * 0.1).astype(np.float32))
    sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
    fxyz = L.level_derivs_plain(T(f0), T(f1), sc.div4hx, sc.div4hy)
    e2 = float(np.float32(0.001) * np.float32(0.001))
    args = (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e2, e2)
    return T(f0), T(f1), uv, Tit, sc, fxyz, args


def test_prologue_with_grey_products_equals_grey_prologue():
    _, _, uv, Tit, _, fxyz, args = prologue_inputs()
    fx, fy, ft = fxyz
    J = torch.stack([fx * fx, fy * fy, fx * fy, fx * ft, fy * ft])
    grey = L.outer_prologue_plain(Tit, uv, fxyz, *args)
    tensor = L.outer_prologue_plain(Tit, uv, fxyz, *args, J=J)
    assert torch.equal(grey, tensor)


@pytest.mark.parametrize("log", [False, True])
def test_prologue_ksi_stays_grey(log):
    """The smoothness hoists do not depend on the tensor; the data hoists
    are the grey ksi times J, in the order of level_fused.py:388-392."""
    f0, f1, uv, Tit, sc, fxyz, args = prologue_inputs()
    J = L.level_tensor_plain(f0, f1, fxyz, sc, log)
    grey = L.outer_prologue_plain(Tit, uv, fxyz, *args)
    hoist = L.outer_prologue_plain(Tit, uv, fxyz, *args, J=J)
    assert torch.equal(hoist[:4], grey[:4])
    ksi = ksi_grey(*fxyz, Tit[0] - uv[0], Tit[1] - uv[1], args[5])
    sum_h = hoist[0] + hoist[1] + hoist[2] + hoist[3]
    want = [ksi * J[2], ksi * J[3], ksi * J[4], ksi * J[0] + sum_h, ksi * J[1] + sum_h]
    for got, w in zip(hoist[4:], want):
        assert torch.equal(got, w)


def test_tensor_wrappers_check_shapes_and_count_no_cpu_launch():
    f0, f1, uv, Tit, sc, fxyz, args = prologue_inputs()
    L.reset_launch_counts()
    J = L.level_tensor(f0, f1, fxyz, sc, True)
    L.outer_prologue(Tit, uv, fxyz, *args, J=J)
    assert all(n == 0 for n in L.launch_counts().values())
    with pytest.raises(ValueError):
        L.level_tensor(f0, f1, fxyz[:2], sc, False)
    with pytest.raises(ValueError):
        L.outer_prologue(Tit, uv, fxyz, *args, J=J[:4])
    with pytest.raises(ValueError):
        L.level_tensor(f0, f1[:, :-1].contiguous(), fxyz, sc, False)

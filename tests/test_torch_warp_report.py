"""compute_flow_warp_report of tpuflow_torch on the CPU: its tiers and
levels against the JAX package's on the blob pairs of
tests/test_bucketed.py:365-400, its flow bitwise compute_flow's, and the
tier predicate (solver.level.warp_tier) against the JAX package's
warp_small_pred at the window's edges and at invalid pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.solver.bucketed import compute_flow_warp_report as jax_warp_report
from tpuflow.solver.bucketed import warp_small_pred

from tpuflow_torch import FlowConfig, compute_flow, compute_flow_warp_report
from tpuflow_torch.cli import _warp_report_line
from tpuflow_torch.solver.level import WARP_MAX_DISP, warp_tier

torch.set_num_threads(2)

H, W = 72, 96
# The schedule of tests/test_bucketed.py:386-389, which tracks the motion.
CFG_KW = dict(warp_levels_count=8, warp_scale_factor=0.6, outer_iterations_count=30,
              inner_iterations_count=5, equation_alpha=10.0, median_radius=3,
              gaussian_sigma=1.5)


def blobs(dx, h=H, w=W):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (200.0 * np.exp(-((ys - 36) ** 2 + (xs - 48 - dx) ** 2) / 60.0)
            + 150.0 * np.exp(-((ys - 20) ** 2 + (xs - 20 - dx) ** 2) / 40.0)
            ).astype(np.float32)


@pytest.mark.parametrize("dx", [0.8, 6.5])
def test_report_matches_jax(dx):
    u, v, rep = compute_flow_warp_report(blobs(0), blobs(dx), FlowConfig(**CFG_KW),
                                         device="cpu")
    _, _, jrep = jax_warp_report(blobs(0), blobs(dx), JFlowConfig(**CFG_KW))
    assert rep["tiers"].dtype == np.int32
    assert rep["tiers"].tolist() == np.asarray(jrep["tiers"]).tolist()
    assert rep["levels"] == jrep["levels"]
    assert (rep["n_wide"], rep["n_gather"]) == (jrep["n_wide"], jrep["n_gather"])
    if dx < 1:
        assert (rep["tiers"] == 0).all()
    else:
        assert rep["n_wide"] >= 1


@pytest.mark.parametrize("dx", [0.8, 6.5])
def test_report_flow_bitwise_compute_flow(dx):
    cfg = FlowConfig(**CFG_KW)
    u, v, _ = compute_flow_warp_report(blobs(0), blobs(dx), cfg, device="cpu")
    res = compute_flow(blobs(0), blobs(dx), cfg, device="cpu")
    assert u.tobytes() == res.u.tobytes() and v.tobytes() == res.v.tobytes()


def jax_tier(u, v, inv_hx, inv_hy):
    h, w = u.shape
    args = (jnp.asarray(u), jnp.asarray(v), np.float32(inv_hx), np.float32(inv_hy),
            np.float32(w - 1), np.float32(h - 1))
    if bool(warp_small_pred(*args, D=WARP_MAX_DISP)):
        return 0
    return 1 if bool(warp_small_pred(*args, D=2 * WARP_MAX_DISP)) else 2


def field(kind, d, h=30, w=40):
    """A flow of the named kind: ``d`` px everywhere, at one pixel, or at
    one pixel beside NaN and out-of-bounds pixels that move further."""
    u = np.zeros((h, w), np.float32)
    v = np.zeros((h, w), np.float32)
    if kind == "uniform_u":
        u[:] = d
    elif kind == "uniform_v":
        v[:] = d
    elif kind == "one_pixel":
        u[h // 2, w // 2] = d
    elif kind == "with_invalid":
        v[h // 2, w // 2] = d
        u[0, :5] = -40.0        # out of bounds: no displacement counted
        u[3, 7] = np.nan        # NaN target: none either
        v[-1, -3:] = 500.0
    return u, v


@pytest.mark.parametrize("kind", ["uniform_u", "uniform_v", "one_pixel", "with_invalid"])
@pytest.mark.parametrize("d", [4.0, 4.5, 5.0, 8.0, 8.9, 9.0, -4.0, -4.2, -8.0, -8.5, 0.0])
@pytest.mark.parametrize("inv_h", [1.0, 1.0 / 1.7])
def test_tier_predicate_matches_jax(kind, d, inv_h):
    u, v = field(kind, d / inv_h)
    got = warp_tier(torch.from_numpy(np.stack([u, v])), np.float32(inv_h), np.float32(inv_h))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == jax_tier(u, v, inv_h, inv_h)


@pytest.mark.parametrize("d,tier", [(4.0, 0), (5.0, 1), (8.0, 1), (9.0, 2), (-4.2, 1)])
def test_tier_edges(d, tier):
    # |dxq| = floor(x + d) - x: 4 and 8 stay in their class, 5 and 9 leave it,
    # and -4.2 floors to -5
    u, v = field("uniform_u", d)
    assert int(warp_tier(torch.from_numpy(np.stack([u, v])), 1.0, 1.0)) == tier


def test_tier_of_invalid_pixels_is_zero():
    u, v = field("uniform_u", 0.0)
    u[:] = 1e4
    v[:5] = np.nan
    assert int(warp_tier(torch.from_numpy(np.stack([u, v])), 1.0, 1.0)) == 0


@pytest.mark.parametrize("tiers,want", [
    ([0, 0, 0], "every level within the ±4 px displacement class"),
    ([0, 1, 2], "1 level(s) beyond ±4 px, 1 beyond ±8 px: 20x10@tier1, 40x20@tier2"),
])
def test_report_line(tiers, want):
    report = {"tiers": np.array(tiers, np.int32), "levels": [(10, 5), (20, 10), (40, 20)],
              "n_wide": tiers.count(1), "n_gather": tiers.count(2)}
    assert _warp_report_line(report) == "warp-report: " + want

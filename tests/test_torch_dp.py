"""Data parallelism and the dp x sp hybrid of tpuflow_torch on the CPU
(``compute_flow(stack, mesh=)``, ``compute_flow_hybrid``), on meshes of
repeated "cpu" devices: bitwise per-pair ``compute_flow``, ragged stacks
included, and within mean EPE 1e-4 (tests/test_parallel.py:73-95) of the
JAX package's ``compute_flow(stack, mesh=make_mesh((2, 4)))`` and
``compute_flow_bucketed_hybrid(split_group=1)``."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.parallel.hybrid import compute_flow_bucketed_hybrid
from tpuflow.parallel.mesh import make_mesh as jax_make_mesh
from tpuflow.solver.flow2d import compute_flow as jax_compute_flow

from tpuflow_torch import (
    DataConstancy, FlowConfig, compute_flow, compute_flow_hybrid, endpoint_error, make_mesh,
)
from tpuflow_torch.parallel.hybrid import hybrid_split_level
from tpuflow_torch.pyramid import level_schedule

torch.set_num_threads(2)

# The schedule of tests/test_parallel.py:20-27.
CFG_KW = dict(warp_levels_count=3, warp_scale_factor=0.7, outer_iterations_count=4,
              inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8)


def blob(h, w, cy, cx, sigma=4.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (200.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))).astype(
        np.float32)


def make_batch(b, h, w):
    """tests/test_parallel.py:30-33, with seeded noise under the blobs."""
    rng = np.random.default_rng(b * 1000 + h)
    noise = rng.random((b, h, w), dtype=np.float32) * 10.0
    f0 = np.stack([blob(h, w, h / 2 + i, w / 2 - i) for i in range(b)]) + noise
    f1 = np.stack([blob(h, w, h / 2 + i + 0.8, w / 2 - i + 1.2) for i in range(b)]) + noise
    return f0, f1


def cpu_mesh(n_data, n_y):
    return make_mesh((n_data, n_y), ["cpu"] * (n_data * n_y))


def assert_per_pair(res, f0, f1, cfg):
    assert res.u.shape == res.v.shape == f0.shape
    for i in range(len(f0)):
        one = compute_flow(f0[i], f1[i], cfg, device="cpu")
        assert res.u[i].tobytes() == one.u.tobytes() and res.v[i].tobytes() == one.v.tobytes()


@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
@pytest.mark.parametrize("b,shape", [(4, (2, 2)), (3, (2, 2)), (5, (4, 1))])
def test_dp_bitwise_per_pair(b, shape, constancy):
    cfg = FlowConfig(data_constancy=DataConstancy(constancy), **CFG_KW)
    f0, f1 = make_batch(b, 64, 72)
    res = compute_flow(f0, f1, cfg, mesh=cpu_mesh(*shape), device="cpu")
    assert_per_pair(res, f0, f1, cfg)


@pytest.mark.parametrize("split", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("b", [4, 3])
def test_hybrid_bitwise_per_pair(b, split):
    cfg = FlowConfig(**CFG_KW)
    f0, f1 = make_batch(b, 120, 140)
    res = compute_flow_hybrid(f0, f1, cfg, mesh=cpu_mesh(2, 2), split_level=split,
                              device="cpu")
    assert_per_pair(res, f0, f1, cfg)


def test_hybrid_split_is_the_routers():
    cfg = FlowConfig()
    n = len(level_schedule(584, 388, cfg.warp_levels_count, cfg.warp_scale_factor))
    # one card, 4 shards: the first level of 64 rows or more (16 a shard)
    split = hybrid_split_level(584, 388, cfg, cpu_mesh(1, 4))
    levels = level_schedule(584, 388, cfg.warp_levels_count, cfg.warp_scale_factor)
    assert 0 < split < n and levels[split].height >= 64 > levels[split - 1].height
    with pytest.raises(ValueError, match="split_level"):
        compute_flow_hybrid(*make_batch(2, 64, 72), FlowConfig(**CFG_KW), mesh=cpu_mesh(1, 2),
                            split_level=99, device="cpu")


def test_front_door_stack_rejects_a_foreign_device():
    f0, f1 = make_batch(2, 64, 72)
    with pytest.raises(ValueError, match="mesh's device"):
        compute_flow(f0, f1, FlowConfig(**CFG_KW), mesh=cpu_mesh(2, 1), device="meta")


def test_dp_matches_jax_front_door():
    # Measured on the CPU: mean EPE 2.3e-9 to 3.0e-9 a pair.
    f0, f1 = make_batch(4, 64, 72)
    res = compute_flow(f0, f1, FlowConfig(**CFG_KW), mesh=cpu_mesh(2, 4), device="cpu")
    want = jax_compute_flow(f0, f1, JFlowConfig(**CFG_KW), mesh=jax_make_mesh((2, 4)))
    for i in range(4):
        assert endpoint_error(res.u[i], res.v[i], want.u[i], want.v[i]) <= 1e-4


def test_hybrid_matches_jax_hybrid():
    # Measured on the CPU: mean EPE 7.3e-10 to 7.9e-10 a pair.
    f0, f1 = make_batch(4, 120, 140)
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "y"))
    wu, wv = map(np.asarray, compute_flow_bucketed_hybrid(f0, f1, JFlowConfig(**CFG_KW),
                                                          mesh=jmesh, split_group=1))
    res = compute_flow_hybrid(f0, f1, FlowConfig(**CFG_KW), mesh=cpu_mesh(1, 4), split_level=1,
                              device="cpu")
    for i in range(4):
        assert endpoint_error(res.u[i], res.v[i], wu[i], wv[i]) <= 1e-4

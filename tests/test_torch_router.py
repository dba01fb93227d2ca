"""The cost model and the router of tpuflow_torch (parallel/model.py,
``plan_parallel``, ``halo="auto"``) on the CPU, against the JAX package's
model (tpuflow/parallel/model.py) and its sharded pipeline:

  * with JAX's ICIParams, no host cost per launch and one shard a card, the
    port prices the explicit route as JAX does, to 1e-12 relative, on levels
    whose rows both gates admit or both refuse;
  * the front door's decisions with the port's constants, pinned;
  * on one card the router never takes the explicit route;
  * ``compute_flow_sharded`` with ``halo="explicit"`` and ``"auto"`` within
    mean EPE 1e-4 of ``compute_flow_bucketed_sharded`` with the same halo;
  * ``report_scaling --project`` runs without a card, its measuring modes
    raise.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.parallel import model as jmodel
from tpuflow.solver.bucketed import compute_flow_bucketed_sharded

from tpuflow_torch import FlowConfig, compute_flow_sharded, make_mesh, plan_parallel
from tpuflow_torch.parallel import model
from tpuflow_torch.parallel.mesh import Mesh
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.flow2d import endpoint_error
from tpuflow_torch.tools import report_scaling

from test_torch_mesh import halo_pair
from test_torch_sharded import cfgs

torch.set_num_threads(2)

JAX_ICI = jmodel.ICIParams()
PORT_ICI = model.ICIParams(bandwidth_bytes_s=JAX_ICI.bandwidth_bytes_s,
                           hop_latency_s=JAX_ICI.hop_latency_s, dispatch_s=JAX_ICI.dispatch_s,
                           launch_s=0.0)
# (h, w, t1): rows that divide by 2, 4 and 8, where the JAX gate (hb % n_y
# == 0) and the port's (uneven splits allowed) agree, and levels both refuse
LEVELS = [(24, 32, 4.2e-5), (64, 128, 4.2e-5), (128, 256, 3.1e-4), (448, 640, 1.1e-3),
          (1088, 1920, 5.3e-3), (2176, 3968, 2.1e-2)]


@pytest.mark.parametrize("n_y", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("outer,inner", [(40, 5), (5, 3)])
def test_explicit_prices_are_jax(n_y, k, outer, inner):
    jcfg = JFlowConfig(outer_iterations_count=outer, inner_iterations_count=inner)
    cfg = FlowConfig(outer_iterations_count=outer, inner_iterations_count=inner)
    for h, w, t1 in LEVELS:
        assert model.level_comm_cost(h, w, cfg, n_y, "explicit", PORT_ICI, k) == pytest.approx(
            jmodel.level_comm_cost(h, w, jcfg, n_y, "explicit", JAX_ICI, k), rel=1e-12)
        got = model.level_sharded_time(t1, h, w, cfg, n_y, "explicit", PORT_ICI, k)
        want = jmodel.level_sharded_time(t1, h, w, jcfg, n_y, "explicit", JAX_ICI, k)
        assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)
    got = model.project_schedule(LEVELS, cfg, n_y, "explicit", PORT_ICI, k)
    want = jmodel.project_schedule(LEVELS, jcfg, n_y, "explicit", JAX_ICI, k)
    assert got.keys() == want.keys() and got["levels"] == want["levels"]
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key


def test_best_k_and_auto_with_jax_constants_on_explicit_only():
    cfg, jcfg = FlowConfig(), JFlowConfig()
    for n_y in (2, 4):
        got = model.best_k(LEVELS, cfg, n_y, "explicit", PORT_ICI)
        want = jmodel.best_k(LEVELS, jcfg, n_y, "explicit", JAX_ICI)
        assert got["k"] == want["k"] and got["tn_ms"] == pytest.approx(want["tn_ms"], rel=1e-12)
        got = model.project_schedule_auto(LEVELS, cfg, n_y, PORT_ICI, paths=("explicit",))
        want = jmodel.project_schedule_auto(LEVELS, jcfg, n_y, JAX_ICI, paths=("explicit",))
        assert got["plan"] == want["plan"]
        assert got["tn_ms"] == pytest.approx(want["tn_ms"], rel=1e-12)


def one_card(n_y, n_data=1):
    return make_mesh((n_data, n_y), "cpu")


def spread(n_y):
    """n_y shards on n_y distinct cards (no card is needed to build it)."""
    return Mesh(n_y, devices=[torch.device("cuda", i) for i in range(n_y)])


@pytest.mark.parametrize("shape,batched,mesh,route", [
    ((64, 72), False, one_card(4), "sp"),
    ((388, 584), False, one_card(4), "sp"),
    ((1080, 1920), False, one_card(4), "single"),
    ((64, 72), False, one_card(8), "single"),
    ((388, 584), False, one_card(8), "sp"),
    ((64, 72), False, spread(8), "single"),
    ((388, 584), False, spread(8), "single"),
    ((1080, 1920), False, spread(8), "single"),
    ((2160, 3840), False, spread(4), "sp"),
    ((64, 72), True, one_card(4), "dp"),
    ((1080, 1920), True, spread(8), "dp"),
    ((1080, 1920), False, one_card(1, n_data=8), "single"),
])
def test_front_door_decisions(shape, batched, mesh, route):
    """The JAX front door (tests/test_parallel.py:111-131) sends 388x584
    and 1080p single pairs to "sp" on 8 chips and 64x72 to "single".

    The port differs where its constants differ. Across cards every
    shard's launches come from one host thread (30.8 us each): at 388x584
    and 1080p the sharded level costs more host time than the whole level
    unsharded, so 8 cards stay "single", and only 4K's large levels
    shard. On one card the shards share the card, so the explicit route
    never pays; the cooperative kernel does, where it replaces about 80
    host-paced launches with one: at 388x584 and at 64x72 on 4 shards (16
    rows each), not at 1080p, whose finest level is device-bound. On 8
    shards 64 rows are 8 a shard, below the gate's 16: "single", as in
    JAX. A stack is "dp", as in JAX."""
    assert plan_parallel(shape, batched, FlowConfig(), mesh) == route


@pytest.mark.parametrize("w,h", [(584, 388), (1920, 1080), (3840, 2160)])
@pytest.mark.parametrize("n_y", [2, 4, 8])
def test_auto_never_explicit_on_one_card(w, h, n_y):
    cfg = FlowConfig()
    for s in level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor):
        assert model.plan_level(s.height, s.width, cfg, n_y, model.ONE_CARD,
                                cards=1)[0] != "explicit"


def test_estimate_is_host_paced_below_the_crossover():
    cfg = FlowConfig()
    small = model.estimate_level_t1(64, 72, cfg)
    assert small == pytest.approx(model.level_launches(cfg) * model.ONE_CARD.launch_s)
    assert model.level_launches(cfg) == 87
    big = model.estimate_level_t1(2160, 3840, cfg)
    assert big == pytest.approx(model.LEVEL_PX_S * 2160 * 3840)


def test_hybrid_projection_moves_nothing_on_one_card():
    cfg = FlowConfig()
    levels = model.rub_default_levels(584, 388, cfg)
    assert len(levels) == 47
    one = model.project_schedule_hybrid(levels, cfg, 4, cards=1)
    many = model.project_schedule_hybrid(levels, cfg, 4, ici=model.NVLINK, cards=4)
    assert one["reshard_us_per_pair"] == 0.0 < many["reshard_us_per_pair"]
    assert one["split_level"] == model.hybrid_split(levels, cfg, 4, cards=1)


@pytest.mark.parametrize("halo", ["explicit", "auto"])
def test_pipeline_matches_tpu_sharded_pipeline(halo):
    f0, f1, kw = halo_pair()
    jcfg, tcfg = cfgs(**kw)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "y"))
    want_u, want_v = map(np.asarray, compute_flow_bucketed_sharded(f0, f1, jcfg, mesh=jmesh,
                                                                   halo=halo))
    res = compute_flow_sharded(f0, f1, tcfg, mesh=make_mesh(4, ["cpu"] * 4), halo=halo,
                               device="cpu")
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 1e-4


def test_report_scaling_projects_without_a_card():
    rows = report_scaling.project(584, 388)
    paths = {(r["cards"], r["n_y"], r["path"]) for r in rows}
    assert (1, 4, "kernel") in paths and (4, 4, "auto") in paths and (8, 8, "hybrid") in paths
    assert not any(r["cards"] > 1 and r["path"].startswith("kernel") for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            report_scaling.measure(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            report_scaling.measure_link()

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
    raise;
  * on a row over processes the explicit route is priced with NCCL's
    constants beside the kernel and taken where it is the cheaper, every
    level is replicated where processes share a card, and the plan does
    not depend on the rank that computes it.
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
from tpuflow_torch.solver.sharded import sharded_plan
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
    ((388, 584), False, spread(8), "sp"),
    ((1080, 1920), False, spread(8), "sp"),
    ((2160, 3840), False, spread(4), "sp"),
    ((64, 72), True, one_card(4), "dp"),
    ((1080, 1920), True, spread(8), "dp"),
    ((1080, 1920), False, one_card(1, n_data=8), "single"),
])
def test_front_door_decisions(shape, batched, mesh, route):
    """The JAX front door (tests/test_parallel.py:111-131) sends 388x584
    and 1080p single pairs to "sp" on 8 chips and 64x72 to "single".

    The port differs where its constants differ. On one card the shards
    share the card, so the explicit route never pays; the cooperative
    kernel does, where it replaces about 80 host-paced launches with one:
    at 388x584 and at 64x72 on 4 shards (16 rows each), not at 1080p, whose
    finest level is device-bound. Across cards the kernel runs one launch a
    card with flag barriers between them, so 388x584, 1080p and 4K go "sp"
    as in JAX (the explicit route, whose every launch comes from one host
    thread, alone would keep them "single" below 4K). On 8 shards 64 rows
    are 8 a shard, below the gate's 16: "single", as in JAX. A stack is
    "dp", as in JAX."""
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
    assert one["split_level"] == next(
        i for i, (h, w, t1) in enumerate(levels)
        if model.plan_level(h, w, cfg, 4, model.ONE_CARD, t1, cards=1)[0] != "replicated")


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
    # the kernel is priced across cards too, one launch a card
    assert (4, 4, "kernel") in paths and (8, 8, "kernel+best_k") in paths
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            report_scaling.measure(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            report_scaling.measure_link()


# ---------------------------------------------------------------------------
# The kernel across cards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_y,cards", [(2, 2), (4, 4), (8, 4), (4, 2)])
def test_kernel_across_cards_is_priced_by_its_own_terms(n_y, cards):
    """The busiest card's padded rows at KERNEL_PX_S, one shard's grid syncs
    at ONE_CARD's latency, the row barriers at ROW_BARRIER_S, its owned rows'
    constants in and T out at NVLINK's rate, against one launch a card on
    the host."""
    from tpuflow_torch.parallel.halo import halo_rows
    from tpuflow_torch.parallel.halo_kernel import grid_syncs, row_barriers

    cfg, h, w, k = FlowConfig(), 2160, 3840, 1
    halo, mine = halo_rows(cfg, k), -(-n_y // cards)
    rows = mine * -(-h // n_y)
    device = (model.KERNEL_PX_S * (rows + 2 * halo * mine) * w
              + grid_syncs(cfg, 1, k) * model.ONE_CARD.hop_latency_s
              + row_barriers(cfg, n_y, cards, k) * model.ROW_BARRIER_S
              + 7 * rows * w * 4 / model.NVLINK.bandwidth_bytes_s)
    got = model.kernel_level_time(h, w, cfg, n_y, model.NVLINK, k, cards)
    assert got == pytest.approx(device, rel=1e-12)
    t, resolved = model.level_sharded_time(1.0, h, w, cfg, n_y, "kernel", model.NVLINK, k, cards)
    assert resolved == "kernel" and t == got
    # a level the gate refuses goes to the explicit route or replication
    assert model.level_sharded_time(1.0, 20, w, cfg, n_y, "kernel", model.NVLINK, k,
                                    cards)[1] == "replicated"


def test_auto_offers_the_kernel_across_cards():
    """On a row over 4 cards the router prices the kernel with the
    cross-card constants and takes it at the 4K finest level, where one
    launch a card replaces the explicit route's hundreds of launches."""
    cfg = FlowConfig()
    path, k, t = model.plan_level(2160, 3840, cfg, 4, model.NVLINK, cards=4)
    assert path == "kernel"
    assert t == pytest.approx(model.kernel_level_time(2160, 3840, cfg, 4, model.NVLINK, k, 4))
    assert t < model.level_sharded_time(model.estimate_level_t1(2160, 3840, cfg), 2160, 3840,
                                        cfg, 4, "explicit", model.NVLINK, k, 4)[0]
    plan = sharded_plan(3840, 2160, cfg, spread(4), "auto")
    assert plan[-1][2] == "kernel"


def test_kernel_comm_cost_is_stores_and_barriers_not_torch_copies():
    """The kernel's exchange is priced as stores and barriers, whatever
    ICIParams the caller holds: on one card a grid sync after each push,
    across cards two row barriers; not NVLINK's 28.4 us torch copy per
    message."""
    cfg, h, w = FlowConfig(), 1080, 1920
    row_bytes = 6 * w * 4
    for ici in (model.ONE_CARD, model.NVLINK):
        one = model.level_comm_cost(h, w, cfg, 4, "kernel", ici, 1, cards=1)
        many = model.level_comm_cost(h, w, cfg, 4, "kernel", ici, 1, cards=4)
        assert one == pytest.approx(
            5 * row_bytes / model.ONE_CARD.bandwidth_bytes_s
            + 40 * (2 * row_bytes / model.ONE_CARD.bandwidth_bytes_s
                    + model.ONE_CARD.hop_latency_s), rel=1e-12)
        assert many == pytest.approx(
            5 * row_bytes / model.NVLINK.bandwidth_bytes_s
            + 40 * (2 * row_bytes / model.NVLINK.bandwidth_bytes_s
                    + 2 * model.ROW_BARRIER_S), rel=1e-12)
    assert model.level_comm_cost(h, w, cfg, 4, "kernel", model.NVLINK) < 80 * 2.84e-5


def test_kernel_route_is_accepted_on_a_row_over_several_cards(monkeypatch):
    """halo="kernel" builds its routes over distinct cards (no card needed
    to plan; the lanes' peer access and streams, which need them, are
    recorded), one relax_sharded_kernel over the whole row per admitted
    level and one lane a card; the hybrid's split offers the kernel there
    too."""
    from tpuflow_torch.parallel.hybrid import hybrid_split_level
    from tpuflow_torch.solver import sharded

    enabled = []
    monkeypatch.setattr(sharded, "enable_peer_access", enabled.append)
    cfg = FlowConfig()
    mesh = spread(4)
    monkeypatch.setattr(mesh, "stream", lambda p: f"stream of position {p}")
    plan = sharded_plan(1920, 1080, cfg, mesh, "kernel")
    assert {r for *_, r, _ in plan} == {"kernel", "replicated"}
    solve_kw = sharded.sharded_solve(cfg, mesh, (1080, 1920), "kernel")
    cards = [torch.device("cuda", i) for i in range(4)]
    assert enabled == [cards]
    assert [(lane.device, lane.stream) for lane in solve_kw["bands"]] == [
        (cards[0], None)] + [(cards[y], f"stream of position {y}") for y in range(1, 4)]
    relax_for = solve_kw["relax_for"]
    fn = relax_for(1080, 1920)
    assert fn.func.__name__ == "relax_sharded_kernel"
    assert fn.keywords == {"mesh": mesh, "k_outer": 1, "data": 0}
    split = hybrid_split_level(3840, 2160, cfg, mesh)
    levels = level_schedule(3840, 2160, cfg.warp_levels_count, cfg.warp_scale_factor)
    assert 0 <= split < len(levels)


# ---------------------------------------------------------------------------
# Rows over processes
# ---------------------------------------------------------------------------


def processes(cards):
    """A row over len(cards) processes, one a position, on the cards named
    (by UUID; no card or process group is needed to plan on it)."""
    return Mesh(len(cards), devices=["cpu"] * len(cards), ranks=range(len(cards)), uuids=cards)


def test_link_params_over_processes_are_nccls():
    """Each route's constants, chosen in one place: the explicit route's
    messages between processes are NCCL's; the kernel's stores stay
    NVLINK's; on one card every route's are ONE_CARD's."""
    assert model.link_params(4, "explicit", processes=True) is model.NCCL
    assert model.link_params(4, "kernel", processes=True) is model.NVLINK
    assert model.link_params(4, "explicit") is model.NVLINK is model.link_params(4)
    assert model.link_params(1, "explicit", True) is model.ONE_CARD


@pytest.mark.parametrize("n_y", [2, 4])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_explicit_over_processes_is_priced_by_its_messages(k, n_y):
    """Every process holds the fields: one batch an exchange after the
    first (T's halo with its neighbours), the owned rows gathered at the
    end (one batch with every other process), each at ``dispatch_s`` (what
    an exchange costs the route, measured with one neighbour and two) and
    its bytes; one shard's launches on each process's host thread."""
    from tpuflow_torch.parallel.halo import halo_rows

    cfg, h, w, ici = FlowConfig(), 2160, 3840, model.NCCL
    row_bytes = halo_rows(cfg, k) * w * 4
    exchange = ici.dispatch_s + 2 * row_bytes / ici.bandwidth_bytes_s
    gather = ici.dispatch_s + 2 * (n_y - 1) * -(-h // n_y) * w * 4 / ici.bandwidth_bytes_s
    want = (-(-40 // k) - 1) * exchange + gather
    got = model.level_comm_cost(h, w, cfg, n_y, "explicit", ici, k, processes=True)
    assert got == pytest.approx(want, rel=1e-12)
    t1 = model.estimate_level_t1(h, w, cfg, ici)
    t, resolved = model.level_sharded_time(t1, h, w, cfg, n_y, "explicit", ici, k, n_y,
                                           processes=True)
    compute = t1 * (h // n_y + 2 * halo_rows(cfg, k)) / h
    assert resolved == "explicit"
    assert t == pytest.approx(max(compute, model.relax_launches(cfg) * ici.launch_s) + want)
    # the router prices each route with its own constants: the kernel with
    # NVLINK's, as in one process, the explicit route with NCCL's
    kernel = model.level_sharded_time(t1, h, w, cfg, n_y, "kernel", model.NVLINK, k, n_y,
                                      processes=True)[0]
    assert kernel == model.kernel_level_time(h, w, cfg, n_y, model.NVLINK, k, n_y)
    best = min((kernel, "kernel"), (t, "explicit"), (t1, "replicated"))
    assert model.plan_level(h, w, cfg, n_y, t1=t1, ks=(k,), cards=n_y,
                            processes=True)[::2] == (best[1], best[0])


@pytest.mark.parametrize("n_y", [2, 4])
def test_auto_over_processes_on_distinct_cards_can_choose_explicit(n_y):
    """On a row of processes one a card, the router prices the explicit
    route with NCCL's constants beside the kernel, and takes it where it is
    the cheaper: on two processes, the fine levels of a 4K full_model()
    pair at a large k, where each process issues one shard's launches and
    few exchanges; on four, where the kernel's padded rows shrink with the
    shards and an exchange costs the same, the kernel everywhere."""
    cfg = models_full()
    mesh = processes([f"c{i}" for i in range(n_y)])
    plan = sharded_plan(3840, 2160, cfg, mesh, "auto")
    routes = {route for _, _, route, _ in plan}
    assert "kernel" in routes and ("explicit" in routes) == (n_y == 2)
    for h, w, route, k in plan:
        want = model.plan_level(h, w, cfg, n_y, cards=n_y, processes=True)
        assert (route, k) == want[:2]
    assert plan[-1][2] == ("explicit" if n_y == 2 else "kernel")


def test_auto_over_processes_replicates_where_processes_share_a_card():
    cfg = models_full()
    for cards in (["c0", "c0", "c1", "c1"], ["c0", "c0"]):
        plan = sharded_plan(3840, 2160, cfg, processes(cards), "auto")
        assert {route for *_, route, _ in plan} == {"replicated"}
    # a row of distinct cards beside processes that share one: NCCL's
    # communicator spans every process, so the explicit route is not offered
    mesh = Mesh(2, n_data=2, devices=["cpu"] * 4, ranks=range(4), uuids=["c0", "c1", "c2", "c2"])
    assert {route for *_, route, _ in sharded_plan(3840, 2160, cfg, mesh, "auto")} <= {
        "kernel", "replicated"}


def test_the_plan_over_processes_is_a_function_of_shape_config_and_constants(monkeypatch):
    """Every process computes the same plan: it reads the shape, the config,
    the cards by UUID and the constants, not the rank that asks."""
    from tpuflow_torch.parallel import mesh as mesh_mod

    cfg = models_full()
    plans = []
    for rank in range(2):
        monkeypatch.setattr(mesh_mod, "process_rank", lambda r=rank: (r, 2))
        plans.append(sharded_plan(3840, 2160, cfg, processes(["c0", "c1"]), "auto"))
    assert all(p == plans[0] for p in plans)
    # the same inputs with a dearer NCCL message give another plan
    monkeypatch.setattr(model, "NCCL", model.ICIParams(
        bandwidth_bytes_s=model.NCCL.bandwidth_bytes_s, hop_latency_s=model.NCCL.hop_latency_s,
        dispatch_s=1.0))
    dear = sharded_plan(3840, 2160, cfg, processes(["c0", "c1"]), "auto")
    assert "explicit" not in {route for *_, route, _ in dear} and dear != plans[0]


@pytest.mark.parametrize("cards,sharded", [(["c0", "c1"], True), (["c0", "c0"], False)])
def test_hybrid_split_over_processes_is_the_routers_first_sharded_level(cards, sharded):
    """The hybrid's split on a row over processes is the first level that
    the router (NCCL's constants for the explicit route) shards; where the
    processes share a card it replicates every level, so phase A runs
    them all."""
    from tpuflow_torch.parallel.hybrid import hybrid_split_level

    cfg = models_full()
    mesh = processes(cards)
    plan = sharded_plan(3840, 2160, cfg, mesh, "auto")
    split = hybrid_split_level(3840, 2160, cfg, mesh)
    assert split == next((i for i, (*_, route, _) in enumerate(plan) if route != "replicated"),
                         len(plan))
    assert (split < len(plan)) == sharded


def models_full():
    from tpuflow_torch import models

    return models.full_model()

"""The explicit route's levels and the hybrid's fine part by lanes, one
process over several cards, on the CPU.

The lanes (``solve(..., bands=lanes)``, one a card) step a suffix of
sharded levels, kernel and explicit alike. An explicit level copies each
shard's padded block in from its own card's fields and gives each card
its own T: its shards' owned rows, and, as peer copies, the other shards'
owned rows that its add + median reads (``LevelRows.T``). Held here:

  * the NaN-poisoned emulation (``bands.emulate_lanes``: every banded stage
    into a buffer of NaN outside the lane's plan, an explicit level relaxed
    over each lane's padded blocks, each lane's T only the rows the
    explicit route gives it) bitwise the whole solve on the explicit route
    at k = 1 and 2, for grey, gradient and log, over 2 and 4 lanes and over
    cards holding several shards, and on plans mixing kernel and explicit
    levels; a lane given one padded row less than it reads gets another
    flow;
  * ``relax_sharded_explicit`` with one field set a card on CPU tensors:
    one T a card, each card's rows bitwise ``relax_sharded``'s, NaN outside
    a card's padded blocks changes nothing, copies and peer copies exact;
  * ``compute_flow_sharded(halo="explicit")``, and ``"auto"`` with explicit
    levels, and ``compute_flow_hybrid`` on a one-process row of four CPU
    "cards" (``CpuCards``): bitwise ``compute_flow``, each lane's rows its
    plan's, the peer copies ``bands.lane_copies``;
  * against the JAX package on its 8-device CPU mesh: within mean EPE 1e-4
    (the bound of tests/test_torch_dp.py) of ``compute_flow_bucketed_hybrid``
    and of ``compute_flow_bucketed_sharded(halo="explicit")`` at k = 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.parallel.hybrid import compute_flow_bucketed_hybrid
from tpuflow.solver.bucketed import compute_flow_bucketed_sharded

from tpuflow_torch import (
    compute_flow, compute_flow_hybrid, compute_flow_sharded, endpoint_error, models,
)
from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops import level as L
from tpuflow_torch.parallel.halo import (
    card_copies, card_rows, explicit_copies, halo_applicable, halo_rows, relax_sharded,
    relax_sharded_explicit, row_split,
)
from tpuflow_torch.parallel.mesh import Mesh, peer_copy
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver import sharded
from tpuflow_torch.solver.bands import lane_copies, level_rows, stage_rows
from tpuflow_torch.synthetic import textured_frames

from test_torch_bands import (
    CONSTANCIES, NAN, CpuCards, H, W, cfg_of, lane_routes, level_fields, routes,
    run_lanes, same,
)
from test_torch_dp import CFG_KW, make_batch
from test_torch_mesh import halo_pair
from test_torch_sharded import cfgs

torch.set_num_threads(2)


def check_lanes(cfg, rts, n, groups=None):
    """run_lanes, then: the flow bitwise the whole solve, each lane's rows
    its plan's, the peer copies ``lane_copies``; returns the plans."""
    flow, plans, rows, peers, whole = run_lanes(cfg, rts, n, groups)
    assert same(flow, whole)
    for i, plan in enumerate(plans):
        assert rows[i] == stage_rows(W, H, cfg, plan, prefix=i == 0)
    assert peers == tuple(lane_copies(W, H, cfg, plans).values())
    return plans


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_explicit_lane_emulation_is_bitwise_the_whole_solve(constancy, n, k):
    """The explicit route's levels by lanes, NaN outside each lane's plan
    and outside the rows of T each lane gets: bitwise the whole solve, each
    lane's rows its plan's (fewer than the whole field's), the peer copies
    the pair, the entry rows, T's rows across cards and the gather."""
    cfg = cfg_of(constancy, **({"equation_alpha": 1e-3} if constancy == "log" else {}))
    rts = routes(cfg, n, "explicit", k)
    plans = check_lanes(cfg, rts, n)
    assert {route for route, _ in plans[0].routes} == {"explicit"}
    assert stage_rows(W, H, cfg, plans[1], prefix=False)["warp"] < stage_rows(
        W, H, cfg, None)["warp"]


@pytest.mark.parametrize("groups", [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0,), (1, 2, 3))])
def test_explicit_lanes_of_cards_holding_several_shards(groups):
    """A card holding several shards: its plan the hull of theirs, its
    shards' blocks from its own fields, its T their owned rows and the
    other cards' rows it reads; bitwise, rows and peer copies exact."""
    cfg = cfg_of("gradient")
    plans = check_lanes(cfg, routes(cfg, 4, "explicit", 1), 4, groups)
    assert [plan.shards for plan in plans] == list(groups)


MIXES = [
    [("replicated", 1), ("kernel", 1), ("explicit", 1), ("kernel", 1)],
    [("replicated", 1), ("explicit", 2), ("kernel", 1), ("explicit", 1)],
]


@pytest.mark.parametrize("mix", [0, 1])
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_a_mixed_plan_of_kernel_and_explicit_levels(constancy, mix):
    """Kernel and explicit levels in one suffix: one relaxation call a level
    on its route, every lane's fields; bitwise, rows and peer copies."""
    cfg = cfg_of(constancy, warp_levels_count=4,
                 **({"equation_alpha": 1e-3} if constancy == "log" else {}))
    plans = check_lanes(cfg, MIXES[mix], 2)
    assert plans[0].start == 1 and plans[0].routes == tuple(MIXES[mix][1:])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("field,cut,changes", [("T", 1, True), ("copy_in", 1, False),
                                               ("copy_in", 2, False), ("copy_in", 3, True)])
@pytest.mark.parametrize("lane,side", [(1, "top"), (0, "bottom")])
def test_a_lane_short_of_a_padded_row_gets_another_flow(monkeypatch, lane, side, field, cut,
                                                        changes, k):
    """The poison's teeth on the explicit route, at the finest level, for
    grey (median radius 3, inner 3): a lane given one row less of T than
    its add + median reads gets a flow that is not the whole solve's. Of
    the padded block's fxyz and J (its relaxation's copy-in), the two
    outermost rows never reach the owned rows: the cut edge's garbage and
    these rows move inner - 1 rows into the block in the outer that reads
    them, and each exchange puts true rows back into T's halo. So one and
    two rows less leave the flow bitwise, three rows less change it."""
    from tpuflow_torch.solver import bands

    cfg = cfg_of("grey")
    rts = routes(cfg, 2, "explicit", k)
    real = bands.lane_plans

    def short(*args):
        plans = list(real(*args))
        plan = plans[lane]
        lv = plan.levels[-1]
        lo, hi = getattr(lv, "T" if field == "T" else "J")
        rows = (lo + cut, hi) if side == "top" else (lo, hi - cut)
        lv = (dataclasses.replace(lv, T=rows) if field == "T"
              else dataclasses.replace(lv, J=rows, fxyz=rows))
        plans[lane] = dataclasses.replace(plan, levels=plan.levels[:-1] + (lv,))
        return tuple(plans)

    monkeypatch.setattr(bands, "lane_plans", short)
    for fill in (NAN, 1e30):
        flow, plans, _, _, whole = run_lanes(cfg, rts, 2, fill=fill)
        lv = plans[lane].levels[-1]
        assert lv.J[0] > 0 if side == "top" else lv.J[1] < H
        assert same(flow, whole) != changes, fill


class GroupCards(Mesh):
    """A one-process row whose CPU positions form cards of ``GROUPS``."""

    GROUPS = ((0, 2), (1, 3))

    def row_cards(self, data: int = 0) -> int:
        return len(self.GROUPS)

    def row_groups(self, data: int = 0):
        return [(self.devices[self.row(data)[ys[0]]], ys) for ys in self.GROUPS]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mesh_of", [CpuCards, GroupCards])
def test_tuple_form_of_the_explicit_route_on_cpu_tensors(mesh_of, k):
    """``relax_sharded_explicit`` given one field set a card: one T a card,
    whose own shards' owned rows and the other shards' rows inside its
    ``rows`` entry are bitwise ``relax_sharded``'s, every other row left
    unwritten; NaN outside a card's padded blocks changes nothing; the
    copies are ``explicit_copies``, the peer copies ``card_copies``; a
    count of field sets or rows that is not the row's cards raises."""
    cfg = cfg_of("gradient")
    h, w = 72, 40
    f0, f1, uv, _, sc = level_fields(h, w, 5)
    fxyz = L.level_derivs_plain(f0, f1, sc.div4hx, sc.div4hy)
    J = L.level_tensor_plain(f0, f1, fxyz, sc, False)
    mesh = mesh_of(4, "cpu")
    groups = mesh.row_groups()
    split = row_split(h, 4, halo_rows(cfg, k))
    want = relax_sharded(fxyz, uv, sc, cfg, Mesh(4, "cpu"), k, J)

    def copies(x):
        """Each card's copy of x: its shards' padded blocks, NaN elsewhere."""
        out = []
        for _, ys in groups:
            c = torch.full_like(x, NAN)
            for y in ys:
                c[:, split[y].first:split[y].first + split[y].padded] = \
                    x[:, split[y].first:split[y].first + split[y].padded]
            out.append(c)
        return tuple(out)

    needs = [(max(0, split[ys[0]].row0 - 3), min(h, split[ys[-1]].row0 + split[ys[-1]].rows + 3))
             for _, ys in groups]
    relax_sharded_explicit.copies = peer_copy.messages = peer_copy.bytes = 0
    got = relax_sharded_explicit(copies(fxyz), copies(uv), sc, cfg, mesh, k, J=copies(J),
                                 rows=needs)
    assert isinstance(got, tuple) and len(got) == len(groups)
    for T, (_, ys), need in zip(got, groups, needs):
        written = torch.zeros(h, dtype=torch.bool)
        for s, lo, hi in card_rows(split, ys, need):
            assert same(T[:, lo:hi], want[:, lo:hi])
            written[lo:hi] = True
        assert all(written[split[y].row0:split[y].row0 + split[y].rows].all() for y in ys)
        assert written.sum() < h or len(groups) == 1
    assert relax_sharded_explicit.copies == explicit_copies(h, cfg, 4, k, True)
    assert {"messages": peer_copy.messages, "bytes": peer_copy.bytes} == card_copies(
        split, [ys for _, ys in groups], needs, w)
    whole = relax_sharded_explicit(copies(fxyz), copies(uv), sc, cfg, mesh, k, J=copies(J))
    assert all(same(T, want) for T in whole)
    with pytest.raises(ValueError, match="one tensor a card"):
        relax_sharded_explicit((fxyz,), (uv,), sc, cfg, mesh, k, J=(J,))
    with pytest.raises(ValueError, match="one \\(lo, hi\\) a card"):
        relax_sharded_explicit(copies(fxyz), copies(uv), sc, cfg, mesh, k, J=copies(J),
                               rows=needs[:1])


SIZE = (160, 128)


def reduced():
    return dataclasses.replace(models.full_model(), warp_levels_count=6,
                               outer_iterations_count=6)


def mixed_router(h, w, cfg, n_y, **_):
    """A router that mixes the explicit route and the kernel over the levels
    the gate admits, by the parity of a quarter of their height."""
    if not halo_applicable(h, n_y, cfg, 1):
        return "replicated", 1, None
    return ("explicit" if h // 4 % 2 else "kernel"), 1, None


def lane_counts(w, h, cfg, mesh, halo, k=1):
    """Each lane's rows against its plan's, and the peer copies against
    ``lane_copies``, after a pair's run; returns the lanes."""
    lanes = sharded.sharded_lanes(w, h, cfg, mesh, halo, k)
    assert [lane.plan.shards for lane in lanes] == [(0,), (1,), (2,), (3,)]
    for i, lane in enumerate(lanes):
        assert L.row_counts(i) == stage_rows(w, h, cfg, lane.plan, prefix=i == 0)
    assert lane_copies(w, h, cfg, [lane.plan for lane in lanes]) == {
        "messages": peer_copy.messages, "bytes": peer_copy.bytes}
    return lanes


@pytest.mark.parametrize("halo,k", [("explicit", 1), ("explicit", 2), ("auto", 1)])
def test_compute_flow_sharded_explicit_by_lanes_on_cpu_cards(monkeypatch, halo, k):
    """``compute_flow_sharded`` on a one-process row of four CPU "cards":
    the explicit route, and ``"auto"`` whose plan mixes explicit and kernel
    levels, by lanes; bitwise ``compute_flow``, each lane's rows its plan's,
    the peer copies ``lane_copies``, the explicit route's copies
    ``explicit_copies`` at each of its levels."""
    if halo == "auto":
        monkeypatch.setattr(sharded, "plan_level", mixed_router)
    w, h = SIZE
    cfg = reduced()
    f0, f1 = textured_frames(w, h, [(0.0, 0.0), (1.25, -0.75)])
    base = compute_flow(f0, f1, cfg, device="cpu")
    mesh = CpuCards(4, "cpu")
    sharded.reset_launch_counts()
    res = compute_flow_sharded(f0, f1, cfg, mesh=mesh, halo=halo, k_outer=k, device="cpu")
    assert res.u.tobytes() == base.u.tobytes() and res.v.tobytes() == base.v.tobytes()
    lanes = lane_counts(w, h, cfg, mesh, halo, k)
    plan = lanes[0].plan
    explicit = [p for p in range(plan.start, len(plan.levels) + plan.start)
                if plan.route(p)[0] == "explicit"]
    assert explicit and (halo == "explicit" or len(explicit) < len(plan.levels))
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    assert relax_sharded_explicit.copies == sum(
        explicit_copies(specs[p].height, cfg, 4, plan.route(p)[1], True) for p in explicit)


@pytest.mark.parametrize("router", ["model", "mixed"])
@pytest.mark.parametrize("split", [None, 0, 1, "last", "past"])
def test_hybrid_fine_part_by_lanes_on_cpu_cards(monkeypatch, split, router):
    """``compute_flow_hybrid`` on a one-process (1, 4) row of CPU "cards":
    phase B through ``sharded_solve``'s lanes from the split on, at the
    router's split and at 0, 1, the finest level and past it. Each pair is
    bitwise its own ``compute_flow``; each lane's rows are its plan's over
    the levels from the split (the first lane's also phase A's whole
    levels); the peer copies are ``lane_copies`` from the split, a pair
    each; past the finest level none."""
    from tpuflow_torch.parallel.hybrid import hybrid_split_level

    if router == "mixed":
        monkeypatch.setattr(sharded, "plan_level", mixed_router)
    w, h = SIZE
    cfg = reduced()
    frames = np.stack(textured_frames(w, h, [(0.5 * i, -0.3 * i) for i in range(5)]))
    F0, F1 = frames[:-1], frames[1:]
    mesh = CpuCards(4, "cpu")
    n = len(level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor))
    g0 = {None: hybrid_split_level(w, h, cfg, mesh), "last": n - 1, "past": n}.get(split, split)
    sharded.reset_launch_counts()
    res = compute_flow_hybrid(F0, F1, cfg, mesh=mesh, split_level=None if split is None else g0,
                              device="cpu")
    rows = [L.row_counts(i) for i in range(4)]
    peers = {"messages": peer_copy.messages, "bytes": peer_copy.bytes}
    for i in range(len(F0)):
        one = compute_flow(F0[i], F1[i], cfg, device="cpu")
        assert res.u[i].tobytes() == one.u.tobytes() and res.v[i].tobytes() == one.v.tobytes()
    lanes = sharded.sharded_lanes(w, h, cfg, mesh, "auto")
    plans = [lane.plan for lane in lanes]
    b, fine = len(F0), range(g0, n)
    for i, plan in enumerate(plans):
        want = stage_rows(w, h, cfg, plan, prefix=i == 0, levels=fine)
        if i == 0:
            coarse = stage_rows(w, h, cfg, None, levels=range(g0))
            want = {s: want[s] + coarse[s] for s in want}
        assert rows[i] == {s: b * v for s, v in want.items()}
    want = lane_copies(w, h, cfg, plans, start=g0)
    assert peers == {key: b * v for key, v in want.items()}
    assert (want["messages"] == 0) == (g0 == n)


def test_hybrid_by_lanes_within_the_bound_of_the_jax_hybrid():
    """The one-process hybrid by lanes on four CPU "cards" against the JAX
    package's ``compute_flow_bucketed_hybrid`` on four of its CPU devices,
    split at the first level (tests/test_torch_dp.py's case): mean EPE
    within 1e-4 a pair."""
    f0, f1 = make_batch(4, 120, 140)
    mesh = CpuCards(4, "cpu")
    assert sharded.sharded_lanes(140, 120, FlowConfig(**CFG_KW), mesh, "auto") is not None
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "y"))
    wu, wv = map(np.asarray, compute_flow_bucketed_hybrid(f0, f1, JFlowConfig(**CFG_KW),
                                                          mesh=jmesh, split_group=1))
    res = compute_flow_hybrid(f0, f1, FlowConfig(**CFG_KW), mesh=mesh, split_level=1,
                              device="cpu")
    for i in range(4):
        assert endpoint_error(res.u[i], res.v[i], wu[i], wv[i]) <= 1e-4


def test_explicit_lanes_within_the_bound_of_the_jax_explicit_pipeline():
    """``compute_flow_sharded(halo="explicit")`` at k = 1 by lanes on four
    CPU "cards" against the JAX package's
    ``compute_flow_bucketed_sharded(halo="explicit")`` on its (2, 4) CPU
    mesh (tests/test_torch_router.py's case): mean EPE within 1e-4."""
    f0, f1, kw = halo_pair()
    jcfg, tcfg = cfgs(**kw)
    mesh = CpuCards(4, "cpu")
    h, w = f0.shape
    assert sharded.sharded_lanes(w, h, tcfg, mesh, "explicit") is not None
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "y"))
    want_u, want_v = map(np.asarray, compute_flow_bucketed_sharded(f0, f1, jcfg, mesh=jmesh,
                                                                   halo="explicit"))
    res = compute_flow_sharded(f0, f1, tcfg, mesh=mesh, halo="explicit", device="cpu")
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 1e-4


def test_the_rows_of_T_are_what_add_median_reads():
    """``LevelRows.T``: the median rows widened by the median's half window,
    mirrored at the level's edges, inside the resampled flow's rows."""
    cfg = cfg_of("grey", median_radius=5)
    for h in (40, 64):
        for median in ((0, 5), (10, 20), (h - 3, h)):
            lv = level_rows(h, median, (median[0], median[1]), cfg)
            assert lv.T == (max(0, median[0] - 2), min(h, median[1] + 2))
            assert lv.uv[0] <= lv.T[0] < lv.T[1] <= lv.uv[1]
    assert lane_routes(cfg, 4, "explicit")[-1][0] == "explicit"

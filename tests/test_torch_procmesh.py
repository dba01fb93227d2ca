"""Meshes over processes on the CPU: 2 and 3 gloo processes, one position
each, through ``initialize_distributed`` (the port of
tests/test_multihost.py:59-73, at a reduced schedule on 96x64 frames).

Each worker builds ``make_mesh`` over the group (cards by UUID faked: one
card a process, and two processes a card), solves a stack on ``(world, 1)`` (dp: pair i on data row
i % world) and one pair on the row ``(1, world)`` (the plain twin of the
sharded kernel across processes, halos and T's rows exchanged by messages
over the gloo group) at k = 1 and 2 and by the router, grey and gradient
(``full_model()``'s constancy); the explicit route on the row at k = 1 and
2 (halos and owned rows as point-to-point messages on the default group,
here gloo), and by the router with the explicit route made the cheap one;
the hybrid on ``(1, world)`` (each pair's working set sent to the row) and
``(world, 1)``. It holds each against its own one-process ``compute_flow``
and ``relax_sharded``, bitwise; it checks that every process takes the
same router plan, and what raises over processes: with the backend faked
as NCCL, the explicit route and a hybrid that moves pairs where two
processes share a (faked) card. On a row over processes with a card each,
every process computes only its plan's rows of each whole-field stage of
the sharded levels (``solver.bands``) and the finest flow is gathered once:
the workers count the rows of each stage and the messages; where the
processes share a card under NCCL they take the whole-field path; a stack
runs on the row, and on (2, 2) over four processes. The workers import no JAX: the parent
holds their flows within the sharded pipeline's bound of the JAX package
(tests/test_torch_sharded.py: mean EPE 1e-5, max 1e-4) against
``compute_flow_bucketed_batch``.
"""

import ctypes
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.solver.bucketed import compute_flow_bucketed_batch

from tpuflow_torch.parallel.mesh import Mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(warp_levels_count=3, warp_scale_factor=0.7, outer_iterations_count=4,
          inner_iterations_count=3, median_radius=3, gaussian_sigma=0.8)
B, H, W = 4, 64, 96
CONSTANCIES = ("grey", "gradient")
ROUTES = ("k1", "k2", "auto", "explicit_k1", "explicit_k2", "auto_explicit")
TIMEOUT_S = 120

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

from tpuflow_torch import (
    DataConstancy, FlowConfig, compute_flow, compute_flow_hybrid, compute_flow_sharded,
    make_mesh,
)
from tpuflow_torch.ops.level import level_derivs, level_tensor, reset_row_counts, row_counts
from tpuflow_torch.parallel import Mesh, group, mesh as mesh_mod, model
from tpuflow_torch.parallel import relax_sharded, relax_sharded_explicit, relax_sharded_kernel
from tpuflow_torch.parallel.halo import explicit_copies, explicit_sends
from tpuflow_torch.parallel.multihost import initialize_distributed, process_sequence
from tpuflow_torch.solver.level import LevelScalars, relax
from tpuflow_torch.parallel.hybrid import hybrid_moves, hybrid_split_level
from tpuflow_torch.solver.bands import stage_rows
from tpuflow_torch.solver.sharded import sharded_bands, sharded_plan

port, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
KW = json.loads(sys.argv[5])
torch.set_num_threads(1)
initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank)
data = np.load(os.path.join(out, "inputs.npz"))
F0, F1 = data["F0"], data["F1"]
cfgs = {c: FlowConfig(data_constancy=DataConstancy(c), **KW) for c in ("grey", "gradient")}
res, meta = {}, {}
GATHER = 2 * (world - 1)   # the finest flow's owned rows: two planes to each other process


# run ``run``, a pair on ``mesh``'s row with ``halo`` at ``k``, with the rows
# and sends counted from 0: its flow, the path its plan takes, the rows each
# row stage computed beside the plan's, and its sends beside the explicit
# route's and the one gather of the band path
def banded(key, run, cfg, mesh, halo, k=1):
    h, w = F0.shape[1:]
    plan = sharded_bands(w, h, cfg, mesh, halo, k)
    reset_row_counts()
    group.row_exchange.sends = 0
    got = run()
    res[f"{key}_u"], res[f"{key}_v"] = got.u, got.v
    meta[f"{key}_path"] = "whole" if plan is None else "banded"
    meta[f"{key}_rows"] = [row_counts(), stage_rows(w, h, cfg, plan), stage_rows(w, h, cfg, None)]
    sends = sum(explicit_sends(cfg, world, kk, rank)
                for _, _, route, kk in sharded_plan(w, h, cfg, mesh, halo, k)
                if route == "explicit")
    meta[f"{key}_sends"] = [group.row_exchange.sends, sends + GATHER * (plan is not None)]
    return got


def layout(m):
    return {"ranks": list(m.ranks), "local": list(m.local_positions()), "cards": m.cards,
            "row_cards": m.row_cards(m.local_row()), "spans": m.spans_processes,
            "row_spans": m.row_spans_processes(m.local_row()), "local_row": m.local_row(),
            "shape": [m.n_data, m.n_y], "devices": [str(d) for d in m.devices]}


# the CPU has no card UUIDs: fake them, one card a process, and then ranks 0
# and 1 on one card, 2 on another
mesh_mod.device_uuid = lambda device: f"card{dist.get_rank()}"
row, dp = make_mesh(device="cpu"), make_mesh((world, 1), "cpu")
meta["equal"] = row == make_mesh((1, world), "cpu") and row != dp
mesh_mod.device_uuid = lambda device: f"card{dist.get_rank() // 2}"
shared = make_mesh(device="cpu")
meta["equal"] &= row != shared and hash(row) != hash(shared)
meta["row"], meta["dp"], meta["shared"] = layout(row), layout(dp), layout(shared)

# dp: this process's pairs, and its one-process compute_flow of every pair
r = compute_flow(F0, F1, cfgs["grey"], mesh=dp, device="cpu")
meta["dp_pairs"] = list(r.pairs)
res["dp_u"], res["dp_v"] = r.u, r.v
for i in range(len(F0)):
    one = compute_flow(F0[i], F1[i], cfgs["grey"], device="cpu")
    res[f"dp_ref_u{i}"], res[f"dp_ref_v{i}"] = one.u, one.v



# this process's sends in compute_flow_hybrid: its pairs' working sets to
# their rows, and the explicit route's sends in its row's fine levels
def hybrid_sends(mesh, cfg):
    h, w = F0.shape[1:]
    g0, me, data = hybrid_split_level(w, h, cfg, mesh), mesh.local_positions()[0], mesh.local_row()
    sends = sum(len(to) * (1 + (g0 > 0)) for _, owner, to in hybrid_moves(len(F0), mesh)
                if owner == me)
    pairs = sum(i % mesh.n_data == data for i in range(len(F0)))
    for lh, _, route, k in sharded_plan(w, h, cfg, mesh, "auto", data=data)[g0:]:
        if route == "explicit":
            shard = mesh.row(data).index(me)
            sends += explicit_sends(cfg, mesh.n_y, k, shard) * pairs
    # a pair whose fine levels reach the suffix of sharded levels gathers its flow once
    plan = sharded_bands(w, h, cfg, mesh, "auto", data=data)
    n = len(sharded_plan(w, h, cfg, mesh, "auto", data=data))
    if plan is not None and n > max(g0, plan.start):
        sends += 2 * (mesh.n_y - 1) * pairs
    return sends


# the hybrid: its row's pairs, each pair's working set moved to its row
for mesh, key in ((row, "hybrid_row"), (dp, "hybrid_dp")):
    group.row_exchange.sends = 0
    r = compute_flow_hybrid(F0, F1, cfgs["grey"], mesh=mesh, device="cpu")
    meta[f"{key}_pairs"], meta[f"{key}_sends"] = list(r.pairs), group.row_exchange.sends
    meta[f"{key}_sends_expected"] = hybrid_sends(mesh, cfgs["grey"])
    meta[f"{key}_split"] = hybrid_split_level(F0.shape[2], F0.shape[1], cfgs["grey"], mesh)
    res[f"{key}_u"], res[f"{key}_v"] = r.u, r.v

# the row: the pair sharded over the processes, each process computing its
# own rows of the whole-field stages of the sharded levels
h, w = F0.shape[1:]
for name, cfg in cfgs.items():
    one = compute_flow(F0[0], F1[0], cfg, device="cpu")
    res[f"row_{name}_ref_u"], res[f"row_{name}_ref_v"] = one.u, one.v
    for k in (1, 2):
        banded(f"row_{name}_k{k}", lambda: compute_flow_sharded(
            F0[0], F1[0], cfg, mesh=row, halo="kernel", k_outer=k, device="cpu"),
            cfg, row, "kernel", k)
    got = banded(f"row_{name}_auto", lambda: compute_flow(F0[0], F1[0], cfg, mesh=row,
                                                           device="cpu"), cfg, row, "auto")
    meta[f"row_{name}_pairs"] = got.pairs
    for k in (1, 2):
        relax_sharded_explicit.copies = 0
        banded(f"row_{name}_explicit_k{k}", lambda: compute_flow_sharded(
            F0[0], F1[0], cfg, mesh=row, halo="explicit", k_outer=k, device="cpu"),
            cfg, row, "explicit", k)
        levels = [(lh, kk) for lh, _, route, kk in sharded_plan(
            F0.shape[2], F0.shape[1], cfg, row, "explicit", k) if route == "explicit"]
        meta[f"row_{name}_explicit_k{k}_copies"] = [
            relax_sharded_explicit.copies,
            sum(explicit_copies(lh, cfg, world, kk, name != "grey", shard=rank)
                for lh, kk in levels)]
    for mesh, key in ((row, "plan"), (shared, "plan_shared")):
        plan = sharded_plan(F0.shape[2], F0.shape[1], cfg, mesh, "auto")
        plans = [None] * world
        dist.all_gather_object(plans, plan)
        meta[f"{key}_{name}"] = plan
        meta[f"same_{key}_{name}"] = all(p == plan for p in plans)

# a stack on the row: every pair sharded over the processes, each gathered once
plan = sharded_bands(w, h, cfgs["grey"], row, "auto")
group.row_exchange.sends = 0
r = compute_flow(F0, F1, cfgs["grey"], mesh=row, device="cpu")
meta["stack_row_pairs"], meta["stack_row_sends"] = list(r.pairs), group.row_exchange.sends
meta["stack_row_sends_expected"] = len(F0) * GATHER * (plan is not None)
res["stack_row_u"], res["stack_row_v"] = r.u, r.v

# the plain twin on one level, against the one-process twin and relax
rng = np.random.default_rng(5)
h, w = F0.shape[1:]
f0, f1 = torch.from_numpy(F0[1]), torch.from_numpy(F1[1])
uv = torch.from_numpy((rng.standard_normal((2, h, w)) * 2.0).astype(np.float32))
sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
fxyz = level_derivs(f0, f1, sc.div4hx, sc.div4hy)
J = level_tensor(f0, f1, fxyz, sc, False)
for name, cfg in cfgs.items():
    Jc = None if name == "grey" else J
    for k in (1, 2):
        got = relax_sharded_kernel(fxyz, uv, sc, cfg, row, k, J=Jc)
        twin = relax_sharded(fxyz, uv, sc, cfg, row, k, J=Jc)
        local = relax_sharded(fxyz, uv, sc, cfg, Mesh(world, "cpu"), k, J=Jc)
        unsharded = relax(fxyz, uv, sc, cfg, J=Jc)
        meta[f"relax_{name}_k{k}"] = [got.numpy().tobytes() == local.numpy().tobytes(),
                                      twin.numpy().tobytes() == local.numpy().tobytes(),
                                      got.numpy().tobytes() == unsharded.numpy().tobytes()]

# the router with the explicit route made the cheap one (free messages, a
# slow kernel): its plan mixes explicit and, where a shard would be too
# short, replicated levels, the same on every process
saved = model.NCCL, model.KERNEL_PX_S
model.NCCL = model.ICIParams(bandwidth_bytes_s=1e15, hop_latency_s=0.0, dispatch_s=0.0,
                             launch_s=0.0)
model.KERNEL_PX_S = 1.0
for name, cfg in cfgs.items():
    banded(f"row_{name}_auto_explicit", lambda: compute_flow(F0[0], F1[0], cfg, mesh=row,
                                                              device="cpu"), cfg, row, "auto")
    plan = sharded_plan(F0.shape[2], F0.shape[1], cfg, row, "auto")
    plans = [None] * world
    dist.all_gather_object(plans, plan)
    meta[f"plan_explicit_{name}"] = plan
    meta[f"same_plan_explicit_{name}"] = all(p == plan for p in plans)
model.NCCL, model.KERNEL_PX_S = saved


# what raises over processes
def raised(fn):
    try:
        fn()
    except Exception as err:  # recorded for the parent to check
        return f"{type(err).__name__}: {err}"
    return "no raise"


# NCCL refuses two ranks on one card: with the backend faked as NCCL, the
# routes that would send between them raise before any message
group.p2p_backend = lambda: "nccl"
shared_dp = Mesh(1, n_data=world, devices=shared.devices, ranks=shared.ranks, uuids=shared.uuids)
# processes that share a card take the whole-field path (NCCL would refuse
# the gather), with the kernel route's plain twin between them over gloo
for name, cfg in cfgs.items():
    banded(f"shared_{name}", lambda: compute_flow_sharded(F0[0], F1[0], cfg, mesh=shared,
                                                          halo="kernel", device="cpu"),
           cfg, shared, "kernel")
meta["explicit"] = raised(lambda: compute_flow_sharded(F0[0], F1[0], cfgs["grey"], mesh=shared,
                                                       halo="explicit", device="cpu"))
meta["explicit_level"] = raised(lambda: relax_sharded_explicit(fxyz, uv, sc, cfgs["grey"],
                                                               shared))
meta["hybrid"] = raised(lambda: compute_flow_hybrid(F0, F1, cfgs["grey"], mesh=shared,
                                                    device="cpu"))
r = compute_flow_hybrid(F0, F1, cfgs["grey"], mesh=shared_dp, device="cpu")
meta["hybrid_shared_dp_pairs"] = list(r.pairs)
res["hybrid_shared_dp_u"], res["hybrid_shared_dp_v"] = r.u, r.v
meta["explicit_distinct"] = raised(lambda: relax_sharded_explicit(fxyz, uv, sc, cfgs["grey"], row))
group.p2p_backend = lambda: "gloo"
meta["sequence"] = raised(lambda: process_sequence([], w, h, os.path.join(out, "seq"),
                                                   cfgs["grey"], mesh=dp, device="cpu"))
meta["jax_modules"] = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpuflow")]
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(meta, f)
dist.barrier()
dist.destroy_process_group()
print(f"PROCMESH OK rank={rank}", flush=True)
"""


WORKER_2X2 = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist

from tpuflow_torch import FlowConfig, compute_flow, make_mesh
from tpuflow_torch.parallel import group, mesh as mesh_mod
from tpuflow_torch.parallel.multihost import initialize_distributed
from tpuflow_torch.solver.sharded import sharded_bands

port, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = FlowConfig(**json.loads(sys.argv[5]))
initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank)
data = np.load(os.path.join(out, "inputs.npz"))
F0, F1 = data["F0"], data["F1"]
mesh_mod.device_uuid = lambda device: f"card{dist.get_rank()}"
mesh = make_mesh((2, 2), "cpu")
h, w = F0.shape[1:]
plan = sharded_bands(w, h, cfg, mesh, "auto", data=mesh.local_row())
group.row_exchange.sends = 0
r = compute_flow(F0, F1, cfg, mesh=mesh, device="cpu")
refs = [compute_flow(F0[i], F1[i], cfg, device="cpu") for i in r.pairs]
meta = {"pairs": list(r.pairs), "banded": plan is not None, "sends": group.row_exchange.sends,
        "bitwise": all(r.u[j].tobytes() == one.u.tobytes() and r.v[j].tobytes() == one.v.tobytes()
                       for j, one in enumerate(refs))}
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(meta, f)
dist.barrier()
dist.destroy_process_group()
print(f"PROCMESH OK rank={rank}", flush=True)
"""


def frames():
    """A (B, H, W) stack: seeded noise with a blob, moved by a different
    shift in each pair."""
    rng = np.random.default_rng(11)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    F0, F1 = [], []
    for b in range(B):
        f0 = (rng.random((H, W), np.float32) * 200).astype(np.float32)
        g = 150 * np.exp(-((ys - 30 - b) ** 2 + (xs - 45) ** 2) / 120.0)
        F0.append(f0 + g)
        F1.append(f0 + np.roll(g, (1 + b % 2, 2), axis=(0, 1)))
    return np.stack(F0).astype(np.float32), np.stack(F1).astype(np.float32)


def run_workers(world, tmp, worker=WORKER):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    F0, F1 = frames()
    np.savez(tmp / "inputs.npz", F0=F0, F1=F1)
    script = tmp / "worker.py"
    script.write_text(worker)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFLOW_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(r), str(world),
                               str(tmp), json.dumps(KW)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        assert f"PROCMESH OK rank={r}" in text, text[-2000:]
    if worker is not WORKER:
        return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    return [(dict(np.load(tmp / f"rank{r}.npz")), json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(world)]


@pytest.fixture(scope="module", params=[2, 3], ids=["2procs", "3procs"])
def procs(request, tmp_path_factory):
    world = request.param
    return world, run_workers(world, tmp_path_factory.mktemp(f"procmesh{world}"))


@pytest.fixture(scope="module")
def jax_flows():
    """compute_flow_bucketed_batch of the stack, grey and gradient."""
    F0, F1 = frames()
    out = {}
    for c in CONSTANCIES:
        cfg = JFlowConfig(data_constancy=JDataConstancy(c), **KW)
        u, v = compute_flow_bucketed_batch(F0, F1, cfg)
        out[c] = (np.asarray(u), np.asarray(v))
    return out


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_make_mesh_over_processes(procs):
    world, ranks = procs
    for r, (_, meta) in enumerate(ranks):
        want = {"ranks": list(range(world)), "local": [r], "cards": world, "row_cards": world,
                "spans": True, "row_spans": True, "local_row": 0, "shape": [1, world],
                "devices": ["cpu"] * world}
        assert meta["row"] == want
        # two processes on one card count as one card
        shared = 1 if world == 2 else 2
        assert meta["shared"] == dict(want, cards=shared, row_cards=shared)
        assert meta["dp"]["shape"] == [world, 1] and meta["dp"]["local"] == [r]
        assert meta["dp"]["local_row"] == r and not meta["dp"]["row_spans"]
        assert meta["equal"]


def test_dp_pairs_are_bitwise_the_one_process_compute_flow(procs):
    world, ranks = procs
    for r, (res, meta) in enumerate(ranks):
        assert meta["dp_pairs"] == [i for i in range(B) if i % world == r]
        assert res["dp_u"].shape == (len(meta["dp_pairs"]), H, W)
        for j, i in enumerate(meta["dp_pairs"]):
            assert same(res["dp_u"][j], res[f"dp_ref_u{i}"])
            assert same(res["dp_v"][j], res[f"dp_ref_v{i}"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_row_over_processes_is_bitwise_compute_flow(procs, constancy, route):
    _, ranks = procs
    for res, meta in ranks:
        assert same(res[f"row_{constancy}_{route}_u"], res[f"row_{constancy}_ref_u"])
        assert same(res[f"row_{constancy}_{route}_v"], res[f"row_{constancy}_ref_v"])
        assert meta[f"row_{constancy}_pairs"] is None
    # every process returns the whole flow, the same bits
    for res, _ in ranks[1:]:
        assert same(res[f"row_{constancy}_{route}_u"], ranks[0][0][f"row_{constancy}_{route}_u"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_row_over_processes_computes_its_plans_rows(procs, constancy, route):
    """Each process takes the band path (a faked card each) and computes,
    per row stage, exactly its plan's rows, fewer than the whole field's;
    it sends the explicit route's messages and one gather of the finest
    flow (two planes to each other process), nothing between levels."""
    _, ranks = procs
    for _, meta in ranks:
        key = f"row_{constancy}_{route}"
        assert meta[f"{key}_path"] == "banded"
        got, want, whole = meta[f"{key}_rows"]
        assert got == want
        assert all(got[s] <= whole[s] for s in got) and sum(got.values()) < sum(whole.values())
        sends, expected = meta[f"{key}_sends"]
        assert sends == expected > 0


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_processes_sharing_a_card_take_the_whole_path(procs, constancy):
    """Where two processes share a card under NCCL, which would refuse the
    gather, every level's whole-field stages run over the whole field: the
    same flow, every row computed, no message."""
    _, ranks = procs
    for res, meta in ranks:
        assert meta[f"shared_{constancy}_path"] == "whole"
        got, want, whole = meta[f"shared_{constancy}_rows"]
        assert got == want == whole
        assert meta[f"shared_{constancy}_sends"] == [0, 0]
        assert same(res[f"shared_{constancy}_u"], res[f"row_{constancy}_ref_u"])
        assert same(res[f"shared_{constancy}_v"], res[f"row_{constancy}_ref_v"])


def test_stack_on_the_row_is_bitwise_compute_flow(procs):
    """A stack on (1, world): every pair sharded over the processes, each
    bitwise its compute_flow on every process, one gather a pair."""
    _, ranks = procs
    for res, meta in ranks:
        assert meta["stack_row_pairs"] == list(range(B))
        for i in range(B):
            assert same(res["stack_row_u"][i], res[f"dp_ref_u{i}"])
            assert same(res["stack_row_v"][i], res[f"dp_ref_v{i}"])
        assert meta["stack_row_sends"] == meta["stack_row_sends_expected"] > 0


def test_stack_on_two_by_two_is_bitwise_compute_flow(tmp_path):
    """A stack on a (2, 2) mesh over four processes: pair i on data row
    i % 2, sharded over the row's two processes with their band plans,
    each flow bitwise that process's compute_flow, one gather a pair."""
    ranks = run_workers(4, tmp_path, WORKER_2X2)
    for r, meta in enumerate(ranks):
        assert meta["pairs"] == [i for i in range(B) if i % 2 == r // 2]
        assert meta["bitwise"] and meta["banded"]
        assert meta["sends"] == 2 * len(meta["pairs"])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_plain_twin_over_processes_is_bitwise(procs, constancy, k):
    """The wrapper's CPU route and relax_sharded over the process row,
    against the one-process relax_sharded and relax."""
    _, ranks = procs
    for _, meta in ranks:
        assert meta[f"relax_{constancy}_k{k}"] == [True, True, True]


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_every_process_takes_the_same_plan(procs, constancy):
    world, ranks = procs
    plans = [meta[f"plan_{constancy}"] for _, meta in ranks]
    assert all(meta[f"same_plan_{constancy}"] for _, meta in ranks)
    assert all(p == plans[0] for p in plans)
    routes = {route for _, _, route, _ in plans[0]}
    assert "kernel" in routes and routes <= {"kernel", "explicit", "replicated"}
    # with the explicit route made the cheap one, the router takes it
    explicit = [meta[f"plan_explicit_{constancy}"] for _, meta in ranks]
    assert all(meta[f"same_plan_explicit_{constancy}"] for _, meta in ranks)
    assert all(p == explicit[0] for p in explicit)
    assert "explicit" in {route for _, _, route, _ in explicit[0]}
    # where processes share a (faked) card, their row barriers would wait for
    # time slices: the router replicates every level
    shared = [meta[f"plan_shared_{constancy}"] for _, meta in ranks]
    assert all(meta[f"same_plan_shared_{constancy}"] for _, meta in ranks)
    assert all(p == shared[0] for p in shared)
    assert {route for _, _, route, _ in shared[0]} == {"replicated"}


def test_workers_import_no_jax(procs):
    _, ranks = procs
    assert all(meta["jax_modules"] == [] for _, meta in ranks)


def test_process_modules_import_no_jax():
    code = ("import sys, tpuflow_torch.parallel.group, tpuflow_torch.parallel.ipc\n"
            "import tpuflow_torch.parallel.multihost, tpuflow_torch.tools.report_scaling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuflow')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)


def test_what_raises_over_processes(procs):
    _, ranks = procs
    for _, meta in ranks:
        assert meta["sequence"].startswith("ValueError")


@pytest.mark.parametrize("case", ["explicit", "explicit_level", "hybrid"])
def test_nccl_refuses_two_processes_on_one_card(procs, case):
    """With the backend faked as NCCL, a route that sends between processes
    sharing a (faked) card raises before any message, naming NCCL and the
    card; on distinct cards the same route is accepted."""
    _, ranks = procs
    for _, meta in ranks:
        assert meta[case].startswith("RuntimeError"), meta[case]
        assert "NCCL" in meta[case] and "share card card0" in meta[case]
        assert meta["explicit_distinct"] == "no raise"


@pytest.mark.parametrize("mesh", ["hybrid_row", "hybrid_dp", "hybrid_shared_dp"])
def test_hybrid_over_processes_is_bitwise_compute_flow(procs, mesh):
    """Each process returns its row's pairs, each bitwise its own
    compute_flow of the pair; on (world, 1) no pair moves, also where
    processes share a card under NCCL."""
    world, ranks = procs
    for r, (res, meta) in enumerate(ranks):
        row = 0 if mesh == "hybrid_row" else r
        n_data = 1 if mesh == "hybrid_row" else world
        assert meta[f"{mesh}_pairs"] == [i for i in range(B) if i % n_data == row]
        assert res[f"{mesh}_u"].shape == (len(meta[f"{mesh}_pairs"]), H, W)
        for j, i in enumerate(meta[f"{mesh}_pairs"]):
            assert same(res[f"{mesh}_u"][j], res[f"dp_ref_u{i}"])
            assert same(res[f"{mesh}_v"][j], res[f"dp_ref_v{i}"])
        if mesh != "hybrid_shared_dp":
            assert meta[f"{mesh}_sends"] == meta[f"{mesh}_sends_expected"]
    if mesh == "hybrid_row":
        # the pair's owner sends its working set to the other processes
        assert sum(meta["hybrid_row_sends"] for _, meta in ranks) > 0
    if mesh == "hybrid_dp":
        assert all(meta["hybrid_dp_sends"] == 0 for _, meta in ranks)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_explicit_route_counts_its_copies_and_sends(procs, constancy, k):
    _, ranks = procs
    """Device copies (blocks in, owned rows out) in ``copies``, messages in
    ``row_exchange.sends``: each counted once, each exact."""
    for _, meta in ranks:
        got, want = meta[f"row_{constancy}_explicit_k{k}_copies"]
        assert got == want > 0
        # the explicit route's sends and the finest flow's one gather
        got, want = meta[f"row_{constancy}_explicit_k{k}_sends"]
        assert got == want > 0


def bound(u, v, want_u, want_v):
    epe = np.hypot(u - want_u, v - want_v)
    return float(epe.mean()), float(epe.max())


def test_dp_within_the_bound_of_the_jax_package(procs, jax_flows):
    _, ranks = procs
    want_u, want_v = jax_flows["grey"]
    for res, meta in ranks:
        for j, i in enumerate(meta["dp_pairs"]):
            mean, most = bound(res["dp_u"][j], res["dp_v"][j], want_u[i], want_v[i])
            assert mean <= 1e-5 and most <= 1e-4, (i, mean, most)


@pytest.mark.parametrize("mesh", ["hybrid_row", "hybrid_dp"])
def test_hybrid_within_the_bound_of_the_jax_package(procs, jax_flows, mesh):
    _, ranks = procs
    want_u, want_v = jax_flows["grey"]
    for res, meta in ranks:
        for j, i in enumerate(meta[f"{mesh}_pairs"]):
            mean, most = bound(res[f"{mesh}_u"][j], res[f"{mesh}_v"][j], want_u[i], want_v[i])
            assert mean <= 1e-5 and most <= 1e-4, (i, mean, most)


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_row_within_the_bound_of_the_jax_package(procs, jax_flows, constancy):
    _, ranks = procs
    want_u, want_v = jax_flows[constancy]
    for res, _ in ranks:
        for route in ROUTES:
            mean, most = bound(res[f"row_{constancy}_{route}_u"],
                               res[f"row_{constancy}_{route}_v"], want_u[0], want_v[0])
            assert mean <= 1e-5 and most <= 1e-4, (route, mean, most)


def test_one_process_meshes_keep_their_meaning():
    a, b = Mesh(4, "cpu"), Mesh(4, "cpu")
    assert a == b and hash(a) == hash(b) and not a.spans_processes
    assert a.ranks == (0,) * 4 and a.local_positions() == (0, 1, 2, 3) and a.cards == 1
    c = Mesh(2, n_data=1, devices=["cpu", "cpu"], ranks=[0, 1], uuids=["x", "y"])
    assert c.spans_processes and c.cards == 2 and c != Mesh(2, "cpu")
    assert c.local_positions() == (0,) and c.row_ranks() == (0, 1)
    with pytest.raises(ValueError, match="rank 1"):
        c.stream(1)


def test_a_refused_ipc_open_raises_naming_both_ranks(monkeypatch):
    """With CUDA present a refused open raises; here the C call is stubbed to
    fail as a refused cudaIpcOpenMemHandle does, and the error comes out
    with both ranks and cards named, not swallowed."""
    from tpuflow_torch.parallel import ipc

    def refused(name, *args):
        assert name == "tf_ipc_open_handle"
        raise RuntimeError(f"{name}: CUDA error 201 (invalid device context)")

    monkeypatch.setattr(ipc, "call", refused)
    monkeypatch.setattr(ipc, "device_uuid", lambda device: "GPU-mine")
    with pytest.raises(RuntimeError, match=r"rank 1 on cuda:0 \(GPU-mine\).*rank 3 on card "
                                           r"GPU-peer.*CUDA error 201"):
        ipc.open_peer(bytes(ipc.HANDLE_BYTES), torch.device("cuda", 0), 1, 3, "GPU-peer")


def test_arena_layout():
    from tpuflow_torch.parallel import ipc
    from tpuflow_torch.parallel.halo_kernel import MAX_CARDS, N_PLANES_TENSOR

    t_off, buf_off, nbytes = ipc.arena_layout(1080, 1920, N_PLANES_TENSOR, 600)
    assert t_off == ipc.FLAGS_BYTES >= MAX_CARDS * 8 and t_off % ipc.ALIGN == 0
    assert buf_off % ipc.ALIGN == 0 and buf_off >= t_off + 2 * 1080 * 1920 * 4
    assert nbytes == buf_off + N_PLANES_TENSOR * 600 * 1920 * 4
    assert ctypes.sizeof(ctypes.c_ubyte * ipc.HANDLE_BYTES) == 64


def test_point_to_point_messages_take_contiguous_tensors_only():
    from tpuflow_torch.parallel.group import row_exchange

    block = torch.zeros((2, 10, 4))
    assert block[0, 2:4].is_contiguous() and not block[:, 2:4].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        row_exchange([(1, block[:, 2:4])], [])


@pytest.mark.parametrize("backend,cards,raises", [
    ("nccl", ["a", "a", "b"], True), ("nccl", ["a", "b", "c"], False),
    ("gloo", ["a", "a", "b"], False)])
def test_the_shared_card_rule_is_nccls(monkeypatch, backend, cards, raises):
    from tpuflow_torch.parallel import group

    monkeypatch.setattr(group, "p2p_backend", lambda: backend)
    if raises:
        with pytest.raises(RuntimeError, match="NCCL.*ranks 0 and 1 share card a"):
            group.check_p2p_cards([0, 1, 2], cards, "the explicit route")
    else:
        group.check_p2p_cards([0, 1, 2], cards, "the explicit route")

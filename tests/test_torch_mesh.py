"""The mesh and the explicit route of tpuflow_torch on the CPU, against the
port's own unsharded paths and the JAX package, on seeded numpy inputs:

  * ``make_mesh``: shapes, the JAX default layout, what raises;
  * ``relax_sharded_explicit`` on a mesh of repeated "cpu" devices, bitwise
    against ``relax`` and ``relax_sharded`` for 1-4 shards (3 split 100
    rows unevenly), k = 1 and 2, all three constancies, its copies counted;
  * the same against ``tpuflow.parallel.halo.relax_sharded`` (k = 1 and 2)
    within the bounds of tests/test_torch_sharded.py;
  * ``compute_flow_sharded`` with ``halo="explicit"`` and ``"auto"``
    bitwise against ``compute_flow`` (tests/test_torch_router.py holds
    both against ``compute_flow_bucketed_sharded``);
  * the prologue's wrapper on a row block, and ``solve`` run in two parts.
"""

import numpy as np
import pytest
import torch

from tpuflow.parallel import halo as jhalo

from tpuflow_torch import FlowConfig, compute_flow, compute_flow_sharded
from tpuflow_torch.ops.level import outer_prologue, outer_prologue_plain
from tpuflow_torch.parallel import Mesh, make_mesh, relax_sharded
from tpuflow_torch.parallel.halo import explicit_copies, relax_sharded_explicit
from tpuflow_torch.parallel.mesh import default_shape
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import relax, solve
from tpuflow_torch.solver.sharded import sharded_plan

from test_torch_sharded import CH, bucket_inputs, cfgs, jax_mesh, jax_sc, port_level
from test_torch_sharded import valid_diff

torch.set_num_threads(2)

CONSTANCIES = ["grey", "gradient", "log"]


def cpu_mesh(n_y, n_data=1):
    return make_mesh((n_data, n_y), ["cpu"] * (n_data * n_y))


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (4, (1, 4)), (6, (1, 6)), (8, (2, 4)),
                                     (16, (2, 8))])
def test_default_layout_is_jax(n, shape):
    # tpuflow/parallel/mesh.py:26-31: every device on y, one factor of 2 to
    # data from 8 devices on (tests/test_parallel.py:37-47)
    assert default_shape(n) == shape
    if shape[1] <= 8:
        mesh = make_mesh(device=["cpu"] * n)
        assert (mesh.n_data, mesh.n_y) == shape and mesh.size == n
        assert mesh.shape == {"data": shape[0], "y": shape[1]}


def test_mesh_shapes_and_positions():
    mesh = make_mesh((2, 3), ["cpu"] * 6)
    assert mesh.row(1) == (3, 4, 5) and mesh.position(1, 2) == 5
    assert mesh.cards == mesh.row_cards(0) == 1 and mesh.device == torch.device("cpu")
    assert mesh.stream(0) is None
    # the old calls keep their meaning
    assert make_mesh(4, "cpu") == Mesh(4, torch.device("cpu")) == make_mesh(4, ["cpu"] * 4)
    assert make_mesh(3, ["cpu"]).n_y == 3
    assert hash(make_mesh(2, "cpu")) == hash(Mesh(2, "cpu"))
    with pytest.raises(IndexError):
        mesh.position(2, 0)


def test_mesh_raises():
    with pytest.raises(ValueError, match="shards"):
        make_mesh((1, 9), "cpu")
    with pytest.raises(ValueError, match="data position"):
        Mesh(2, "cpu", n_data=0)
    with pytest.raises(ValueError, match="devices for"):
        make_mesh((2, 2), ["cpu"] * 3)
    with pytest.raises(ValueError, match="one device or one device per position"):
        Mesh(2)
    # a mesh over distinct devices has no single device
    spread = Mesh(2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert spread.cards == 2
    with pytest.raises(ValueError, match="spans 2 devices"):
        spread.device


# ---------------------------------------------------------------------------
# The explicit route against the port's unsharded relax and its plain twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("constancy", CONSTANCIES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n_y", [1, 2, 3, 4])
def test_explicit_matches_relax_bitwise(n_y, k, constancy):
    _, tcfg = cfgs(constancy, outer_iterations_count=3, inner_iterations_count=2)
    fxyz, uv, J, sc = port_level(*bucket_inputs(), tcfg)
    mesh = cpu_mesh(n_y)
    relax_sharded_explicit.copies = 0
    got = relax_sharded_explicit(fxyz, uv, sc, tcfg, mesh, k, J=J)
    assert torch.equal(got, relax(fxyz, uv, sc, tcfg, J=J))
    assert torch.equal(got, relax_sharded(fxyz, uv, sc, tcfg, mesh, k, J=J))
    assert relax_sharded_explicit.copies == explicit_copies(CH, tcfg, n_y, k, J is not None)


def test_explicit_uses_the_rows_of_its_data_row():
    _, tcfg = cfgs(outer_iterations_count=3, inner_iterations_count=2)
    fxyz, uv, J, sc = port_level(*bucket_inputs(seed=5), tcfg)
    got = relax_sharded_explicit(fxyz, uv, sc, tcfg, cpu_mesh(3, n_data=2), 1, data=1)
    assert torch.equal(got, relax(fxyz, uv, sc, tcfg))


def test_explicit_refuses_a_gate_and_mixed_devices():
    cfg = FlowConfig(inner_iterations_count=5)
    with pytest.raises(ValueError, match="every shard needs"):
        relax_sharded_explicit(torch.zeros(3, 63, 8), torch.zeros(2, 63, 8), None, cfg,
                               cpu_mesh(4))
    with pytest.raises(ValueError, match="for shards on"):
        relax_sharded_explicit(torch.zeros(3, 64, 8), torch.zeros(2, 64, 8), None, cfg,
                               Mesh(4, torch.device("cuda", 0)))


@pytest.mark.parametrize("constancy,outer,inner,k", [
    ("grey", 1, 1, 1), ("grey", 3, 2, 1), ("grey", 3, 2, 2), ("gradient", 3, 2, 2),
    ("log", 3, 2, 1)])
def test_explicit_matches_tpu_explicit_halo(outer, inner, k, constancy):
    # Bounds of tests/test_torch_sharded.py: max abs 1e-4 at 1 x 1; at 3 x 2
    # mean EPE 5e-5 and max 2e-2.
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=outer, inner_iterations_count=inner)
    f0, f1, u, v = bucket_inputs()
    want_du, want_dv = jhalo.relax_sharded(f0, f1, u, v, jax_sc(), jcfg, jax_mesh(), "y",
                                           k_outer=k)
    fxyz, uv, J, sc = port_level(f0, f1, u, v, tcfg)
    got = (relax_sharded_explicit(fxyz, uv, sc, tcfg, cpu_mesh(4), k, J=J) - uv).numpy()
    d = valid_diff(got, want_du, want_dv)
    if (outer, inner) == (1, 1):
        assert d.max() <= 1e-4
    else:
        assert d.mean() <= 5e-5 and d.max() <= 2e-2


def test_prologue_wrapper_takes_a_row_block():
    rng = np.random.default_rng(2)
    h, w, row0, height = 22, 37, 9, 50
    T, uv = (torch.from_numpy(rng.random((2, h, w), dtype=np.float32)) for _ in range(2))
    fxyz = torch.from_numpy(rng.random((3, h, w), dtype=np.float32))
    J = torch.from_numpy(rng.random((5, h, w), dtype=np.float32))
    pro = (2.0, 2.6, 35.0, 21.0, 1e-6, 1e-6)
    for tensor in (None, J):
        got = outer_prologue(T, uv, fxyz, *pro, J=tensor, row0=row0, height=height)
        assert torch.equal(got, outer_prologue_plain(T, uv, fxyz, *pro, J=tensor, row0=row0,
                                                     height=height))
        assert not torch.equal(got, outer_prologue(T, uv, fxyz, *pro, J=tensor))
    with pytest.raises(ValueError, match="not rows of a level"):
        outer_prologue(T, uv, fxyz, *pro, row0=40, height=height)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def blob(h, w, cy, cx, sigma):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return (200.0 * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))).astype(
        np.float32)


def halo_pair():
    """The frames and schedule of tests/test_halo.py:113-127."""
    h, w = 120, 140
    f0 = blob(h, w, 60, 70, 8.0) + blob(h, w, 30, 35, 4.0)
    f1 = blob(h, w, 61.1, 69.2, 8.0) + blob(h, w, 30.7, 35.8, 4.0)
    kw = dict(warp_levels_count=4, warp_scale_factor=0.6, outer_iterations_count=5,
              inner_iterations_count=3, median_radius=5, gaussian_sigma=1.0)
    return f0, f1, kw


@pytest.mark.parametrize("constancy,n_y,k", [("grey", 4, 1), ("gradient", 4, 1), ("log", 3, 1),
                                             ("grey", 3, 2)])
def test_explicit_pipeline_bitwise_equal_to_compute_flow(constancy, n_y, k):
    f0, f1, kw = halo_pair()
    _, tcfg = cfgs(constancy, **kw)
    want = compute_flow(f0, f1, tcfg, device="cpu")
    got = compute_flow_sharded(f0, f1, tcfg, mesh=cpu_mesh(n_y), halo="explicit", k_outer=k,
                               device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()
    assert any(r == "explicit" for *_, r, _ in sharded_plan(140, 120, tcfg, cpu_mesh(n_y),
                                                             "explicit", k))


def test_auto_routes_levels_by_the_model():
    f0, f1, kw = halo_pair()
    cfg = FlowConfig(**kw)
    mesh = cpu_mesh(4)
    plan = sharded_plan(140, 120, cfg, mesh, "auto")
    assert [(h, w) for h, w, _, _ in plan] == [
        (s.height, s.width) for s in level_schedule(140, 120, 4, 0.6)]
    # one card: the kernel or replication, never the explicit route
    assert {r for *_, r, _ in plan} <= {"kernel", "replicated"}
    got = compute_flow_sharded(f0, f1, cfg, mesh=mesh, halo="auto", device="cpu")
    want = compute_flow(f0, f1, cfg, device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()


@pytest.mark.parametrize("split", [0, 1, 3, 4])
def test_solve_in_two_parts_is_the_solve(split):
    f0, f1, kw = halo_pair()
    cfg = FlowConfig(**kw)
    a, b = torch.from_numpy(f0), torch.from_numpy(f1)
    whole = solve(a, b, cfg)
    n = len(level_schedule(140, 120, 4, 0.6))
    from tpuflow_torch.solver.level import smooth_pair

    s = smooth_pair(a, b, cfg)
    uv = solve(s[0], s[1], cfg, levels=range(split), smoothed=True)
    uv = solve(s[0], s[1], cfg, levels=range(split, n), uv=uv, smoothed=True)
    assert torch.equal(uv, whole)
    with pytest.raises(ValueError, match="starts from no flow"):
        solve(a, b, cfg, levels=range(1, n))


def test_device_cache_counts_and_evicts():
    from tpuflow_torch.ops.device_cache import device_cached

    made = []

    @device_cached(maxsize=2)
    def build(n):
        made.append(n)
        return torch.full((n,), float(n))

    for n in (1, 2, 1, 3, 2):
        assert torch.equal(build(n), torch.full((n,), float(n)))
    # 1 and 2 built, 1 a hit, 3 built in place of 2 (the least recently
    # used), then 2 built again
    assert made == [1, 2, 3, 2]
    info = build.cache_info()
    assert (info.hits, info.misses, info.maxsize, info.currsize) == (1, 4, 2, 2)


# ---------------------------------------------------------------------------
# The kernel over several cards: what the mesh gives its wrapper
# ---------------------------------------------------------------------------


def test_row_groups_by_card():
    cuda = [torch.device("cuda", i) for i in range(4)]
    dealt = Mesh(8, devices=[cuda[i % 4] for i in range(8)])
    assert dealt.row_groups() == [(cuda[i], (i, i + 4)) for i in range(4)]
    blocks = Mesh(4, n_data=2, devices=[cuda[1], cuda[1], cuda[0], cuda[0]] + cuda)
    assert blocks.row_groups(0) == [(cuda[1], (0, 1)), (cuda[0], (2, 3))]
    assert blocks.row_groups(1) == [(cuda[i], (i,)) for i in range(4)]
    assert cpu_mesh(3).row_groups() == [(torch.device("cpu"), (0, 1, 2))]


def test_peer_access_is_checked_before_it_is_enabled(monkeypatch):
    """A pair of cards without peer access raises, naming both, before any
    entry point is called."""
    from tpuflow_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    monkeypatch.setattr(mesh_mod, "_PEERS", set())
    with pytest.raises(ValueError, match=r"cuda:0 cannot reach the memory of cuda:1"):
        mesh_mod.enable_peer_access([torch.device("cuda", 0), torch.device("cuda", 1)])


@pytest.mark.parametrize("constancy,n_y,k", [("grey", 4, 1), ("gradient", 4, 1), ("log", 3, 2)])
def test_kernel_pipeline_bitwise_equal_to_compute_flow(constancy, n_y, k):
    """compute_flow_sharded(halo="kernel") over repeated "cpu" positions runs
    the kernel's plain twin at every admitted level: bitwise compute_flow."""
    f0, f1, kw = halo_pair()
    _, tcfg = cfgs(constancy, **kw)
    want = compute_flow(f0, f1, tcfg, device="cpu")
    got = compute_flow_sharded(f0, f1, tcfg, mesh=cpu_mesh(n_y), halo="kernel", k_outer=k,
                               device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()
    assert any(r == "kernel" for *_, r, _ in sharded_plan(140, 120, tcfg, cpu_mesh(n_y),
                                                           "kernel", k))


def test_kernel_wrapper_plain_twin_refuses_counters():
    from tpuflow_torch.parallel import relax_sharded_kernel

    _, tcfg = cfgs(outer_iterations_count=3, inner_iterations_count=2)
    fxyz, uv, J, sc = port_level(*bucket_inputs(seed=3), tcfg)
    mesh = cpu_mesh(4)
    assert torch.equal(relax_sharded_kernel(fxyz, uv, sc, tcfg, mesh), relax(fxyz, uv, sc, tcfg))
    with pytest.raises(ValueError, match="row barriers"):
        relax_sharded_kernel(fxyz, uv, sc, tcfg, mesh, barriers=torch.zeros(1, dtype=torch.int32))

"""The row-sharded solve of tpuflow_torch on the CPU (the plain versions of
its kernels), against the port's unsharded solve and the JAX package's
sharded paths, on seeded numpy inputs given to both:

  * ``relax_sharded`` (the plain version of the sharded kernel) against the
    port's ``relax``: bitwise, on every pixel, for 1-4 shards (3 shards split
    100 rows unevenly: 34, 33, 33), k = 1 and 2, all three constancies;
  * the same against ``tpuflow.parallel.halo_kernel.relax_sharded_kernel``
    in Pallas interpret mode on a 4-device mesh, and against the explicit
    ``tpuflow.parallel.halo.relax_sharded``;
  * k-outer fusion, the gate, ``compute_flow_sharded`` against
    ``compute_flow`` (bitwise) and against the JAX pipeline with
    ``halo="kernel"``, what raises, the sharded kernel's work count, and
    that the modules import no JAX.

Bounds against the JAX package: 1 outer x 1 inner to max abs 1e-4 (as in
tests/test_torch_level.py); 3 x 2 to mean EPE 5e-5 and max 2e-2, about 10x
and 2x what was measured. The TPU kernel runs the du-form sweep and the
port the T-form, two programs whose ulp differences the lagged
nonlinearity amplifies at a few phi-sensitive pixels. A halo one row short
in the port's plain version fails both bounds of the kernel comparison at
k = 1 (max abs 0.58 at 1 x 1, mean EPE 2.2e-4 to 3.0e-4 at 3 x 2).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.parallel import halo as jhalo
from tpuflow.parallel import halo_kernel as jhalo_kernel
from tpuflow.solver.bucketed import LevelScalars as JLevelScalars
from tpuflow.solver.bucketed import compute_flow_bucketed_sharded, maintain_mirror1

from tpuflow_torch import DataConstancy, FlowConfig, compute_flow, compute_flow_sharded
from tpuflow_torch.ops.level import level_derivs, level_tensor
from tpuflow_torch.ops.solver_ops import edge_weights
from tpuflow_torch.parallel import (
    MAX_SHARDS, Mesh, kernel_halo_applicable, make_mesh, relax_sharded, relax_sharded_kernel,
    row_split,
)
from tpuflow_torch.parallel.mesh import resolve_device
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver import sharded
from tpuflow_torch.solver.flow2d import endpoint_error
from tpuflow_torch.solver.level import LevelScalars, relax
from tpuflow_torch.tools import roofline as R

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
CONSTANCIES = ["grey", "gradient", "log"]
HB, WB, CW, CH = 128, 256, 200, 100   # tests/test_halo_kernel.py:33


def cfgs(constancy="grey", **kw):
    return (JFlowConfig(data_constancy=JDataConstancy(constancy), **kw),
            FlowConfig(data_constancy=DataConstancy(constancy), **kw))


def bucket_inputs(seed=7):
    """The inputs of tests/test_halo_kernel.py:33-46: a 128x256 bucket whose
    100x200 valid region holds seeded frames and flow."""
    rng = np.random.default_rng(seed)

    def mkfield(scale=1.0, base=0.0):
        a = np.zeros((HB, WB), np.float32)
        a[:CH, :CW] = rng.random((CH, CW), dtype=np.float32) * scale + base
        return jnp.asarray(a)

    f0 = maintain_mirror1(mkfield(255.0), CW, CH)
    f1 = maintain_mirror1(f0 + mkfield(8.0), CW, CH)
    u = maintain_mirror1(mkfield(1.0, -0.5), CW, CH)
    v = maintain_mirror1(mkfield(1.0, -0.5), CW, CH)
    return f0, f1, u, v


def jax_sc():
    return JLevelScalars.make(CW, CH, 1.3, 1.7, 35.0, 584, 388, CW, CH).tree()


def port_level(f0, f1, u, v, tcfg):
    """The port's level fields from the valid region: fxyz, uv, J, sc."""
    valid = lambda a: T(np.ascontiguousarray(np.asarray(a)[:CH, :CW]))  # noqa: E731
    sc = LevelScalars.make(CW, CH, 1.3, 1.7, 35.0)
    f0_t, f1_t = valid(f0), valid(f1)
    fxyz = level_derivs(f0_t, f1_t, sc.div4hx, sc.div4hy)
    J = None
    if tcfg.data_constancy != DataConstancy.GREY:
        J = level_tensor(f0_t, f1_t, fxyz, sc,
                         tcfg.data_constancy == DataConstancy.LOG_DERIVATIVES)
    return fxyz, torch.stack([valid(u), valid(v)]), J, sc


def jax_mesh(n=4):
    return JMesh(np.array(jax.devices()[:n]), ("y",))


def valid_diff(got_d, want_du, want_dv):
    return np.hypot(got_d[0] - np.asarray(want_du)[:CH, :CW],
                    got_d[1] - np.asarray(want_dv)[:CH, :CW])


# ---------------------------------------------------------------------------
# The plain version against the port's unsharded relax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("constancy", CONSTANCIES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n_y", [1, 2, 3, 4])
def test_plain_matches_unsharded_relax_bitwise(n_y, k, constancy):
    _, tcfg = cfgs(constancy, outer_iterations_count=3, inner_iterations_count=2)
    fxyz, uv, J, sc = port_level(*bucket_inputs(), tcfg)
    want = relax(fxyz, uv, sc, tcfg, J=J)
    mesh = make_mesh(n_y, device="cpu")
    got = relax_sharded(fxyz, uv, sc, tcfg, mesh, k, J=J)
    assert torch.equal(got, want)
    # The wrapper runs the plain version on CPU tensors, and counts no launch.
    launches = relax_sharded_kernel.launches
    assert torch.equal(relax_sharded_kernel(fxyz, uv, sc, tcfg, mesh, k, J=J), want)
    assert relax_sharded_kernel.launches == launches


@pytest.mark.parametrize("h,n_y", [(100, 3), (100, 4), (67, 4), (128, 8), (16, 1)])
def test_row_split_is_tensor_split(h, n_y):
    shards = row_split(h, n_y, halo=6)
    assert [s.rows for s in shards] == [len(c) for c in torch.tensor_split(torch.arange(h), n_y)]
    assert [s.row0 for s in shards] == [0] + list(np.cumsum([s.rows for s in shards])[:-1])
    assert shards[0].top == 0 and shards[-1].bot == 0
    assert all(s.top == 6 for s in shards[1:]) and all(s.bot == 6 for s in shards[:-1])


def test_edge_weights_of_a_block_are_the_global_rows():
    full = edge_weights(50, 7, 2.0, 3.0, "cpu")
    for row0, rows in ((0, 20), (14, 22), (30, 20)):
        block = edge_weights(rows, 7, 2.0, 3.0, "cpu", row0=row0, height=50)
        assert torch.equal(block[0], full[0]) and torch.equal(block[1], full[1])
        assert torch.equal(block[2], full[2][row0:row0 + rows])
        assert torch.equal(block[3], full[3][row0:row0 + rows])


# ---------------------------------------------------------------------------
# Against the JAX package's sharded relaxations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("constancy", CONSTANCIES)
@pytest.mark.parametrize("outer,inner", [(1, 1), (3, 2)])
def test_plain_matches_tpu_sharded_kernel(outer, inner, constancy):
    # Measured on the CPU: max abs at 1 x 1 1.8e-7 (grey, gradient) and
    # 2.4e-7 (log); mean EPE at 3 x 2 1.5e-6 (grey), 7.6e-7 (gradient) and
    # 4.9e-6 (log), max 1.9e-3, 1.1e-3 and 9.3e-3.
    jcfg, tcfg = cfgs(constancy, outer_iterations_count=outer, inner_iterations_count=inner)
    f0, f1, u, v = bucket_inputs()
    want_du, want_dv = jhalo_kernel.relax_sharded_kernel(f0, f1, u, v, jax_sc(), jcfg,
                                                         jax_mesh(), interpret=True)
    fxyz, uv, J, sc = port_level(f0, f1, u, v, tcfg)
    got = (relax_sharded(fxyz, uv, sc, tcfg, make_mesh(4, device="cpu"), J=J) - uv).numpy()
    if (outer, inner) == (1, 1):
        assert max(np.abs(got[0] - np.asarray(want_du)[:CH, :CW]).max(),
                   np.abs(got[1] - np.asarray(want_dv)[:CH, :CW]).max()) <= 1e-4
    else:
        d = valid_diff(got, want_du, want_dv)
        assert d.mean() <= 5e-5 and d.max() <= 2e-2


def test_plain_matches_tpu_explicit_halo():
    # Measured on the CPU: mean EPE 1.8e-6, max 2.9e-3.
    jcfg, tcfg = cfgs(outer_iterations_count=3, inner_iterations_count=2)
    f0, f1, u, v = bucket_inputs()
    want_du, want_dv = jhalo.relax_sharded(f0, f1, u, v, jax_sc(), jcfg, jax_mesh(), "y",
                                           k_outer=2)
    fxyz, uv, J, sc = port_level(f0, f1, u, v, tcfg)
    got = (relax_sharded(fxyz, uv, sc, tcfg, make_mesh(4, device="cpu"), 2) - uv).numpy()
    d = valid_diff(got, want_du, want_dv)
    assert d.mean() <= 5e-5 and d.max() <= 2e-2


@pytest.mark.parametrize("k", [2, 5])
def test_k_outer_fusion_bitwise_equal_to_k1(k):
    # tests/test_halo_kernel.py:67: one exchange per k fused outers with a
    # k (inner + 1)-row halo leaves the owned rows bit for bit unchanged.
    _, tcfg = cfgs(outer_iterations_count=10, inner_iterations_count=2)
    fxyz, uv, J, sc = port_level(*bucket_inputs(seed=3), tcfg)
    mesh = make_mesh(4, device="cpu")
    assert torch.equal(relax_sharded(fxyz, uv, sc, tcfg, mesh, k),
                       relax_sharded(fxyz, uv, sc, tcfg, mesh, 1))


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_kernel_gate():
    cfg = FlowConfig(inner_iterations_count=5)          # halo(k) = 6k
    assert kernel_halo_applicable(128, 4, cfg, k_outer=2)      # 32 rows >= max(12, 16)
    assert not kernel_halo_applicable(128, 4, cfg, k_outer=6)  # halo 36 > 32 rows
    assert not kernel_halo_applicable(128, 4, FlowConfig(inner_iterations_count=0))
    assert not kernel_halo_applicable(64, 8, cfg)              # 8 rows per shard
    assert kernel_halo_applicable(67, 4, cfg)                  # 17, 17, 17, 16 rows
    assert not kernel_halo_applicable(63, 4, cfg)              # 16, 16, 16, 15 rows
    with pytest.raises(ValueError, match="every shard needs"):
        relax_sharded_kernel(torch.zeros(3, 63, 8), torch.zeros(2, 63, 8), None, cfg,
                             make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="inner sweep"):
        relax_sharded_kernel(torch.zeros(3, 64, 8), torch.zeros(2, 64, 8), None,
                             FlowConfig(inner_iterations_count=0), make_mesh(4, device="cpu"))


@pytest.mark.parametrize("w,h,n_sharded,n_levels", [(1920, 1080, 27, 50), (584, 388, 18, 47)])
def test_sharded_levels_of_the_default_schedule(w, h, n_sharded, n_levels):
    cfg = FlowConfig()
    levels = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    admitted = [s.height for s in levels if kernel_halo_applicable(s.height, 4, cfg)]
    assert len(levels) == n_levels and len(admitted) == n_sharded
    assert min(admitted) >= 64 and all(s.height < 64 for s in levels
                                       if s.height not in admitted)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def blob_pair():
    """The inputs of tests/test_halo_kernel.py:149-157."""
    rng = np.random.default_rng(3)
    h, w = 120, 200
    f0 = (rng.random((h, w), np.float32) * 200).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    g = 150 * np.exp(-((ys - 60) ** 2 + (xs - 90) ** 2) / 200.0)
    f0 += g
    f1 = f0 + np.roll(g, (2, 1), axis=(0, 1)) - g
    return f0, f1


PIPE_CFG = dict(warp_levels_count=4, outer_iterations_count=6, inner_iterations_count=2)


def test_pipeline_matches_tpu_sharded_pipeline():
    # Measured on the CPU: EPE 1.5e-7, max 4.4e-6.
    f0, f1 = blob_pair()
    jcfg, tcfg = cfgs(**PIPE_CFG)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "y"))
    want_u, want_v = map(np.asarray, compute_flow_bucketed_sharded(f0, f1, jcfg, mesh=mesh,
                                                                   halo="kernel"))
    res = compute_flow_sharded(f0, f1, tcfg, mesh=make_mesh(4, device="cpu"), device="cpu")
    assert res.u.shape == f0.shape
    assert endpoint_error(res.u, res.v, want_u, want_v) <= 1e-5
    assert np.hypot(res.u - want_u, res.v - want_v).max() <= 1e-4


@pytest.mark.parametrize("constancy,n_y,k", [("grey", 4, 1), ("gradient", 4, 1), ("log", 4, 1),
                                             ("grey", 3, 2)])
def test_pipeline_bitwise_equal_to_compute_flow(constancy, n_y, k):
    f0, f1 = blob_pair()
    _, tcfg = cfgs(constancy, **PIPE_CFG)
    want = compute_flow(f0, f1, tcfg, device="cpu")
    got = compute_flow_sharded(f0, f1, tcfg, mesh=make_mesh(n_y, device="cpu"), k_outer=k,
                               device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()
    levels = level_schedule(200, 120, tcfg.warp_levels_count, tcfg.warp_scale_factor)
    assert any(kernel_halo_applicable(s.height, n_y, tcfg, k) for s in levels)


def test_launch_counts_cover_the_sharded_kernel():
    relax_sharded_kernel.launches = 3
    assert sharded.launch_counts()["relax_sharded"] == 3
    sharded.reset_launch_counts()
    counts = sharded.launch_counts()
    assert counts["relax_sharded"] == 0 and set(counts) > {"jacobi_sweep", "warp"}
    assert not any(counts.values())


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", ["explicit", "auto", "gspmd"])
def test_unported_halo_modes_raise(halo):
    # explicit and auto are ported (bitwise compute_flow); only gspmd raises
    f0, f1 = blob_pair()
    _, tcfg = cfgs(**PIPE_CFG)
    mesh = make_mesh(4, device="cpu")
    if halo == "gspmd":
        with pytest.raises(NotImplementedError, match="not ported"):
            compute_flow_sharded(f0, f1, tcfg, mesh=mesh, halo=halo, device="cpu")
        return
    got = compute_flow_sharded(f0, f1, tcfg, mesh=mesh, halo=halo, device="cpu")
    want = compute_flow(f0, f1, tcfg, device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()


def test_bad_arguments_raise():
    f0, f1 = blob_pair()
    mesh = make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="halo"):
        compute_flow_sharded(f0, f1, mesh=mesh, halo="ring", device="cpu")
    with pytest.raises(ValueError, match="k_outer"):
        compute_flow_sharded(f0, f1, mesh=mesh, k_outer=0, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        compute_flow_sharded(f0, f1, mesh=Mesh(4, torch.device("cuda")), device="cpu")
    with pytest.raises(ValueError, match="shards"):
        make_mesh(MAX_SHARDS + 1, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        Mesh(0, torch.device("cpu"))
    # a mesh over distinct devices is accepted (make_mesh resolves them, so
    # without CUDA it refuses "cuda:1" for that reason only)
    spread = Mesh(2, devices=["cuda:0", "cuda:1"])
    assert spread.cards == 2 and spread.devices[1] == torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2, device=["cuda:0", "cuda:1"])
    assert make_mesh(2, device=["cpu", "cpu"]) == Mesh(2, torch.device("cpu"))


def test_mesh_device_is_resolved():
    assert resolve_device("cpu") == torch.device("cpu")
    assert make_mesh(3, device=torch.device("cpu")).device == torch.device("cpu")
    if torch.cuda.is_available():
        # an index-free CUDA device takes the current device's index
        assert make_mesh(2).device == torch.device("cuda", torch.cuda.current_device())
        assert Mesh(2, torch.device("cuda")) == make_mesh(2)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda:1")
        assert Mesh(2, torch.device("cuda")).device == torch.device("cuda")


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test is for machines without it")
    f0, f1 = blob_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow_sharded(f0, f1, mesh=make_mesh(4, device="cpu"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)


# ---------------------------------------------------------------------------
# The sharded kernel's work count
# ---------------------------------------------------------------------------


def tiles_design(h, w, n_y, k, tensor, outer=40, inner=5):
    """What the kernel's tile bodies stream over every shard's padded rows:
    per outer one pass of 64-wide prologue tiles and one of k-sweep regions
    (csrc/sharded.cu)."""
    rows = [sh.padded for sh in row_split(h, n_y, k * (inner + 1))]
    return sum(outer * (R._prologue_design_bytes(p, w, tensor, 64)
                        + R._ksweep_design_bytes(p, w, inner)) for p in rows)


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_work_at_one_shard_is_the_unsharded_relax(constancy):
    h, w, outer, inner = 1080, 1920, 40, 5
    _, cfg = cfgs(constancy)
    tensor = constancy != "grey"
    work = R.kernel_work("relax_sharded", h, w, n_y=1, cfg=cfg)
    pro = R.kernel_work("outer_prologue" if constancy == "grey" else "outer_prologue_tensor", h, w)
    sweep = R.kernel_work("jacobi_sweep", h, w)
    # the kernel streams the tiles and regions of the 40 + 40 unsharded
    # launches (its prologue tiles 64 wide where the launch's are 32), and
    # copies the level's planes in and T out once
    consts = 5 + (5 if tensor else 0)
    copies = (consts + (consts + 2) + 2 + 2) * h * w * 4
    assert work["design_bytes"] == copies + tiles_design(h, w, 1, 1, tensor)
    unsharded = outer * (R._prologue_design_bytes(h, w, tensor, 32)
                         + R._ksweep_design_bytes(h, w, inner))
    assert 1.0 < work["design_bytes"] / unsharded < 1.02
    # and does their arithmetic
    for key in ("instructions", "flops"):
        assert work[key] == outer * pro[key] + outer * inner * sweep[key]
    # but the function reads uv, fxyz (and J) once and writes T once, so
    # its bound is the arithmetic
    planes = 2 + 3 + 2 + (0 if constancy == "grey" else 5)
    assert work["bytes"] == planes * h * w * 4
    assert work["bound_by"] == "operations" and work["resource"] == "float32 issue"
    assert work["bound_ms"] == pytest.approx(work["instructions"] / R.F32_ISSUE_PER_S * 1e3)
    assert work["bound_ms"] < outer * pro["bound_ms"] + outer * inner * sweep["bound_ms"]


def test_work_of_four_shards_adds_the_margin_and_the_exchanges():
    h, w, outer, inner, k = 1080, 1920, 40, 5, 1
    one = R.kernel_work("relax_sharded", h, w)
    four = R.kernel_work("relax_sharded", h, w, n_y=4, k=k)
    halo = k * (inner + 1)
    margin = 2 * halo * 3                        # two halos at each of 3 boundaries
    assert sum(sh.padded for sh in row_split(h, 4, halo)) == h + margin
    plane_halos = 3 * 2 * halo * w * 4 * 2      # boundaries x ways x rows x w x 4 B, r + w
    assert four["design_bytes"] - one["design_bytes"] == (
        tiles_design(h, w, 4, k, False) - tiles_design(h, w, 1, k, False)
        + outer * 2 * plane_halos + 5 * plane_halos)
    # the margin and the exchanges are the design's, not the function's
    for key in ("bytes", "instructions", "flops", "bound_ms"):
        assert four[key] == one[key]
    # k = 2: twice the halo, one exchange of the iterate per 2 outers
    k2 = R.kernel_work("relax_sharded", h, w, n_y=4, k=2)
    no_outer = R.kernel_work("relax_sharded", h, w, n_y=4, k=2,
                             cfg=FlowConfig(outer_iterations_count=0))
    assert k2["design_bytes"] - no_outer["design_bytes"] == (
        tiles_design(h, w, 4, 2, False) + (outer // 2) * 2 * (2 * plane_halos))
    # the gradient/log tensor: 5 more planes per prologue pixel, J's halos
    # once, and J copied in
    grad = R.kernel_work("relax_sharded", h, w, n_y=4, cfg=cfgs("gradient")[1])
    assert grad["design_bytes"] - four["design_bytes"] == (
        (h + margin) * outer * 5 * w * 4 + 5 * plane_halos + 2 * 5 * h * w * 4)
    assert grad["bytes"] - four["bytes"] == 5 * h * w * 4


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------


def test_sharded_modules_import_no_jax():
    code = (
        "import sys, tpuflow_torch.parallel, tpuflow_torch.solver.sharded\n"
        "import tpuflow_torch.parallel.model, tpuflow_torch.parallel.hybrid\n"
        "import tpuflow_torch.parallel.multihost, tpuflow_torch.tools.report_scaling\n"
        "import tpuflow_torch.ops.device_cache\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuflow')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)

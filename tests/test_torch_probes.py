"""The port's two measurement probes and its work counts, on the CPU:

  * ``tpuflow_torch.tools.roofline.microkernel(name)`` (the plain fold of
    ``roofline_micro``) against ``tools/roofline.microkernel(name)`` run in
    Pallas interpret mode, for all six bodies, at the probe's (392, 640)
    field and 2 x 8 passes, chained twice;
  * ``probe_kernel_matmul.probe_matmul`` (its plain k-ordered sum) against
    ``tools/probe_kernel_matmul.in_kernel`` (interpret mode) and ``in_xla``
    on the probe's seeded inputs, and against a numpy fold in k order at
    odd (M, K, N);
  * ``kernel_work``'s plane counts and bounds for every kernel, and
    ``pair_bounds``, its sum over one pair's level schedule;
  * the measurement entry points and the graph-replay timer raise without
    a card.

Bounds: the chained step ``x + 1e-4 * y`` may be contracted into one fused
multiply-add by XLA, so the folds agree to 1 ulp, not bitwise: rtol 1e-6.
The matmuls sum 9 non-zero products per output in different orders: rel
(max abs diff over max |value|) 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpuflow_torch.tools import probe_kernel_matmul as P
from tpuflow_torch.tools import roofline as R

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_roofline(monkeypatch, tmp_path):
    """tools/roofline.py, imported with its jit cache in ``tmp_path``; the
    jax cache settings its import changes are put back afterwards."""
    monkeypatch.setenv("TPUFLOW_JIT_CACHE", str(tmp_path / "jit_cache"))
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", os.environ["JAX_COMPILATION_CACHE_DIR"])
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.syspath_prepend(REPO)
    import tools.roofline as jr

    for k, v in saved.items():
        jax.config.update(k, v)
    monkeypatch.setattr(jr, "T_LOOP", 2)
    monkeypatch.setattr(R, "T_LOOP", 2)
    return jr


@pytest.mark.parametrize("name", list(R.BODIES))
def test_microkernel_matches_tpu_probe(jax_roofline, name):
    jr = jax_roofline
    assert (jr.HB, jr.WB, jr.N_IN, jr.UNROLL) == (R.HB, R.WB, R.N_IN, R.UNROLL)
    ins = np.random.default_rng(0).random((R.N_IN, R.HB, R.WB), np.float32) + 0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jr.microkernel(name)(tuple(jnp.asarray(a) for a in ins), 2))
    got = R.microkernel(name)(torch.from_numpy(ins), 2).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(R.BODIES))
def test_roofline_micro_plain_is_the_fold(name):
    # 3 x 8 passes by hand, the edge rule of the shifts included: the last
    # column (row) reads the second-to-last, a mirror.
    rng = np.random.default_rng(1)
    ins = torch.from_numpy(rng.random((R.N_IN, 5, 6), np.float32) + 0.5)
    body = R.BODIES[name][0]
    x = ins[0] * 0.5
    for _ in range(3):
        for j in range(R.UNROLL):
            x = body(x, ins[j])
    got = R.roofline_micro(name, ins[0], ins[1:], 3)
    assert torch.equal(got, x)
    a = ins[3]
    if name == "shift_x":
        assert torch.equal(R._shift_xp(a)[:, -1], a[:, -2])
    if name == "shift_y":
        assert torch.equal(R._shift_yp(a)[-1], a[-2])


def test_roofline_micro_rejects_bad_shapes():
    x = torch.ones(4, 6)
    with pytest.raises(ValueError, match="rest"):
        R.roofline_micro("stream", x, torch.ones(6, 4, 6), 1)
    with pytest.raises(ValueError, match="wide"):
        R.roofline_micro("stream", torch.ones(2, R.MAX_WIDTH + 1),
                         torch.ones(7, 2, R.MAX_WIDTH + 1), 1)
    with pytest.raises(KeyError):
        R.microkernel("nope")


def test_matmul_probe_matches_tpu_probe(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import tools.probe_kernel_matmul as jp

    a, b = P.probe_inputs()
    assert a.shape == (jp.HB, jp.H0) and b.shape == (jp.H0, jp.W0)
    got = P.probe_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    with pltpu.force_tpu_interpret_mode():
        in_kernel = np.asarray(jp.in_kernel(jnp.asarray(a), jnp.asarray(b)))
    in_xla = np.asarray(jp.in_xla(jnp.asarray(a), jnp.asarray(b)))
    for want in (in_kernel, in_xla):
        res = P.compare(got, want)
        assert res["rel"] <= 1e-6, res
    assert (np.count_nonzero(a, axis=1) == 9).all()


def test_matmul_probe_plain_sums_in_k_order():
    rng = np.random.default_rng(2)
    a = rng.random((5, 7), np.float32)
    b = rng.random((7, 3), np.float32)
    got = P.probe_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.zeros((5, 3), np.float32)
    for k in range(7):
        want = want + a[:, k:k + 1] * b[k:k + 1, :]
    assert (got == want).all()
    with pytest.raises(ValueError, match="shape"):
        P.probe_matmul(torch.ones(2, 3), torch.ones(4, 2))


@pytest.mark.parametrize("m,k,n", [(5, 449, 7), (65, 17, 641)])
def test_matmul_probe_plain_sums_in_k_order_odd_shapes(m, k, n):
    # the odd shapes chip_smoke.py holds the kernel to (4-byte copies,
    # partial tiles and k-chunks), on the probe's banded inputs
    a, b = P.probe_inputs(m, k, n)
    assert a.shape == (m, k) and b.shape == (k, n)
    assert (np.count_nonzero(a, axis=1) == min(9, k)).all()
    got = P.probe_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.zeros((m, n), np.float32)
    for j in range(k):
        want = want + a[:, j:j + 1] * b[j:j + 1, :]
    assert (got == want).all()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-6


def test_probe_inputs_default_to_the_probe():
    a, b = P.probe_inputs()
    a2, b2 = P.probe_inputs(P.HB, P.H0, P.W0)
    assert np.array_equal(a, a2) and np.array_equal(b, b2)
    assert a.shape == (P.HB, P.H0) and b.shape == (P.H0, P.W0)


# planes read + written, from each kernel's source in csrc/level.cu
PLANES = {"warp": 5, "level_derivs": 5, "level_tensor_gradient": 8, "level_tensor_log": 7,
          "outer_prologue": 16, "outer_prologue_tensor": 21, "jacobi_sweep": 17,
          "jacobi_sweeps": 15, "add_median": 6}


@pytest.mark.parametrize("name", list(PLANES))
def test_kernel_work_planes_and_bound(name):
    h, w = 2160, 3840
    work = R.kernel_work(name, h, w)
    assert work["bytes"] == PLANES[name] * h * w * 4 and work["shared_bytes"] == 0
    t_bytes = work["bytes"] / R.PEAK_BYTES_PER_S * 1e3
    t_ops = work["instructions"] / R.F32_ISSUE_PER_S * 1e3
    assert work["bound_ms"] == max(t_bytes, t_ops)
    assert work["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # an instruction is at most 2 flops (an FFMA), and the issue rate is half the flop rate
    assert work["instructions"] <= work["flops"] <= 2 * work["instructions"]
    assert t_ops >= work["flops"] / R.PEAK_FLOPS * 1e3


def test_kernel_work_what_binds():
    by = {n: R.kernel_work(n, 2160, 3840)["bound_by"] for n in PLANES}
    assert set(by.values()) == {"bytes", "operations"}
    # the 5x5 median: u + (T - u) once and 99 compare-exchanges per plane,
    # a min and a max each, at the issue rate
    assert by["add_median"] == "operations"
    assert R.kernel_work("add_median", 10, 10)["instructions"] == 100 * 2 * (2 + 2 * 99)
    assert R.kernel_work("add_median", 10, 10, radius=3)["instructions"] == 100 * 2 * (2 + 2 * 19)
    with pytest.raises(KeyError, match="7x7"):
        R.kernel_work("add_median", 10, 10, radius=7)
    # the log tensor needs 2 log1pf per pixel, not the kernel's 32: bytes bind
    log = R.kernel_work("level_tensor_log", 1, 1)
    grad = R.kernel_work("level_tensor_gradient", 1, 1)
    assert log["instructions"] == grad["instructions"] + 7 + 2 * 7 + 2 * 18
    assert by["level_tensor_log"] == "bytes" and by["level_tensor_gradient"] == "bytes"
    assert by["jacobi_sweep"] == "bytes" and by["outer_prologue_tensor"] == "bytes"
    assert by["jacobi_sweeps"] == "bytes"
    # phi once per pixel, and the prologues differ by the grey J's 5 products
    pro, pro_t = R.kernel_work("outer_prologue", 1, 1), R.kernel_work("outer_prologue_tensor", 1, 1)
    assert pro["instructions"] - pro_t["instructions"] == 5
    sweep = R.kernel_work("jacobi_sweep", 1, 1)
    assert sweep["instructions"] == R.SWEEP_COUNTS["flops"] + 2 * R.LIBRARY_OPS["div"][0]
    assert sweep["flops"] == R.SWEEP_COUNTS["flops"] + 2 * R.LIBRARY_OPS["div"][1]
    assert R.SWEEP_COUNTS["loads"] + R.SWEEP_COUNTS["stores"] == 22


@pytest.mark.parametrize("inner", [1, 2, 5])
def test_kernel_work_of_the_k_sweep(inner):
    """One launch of ``inner`` sweeps: 13 planes read and 2 written once,
    ``inner`` sweeps of arithmetic; the overlapping tiles' re-reads are
    design bytes."""
    from tpuflow_torch.ops.level import KMAX, ksweep_tiles

    h, w = 2160, 3840
    ks = R.kernel_work("jacobi_sweeps", h, w, inner=inner)
    one = R.kernel_work("jacobi_sweep", h, w)
    assert ks["bytes"] == 15 * h * w * 4
    assert ks["instructions"] == inner * one["instructions"]
    assert ks["flops"] == inner * one["flops"]
    assert ks["bytes"] < ks["design_bytes"] < 15 * h * w * 4 * 2.5
    # the design bytes by hand at 2x2: one block, the whole level, no ring
    tiny = R.kernel_work("jacobi_sweeps", 2, 2, inner=inner)
    assert tiny["design_bytes"] == tiny["bytes"] == 15 * 4 * 4
    assert len(list(ksweep_tiles(2, 2, inner))) == 1
    with pytest.raises(ValueError, match="sweeps"):
        R.kernel_work("jacobi_sweeps", h, w, inner=KMAX + 1)
    with pytest.raises(ValueError, match="sweeps"):
        R.kernel_work("jacobi_sweeps", h, w, inner=0)


def test_kernel_work_probes():
    npix, passes = R.HB * R.WB, R.PASSES
    micro = R.kernel_work("roofline_micro_stream", R.HB, R.WB)
    assert micro["bytes"] == (R.N_IN + 1) * R.FIELD_BYTES
    assert micro["instructions"] == micro["flops"] == passes * npix
    # one shared-memory load per pass binds the add bodies, not their adds
    assert micro["shared_bytes"] == passes * R.FIELD_BYTES
    assert micro["resource"] == "shared memory" and micro["bound_by"] == "bytes"
    assert micro["bound_ms"] == micro["shared_bytes"] / R.SHARED_BYTES_PER_S * 1e3
    assert R.kernel_work("roofline_micro_fma", R.HB, R.WB)["resource"] == "shared memory"
    phi = R.kernel_work("roofline_micro_phi", R.HB, R.WB)
    sqrt, rcp = R.LIBRARY_OPS["sqrt"], R.LIBRARY_OPS["rcp"]
    assert phi["instructions"] == passes * npix * (3 + sqrt[0] + rcp[0])
    assert phi["flops"] == passes * npix * (3 + sqrt[1] + rcp[1])
    assert phi["resource"] == "float32 issue" and phi["bound_by"] == "operations"
    mm = R.kernel_work("probe_matmul", P.HB, P.W0)
    assert mm["flops"] == 2 * mm["instructions"] == 2 * P.HB * P.H0 * P.W0
    assert mm["bytes"] == 4 * (P.HB * P.H0 + P.H0 * P.W0 + P.HB * P.W0)
    with pytest.raises(KeyError):
        R.kernel_work("nope", 4, 4)


@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
def test_pair_bounds_weigh_each_level_by_its_size(constancy):
    from tpuflow_torch.config import DataConstancy, FlowConfig
    from tpuflow_torch.pyramid import level_schedule

    cfg = FlowConfig(data_constancy=DataConstancy(constancy))
    w, h = 240, 135
    pb = R.pair_bounds(w, h, cfg)
    levels = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    prologue = "outer_prologue" if constancy == "grey" else "outer_prologue_tensor"
    tensor = {"grey": set(), "gradient": {"level_tensor_gradient"},
              "log": {"level_tensor_log"}}[constancy]
    assert set(pb) == ({"warp", "level_derivs", "jacobi_sweeps", "add_median", prologue} | tensor
                       | {"banded_x", "banded_y"})
    outer, inner = cfg.outer_iterations_count, cfg.inner_iterations_count
    # one k-sweep launch per outer iteration at inner <= KMAX
    assert pb["jacobi_sweeps"]["launches"] == len(levels) * outer
    want = sum(outer * R.kernel_work("jacobi_sweeps", s.height, s.width, inner=inner)["bound_ms"]
               for s in levels)
    assert pb["jacobi_sweeps"]["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert pb[prologue]["launches"] == len(levels) * outer
    want = sum(outer * R.kernel_work(prologue, s.height, s.width)["bound_ms"] for s in levels)
    assert pb[prologue]["bound_ms"] == pytest.approx(want, rel=1e-12)
    # every level but the finest is smaller than level 0
    level0 = pb[prologue]["launches"] * R.kernel_work(prologue, h, w)["bound_ms"]
    assert pb[prologue]["bound_ms"] < level0 / 3


@pytest.mark.parametrize("constancy,inner", [("grey", 5), ("gradient", 5), ("log", 7),
                                             ("grey", 0)])
def test_level_bound_is_the_pair_bound_of_one_level(constancy, inner):
    """level_bound_ms (what the per-level trace is read against) sums the
    same launches as pair_bounds: over the schedule they agree."""
    from tpuflow_torch.config import DataConstancy, FlowConfig
    from tpuflow_torch.pyramid import level_schedule

    cfg = FlowConfig(data_constancy=DataConstancy(constancy), inner_iterations_count=inner)
    w, h = 240, 135
    levels = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    total = sum(v["bound_ms"] for k, v in R.pair_bounds(w, h, cfg).items()
                if k not in ("banded_x", "banded_y"))
    assert sum(R.level_bound_ms(s.height, s.width, cfg) for s in levels) == pytest.approx(
        total, rel=1e-12)
    names = [name for name, _, _ in R.level_launches(cfg)]
    assert names.count("jacobi_sweeps") == -(-inner // 5)
    assert ("add_median", 1, {"radius": 5}) in R.level_launches(cfg)


@pytest.mark.parametrize("inner,launches", [(0, 0), (3, 1), (5, 1), (7, 2), (10, 2), (11, 3)])
def test_pair_bounds_split_the_inner_loop_into_k_sweep_launches(inner, launches):
    from tpuflow_torch.config import FlowConfig
    from tpuflow_torch.ops.level import KMAX
    from tpuflow_torch.pyramid import level_schedule

    cfg = FlowConfig(inner_iterations_count=inner, outer_iterations_count=4)
    w, h = 120, 90
    pb = R.pair_bounds(w, h, cfg)
    levels = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    if not launches:
        assert "jacobi_sweeps" not in pb
        return
    assert pb["jacobi_sweeps"]["launches"] == len(levels) * 4 * launches
    chunks = [min(KMAX, inner - d) for d in range(0, inner, KMAX)]
    want = sum(4 * R.kernel_work("jacobi_sweeps", s.height, s.width, inner=k)["bound_ms"]
               for s in levels for k in chunks)
    assert pb["jacobi_sweeps"]["bound_ms"] == pytest.approx(want, rel=1e-12)


def test_measurements_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.measure()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.run()


@pytest.mark.parametrize("capturing, counted", [(False, 1), (True, 0)])
def test_probe_matmul_counts_only_launches_it_makes(monkeypatch, capturing, counted):
    monkeypatch.setattr(P, "on_cuda", lambda *t: True)
    monkeypatch.setattr(P, "launch", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    monkeypatch.setattr(P.probe_matmul, "launches", 0)
    P.probe_matmul(torch.zeros(2, 3), torch.zeros(3, 4))
    assert P.probe_matmul.launches == counted


def test_graph_timer_raises_without_cuda(monkeypatch):
    from tpuflow_torch.profile_pair import prologue_by_level, sweeps_by_level

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.graph_ms(lambda: calls.append(1))
    assert calls == []
    with pytest.raises(RuntimeError, match="CUDA"):
        prologue_by_level(64, 48)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweeps_by_level(64, 48)


@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
def test_profile_names_every_kernel_of_the_pair(constancy):
    """level_kernels_by_gap finds each kernel of pair_bounds by its
    demangled name, and the one-sweep kernel's pattern does not take the
    k-sweep kernel's launches."""
    from tpuflow_torch.config import DataConstancy, FlowConfig
    from tpuflow_torch.profile_pair import LEVEL_KERNELS

    cfg = FlowConfig(data_constancy=DataConstancy(constancy))
    assert set(R.pair_bounds(64, 48, cfg)) <= set(LEVEL_KERNELS)
    ksweep = "void (anonymous namespace)::jacobi_sweeps_kernel<5, false>(const float*, ...)"
    hits = [name for name, pattern in LEVEL_KERNELS.items() if pattern in ksweep]
    assert hits == ["jacobi_sweeps"]


def test_probe_modules_import_no_jax():
    code = (
        "import sys, tpuflow_torch.tools.roofline, tpuflow_torch.tools.probe_kernel_matmul\n"
        "import tpuflow_torch.profile_pair\n"
        "import tpuflow_torch.utils.timing, tpuflow_torch.utils.profiling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuflow', 'tools')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)

"""The streaming path of tpuflow_torch on the CPU, against the JAX package:
process_sequence (names, manifest, flows, chain, resume, mesh=),
FrameLoader, the (B, H, W) front door, compute_flow_async, write_flow_vtk
and flow_energy. Inputs come from numpy with a seed; JAX runs on the CPU and
arrays pass between the two packages as numpy."""

import json
import os

import numpy as np
import pytest
import torch

from tpuflow import compute_flow as jax_compute_flow
from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.io import write_raw_f32, write_raw_u8
from tpuflow.io.loader import FrameLoader as JFrameLoader
from tpuflow.io.vtk import write_flow_vtk as jax_write_flow_vtk
from tpuflow.parallel.multihost import process_sequence as jax_process_sequence
from tpuflow.utils.diagnostics import flow_energy as jax_flow_energy

from tpuflow_torch import (
    DataConstancy, FlowConfig, compute_flow, compute_flow_async, compute_flow_sharded,
    endpoint_error, make_mesh,
)
from tpuflow_torch.io import FrameLoader, write_flow_vtk
from tpuflow_torch.parallel.multihost import SequenceManifest, process_rank, process_sequence
from tpuflow_torch.utils.diagnostics import flow_energy

torch.set_num_threads(2)

W, H = 24, 16
# The schedule of tests/test_aux.py:38-45.
CFG_KW = dict(warp_levels_count=2, warp_scale_factor=0.6, outer_iterations_count=3,
              inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8)
CFG = FlowConfig(**CFG_KW)
JCFG = JFlowConfig(**CFG_KW)
CONSTANCIES = ("grey", "gradient", "log")
STEMS = ("flow-u-24-16.raw", "flow-v-24-16.raw", "res.pgm", "amp-24-16.raw")


def make_seq(d, n=4, w=W, h=H, seed=0):
    """n u8 frames: a blob moving 0.5 px a frame on seeded noise; n - 1 pairs."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    noise = rng.random((h, w), dtype=np.float32) * 20.0
    paths = []
    for i in range(n):
        img = noise + 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2 - 0.5 * i) ** 2) / 18.0)
        p = os.path.join(d, f"f{i}.raw")
        write_raw_u8(p, img)
        paths.append(p)
    return [(paths[i], paths[i + 1]) for i in range(n - 1)]


def read_uv(out, pid):
    return [np.fromfile(os.path.join(out, f"{pid}flow-{c}-{W}-{H}.raw"), dtype="<f4")
            .reshape(H, W) for c in "uv"]


def manifest_ids(out):
    with open(os.path.join(out, "manifest.jsonl")) as f:
        return [json.loads(line)["pair"] for line in f if line.strip()]


def pair_frames(rng, b=None, w=W, h=H):
    shape = (h, w) if b is None else (b, h, w)
    f0 = (rng.random(shape, dtype=np.float32) * 255.0).astype(np.float32)
    return f0, np.roll(f0, 1, axis=-1) + rng.random(shape, dtype=np.float32)


# --- process_sequence -------------------------------------------------------

@pytest.mark.parametrize("n_frames", [2, 4])
def test_process_sequence_matches_jax(tmp_path, n_frames):
    pairs = make_seq(str(tmp_path), n=n_frames)
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    done = process_sequence(pairs, W, H, out, CFG, device="cpu")
    jdone = jax_process_sequence(pairs, W, H, jout, JCFG)
    ids = [f"{i:05d}_" for i in range(n_frames - 1)]
    assert done == jdone == ids
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert manifest_ids(out) == manifest_ids(jout) == ids
    for pid in ids:
        got, want = read_uv(out, pid), read_uv(jout, pid)
        assert np.isfinite(got).all()
        assert endpoint_error(*got, *want) <= 1e-4, pid


@pytest.mark.parametrize("chain", [2, 3, 5])
def test_process_sequence_chain_bytewise_chain_1(tmp_path, chain):
    pairs = make_seq(str(tmp_path), n=5)
    out1, outc = str(tmp_path / "out1"), str(tmp_path / "outc")
    done1 = process_sequence(pairs, W, H, out1, CFG, device="cpu")
    donec = process_sequence(pairs, W, H, outc, CFG, chain=chain, device="cpu")
    assert done1 == donec == [f"{i:05d}_" for i in range(4)]
    for pid in done1:
        for stem in STEMS:
            with open(os.path.join(out1, pid + stem), "rb") as a, \
                    open(os.path.join(outc, pid + stem), "rb") as b:
                assert a.read() == b.read(), pid + stem
    assert process_sequence(pairs, W, H, outc, CFG, chain=chain, device="cpu") == []


def test_process_sequence_bytewise_compute_flow(tmp_path):
    """The files are compute_flow's flow through the same writers."""
    from tpuflow_torch.io import read_frame
    from tpuflow_torch.parallel.multihost import write_pair

    pairs = make_seq(str(tmp_path), n=3)
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    os.makedirs(ref)
    process_sequence(pairs, W, H, out, CFG, device="cpu")
    for i, (p0, p1) in enumerate(pairs):
        res = compute_flow(read_frame(p0, W, H), read_frame(p1, W, H), CFG, device="cpu")
        write_pair(ref, f"{i:05d}_", res.u, res.v, W, H)
    for name in os.listdir(ref):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("chain", [1, 2])
def test_process_sequence_resume(tmp_path, chain):
    pairs = make_seq(str(tmp_path), n=5)
    out = str(tmp_path / "out")
    # a manifest that already holds pairs 0 and 2: exactly 1 and 3 remain
    manifest = SequenceManifest(os.path.join(out, "manifest.jsonl"))
    os.makedirs(out)
    manifest.record("00000_", 0.0)
    manifest.record("00002_", 0.0)
    assert process_sequence(pairs, W, H, out, CFG, chain=chain, device="cpu") == [
        "00001_", "00003_"]
    assert not os.path.exists(os.path.join(out, "00000_res.pgm"))
    assert manifest.done() == {f"{i:05d}_" for i in range(4)}
    assert process_sequence(pairs, W, H, out, CFG, chain=chain, device="cpu") == []
    # resume=False solves every pair again
    assert len(process_sequence(pairs, W, H, out, CFG, resume=False, device="cpu")) == 4


def test_process_sequence_mesh_raises(tmp_path):
    # process_sequence(mesh=) runs: groups of n_data pairs, one a data
    # position, byte for byte the files of chain=1; with a chain it raises
    pairs = make_seq(str(tmp_path), n=5)
    ref, out = str(tmp_path / "ref"), str(tmp_path / "out")
    assert process_sequence(pairs, W, H, ref, CFG, device="cpu") == [
        f"{i:05d}_" for i in range(4)]
    mesh = make_mesh((3, 1), ["cpu"] * 3)
    assert process_sequence(pairs, W, H, out, CFG, mesh=mesh, device="cpu") == [
        f"{i:05d}_" for i in range(4)]
    for name in sorted(os.listdir(ref)):
        if name != "manifest.jsonl":
            with open(os.path.join(ref, name), "rb") as a, open(os.path.join(out, name),
                                                              "rb") as b:
                assert a.read() == b.read(), name
    with pytest.raises(ValueError, match="exclude each other"):
        process_sequence(pairs, W, H, str(tmp_path / "o2"), CFG, chain=2, mesh=mesh,
                         device="cpu")
    assert not os.path.exists(tmp_path / "o2")


def test_process_sequence_bad_chain(tmp_path):
    with pytest.raises(ValueError, match="chain"):
        process_sequence(make_seq(str(tmp_path), n=2), W, H, str(tmp_path / "o"), CFG,
                         chain=0, device="cpu")


def test_process_rank_without_a_group():
    assert process_rank() == (0, 1)


# --- FrameLoader --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["u8", "f32", "mixed"])
def test_frame_loader_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        img = rng.random((20, 32), dtype=np.float32) * 300.0 - 20.0
        p = str(tmp_path / f"f{i}.raw")
        f32 = dtype == "f32" or (dtype == "mixed" and i % 2)
        (write_raw_f32 if f32 else write_raw_u8)(p, img)
        paths.append(p)
    with FrameLoader(paths, 32, 20) as ld, JFrameLoader(paths, 32, 20, force_numpy=True) as jld:
        for _ in paths:
            got, want = ld.next(), jld.next()
            assert got.dtype == np.float32 and got.shape == (20, 32)
            assert got.tobytes() == want.tobytes()
        with pytest.raises(IndexError):
            ld.next()
        with pytest.raises(IndexError):
            jld.next()


def test_frame_loader_closed_is_exhausted(tmp_path):
    p = str(tmp_path / "a.raw")
    write_raw_u8(p, np.zeros((4, 4), np.float32))
    with FrameLoader([p, p], 4, 4) as ld:
        ld.next()
    with pytest.raises(IndexError):
        ld.next()


# --- the (B, H, W) front door and compute_flow_async --------------------------

@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_batch_front_door(constancy):
    rng = np.random.default_rng(11)
    f0, f1 = pair_frames(rng, b=3)
    cfg = FlowConfig(data_constancy=DataConstancy(constancy), **CFG_KW)
    res = compute_flow(f0, f1, cfg, device="cpu")
    assert res.u.shape == res.v.shape == (3, H, W)
    for i in range(3):
        one = compute_flow(f0[i], f1[i], cfg, device="cpu")
        assert res.u[i].tobytes() == one.u.tobytes() and res.v[i].tobytes() == one.v.tobytes()
    jres = jax_compute_flow(f0, f1, JFlowConfig(data_constancy=JDataConstancy(constancy),
                                                **CFG_KW))
    assert endpoint_error(res.u, res.v, np.asarray(jres.u), np.asarray(jres.v)) <= 1e-4
    assert res.megapixels_per_second == pytest.approx(3 * H * W / res.seconds / 1e6)


def test_batch_front_door_rejects_trace():
    f0, f1 = pair_frames(np.random.default_rng(0), b=2)
    with pytest.raises(ValueError, match="collect_trace"):
        compute_flow(f0, f1, CFG, collect_trace=True, device="cpu")


@pytest.mark.parametrize("shapes", [((2, H, W), (3, H, W)), ((H, W), (2, H, W)),
                                    ((2, 2, H, W), (2, 2, H, W))])
def test_front_door_rejects_mismatched_shapes(shapes):
    with pytest.raises(ValueError, match="expected two equal"):
        compute_flow(np.zeros(shapes[0], np.float32), np.zeros(shapes[1], np.float32), CFG,
                     device="cpu")


def test_sharded_rejects_a_stack():
    # a stack goes through compute_flow(..., mesh=), bitwise the stack
    # without a mesh; compute_flow_sharded refuses it and names that call
    f0, f1 = pair_frames(np.random.default_rng(0), b=2)
    with pytest.raises(ValueError, match=r"compute_flow\(\.\.\., mesh=\)"):
        compute_flow_sharded(f0, f1, CFG, mesh=make_mesh(2, "cpu"), device="cpu")
    got = compute_flow(f0, f1, CFG, mesh=make_mesh(2, "cpu"), device="cpu")
    want = compute_flow(f0, f1, CFG, device="cpu")
    assert got.u.tobytes() == want.u.tobytes() and got.v.tobytes() == want.v.tobytes()


@pytest.mark.parametrize("constancy", CONSTANCIES)
def test_compute_flow_async_bitwise(constancy):
    f0, f1 = pair_frames(np.random.default_rng(5))
    cfg = FlowConfig(data_constancy=DataConstancy(constancy), **CFG_KW)
    uv = compute_flow_async(f0, f1, cfg, device="cpu")
    res = compute_flow(f0, f1, cfg, device="cpu")
    assert isinstance(uv, torch.Tensor) and uv.shape == (2, H, W) and uv.dtype == torch.float32
    assert uv[0].numpy().tobytes() == res.u.tobytes()
    assert uv[1].numpy().tobytes() == res.v.tobytes()


def test_compute_flow_async_rejects_a_stack():
    f0, f1 = pair_frames(np.random.default_rng(0), b=2)
    with pytest.raises(ValueError, match=r"\(H, W\) frames"):
        compute_flow_async(f0, f1, CFG, device="cpu")


@pytest.mark.parametrize("entry", ["compute_flow_async", "process_sequence", "flow_energy",
                                   "compute_flow_stack"])
def test_cuda_default_raises_without_cuda(tmp_path, entry):
    # Decided here, not at import: every xdist worker must collect the same tests.
    if torch.cuda.is_available():
        pytest.skip("checks the machine without CUDA")
    f0, f1 = pair_frames(np.random.default_rng(0))
    calls = {
        "compute_flow_async": lambda: compute_flow_async(f0, f1, CFG),
        "process_sequence": lambda: process_sequence(make_seq(str(tmp_path), n=2), W, H,
                                                     str(tmp_path / "o"), CFG),
        "flow_energy": lambda: flow_energy(f0, f1, f0 * 0, f0 * 0, CFG),
        "compute_flow_stack": lambda: compute_flow(f0[None], f1[None], CFG),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


# --- write_flow_vtk ---------------------------------------------------------------

@pytest.mark.parametrize("shape,name", [((2, 2), "flow"), ((7, 11), "flow"), ((16, 24), "uv")])
def test_vtk_bytewise_jax(tmp_path, shape, name):
    rng = np.random.default_rng(7)
    u = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    v = (rng.standard_normal(shape) * 1e-4).astype(np.float32)
    a, b = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    write_flow_vtk(u, v, a, name=name)
    jax_write_flow_vtk(u, v, b, name=name)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_vtk_rejects_bad_fields(tmp_path):
    with pytest.raises(ValueError):
        write_flow_vtk(np.zeros((2, 3)), np.zeros((3, 2)), str(tmp_path / "x.vtk"))


# --- flow_energy -------------------------------------------------------------------

@pytest.mark.parametrize("constancy", CONSTANCIES)
@pytest.mark.parametrize("h", [1.0, 1.7])
def test_flow_energy_matches_jax(constancy, h):
    rng = np.random.default_rng(13)
    f0, f1 = pair_frames(rng, w=40, h=32)
    u = (rng.standard_normal((32, 40)) * 0.7).astype(np.float32)
    v = (rng.standard_normal((32, 40)) * 0.7).astype(np.float32)
    cfg = FlowConfig(data_constancy=DataConstancy(constancy))
    jcfg = JFlowConfig(data_constancy=JDataConstancy(constancy))
    got = flow_energy(f0, f1, u, v, cfg, hx=h, hy=h * 0.9, device="cpu")
    want = jax_flow_energy(f0, f1, u, v, jcfg, hx=h, hy=h * 0.9)
    for field in ("data", "smoothness", "total"):
        assert float(getattr(got, field)) == pytest.approx(float(getattr(want, field)),
                                                           rel=1e-5), field


# tests/test_aux.py:157 is grey at alpha 35. With the gradient and log
# tensors, whose quadratic form takes J33 from the grey ft, the energy falls
# where the data term leads (the JAX package's does the same): alpha 1e-3.
@pytest.mark.parametrize("constancy,alpha", [("grey", 35.0), ("grey", 1e-3),
                                             ("gradient", 1e-3), ("log", 1e-3)])
def test_flow_energy_decreases_with_solving(constancy, alpha):
    ys, xs = np.mgrid[0:32, 0:40].astype(np.float32)
    f0 = 200.0 * np.exp(-((ys - 16) ** 2 + (xs - 20) ** 2) / 40.0)
    f1 = 200.0 * np.exp(-((ys - 16.8) ** 2 + (xs - 21.1) ** 2) / 40.0)
    cfg = FlowConfig(warp_levels_count=3, warp_scale_factor=0.6, outer_iterations_count=8,
                     inner_iterations_count=3, median_radius=3, gaussian_sigma=0.8,
                     equation_alpha=alpha, data_constancy=DataConstancy(constancy))
    zero = np.zeros_like(f0)
    e0 = flow_energy(f0, f1, zero, zero, cfg, device="cpu")
    res = compute_flow(f0, f1, cfg, device="cpu")
    e1 = flow_energy(f0, f1, torch.from_numpy(res.u), torch.from_numpy(res.v), cfg,
                     device="cpu")
    assert float(e1.total) < float(e0.total)
    assert float(e1.data) < float(e0.data)
    assert np.isfinite(float(e1.smoothness))

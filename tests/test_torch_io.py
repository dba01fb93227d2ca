"""tpuflow_torch.io against tpuflow.io: the RAW files are byte-equal, the
frames read back equal, and the colour circle, its P6 PPM and the
magnitude file are the same bytes as tpuflow's numpy path. tpuflow.io uses
its native codec instead where it is built; that codec multiplies by
1/scale where the numpy path divides by the scale, so its colour channels
may floor one lower or higher at a few pixels, and the port is held to
within 1 of it there."""

import os

import numpy as np
import pytest

import tpuflow.io.flow_viz as jviz
import tpuflow.io.raw as jraw

import tpuflow_torch.io as tio


@pytest.fixture(params=["as_built", "numpy"])
def jax_io(request, monkeypatch):
    """(tpuflow.io.raw, tpuflow.io.flow_viz, the colour tolerance) as they
    load (the native codec where built), or on their numpy path."""
    if request.param == "numpy" or jviz._codec is None:
        monkeypatch.setattr(jraw, "_codec", None)
        monkeypatch.setattr(jviz, "_codec", None)
        return jraw, jviz, 0
    return jraw, jviz, 1


def rgb_diff(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def image(h=23, w=31, seed=0):
    rng = np.random.default_rng(seed)
    # Out-of-range and fractional values exercise the u8 clamp and truncation.
    return (rng.random((h, w)) * 300.0 - 20.0).astype(np.float32)


def flow(h=29, w=37, seed=1):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((h, w)) * 8.0).astype(np.float32)
    v = (rng.standard_normal((h, w)) * 8.0).astype(np.float32)
    u[0, :5] = 0.0                       # the x == 0 branches of the phase
    v[0, :3] = [0.0, 2.0, -2.0]
    u[1, :4], v[1, :4] = [3.0, -3.0, 3.0, -3.0], [0.0, 0.0, -1.0, 1.0]
    u[2, :2], v[2, :2] = [100.0, -50.0], [100.0, 0.0]  # amplitude clipped at 1
    return u, v


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_raw_write_byte_equal(tmp_path, kind):
    img = image()
    ours, theirs = tmp_path / "ours.raw", tmp_path / "theirs.raw"
    getattr(tio, f"write_raw_{kind}")(str(ours), img)
    getattr(jraw, f"write_raw_{kind}")(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size == img.size * (1 if kind == "u8" else 4)


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_raw_read_equal(tmp_path, jax_io, kind):
    jr, _, _ = jax_io
    path = str(tmp_path / "frame.raw")
    getattr(jr, f"write_raw_{kind}")(path, image())
    got = getattr(tio, f"read_raw_{kind}")(path, 31, 23)
    want = getattr(jr, f"read_raw_{kind}")(path, 31, 23)
    assert got.dtype == np.float32 and got.shape == (23, 31)
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()
    assert tio.read_frame(path, 31, 23).tobytes() == jr.read_frame(path, 31, 23).tobytes()


def test_read_frame_rejects_other_sizes(tmp_path):
    path = str(tmp_path / "frame.raw")
    tio.write_raw_u8(path, image())
    with pytest.raises(ValueError, match="matches neither"):
        tio.read_frame(path, 30, 23)
    with pytest.raises(ValueError, match="too small"):
        tio.read_raw_f32(path, 31, 23)


def test_flow_to_rgb_equal(jax_io):
    _, jv, tol = jax_io
    u, v = flow()
    for scale in (10.0, 3.0):
        got = tio.flow_to_rgb(u, v, scale)
        assert got.dtype == np.uint8 and got.shape == u.shape + (3,)
        assert rgb_diff(got, jv.flow_to_rgb(u, v, scale)) <= tol


def test_flow_image_and_magnitude_files_equal(tmp_path, jax_io):
    _, jv, tol = jax_io
    u, v = flow(seed=4)
    names = ("res.pgm", "amp.raw")
    for tag, mod in (("ours", tio), ("theirs", jv)):
        os.makedirs(tmp_path / tag)
        mod.write_flow_image_rgb(u, v, 10, str(tmp_path / tag / names[0]))
        mod.write_magnitude_f32(u, v, str(tmp_path / tag / names[1]))
    read = lambda tag, name: (tmp_path / tag / name).read_bytes()  # noqa: E731
    assert read("ours", "amp.raw") == read("theirs", "amp.raw")
    header = b"P6 \n37 29 \n255\n"
    ours, theirs = read("ours", "res.pgm"), read("theirs", "res.pgm")
    assert ours.startswith(header) and theirs.startswith(header)
    assert len(ours) == len(header) + 37 * 29 * 3 == len(theirs)
    body = lambda b: np.frombuffer(b[len(header):], np.uint8)  # noqa: E731
    assert rgb_diff(body(ours), body(theirs)) <= tol

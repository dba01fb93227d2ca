"""tpuflow_torch.cli on the CPU (``--device cpu``): the cases of
tests/test_cli.py (settings file, positional with counter, parameter
sweep, f32 autodetect, bad usage), outputs against tpuflow.cli's and
against an in-process compute_flow, the constancy flag, the flags that are
not ported yet, the CUDA default, and an import that loads no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuflow.cli import main as jmain
from tpuflow.io import write_raw_f32, write_raw_u8

from tpuflow_torch import DataConstancy, FlowConfig, compute_flow, endpoint_error
from tpuflow_torch.cli import main
from tpuflow_torch.io import read_frame

torch.set_num_threads(2)

W, H = 32, 24
OUTPUTS = [f"amp-{W}-{H}.raw", f"flow-u-{W}-{H}.raw", f"flow-v-{W}-{H}.raw", "res.pgm"]
# Settings of tests/test_cli.py: 2 levels, 3 x 2 iterations, radius 3, sigma 0.8.
SETTINGS_CFG = dict(warp_levels_count=2, warp_scale_factor=0.7, outer_iterations_count=3,
                    inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8)
SETTINGS_TMPL = """<?xml version="1.0"?>
<OpticalFlow>
  <Input>
    <Path inputPath="{inp}/"/>
    <Mode Nx="32" Ny="24" imageType="8-bit">
      <Files file1="a.raw" file2="b.raw"/>
    </Mode>
  </Input>
  <Parameters>
    <Method mode="2d" run="flow" key="0"/>
    <Solver>
      <Iterations inner="2" outer="3"/>
      <Warping levels="2" scaling="0.7" medianRadius="3"/>
      <Model sigma="0.8" alpha="35" e_smooth="0.001" e_data="0.001"/>
    </Solver>
  </Parameters>
  <Output>
    <Path outputPath="{out}/"/>
  </Output>
</OpticalFlow>
"""


def make_frames(d, w=W, h=H):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f0 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2) ** 2) / 32.0)
    f1 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2 - 1) ** 2) / 32.0)
    write_raw_u8(os.path.join(d, "a.raw"), f0)
    write_raw_u8(os.path.join(d, "b.raw"), f1)


def settings_file(tmp_path):
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    make_frames(str(inp))
    settings = tmp_path / "settings.xml"
    settings.write_text(SETTINGS_TMPL.format(inp=inp, out=out))
    return settings, inp, out


def read_uv(out, prefix=""):
    return [np.fromfile(out / f"{prefix}flow-{c}-{W}-{H}.raw", dtype="<f4").reshape(H, W)
            for c in "uv"]


def check_outputs(out, prefix=""):
    assert sorted(os.listdir(out)) == sorted(prefix + n for n in OUTPUTS)
    for name in OUTPUTS:
        size = (out / (prefix + name)).stat().st_size
        assert size == (len(f"P6 \n{W} {H} \n255\n") + W * H * 3 if name == "res.pgm"
                        else W * H * 4), name
    u, v = read_uv(out, prefix)
    assert np.isfinite(u).all() and np.isfinite(v).all()
    return u, v


@pytest.mark.parametrize("constancy", [None, "gradient", "log"])
def test_settings_mode_matches_compute_flow(tmp_path, constancy):
    settings, inp, out = settings_file(tmp_path)
    flag = [] if constancy is None else ["--constancy", constancy]
    assert main([str(settings), "--quiet", "--device", "cpu", *flag]) == 0
    u, v = check_outputs(out)
    assert (out / "res.pgm").read_bytes().startswith(b"P6 \n32 24 \n255\n")
    cfg = FlowConfig(data_constancy=DataConstancy(constancy or "grey"), **SETTINGS_CFG)
    res = compute_flow(read_frame(str(inp / "a.raw"), W, H), read_frame(str(inp / "b.raw"), W, H),
                       cfg, device="cpu")
    assert u.tobytes() == res.u.tobytes() and v.tobytes() == res.v.tobytes()


@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
def test_settings_mode_matches_tpuflow_cli(tmp_path, constancy):
    settings, _, out = settings_file(tmp_path)
    assert main([str(settings), "--quiet", "--device", "cpu", "--constancy", constancy]) == 0
    got = read_uv(out)
    jout = tmp_path / "jout"
    settings.write_text(settings.read_text().replace(f"{out}/", f"{jout}/"))
    assert jmain([str(settings), "--quiet", "--constancy", constancy]) == 0
    want = read_uv(jout)
    assert endpoint_error(*got, *want) <= 1e-3
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))


def test_positional_mode_with_counter(tmp_path):
    make_frames(str(tmp_path))
    out = tmp_path / "out"
    rc = main([str(tmp_path / "a.raw"), str(tmp_path / "b.raw"), "32", "24", "007", str(out),
               "--quiet", "--device", "cpu"])
    assert rc == 0
    check_outputs(out, prefix="007")


def test_positional_sweep_mode_embeds_params(tmp_path):
    make_frames(str(tmp_path))
    out = tmp_path / "out"
    rc = main([str(tmp_path / "a.raw"), str(tmp_path / "b.raw"), "32", "24", "x", str(out),
               "10", "0.8", "--quiet", "--device", "cpu"])
    assert rc == 0
    check_outputs(out, prefix="alpha10_sigma0.8_")


def test_f32_frames_autodetected(tmp_path):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    f = 100.0 * np.exp(-((ys - 12) ** 2 + (xs - 16) ** 2) / 32.0)
    write_raw_f32(os.path.join(tmp_path, "a.raw"), f)
    write_raw_f32(os.path.join(tmp_path, "b.raw"), f)
    out = tmp_path / "out"
    rc = main([str(tmp_path / "a.raw"), str(tmp_path / "b.raw"), "32", "24", str(out),
               "--quiet", "--device", "cpu"])
    assert rc == 0
    u, _ = check_outputs(out)
    assert np.abs(u).max() < 1e-3  # identical frames -> zero flow


@pytest.mark.parametrize("argv", [["one", "two", "3"], ["missing-settings.xml"],
                                  ["a", "b", "32", "24", "c", "d", "e"]])
def test_bad_usage(argv):
    with pytest.raises(SystemExit):
        main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("flags", [["--sequence", "x_*.raw", "--size", "24x16", "--out", "o"],
                                   ["--chain", "2"], ["--warp-report"]])
def test_unported_flags_exit(tmp_path, flags):
    settings, _, out = settings_file(tmp_path)
    with pytest.raises(SystemExit, match="not ported yet"):
        main([str(settings), "--device", "cpu", *flags])
    assert not out.exists()


@pytest.mark.parametrize("device_flag", [[], ["--device", "cuda"]])
def test_cuda_device_raises_without_cuda(tmp_path, device_flag):
    # Decided here, not at import: every xdist worker must collect the same tests.
    if torch.cuda.is_available():
        pytest.skip("checks the machine without CUDA")
    settings, _, _ = settings_file(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(settings), "--quiet", *device_flag])


def test_module_entry_point_runs(tmp_path):
    settings, _, out = settings_file(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "tpuflow_torch.cli", str(settings),
                           "--device", "cpu", "--constancy", "log"],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "log constancy" in proc.stdout and "wrote" in proc.stdout
    check_outputs(out)


def test_cli_import_loads_no_jax():
    code = (
        "import sys, tpuflow_torch.cli, tpuflow_torch.io\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpuflow' or m.startswith('tpuflow.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

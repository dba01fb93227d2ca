"""tpuflow_torch.cli on the CPU (``--device cpu``): the cases of
tests/test_cli.py (settings file, positional with counter, parameter
sweep, f32 autodetect, bad usage, the sequence mode), outputs against
tpuflow.cli's and against an in-process compute_flow, the constancy flag,
--chain and --warp-report, the CUDA default, and imports that load no
JAX."""

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


SEQ_W, SEQ_H = 24, 16


def make_sequence(d, n=3):
    """tests/test_cli.py:115's frames: a blob moving 0.5 px a frame."""
    ys, xs = np.mgrid[0:SEQ_H, 0:SEQ_W].astype(np.float32)
    for i in range(n):
        img = 200.0 * np.exp(-((ys - 8) ** 2 + (xs - 12 - 0.5 * i) ** 2) / 18.0)
        write_raw_u8(os.path.join(d, f"seq_{i:03d}.raw"), img)
    return str(d / "seq_*.raw")


def sequence_argv(glob, out, *extra):
    return ["--sequence", glob, "--size", f"{SEQ_W}x{SEQ_H}", "--out", str(out), "--quiet",
            "--device", "cpu", *extra]


def test_sequence_mode_writes_files_and_manifest(tmp_path):
    out = tmp_path / "seqout"
    assert main(sequence_argv(make_sequence(tmp_path), out)) == 0
    files = os.listdir(out)
    for pid in ("00000_", "00001_"):
        for stem in (f"flow-u-{SEQ_W}-{SEQ_H}.raw", f"flow-v-{SEQ_W}-{SEQ_H}.raw", "res.pgm",
                     f"amp-{SEQ_W}-{SEQ_H}.raw"):
            assert pid + stem in files
    assert "manifest.jsonl" in files and len(files) == 9
    with open(out / "manifest.jsonl") as f:
        assert [line.split('"')[3] for line in f] == ["00000_", "00001_"]
    # a second run resumes: nothing left to solve
    assert main(sequence_argv(make_sequence(tmp_path), out)) == 0
    assert len((out / "manifest.jsonl").read_text().splitlines()) == 2


@pytest.mark.parametrize("drop", ["--size", "--out", "both"])
def test_sequence_mode_requires_size_and_out(tmp_path, drop):
    argv = sequence_argv(str(tmp_path / "x_*.raw"), tmp_path / "o")
    for flag in (["--size", "--out"] if drop == "both" else [drop]):
        i = argv.index(flag)
        del argv[i:i + 2]
    with pytest.raises(SystemExit, match="--size WxH and --out DIR"):
        main(argv)


def test_sequence_mode_needs_two_frames(tmp_path):
    make_sequence(tmp_path, n=1)
    with pytest.raises(SystemExit, match="matched 1 files"):
        main(sequence_argv(str(tmp_path / "seq_*.raw"), tmp_path / "o"))


@pytest.mark.parametrize("chain", ["2", "3"])
def test_sequence_chain_bytewise_chain_1(tmp_path, chain):
    glob = make_sequence(tmp_path, n=4)
    out1, outc = tmp_path / "out1", tmp_path / "outc"
    assert main(sequence_argv(glob, out1)) == 0
    assert main(sequence_argv(glob, outc, "--chain", chain)) == 0
    names = sorted(n for n in os.listdir(out1) if n != "manifest.jsonl")
    assert len(names) == 12 and sorted(os.listdir(outc)) == sorted(os.listdir(out1))
    for name in names:
        assert (out1 / name).read_bytes() == (outc / name).read_bytes(), name


@pytest.mark.parametrize("n_frames", [3, 4])
def test_sequence_matches_tpuflow_cli(tmp_path, n_frames):
    # the CLI's configuration: FlowConfig(), grey, the default schedule
    glob = make_sequence(tmp_path, n=n_frames)
    out, jout = tmp_path / "out", tmp_path / "jout"
    assert main(sequence_argv(glob, out)) == 0
    assert jmain(["--sequence", glob, "--size", f"{SEQ_W}x{SEQ_H}", "--out", str(jout),
                  "--quiet"]) == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for pid in (f"{i:05d}_" for i in range(n_frames - 1)):
        got, want = ([np.fromfile(d / f"{pid}flow-{c}-{SEQ_W}-{SEQ_H}.raw", dtype="<f4")
                      for c in "uv"] for d in (out, jout))
        assert np.isfinite(got).all()
        assert endpoint_error(*got, *want) <= 1e-4, pid


def test_warp_report_prints_its_line(tmp_path, capsys):
    settings, inp, out = settings_file(tmp_path)
    assert main([str(settings), "--device", "cpu", "--warp-report"]) == 0
    lines = capsys.readouterr().out.splitlines()
    report = [line for line in lines if line.startswith("warp-report: ")]
    assert report == ["warp-report: every level within the ±4 px displacement class"]
    # the files are compute_flow's, bit for bit
    u, v = check_outputs(out)
    res = compute_flow(read_frame(str(inp / "a.raw"), W, H), read_frame(str(inp / "b.raw"), W, H),
                       FlowConfig(**SETTINGS_CFG), device="cpu")
    assert u.tobytes() == res.u.tobytes() and v.tobytes() == res.v.tobytes()


def test_warp_report_quiet_still_reports(tmp_path, capsys):
    settings, _, _ = settings_file(tmp_path)
    assert main([str(settings), "--device", "cpu", "--warp-report", "--quiet"]) == 0
    assert capsys.readouterr().out.startswith("warp-report: ")


@pytest.mark.parametrize("flags,message", [
    (["--chain", "2"], "--chain applies to --sequence only"),
    (["--sequence", "x_*.raw", "--size", "24x16", "--out", "o", "--warp-report"],
     "does not apply to --sequence"),
])
def test_flag_misuse_exits(tmp_path, flags, message):
    settings, _, out = settings_file(tmp_path)
    with pytest.raises(SystemExit, match=message):
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
        "import sys, tpuflow_torch.cli, tpuflow_torch.io, tpuflow_torch.bench\n"
        "import tpuflow_torch.io.loader, tpuflow_torch.io.vtk\n"
        "import tpuflow_torch.parallel.multihost, tpuflow_torch.utils.diagnostics\n"
        "from tpuflow_torch import compute_flow_async, compute_flow_warp_report\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpuflow' or m.startswith('tpuflow.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

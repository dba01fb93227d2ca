"""tpuflow_torch's configuration, settings.xml reader, schedule, level
constants and oracle copy, held exactly equal to the JAX package's; and the
port imports no JAX."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpuflow.models as jmodels
import tpuflow.oracle as joracle
from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow.config import FlowConfig as JFlowConfig
from tpuflow.config import IOConfig as JIOConfig
from tpuflow.config import load_settings_xml as jload_settings_xml
from tpuflow.pyramid import level_schedule as jlevel_schedule
from tpuflow.solver.bucketed import LevelScalars as JLevelScalars

import tpuflow_torch.models as tmodels
from tpuflow_torch import oracle_np
from tpuflow_torch.config import (
    DataConstancy, FlowConfig, IOConfig, from_jax_config, load_settings_xml,
)
from tpuflow_torch.pyramid import level_schedule
from tpuflow_torch.solver.level import LevelScalars

torch.set_num_threads(2)

SIZES = [(584, 388, 47), (1920, 1080, 50), (3840, 2160, 50)]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["data_constancy"] = cfg.data_constancy.value
    return out


def test_defaults_equal_jax():
    assert _fields(FlowConfig()) == _fields(JFlowConfig())
    assert [f.name for f in dataclasses.fields(FlowConfig)] == [
        f.name for f in dataclasses.fields(JFlowConfig)]


@pytest.mark.parametrize("bad", [
    dict(warp_scale_factor=0.0), dict(warp_scale_factor=1.0),
    dict(warp_levels_count=0), dict(median_radius=8),
])
def test_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JFlowConfig(**bad)
    with pytest.raises(ValueError):
        FlowConfig(**bad)


@pytest.mark.parametrize("as_dict", [False, True])
def test_from_jax_config(as_dict):
    jcfg = JFlowConfig(warp_levels_count=12, warp_scale_factor=0.75,
                       outer_iterations_count=7, median_radius=3,
                       data_constancy=JDataConstancy.LOG_DERIVATIVES)
    src = dataclasses.asdict(jcfg) if as_dict else jcfg
    cfg = from_jax_config(src)
    assert isinstance(cfg, FlowConfig)
    assert cfg.data_constancy is DataConstancy.LOG_DERIVATIVES
    assert _fields(cfg) == _fields(jcfg)


def test_from_jax_config_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        from_jax_config({"warp_levels_count": 3, "engine": "levels"})
    with pytest.raises(TypeError):
        from_jax_config(42)


@pytest.mark.parametrize("name", ["horn_schunck", "brox", "full_model",
                                  "xray_log", "reference_default"])
def test_presets_equal_jax(name):
    assert _fields(getattr(tmodels, name)()) == _fields(getattr(jmodels, name)())


@pytest.mark.parametrize("w,h,n_levels", SIZES)
def test_level_schedule_equals_jax(w, h, n_levels):
    cfg = FlowConfig()
    got = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    want = jlevel_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    assert len(got) == n_levels
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]


@pytest.mark.parametrize("w,h,n_levels", SIZES)
def test_level_scalars_equal_jax(w, h, n_levels):
    cfg = FlowConfig()
    specs = level_schedule(w, h, cfg.warp_levels_count, cfg.warp_scale_factor)
    prev = specs[0]
    for s in specs:
        got = LevelScalars.make(s.width, s.height, s.hx, s.hy, cfg.equation_alpha)
        want = JLevelScalars.make(s.width, s.height, s.hx, s.hy, cfg.equation_alpha,
                                  w, h, prev.width, prev.height)
        for f in dataclasses.fields(LevelScalars):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert np.asarray(a).tobytes() == np.asarray(b).astype(
                np.asarray(a).dtype).tobytes(), (s.level, f.name, a, b)
            assert a == b, (s.level, f.name)
        prev = s


# A reference-schema settings.xml with every field off its default.
SETTINGS_XML = """<?xml version="1.0"?>
<OpticalFlow>
  <Input>
    <Path inputPath="/data/in/"/>
    <Mode Nx="640" Ny="480" imageType="8-bit">
      <Files file1="f_001.raw" file2="f_002.raw"/>
    </Mode>
  </Input>
  <Parameters>
    <Method mode="2d" run="flow" key="{key}"/>
    <Solver>
      <Iterations inner="7" outer="12"/>
      <Warping levels="20" scaling="0.8" medianRadius="3"/>
      <Model sigma="1.2" alpha="20.5" e_smooth="0.002" e_data="0.0005"/>
    </Solver>
  </Parameters>
  <Output>
    <Path outputPath="/data/out/"/>
  </Output>
</OpticalFlow>
"""


def test_io_config_defaults_equal_jax():
    assert dataclasses.asdict(IOConfig()) == dataclasses.asdict(JIOConfig())


@pytest.mark.parametrize("key", ["0", "1"])
def test_load_settings_xml_equals_jax(tmp_path, key):
    path = tmp_path / "settings.xml"
    path.write_text(SETTINGS_XML.format(key=key))
    flow, io = load_settings_xml(str(path))
    jflow, jio = jload_settings_xml(str(path))
    assert _fields(flow) == _fields(jflow)
    assert dataclasses.asdict(io) == dataclasses.asdict(jio)
    assert (io.width, io.height, io.file_name2, io.press_key) == (640, 480, "f_002.raw",
                                                                  key == "1")
    assert flow.warp_levels_count == 20 and flow.equation_data == 0.0005


@pytest.mark.parametrize("drop", ["<Output>", "<Solver>"])
def test_load_settings_xml_missing_element_raises(tmp_path, drop):
    text = SETTINGS_XML.format(key="0")
    tag = drop.strip("<>")
    start, end = text.index(drop), text.index(f"</{tag}>") + len(f"</{tag}>")
    path = tmp_path / "settings.xml"
    path.write_text(text[:start] + text[end:])
    with pytest.raises(ValueError, match="missing element"):
        jload_settings_xml(str(path))
    with pytest.raises(ValueError, match="missing element"):
        load_settings_xml(str(path))


def test_import_loads_no_jax():
    code = (
        "import sys, tpuflow_torch, tpuflow_torch.solver.level, tpuflow_torch.oracle_np, "
        "tpuflow_torch.models, tpuflow_torch.cli, tpuflow_torch.io\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpuflow' or m.startswith('tpuflow.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_oracle_copy_bitwise_equal():
    rng = np.random.default_rng(11)
    f0 = (rng.random((30, 41)) * 255).astype(np.float32)
    f1 = np.roll(f0, 1, axis=1) + rng.standard_normal((30, 41)).astype(np.float32)
    kw = dict(warp_levels_count=4, warp_scale_factor=0.7, outer_iterations_count=3,
              inner_iterations_count=2, median_radius=5, gaussian_sigma=1.2)
    got = oracle_np.compute_flow(f0, f1, **kw)
    want = joracle.compute_flow(f0, f1, **kw)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()

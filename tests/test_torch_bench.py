"""tpuflow_torch.bench on the CPU: the JSON record carries bench.py's keys,
``epe_px`` is null with a reason without the rub raws, the fallback frames
are bench.py's, the arguments, and the bench raises without CUDA. And the
default schedule (FlowConfig()'s levels, 40 x 5) of the port's plain path
against the NumPy oracle for the three constancies, which is what the bench's
``--epe`` measures on the card at 584x388."""

import os
import re

import numpy as np
import pytest
import torch

from tpuflow_torch import bench, endpoint_error, models, oracle_np
from tpuflow_torch.config import FlowConfig
from tpuflow_torch.synthetic import textured_pair

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_py_keys():
    """The keys of bench.py's one JSON line, from its docstring (lines 3-7)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        head = "".join(f.readlines()[2:7])
    return re.findall(r'"(\w+)":', head)


def record(**kw):
    args = dict(w=584, h=388, preset="grey", slopes=[0.2, 0.1, 0.4], pair_ms=[300.0, 250.0],
                card="NVIDIA H100 80GB HBM3, 700.00 W", k=16, k_lo=4)
    args.update(kw)
    return bench.make_record(args.pop("w"), args.pop("h"), args.pop("preset"),
                             args.pop("slopes"), args.pop("pair_ms"), args.pop("card"), **args)


def test_record_has_bench_py_keys():
    keys = bench_py_keys()
    assert keys == list(bench.KEYS)
    rec = record()
    assert set(keys) <= set(rec)
    assert rec["unit"] == "Mpix/s"
    assert {"card", "pair_ms_median"} <= set(rec)


def test_record_values():
    rec = record()
    mpix = sorted(584 * 388 / s / 1e6 for s in (0.2, 0.1, 0.4))
    assert rec["mpix_s_min"] == mpix[0] and rec["mpix_s_max"] == mpix[-1]
    # the median over runs, not bench.py's best
    assert rec["value"] == rec["mpix_s_median"] == mpix[1]
    assert rec["vs_baseline"] == rec["value"] / bench.SELF_BASELINE_MPIX_S
    assert rec["pair_ms_median"] == 275.0
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_epe_null_with_reason_without_rub_raws():
    if all(os.path.exists(p) for p in bench.RUB):
        pytest.skip("checks a checkout without the rub raws")
    f0, f1, is_rub = bench.load_frames(584, 388)
    assert not is_rub
    epe = bench.rub_epe(np.zeros_like(f0), np.zeros_like(f0), is_rub, "grey")
    assert epe[0] is None and epe[1] is None and "absent" in epe[2]
    rec = record(epe=epe)
    assert rec["epe_px"] is None and rec["epe_ok"] is None and rec["epe_reason"] == epe[2]


@pytest.mark.parametrize("preset", ["full_model", "xray_log"])
def test_epe_null_for_other_presets(preset):
    epe = bench.rub_epe(None, None, True, preset)
    assert epe[:2] == (None, None) and preset in epe[2]


def test_record_without_reason_when_epe_measured():
    rec = record(epe=(1e-6, True, None))
    assert rec["epe_px"] == 1e-6 and rec["epe_ok"] is True and "epe_reason" not in rec


@pytest.mark.parametrize("w,h", [(584, 388), (64, 48)])
def test_fallback_frames_are_bench_py_s(w, h):
    f0, f1 = bench.fallback_frames(w, h)
    # bench.py:121-127, at (w, h)
    rng = np.random.default_rng(0)
    base = rng.random((h, w), dtype=np.float32) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = 80.0 * np.exp(-((ys - h // 2) ** 2 + (xs - w // 2) ** 2) / (2 * 40.0**2))
    assert f0.tobytes() == (base * 0.3 + blob).astype(np.float32).tobytes()
    assert f1.tobytes() == (base * 0.3 + np.roll(blob, (2, 3), axis=(0, 1))).astype(
        np.float32).tobytes()


@pytest.mark.parametrize("preset,constancy", [("grey", "grey"), ("full_model", "gradient"),
                                              ("xray_log", "log")])
def test_preset_config(preset, constancy):
    assert bench.preset_config(preset).data_constancy.value == constancy
    with pytest.raises(ValueError):
        bench.preset_config("horn_schunck")


@pytest.mark.parametrize("argv,size", [([], (584, 388)), (["--size", "1920X1080"], (1920, 1080))])
def test_parse_args(argv, size):
    args = bench.parse_args(argv)
    assert (args.width, args.height) == size
    assert (args.runs, args.pairs, args.preset, args.epe) == (6, 96, "grey", False)


@pytest.mark.parametrize("argv", [["--pairs", "1"], ["--runs", "0"], ["--preset", "other"]])
def test_parse_args_rejects(argv):
    with pytest.raises(SystemExit):
        bench.parse_args(argv)


def test_bench_raises_without_cuda():
    # Decided here, not at import: every xdist worker must collect the same tests.
    if torch.cuda.is_available():
        pytest.skip("checks the machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--size", "64x48", "--runs", "1", "--pairs", "2"])


# The default schedule: every level of FlowConfig() (scale 0.9), 40 outer x 5
# inner, on the shifted texture at 96x64, the port's plain path against the
# oracle within the parity contract's 0.05 px mean EPE.
@pytest.mark.parametrize("constancy", ["grey", "gradient", "log"])
def test_default_schedule_against_oracle(constancy):
    from tpuflow_torch import compute_flow

    cfg = {"grey": FlowConfig(), "gradient": models.full_model(),
           "log": models.xray_log(alpha=bench.EPE_LOG_ALPHA)}[constancy]
    assert (cfg.warp_levels_count, cfg.outer_iterations_count,
            cfg.inner_iterations_count) == (50, 40, 5)
    f0, f1 = textured_pair(96, 64)
    res = compute_flow(f0, f1, cfg, device="cpu")
    ou, ov = oracle_np.compute_flow(f0, f1, data_constancy=constancy,
                                    equation_alpha=cfg.equation_alpha)
    assert endpoint_error(res.u, res.v, ou, ov) <= bench.EPE_TARGET_PX

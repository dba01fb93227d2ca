"""The per-level trace of the front door and the timing helpers, on the CPU:

  * ``compute_flow(..., collect_trace=True)`` gives the same (level, width,
    height) records as ``tpuflow.compute_flow(collect_trace=True)`` on a
    small blob pair, and the same flow, bit for bit, as the untraced call;
  * ``format_level_table`` prints the text of ``tpuflow.utils.timing``'s;
  * ``profiling.trace`` raises without a card.
"""

import numpy as np
import pytest
import torch

from tpuflow import FlowConfig as JFlowConfig
from tpuflow.config import DataConstancy as JDataConstancy
from tpuflow import compute_flow as jcompute_flow
from tpuflow.solver.flow2d import LevelTrace as JLevelTrace
from tpuflow.utils.timing import Timer as JTimer
from tpuflow.utils.timing import format_level_table as jformat_level_table

from tpuflow_torch import DataConstancy, FlowConfig, LevelTrace, compute_flow
from tpuflow_torch.utils import profiling
from tpuflow_torch.utils.timing import Timer, format_level_table

torch.set_num_threads(2)

SCHEDULE = dict(warp_levels_count=4, warp_scale_factor=0.7, outer_iterations_count=2,
                inner_iterations_count=2, median_radius=3)


def blob_pair(h=24, w=32):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f0 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2) ** 2) / 32.0)
    f1 = 200.0 * np.exp(-((ys - h / 2) ** 2 + (xs - w / 2 - 1) ** 2) / 32.0)
    return f0, f1


@pytest.mark.parametrize("constancy", ["grey", "gradient"])
def test_collect_trace_levels_match_tpuflow(constancy):
    f0, f1 = blob_pair()
    cfg = FlowConfig(data_constancy=DataConstancy(constancy), **SCHEDULE)
    traced = compute_flow(f0, f1, cfg, collect_trace=True, device="cpu")
    plain = compute_flow(f0, f1, cfg, device="cpu")
    want = jcompute_flow(f0, f1, JFlowConfig(data_constancy=JDataConstancy(constancy), **SCHEDULE),
                         collect_trace=True)
    assert [(t.level, t.width, t.height) for t in traced.levels] == \
        [(t.level, t.width, t.height) for t in want.levels]
    assert len(traced.levels) == 4
    assert all(isinstance(t, LevelTrace) and t.seconds > 0.0 for t in traced.levels)
    assert plain.levels == []
    assert traced.u.tobytes() == plain.u.tobytes() and traced.v.tobytes() == plain.v.tobytes()


def test_level_table_text_matches_tpuflow():
    records = [(3, 29, 20, 0.0123), (2, 41, 28, 0.5), (1, 584, 388, 1.25e-13),
               (0, 3840, 2160, 0.61234)]
    got = format_level_table([LevelTrace(*r) for r in records])
    want = jformat_level_table([JLevelTrace(*r) for r in records])
    assert got == want
    assert got.splitlines()[0] == want.splitlines()[0] and len(got.splitlines()) == 5


def test_timer_measures_the_block():
    with Timer() as t, JTimer() as jt:
        sum(range(1000))
    assert 0.0 <= jt.seconds <= t.seconds  # the inner timer exits first


def test_profiling_trace_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()

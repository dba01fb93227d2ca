"""Several processes of tpuflow_torch on the CPU: ``initialize_distributed``
joins two processes into one gloo group over localhost, and
``process_sequence`` splits 4 pairs between them by index into one shared
manifest (the port of tests/test_multihost.py:95-133, at a reduced
schedule on small frames). Also the single-process no-op."""

import os
import socket
import subprocess
import sys

import pytest

from tpuflow_torch.parallel.multihost import initialize_distributed, process_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import numpy as np
import torch.distributed as dist
from tpuflow_torch import FlowConfig
from tpuflow_torch.io import write_raw_f32
from tpuflow_torch.parallel.multihost import (
    initialize_distributed, process_rank, process_sequence,
)

port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if pid == 0:
    initialize_distributed(f"localhost:{port}", num_processes=2, process_id=0)
else:
    # the other process finds its rank and the group through torch's env://
    os.environ.update(TPUFLOW_NUM_PROCESSES="2", MASTER_ADDR="localhost", MASTER_PORT=port,
                      RANK="1", WORLD_SIZE="2")
    initialize_distributed()
assert process_rank() == (pid, 2), process_rank()
assert dist.get_backend() == "gloo"
cfg = FlowConfig(warp_levels_count=2, warp_scale_factor=0.5, outer_iterations_count=2,
                 inner_iterations_count=2, median_radius=3, gaussian_sigma=0.8)
h, w = 48, 64
indir = os.path.join(out, "frames")
if pid == 0:
    rng = np.random.default_rng(0)
    os.makedirs(indir)
    for i in range(5):
        write_raw_f32(os.path.join(indir, f"f{i}.raw"), rng.random((h, w), np.float32) * 255)
dist.barrier()
pairs = [(os.path.join(indir, f"f{i}.raw"), os.path.join(indir, f"f{i + 1}.raw"))
         for i in range(4)]
done = process_sequence(pairs, w, h, out, cfg, device="cpu")
expect = [f"{i:05d}_" for i in range(4) if i % 2 == pid]
assert done == expect, (pid, done, expect)
dist.barrier()
dist.destroy_process_group()
print(f"MP OK pid={pid} pairs={done}")
"""


def test_two_process_sequence(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFLOW_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "out"
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(pid), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{text[-4000:]}"
        assert f"MP OK pid={pid}" in text, text[-2000:]
    lines = (out / "manifest.jsonl").read_text().strip().splitlines()
    assert len(lines) == 4
    assert sorted(f.name for f in out.glob("*res.pgm")) == [f"{i:05d}_res.pgm" for i in range(4)]


def test_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("TPUFLOW_NUM_PROCESSES", raising=False)
    initialize_distributed()
    monkeypatch.setenv("TPUFLOW_NUM_PROCESSES", "1")
    initialize_distributed()
    assert process_rank() == (0, 1)


def test_mesh_needs_a_single_process_and_no_chain(tmp_path):
    from tpuflow_torch import FlowConfig, make_mesh
    from tpuflow_torch.parallel.multihost import process_sequence

    with pytest.raises(ValueError, match="exclude each other"):
        process_sequence([], 8, 8, str(tmp_path), FlowConfig(), chain=2,
                         mesh=make_mesh((2, 1), "cpu"), device="cpu")

"""Processes and streaming sequences: ``initialize_distributed``, the
resumable manifest and ``process_sequence`` (the port of
tpuflow/parallel/multihost.py:29-48, :51-263).

Frame pairs are independent, so recovery is re-processing: the manifest
records a pair only after its four files are written, and ``resume`` skips
the pairs it holds. Several processes split a sequence by pair index, with
the rank and world size of an initialised ``torch.distributed`` group.

On the card the host overlaps the device. The main thread reads the frames
and submits each pair with ``compute_flow_async`` (uploads from pinned
staging buffers, no fence); each flow (or each chunk of ``chain`` flows,
stacked on the device) goes down on a copy stream of its own, which waits
only for that work, into pinned memory; one writer thread waits for that
copy and writes the files, in order. With ``mesh=`` each group of
``n_data`` pairs is solved one pair a data position, each on its position's
stream, and fetched on the copy stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.io import FrameLoader, write_flow_image_rgb, write_magnitude_f32, write_raw_f32
from tpuflow_torch.parallel.group import process_group, process_rank  # noqa: F401
from tpuflow_torch.parallel.mesh import resolve_device
from tpuflow_torch.solver.flow2d import _device, _full_float32, _on, compute_flow_async


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join this process to a ``torch.distributed`` group; a no-op for a
    single process (neither argument given and ``TPUFLOW_NUM_PROCESSES``
    unset or at most 1, as in the JAX package). The group rendezvouses at
    ``tcp://coordinator_address`` (``host:port``), or, without it, by
    torch's ``env://`` variables (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE). It runs over NCCL where CUDA is available, over gloo
    otherwise; on the card each process takes the card of its local rank
    (LOCAL_RANK, else its rank modulo the cards). A gloo group beside it
    (``group.process_group``) carries every host object a mesh over the
    processes exchanges; NCCL's communicator is made lazily, at the first
    batch of tensor messages (``make_mesh`` over processes sends one where
    every process has a card of its own), so two ranks on one card join
    without complaint."""
    if num_processes is None and coordinator_address is None:
        env_procs = os.environ.get("TPUFLOW_NUM_PROCESSES")
        if env_procs is None or int(env_procs) <= 1:
            return
    dist = torch.distributed
    cuda = torch.cuda.is_available()
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if cuda:
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo", **kw)
    process_group()   # the gloo group for host objects, made by every process at once


def run_processes(command: Sequence[str], world: int, timeout: float,
                  cwd: Optional[str] = None) -> List[Tuple[Optional[int], str]]:
    """Start ``world`` processes of ``command`` at once, each with three
    more arguments, ``localhost:PORT RANK WORLD`` (a free port), for
    ``initialize_distributed``; wait for all of them within ``timeout``
    seconds and kill what is left. Returns (exit code, None where killed at
    the timeout; standard output and error) by rank."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([*command, f"localhost:{port}", str(r), str(world)], cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline, out = time.monotonic() + timeout, []
    try:
        for p in procs:
            try:
                text = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                out.append((p.returncode, text))
            except subprocess.TimeoutExpired:
                p.kill()
                out.append((None, p.communicate()[0]))
    finally:
        for p in procs:
            p.kill()
    return out


def process_results(command: Sequence[str], world: int, timeout: float,
                    cwd: Optional[str] = None) -> List[dict]:
    """``run_processes``, then each process's last ``PROCRESULT {json}``
    line, by rank; raises, with the output's tail, where a process failed or
    printed none."""
    results = []
    for rank, (rc, text) in enumerate(run_processes(command, world, timeout, cwd)):
        lines = [ln[len("PROCRESULT "):] for ln in text.splitlines()
                 if ln.startswith("PROCRESULT ")]
        if rc != 0 or not lines:
            raise RuntimeError(f"rank {rank} of {world} exited {rc}:\n{text[-4000:]}")
        results.append(json.loads(lines[-1]))
    return results


@dataclasses.dataclass
class SequenceManifest:
    """Completed-pair ledger for resumable streaming runs."""

    path: str

    def done(self) -> set:
        if not os.path.exists(self.path):
            return set()
        with open(self.path) as f:
            return {json.loads(line)["pair"] for line in f if line.strip()}

    def record(self, pair_id: str, seconds: float) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"pair": pair_id, "seconds": seconds}) + "\n")


def write_pair(output_dir: str, counter: str, u: np.ndarray, v: np.ndarray, width: int,
               height: int, flow_max_scale: float = 10.0) -> None:
    """The four files of one pair in the reference's names, ``counter``
    before each (a sequence's pair id): flow-u, flow-v, amp RAW and the
    res.pgm colour circle (reference: src/main.cpp:205-213)."""
    suffix = f"-{width}-{height}.raw"
    write_raw_f32(os.path.join(output_dir, f"{counter}flow-u{suffix}"), u)
    write_raw_f32(os.path.join(output_dir, f"{counter}flow-v{suffix}"), v)
    write_flow_image_rgb(u, v, flow_max_scale, os.path.join(output_dir, f"{counter}res.pgm"))
    write_magnitude_f32(u, v, os.path.join(output_dir, f"{counter}amp{suffix}"))


def _download(flows: torch.Tensor, copy_stream):
    """Start the copy of ``flows`` to the host; returns (host tensor, event
    that completes with the copy, or None on the CPU)."""
    if flows.device.type != "cuda":
        return flows, None
    solved = torch.cuda.Event()
    solved.record()
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(solved)
        host = torch.empty(flows.shape, dtype=flows.dtype, pin_memory=True)
        host.copy_(flows, non_blocking=True)
        # the allocator must not hand the flow's memory to later pairs on the
        # default stream until this copy has read it
        flows.record_stream(copy_stream)
        copied = torch.cuda.Event()
        copied.record(copy_stream)
    return host, copied


def _copy_stream(streams: dict, device: torch.device):
    """The copy stream of ``device`` (None on the CPU), made at first use."""
    if device.type != "cuda":
        return None
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def process_sequence(pairs: Sequence[Tuple[str, str]], width: int, height: int,
                     output_dir: str, cfg: Optional[FlowConfig] = None, *,
                     resume: bool = True, flow_max_scale: float = 10.0, chain: int = 1,
                     mesh=None, device="cuda") -> List[str]:
    """Stream a sequence of frame-pair files through the solver; returns the
    pair ids this process completed, in order.

    Pair ``idx`` is written as ``{idx:05d}_flow-u-W-H.raw``, ``flow-v``,
    ``amp`` and ``res.pgm`` in ``output_dir``, and then recorded in its
    ``manifest.jsonl``; this process takes the pairs with ``idx % world ==
    rank``. ``resume`` drops the recorded pairs before the rest is chunked.

    ``chain=N`` submits N pairs back to back, stacks their flows on the
    device and fetches them in one copy; the files are byte for byte those
    of ``chain=1``. ``mesh=`` solves groups of ``n_data`` pairs, pair d of
    a group on position (d, 0) of the mesh, in one process (a group
    of processes already splits the pairs by index), and takes no ``chain``;
    ``device`` must then be the mesh's first device. ``device="cuda"``
    raises without CUDA.
    """
    if chain < 1:
        raise ValueError(f"chain must be at least 1, got {chain}")
    if mesh is not None and chain > 1:
        raise ValueError("process_sequence: mesh= and chain > 1 exclude each other (a mesh "
                         "spreads pairs over positions, a chain over one fetch)")
    if mesh is not None and process_rank()[1] > 1:
        raise ValueError("process_sequence: mesh= needs a single process (a group of "
                         "processes already splits the pairs by index)")
    cfg = cfg or FlowConfig()
    device = _device(device)
    if mesh is not None and resolve_device(device) != mesh.devices[0]:
        raise ValueError(f"device {str(device)!r} is not the mesh's device, {mesh.devices[0]}")
    os.makedirs(output_dir, exist_ok=True)
    manifest = SequenceManifest(os.path.join(output_dir, "manifest.jsonl"))
    done = manifest.done() if resume else set()
    rank, world = process_rank()
    mine = [(f"{idx:05d}_", p0, p1) for idx, (p0, p1) in enumerate(pairs)
            if idx % world == rank and f"{idx:05d}_" not in done]
    completed: List[str] = []

    def drain(ids, fetched, t_submit):
        for _, copied in fetched:
            if copied is not None:
                copied.synchronize()
        flows = np.concatenate([host.numpy() for host, _ in fetched])
        # a chunk shares one submit time: its time per pair
        per_pair = (time.perf_counter() - t_submit) / len(ids)
        for pair_id, (u, v) in zip(ids, flows):
            write_pair(output_dir, pair_id, u, v, width, height, flow_max_scale)
            manifest.record(pair_id, per_pair)
            completed.append(pair_id)

    if not mine:
        return completed
    # chunks being copied or written behind the one being submitted (the
    # JAX package's bounded queues)
    in_flight = 6 if chain == 1 else 3
    group = chain if mesh is None else mesh.n_data
    copy_streams = {}
    files = [p for _, p0, p1 in mine for p in (p0, p1)]
    with _full_float32(), _on(device), FrameLoader(files, width, height) as loader, \
            ThreadPoolExecutor(max_workers=1) as writer:
        futures = []
        for c0 in range(0, len(mine), group):
            chunk = mine[c0:c0 + group]
            t_submit = time.perf_counter()
            if mesh is None:
                flows = [compute_flow_async(loader.next(), loader.next(), cfg, device=device)
                         for _ in chunk]
                stacked = torch.stack(flows) if len(flows) > 1 else flows[0][None]
                fetched = [_download(stacked, _copy_stream(copy_streams, device))]
            else:
                fetched = []
                for d in range(len(chunk)):
                    p = mesh.position(d, 0)
                    dev = mesh.devices[p]
                    with _on(dev), mesh.on(p):
                        flow = compute_flow_async(loader.next(), loader.next(), cfg, device=dev)
                        fetched.append(_download(flow[None], _copy_stream(copy_streams, dev)))
            futures.append(writer.submit(drain, [pid for pid, _, _ in chunk], fetched, t_submit))
            if len(futures) > in_flight:
                futures.pop(0).result()
        for f in futures:
            f.result()
    return completed

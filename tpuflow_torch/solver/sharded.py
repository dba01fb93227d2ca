"""The row-sharded pipeline: ``compute_flow_sharded`` (the port of
``compute_flow_bucketed_sharded(..., halo="kernel")``,
tpuflow/solver/bucketed.py:1470-1633).

Only the relaxation is sharded. Each level whose rows the kernel's gate
admits (``kernel_halo_applicable``: every shard owns at least max(k (inner +
1), 16) rows) relaxes in one launch of ``relax_sharded_kernel`` with its rows
over the mesh; every other level runs the unsharded ``relax``, as the JAX
pipeline replicates the buckets its gates refuse. The resample, warp,
derivatives, tensor and median run on the whole field with the level
kernels. The flow is bitwise that of ``compute_flow``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.level import launch_counts as level_launch_counts
from tpuflow_torch.ops.level import reset_launch_counts as reset_level_launch_counts
from tpuflow_torch.parallel.halo_kernel import kernel_halo_applicable, relax_sharded_kernel
from tpuflow_torch.parallel.mesh import Mesh, resolve_device
from tpuflow_torch.solver.flow2d import FlowResult, compute_flow
from tpuflow_torch.solver.level import relax

# The halo modes of the JAX pipeline that the port does not run.
NOT_PORTED = {
    "explicit": "the exchange outside the kernel is ROADMAP Queue 1 (multiple GPUs)",
    "auto": "the cost router is ROADMAP Queue 1 (multiple GPUs)",
    "gspmd": "compiler-partitioned stencils are on ROADMAP's 'Do not port' list",
}


def compute_flow_sharded(frame_0, frame_1, cfg: Optional[FlowConfig] = None, *, mesh: Mesh,
                         halo: str = "kernel", k_outer: int = 1,
                         device="cuda") -> FlowResult:
    """``compute_flow`` with the rows of every admitted level's relaxation
    sharded over ``mesh`` (``make_mesh(n_y, device)``), halos exchanged once
    every ``k_outer`` outers. ``halo`` is ``"kernel"``; the JAX pipeline's
    other modes raise NotImplementedError. ``device`` must be the mesh's
    device, its index included; ``"cuda"`` raises without CUDA."""
    if halo in NOT_PORTED:
        raise NotImplementedError(f"halo={halo!r} is not ported: {NOT_PORTED[halo]}")
    if halo != "kernel":
        raise ValueError(f"unknown halo mode {halo!r}")
    if k_outer < 1:
        raise ValueError(f"k_outer must be at least 1, got {k_outer}")
    if np.ndim(frame_0) == 3:
        raise NotImplementedError("compute_flow_sharded on a (B, H, W) stack: data parallelism "
                                  "and the dp x sp hybrid are ROADMAP Queue 1 item 4 "
                                  "(multiple GPUs); compute_flow takes stacks on one card")
    cfg = cfg or FlowConfig()
    if resolve_device(device) != mesh.device:
        raise ValueError(f"device {str(device)!r} is not the mesh's device, {mesh.device}")
    sharded = functools.partial(relax_sharded_kernel, mesh=mesh, k_outer=k_outer)

    def relax_for(h: int, w: int):
        return sharded if kernel_halo_applicable(h, mesh.n_y, cfg, k_outer) else relax

    return compute_flow(frame_0, frame_1, cfg, device=mesh.device, _relax_for=relax_for)


def reset_launch_counts() -> None:
    """Set the launch counts of the sharded path's kernels to 0."""
    reset_level_launch_counts()
    relax_sharded_kernel.launches = 0


def launch_counts() -> dict:
    """The level kernels' launch counts and ``relax_sharded``'s."""
    return {**level_launch_counts(), "relax_sharded": relax_sharded_kernel.launches}

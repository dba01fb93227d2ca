"""The row-sharded relaxation as one cooperative CUDA kernel (csrc/sharded.cu),
the port of tpuflow/parallel/halo_kernel.py:70-422.

``relax_sharded_kernel`` is ``relax_sharded`` (parallel/halo.py) in one
launch per level: every shard of the mesh lives on the one card, blocks are
split evenly over the shards, the halo exchange is stores into the
neighbour shards' halo rows, and the barrier between phases is a grid-wide
sync. Each outer runs the level kernels' tile bodies over every shard's
padded rows: prologue tiles, a sync, then ceil(inner / KMAX) passes of
k-sweep regions (``grid_syncs`` says how many syncs; the kernel counts
them on the card when given ``syncs``). On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises (a refused cooperative launch included, as
``launch`` raises on any error the entry point returns). It counts its
launches in ``relax_sharded_kernel.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.cuda_lib import launch, on_cuda
from tpuflow_torch.ops.level import KMAX, KSWEEP_RW
from tpuflow_torch.parallel.halo import (
    check_sharded_args, halo_applicable, relax_sharded, row_split,
)
from tpuflow_torch.parallel.mesh import Mesh

F = np.float32
# Planes of a shard's buffer (csrc/sharded.cu): T twice (ping-pong), uv,
# fxyz, the 9 hoists, and J with the gradient/log tensor.
N_PLANES = 2 + 2 + 2 + 3 + 9
N_PLANES_TENSOR = N_PLANES + 5
# The kernel's prologue tiles are one block wide: a k-sweep region's width
# (csrc/sharded.cu: SH_PRO_TW = KS_RW), PROLOGUE_TH rows.
SHARDED_PROLOGUE_TW = KSWEEP_RW


def kernel_halo_applicable(h: int, n_y: int, cfg: FlowConfig, k_outer: int = 1) -> bool:
    """The kernel's gate (halo_kernel.py:79-97): at least one sweep per
    outer, and every shard owns at least max(halo, 16) rows. The halo is
    ``halo_rows``, k (inner + 1), without the TPU's rounding to 8 rows
    (halo_kernel.py:70-76), which only served its (8, 128) tiles. There is
    no fast-memory gate: the shards' buffers live in device memory."""
    return cfg.inner_iterations_count >= 1 and halo_applicable(h, n_y, cfg, k_outer)


def grid_syncs(cfg: FlowConfig, n_y: int, k_outer: int = 1) -> int:
    """The grid-wide syncs of one launch (csrc/sharded.cu): per outer one
    at its top and one after the prologue tiles, one between two k-sweep
    passes, one after each halo push (every ``k_outer`` outers, with more
    than one shard), and one before the copy-out."""
    outer, passes = cfg.outer_iterations_count, -(-cfg.inner_iterations_count // KMAX)
    pushes = -(-outer // k_outer) if n_y > 1 else 0
    return outer * (1 + passes) + pushes + 1


def relax_sharded_kernel(fxyz: torch.Tensor, uv: torch.Tensor, sc, cfg: FlowConfig,
                         mesh: Mesh, k_outer: int = 1, J: Optional[torch.Tensor] = None,
                         syncs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T (2, h, w) after outer x inner relaxation with rows sharded over
    ``mesh`` and halos exchanged once every ``k_outer`` outers; ``T - uv``
    is the (du, dv) of the TPU kernel. The other arguments are
    ``relax_sharded``'s. ``syncs``, a one-element int32 tensor on the card,
    gets the grid syncs the launch made added to it (the plain version makes
    none and refuses it). The shards' buffers are not initialised: the
    kernel writes every row before it reads it."""
    if cfg.inner_iterations_count < 1:
        raise ValueError("relax_sharded_kernel needs at least one inner sweep per outer")
    halo = check_sharded_args(fxyz, uv, cfg, mesh, k_outer, J)
    if not on_cuda(fxyz, uv, *(() if J is None else (J,))):
        if syncs is not None:
            raise ValueError("syncs counts the kernel's grid syncs; the plain version has none")
        return relax_sharded(fxyz, uv, sc, cfg, mesh, k_outer, J)
    if uv.device != mesh.device:
        raise ValueError(f"tensors on {uv.device} for a mesh over {mesh.device}")
    if syncs is not None and (syncs.dtype != torch.int32 or syncs.numel() != 1
                              or syncs.device != uv.device):
        raise ValueError(f"syncs must be one int32 on {uv.device}, got {syncs.dtype} "
                         f"{tuple(syncs.shape)} on {syncs.device}")
    _, h, w = uv.shape
    if w < 2:
        raise ValueError(f"the mirror boundary needs a level at least 2 wide, got {w}")
    shards = row_split(h, mesh.n_y, halo)
    planes = N_PLANES if J is None else N_PLANES_TENSOR
    bufs = [torch.empty((planes, sh.padded, w), dtype=torch.float32, device=uv.device)
            for sh in shards]
    T = torch.empty_like(uv)
    ptrs = (ctypes.c_void_p * len(bufs))(*(b.data_ptr() for b in bufs))
    bounds = (ctypes.c_int * (len(shards) + 1))(*[sh.row0 for sh in shards], h)
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    launch("tf_relax_sharded", ptrs, bounds, mesh.n_y, uv.data_ptr(), fxyz.data_ptr(),
           None if J is None else J.data_ptr(), T.data_ptr(),
           None if syncs is None else syncs.data_ptr(), h, w, halo,
           cfg.outer_iterations_count, cfg.inner_iterations_count, k_outer,
           *map(float, (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, e_s2, e_d2)))
    relax_sharded_kernel.launches += 1
    return T


relax_sharded_kernel.launches = 0

"""Meshes, row sharding, data parallelism and streaming (the port of
tpuflow/parallel).

  * ``make_mesh(shape, device)``: a ``("data", "y")`` grid of positions,
    one device each (devices may repeat), each with its own CUDA stream;
  * ``relax_sharded``: the plain sharded relaxation, shards as padded
    tensor blocks, halos exchanged by tensor copies;
  * ``relax_sharded_kernel``: the same in one cooperative CUDA launch per
    card (csrc/sharded.cu), halos stored through peer pointers between
    cards, which meet at flag barriers;
  * ``relax_sharded_explicit``: the same with each shard on its position's
    device and stream, halos copied between them after CUDA events, or,
    over processes, sent between their cards by NCCL;
  * ``model``: the cost model and the per-level router of ``halo="auto"``;
  * ``hybrid.compute_flow_hybrid``: coarse levels one pair a position,
    fine levels sharded over ``y``;
  * ``multihost``: ``initialize_distributed``, ``SequenceManifest`` and
    ``process_sequence``, the resumable streaming loop, split over
    processes by pair index and over a mesh's data positions;
  * ``group``: the gloo group of a mesh over processes (one position a
    process) and a row's host messages over it, and the row's tensor
    messages between the cards (NCCL point to point on the default group);
    ``ipc``: each card's arena of a row over processes, opened in the
    others from CUDA IPC handles.

``tpuflow_torch.solver.sharded.compute_flow_sharded`` is the sharded
pipeline; ``compute_flow(..., mesh=)`` routes by ``plan_parallel``.
"""

from tpuflow_torch.parallel.halo import (  # noqa: F401
    halo_applicable, relax_sharded, relax_sharded_explicit, row_split,
)
from tpuflow_torch.parallel.halo_kernel import (  # noqa: F401
    kernel_halo_applicable, relax_sharded_kernel,
)
from tpuflow_torch.parallel.mesh import MAX_SHARDS, Mesh, make_mesh  # noqa: F401

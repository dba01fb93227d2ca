"""Row-sharded relaxation on one card (the port of tpuflow/parallel's
spatial path with ``halo="kernel"``).

  * ``make_mesh(n_y, device)``: n_y row shards on one device;
  * ``relax_sharded``: the plain version, shards as padded tensor blocks,
    halos exchanged by tensor copies;
  * ``relax_sharded_kernel``: the same in one cooperative CUDA launch
    (csrc/sharded.cu), gated by ``kernel_halo_applicable``;
  * ``tpuflow_torch.solver.sharded.compute_flow_sharded``: the pipeline;
  * ``parallel.multihost``: ``SequenceManifest`` and ``process_sequence``,
    the resumable streaming loop, split over processes by pair index.

Data parallelism, the explicit exchange, the dp x sp hybrid, the cost
router and meshes over several cards are not ported yet (ROADMAP Queue 1,
multiple GPUs).
"""

from tpuflow_torch.parallel.halo import halo_applicable, relax_sharded, row_split  # noqa: F401
from tpuflow_torch.parallel.halo_kernel import (  # noqa: F401
    kernel_halo_applicable, relax_sharded_kernel,
)
from tpuflow_torch.parallel.mesh import MAX_SHARDS, Mesh, make_mesh  # noqa: F401

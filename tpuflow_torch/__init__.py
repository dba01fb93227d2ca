"""tpuflow_torch — the PyTorch/CUDA port of tpuflow for NVIDIA Hopper.

Dense variational 2D optical flow (coarse-to-fine warping, robust data and
smoothness terms, lagged-nonlinearity Jacobi relaxation, median filtering)
with the same semantics as the JAX package ``tpuflow``, which stays the
reference. Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA kernel for ``sm_90a`` here
(``tpuflow_torch/csrc``), built with nvcc at first use. All three data
constancies (grey, gradient, log-derivative) run; ``python -m
tpuflow_torch.cli`` is the reference-compatible command line, and
``tpuflow_torch.io`` reads and writes its RAW and PPM files.
``compute_flow`` also takes (B, H, W) stacks of pairs;
``compute_flow_async`` leaves the flow on the device without a fence, the
block of ``parallel.multihost.process_sequence``, which streams a sequence
of RAW frames to files, resumably; ``compute_flow_warp_report`` adds each
level's displacement class. ``make_mesh`` lays a ``("data", "y")`` grid of
positions over one card or several: ``compute_flow(..., mesh=)`` deals a
stack's pairs over it or shards one pair's rows, ``compute_flow_sharded``
shards each level's relaxation by rows (``halo="kernel"``, ``"explicit"``
or ``"auto"``), ``compute_flow_hybrid`` runs a stack's coarse levels one
pair a position and its fine levels sharded. ``python -m
tpuflow_torch.bench`` prints the throughput line. Importing this package
imports neither JAX nor ``tpuflow``.
"""

__version__ = "0.1.0"

from tpuflow_torch.config import (  # noqa: F401
    DataConstancy, FlowConfig, IOConfig, from_jax_config, load_settings_xml,
)
from tpuflow_torch.solver.flow2d import (  # noqa: F401
    FlowResult, LevelTrace, compute_flow, compute_flow_async, compute_flow_warp_report,
    endpoint_error, plan_parallel,
)
from tpuflow_torch.parallel.mesh import make_mesh  # noqa: F401
from tpuflow_torch.solver.sharded import compute_flow_sharded  # noqa: F401
from tpuflow_torch.parallel.hybrid import compute_flow_hybrid  # noqa: F401

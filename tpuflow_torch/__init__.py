"""tpuflow_torch — the PyTorch/CUDA port of tpuflow for NVIDIA Hopper.

Dense variational 2D optical flow (coarse-to-fine warping, robust data and
smoothness terms, lagged-nonlinearity Jacobi relaxation, median filtering)
with the same semantics as the JAX package ``tpuflow``, which stays the
reference. Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA kernel for ``sm_90a`` here
(``tpuflow_torch/csrc``), built with nvcc at first use. Importing this
package imports neither JAX nor ``tpuflow``.
"""

__version__ = "0.1.0"

from tpuflow_torch.config import DataConstancy, FlowConfig, from_jax_config  # noqa: F401
from tpuflow_torch.solver.flow2d import FlowResult, compute_flow, endpoint_error  # noqa: F401

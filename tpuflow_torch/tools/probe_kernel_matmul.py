"""Probe: a float32 matmul written as a kernel against PyTorch's matmul.

    python -m tpuflow_torch.tools.probe_kernel_matmul      # on a CUDA card; raises without one

The port of tools/probe_kernel_matmul.py. That probe asked whether a level
kernel could compute the box-resample products (a band of 9 box-like
weights per row of A, image rows in B) itself and still meet the EPE
contract. Here the kernel is ``probe_matmul`` (csrc/probes.cu, a SIMT GEMM
that sums in k order with fused multiply-adds), held against
``torch.matmul`` with TF32 off on the probe's seeded inputs. Prints one JSON
line: the probe's three numbers (``max_abs_diff``, ``bitwise_equal``,
``rel``), the kernel's and the library call's device ms, the kernel's bound
and the card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpuflow_torch.ops.cuda_lib import launch, on_cuda

H0, HB, W0 = 448, 64, 640
REPS = 50


def probe_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B summed in k order, one rounded multiply and add per step."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1, :]
    return acc


def probe_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if not on_cuda(a, b):
        return probe_matmul_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    launch("tf_probe_matmul", a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n)
    # A call captured into a CUDA graph records the launch and makes none;
    # the graph's replays launch it without this wrapper.
    if not torch.cuda.is_current_stream_capturing():
        probe_matmul.launches += 1
    return out


probe_matmul.launches = 0


def probe_inputs(m: int = HB, k: int = H0, n: int = W0) -> tuple:
    """The probe's seeded numpy inputs (tools/probe_kernel_matmul.py:41-47):
    A (m, k) with a band of 9 uniform weights per row (all k if k < 9),
    B (k, n) = 200 * uniform. The defaults are the probe's own."""
    rng = np.random.default_rng(0)
    band = min(9, k)
    a = np.zeros((m, k), np.float32)
    for i in range(m):
        j = min(int(i * k / m), k - band)
        a[i, j:j + band] = rng.random(band, dtype=np.float32)
    b = (200.0 * rng.random((k, n))).astype(np.float32)
    return a, b


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The probe's three numbers."""
    diff = np.abs(got - want)
    return {"max_abs_diff": float(diff.max()), "bitwise_equal": bool((got == want).all()),
            "rel": float(diff.max() / np.abs(want).max())}


def run() -> dict:
    """The probe on the card: kernel against torch.matmul (TF32 off), with
    the bound from ``roofline.kernel_work``. ``ms`` and ``library_ms`` are
    device times by CUDA-graph replay (``roofline.graph_ms``); the
    ``host_paced_`` pair are ``REPS`` back-to-back Python calls between two
    events (``roofline.cuda_ms``), which at a few µs of work per call read
    the host's pace. ``launch_floor_ms`` is the graph-replay time of a
    one-element ``add_``: what any kernel costs by that timer.
    ``ms_unaligned`` is the kernel on the same values stored 4 bytes past
    a 16-byte boundary."""
    from tpuflow_torch.tools.roofline import cuda_ms, device_info, graph_ms, kernel_work

    if not torch.cuda.is_available():
        raise RuntimeError("the matmul probe runs on a CUDA card, and none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    a_np, b_np = probe_inputs()
    a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
    got = probe_matmul(a, b).cpu().numpy()
    want = torch.matmul(a, b).cpu().numpy()
    work = kernel_work("probe_matmul", HB, W0)
    kernel, library = (lambda: probe_matmul(a, b)), (lambda: torch.matmul(a, b))
    a4, b4 = (torch.empty(t.numel() + 1, device=t.device)[1:].view_as(t).copy_(t) for t in (a, b))
    one = torch.zeros(1, device=a.device)
    return {"probe": "matmul", "shape": [[HB, H0], [H0, W0]], **compare(got, want),
            "ms": graph_ms(kernel), "library_ms": graph_ms(library),
            "ms_unaligned": graph_ms(lambda: probe_matmul(a4, b4)),
            "host_paced_ms": cuda_ms(kernel, REPS),
            "library_host_paced_ms": cuda_ms(library, REPS),
            "launch_floor_ms": graph_ms(lambda: one.add_(1.0)),
            "timing": "ms, library_ms: CUDA-graph replay; host_paced_*: back-to-back calls",
            "library": "torch.matmul, TF32 off",
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "device": device_info()}


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

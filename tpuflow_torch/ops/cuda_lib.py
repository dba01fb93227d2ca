"""Build and load the port's CUDA kernels.

The sources under ``tpuflow_torch/csrc/`` have a plain C interface. On
first use one ``nvcc`` per source compiles it for ``sm_90a``, all at once,
and one more links the objects into a shared library in
``tpuflow_torch/_build/`` (named by a hash of the sources, the headers they
include and the flags, so an edit rebuilds); ``ctypes`` loads it. Nothing
is built at import time, and nothing here runs on a machine without CUDA
unless a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("level.cu", "probes.cu", "sharded.cu", "banded.cu")
HEADERS = ("level_body.cuh",)
# No fast math: sqrtf and '/' must round as IEEE. --fmad=false keeps every
# multiply and add rounded on its own, as the JAX kernels associate them.
# sharded.cu's grid-wide sync needs no relocatable device code (-rdc) since
# CUDA 11, so the objects link as plain ones.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# Every entry point returns cudaGetLastError() after its launch; the last
# argument is the stream.
SIGNATURES = {
    "tf_warp": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    "tf_level_derivs": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    "tf_level_tensor": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "tf_outer_prologue": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    "tf_outer_prologue_tensor": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                 _P),
    "tf_jacobi_sweep": (_P, _P, _P, _P, _I, _I, _P),
    "tf_jacobi_sweeps": (_P, _P, _P, _P, _I, _I, _I, _P),
    "tf_add_median": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tf_roofline_micro": (_P, _P, _P, _I, _I, _I, _I, _P),
    "tf_probe_matmul": (_P, _P, _P, _I, _I, _I, _P),
    "tf_banded_x": (_P, _P, _P, _I, _I, _L, _L, _I, _I, _I, _I, _I, _P),
    "tf_banded_y": (_P, _P, _P, _I, _I, _I, _I, _L, _P),
}
# Entry points that take their streams in their arguments (``call``).
STREAMLESS_SIGNATURES = {
    "tf_relax_sharded": (_I, _P, _P, _P, _P, _P, _I, _P, ctypes.c_uint64, _P, _P, _P, _P, _I,
                         ctypes.c_uint, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                         _F),
    "tf_enable_peer_access": (_I, _I),
    # CUDA IPC of a row's arenas (parallel/ipc.py); out-pointers by ctypes.byref
    "tf_ipc_alloc": (_I, ctypes.c_size_t, _P),
    "tf_ipc_free": (_I, _P),
    "tf_ipc_get_handle": (_P, _P),
    "tf_ipc_open_handle": (_P, _I, _P),
    "tf_ipc_close_handle": (_I, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a library built earlier was reused
    log: str              # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and nvcc is not on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256()
    for s in srcs + [CSRC / h for h in HEADERS]:
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libtpuflow_level_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        failed = [(s.name, p.returncode) for s, p in zip(srcs, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            failed = [("link", link.returncode)] if link.returncode != 0 else []
        seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**SIGNATURES, **STREAMLESS_SIGNATURES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tf_error_string.argtypes = (ctypes.c_int,)
    lib.tf_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=so, build_seconds=seconds, log=log)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Check the tensors a kernel wrapper was given and say where they lie.

    True for CUDA tensors on the current device (the kernel runs), False
    for CPU tensors (the plain version runs); anything else raises, since
    the kernels take only contiguous float32 on one device.
    """
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {device} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {device}, but the current CUDA device is "
            f"{torch.cuda.current_device()}")
    return True


def call(name: str, *args) -> None:
    """Call entry point ``name`` with ``args``; raise on a CUDA error."""
    lib = load_library().lib
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.tf_error_string(err).decode()})")


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the current stream; raise on a CUDA error."""
    call(name, *args, torch.cuda.current_stream().cuda_stream)

"""Measurement tools of the port: the roofline microbenchmarks and the
in-kernel matmul probe, Hopper twins of ``tools/roofline.py`` and
``tools/probe_kernel_matmul.py``. Their entry points need a CUDA card."""

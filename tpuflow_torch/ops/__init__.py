"""Per-pixel and stencil operations, with the CUDA kernel wrappers."""

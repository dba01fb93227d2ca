"""Timing and profiling helpers (the port of ``tpuflow.utils.timing`` and
``tpuflow.utils.profiling``)."""

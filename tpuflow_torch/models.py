"""Model-family presets for the variational flow solver.

The reference exposes one solver with three data-constancy variants selected
at init (reference: src/data_types/data_structs.h:27,
src/cuda_operations/2d/cuda_operation_solve_2d.cpp:65-82). These presets
name the classic model families those variants implement, with the
BASELINE.json benchmark configs:

  * Horn-Schunck: brightness constancy, single level (configs[0]);
  * Brox warping: coarse-to-fine + robust penalizers, grey or gradient
    constancy (configs[1]);
  * Full model: higher-order data term + flow-driven smoothness + median
    filtering (configs[2]);
  * X-ray / log: log-derivative constancy for multiplicative illumination
    robustness (synchrotron radiography, reference README.md:30-38).

The same presets as tpuflow/models/__init__.py; the port's solver runs
all of them.
"""

from __future__ import annotations

from tpuflow_torch.config import DataConstancy, FlowConfig


def horn_schunck(
    alpha: float = 35.0,
    outer_iterations: int = 40,
    inner_iterations: int = 5,
) -> FlowConfig:
    """Single-level brightness-constancy relaxation (no pyramid, no warping,
    no presmoothing/median) — BASELINE configs[0]."""
    return FlowConfig(
        warp_levels_count=1,
        outer_iterations_count=outer_iterations,
        inner_iterations_count=inner_iterations,
        equation_alpha=alpha,
        median_radius=1,
        gaussian_sigma=0.0,
        data_constancy=DataConstancy.GREY,
    )


def brox(
    constancy: DataConstancy = DataConstancy.GRADIENT,
    alpha: float = 35.0,
    sigma: float = 1.5,
) -> FlowConfig:
    """Coarse-to-fine warping with robust (sub-quadratic) penalizers and
    gradient constancy — BASELINE configs[1]."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        median_radius=1,
        data_constancy=constancy,
    )


def full_model(
    constancy: DataConstancy = DataConstancy.GRADIENT,
    alpha: float = 35.0,
    sigma: float = 1.5,
    median_radius: int = 5,
) -> FlowConfig:
    """Higher-order data term + flow-driven smoothness + median filtering —
    BASELINE configs[2], the reference's default operating point."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        median_radius=median_radius,
        data_constancy=constancy,
    )


def xray_log(alpha: float = 35.0, sigma: float = 1.5) -> FlowConfig:
    """Log-derivative constancy for X-ray / multiplicative illumination."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        data_constancy=DataConstancy.LOG_DERIVATIVES,
    )


def reference_default() -> FlowConfig:
    """The reference CLI's exact defaults (reference: src/main.cpp:65-84)."""
    return FlowConfig()

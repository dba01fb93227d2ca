"""Typed solver configuration — the port's copy of ``tpuflow.config``.

``FlowConfig`` and ``DataConstancy`` carry the same fields, defaults and
validation as the JAX package (tpuflow/config.py:18-77), so a
configuration means the same solve in both. ``IOConfig`` and
``load_settings_xml`` read a reference-format ``settings.xml`` with the
same field mapping (tpuflow/config.py:80-139). ``from_jax_config`` carries
a ``tpuflow.FlowConfig`` (or its ``dataclasses.asdict``) across without
importing the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import xml.etree.ElementTree as ET
from typing import Any, Mapping


class DataConstancy(enum.Enum):
    """Data-term variant (reference: src/data_types/data_structs.h:27)."""

    GREY = "grey"
    GRADIENT = "gradient"
    LOG_DERIVATIVES = "log"


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """All solver parameters.

    Defaults match the reference CLI defaults (reference: src/main.cpp:65-84):
    50 warp levels, scale 0.9, 40 outer x 5 inner iterations, alpha=35,
    e_smooth=e_data=0.001, median radius 5 (window side), sigma=1.5,
    grey constancy. The solver is float32 throughout.
    """

    warp_levels_count: int = 50
    warp_scale_factor: float = 0.9
    outer_iterations_count: int = 40
    inner_iterations_count: int = 5
    equation_alpha: float = 35.0
    equation_smoothness: float = 0.001
    equation_data: float = 0.001
    median_radius: int = 5  # window SIDE length (3/5/7 in the reference)
    gaussian_sigma: float = 1.5
    data_constancy: DataConstancy = DataConstancy.GREY

    def __post_init__(self):
        if self.warp_scale_factor <= 0.0 or self.warp_scale_factor >= 1.0:
            raise ValueError(
                f"warp_scale_factor must be in (0, 1), got {self.warp_scale_factor}"
            )
        if self.warp_levels_count < 1:
            raise ValueError("warp_levels_count must be >= 1")
        if self.median_radius > 7:
            # Same limit as the reference host wrapper
            # (reference: src/cuda_operations/2d/cuda_operation_median_2d.cpp:152-154).
            raise ValueError("median_radius > 7 is not supported")


def from_jax_config(obj_or_dict: Any) -> FlowConfig:
    """A port ``FlowConfig`` from a ``tpuflow.FlowConfig`` or its field dict.

    The JAX package's enum is a different class with the same values, so
    ``data_constancy`` is carried by value (an enum member or its string).
    Unknown fields raise, so a drifted schema cannot pass silently.
    """
    if isinstance(obj_or_dict, Mapping):
        fields = dict(obj_or_dict)
    elif dataclasses.is_dataclass(obj_or_dict):
        fields = {f.name: getattr(obj_or_dict, f.name)
                  for f in dataclasses.fields(obj_or_dict)}
    else:
        raise TypeError(
            f"expected a FlowConfig dataclass or dict, got {type(obj_or_dict)!r}")
    known = {f.name for f in dataclasses.fields(FlowConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown FlowConfig fields: {sorted(unknown)}")
    if "data_constancy" in fields:
        dc = fields["data_constancy"]
        fields["data_constancy"] = DataConstancy(getattr(dc, "value", dc))
    return FlowConfig(**fields)


@dataclasses.dataclass(frozen=True)
class IOConfig:
    """Input/output file description (paths, size, filenames)."""

    width: int = 584
    height: int = 388
    input_path: str = "./data/"
    output_path: str = "./data/output/"
    file_name1: str = "rub1.raw"
    file_name2: str = "rub2.raw"
    counter: str = ""
    press_key: bool = False  # parsed but ignored, as in the reference


def load_settings_xml(path: str) -> tuple[FlowConfig, IOConfig]:
    """Parse a reference-format ``settings.xml``.

    The field mapping follows the reference parser
    (reference: src/utils/settings.cpp:93-137): ``Input/Path@inputPath``,
    ``Input/Mode@Nx,Ny``, ``Input/Mode/Files@file1,file2``,
    ``Parameters/Method@key``, ``Parameters/Solver/Iterations@inner,outer``,
    ``Parameters/Solver/Warping@levels,scaling,medianRadius``,
    ``Parameters/Solver/Model@sigma,alpha,e_smooth,e_data``,
    ``Output/Path@outputPath``.
    """
    root = ET.parse(path).getroot()

    def el(xpath: str) -> ET.Element:
        node = root.find(xpath)
        if node is None:
            raise ValueError(f"settings file {path!r} missing element {xpath!r}")
        return node

    mode = el("Input/Mode")
    files = el("Input/Mode/Files")
    iters = el("Parameters/Solver/Iterations")
    warping = el("Parameters/Solver/Warping")
    model = el("Parameters/Solver/Model")

    flow = FlowConfig(
        warp_levels_count=int(warping.get("levels")),
        warp_scale_factor=float(warping.get("scaling")),
        outer_iterations_count=int(iters.get("outer")),
        inner_iterations_count=int(iters.get("inner")),
        equation_alpha=float(model.get("alpha")),
        equation_smoothness=float(model.get("e_smooth")),
        equation_data=float(model.get("e_data")),
        median_radius=int(warping.get("medianRadius")),
        gaussian_sigma=float(model.get("sigma")),
    )
    io = IOConfig(
        width=int(mode.get("Nx")),
        height=int(mode.get("Ny")),
        input_path=el("Input/Path").get("inputPath"),
        output_path=el("Output/Path").get("outputPath"),
        file_name1=files.get("file1"),
        file_name2=files.get("file2"),
        press_key=bool(int(el("Parameters/Method").get("key", "0"))),
    )
    return flow, io

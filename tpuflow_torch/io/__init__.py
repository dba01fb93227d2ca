"""I/O: RAW frame readers and writers, flow visualisation, the frame loader
and VTK export (numpy)."""

from tpuflow_torch.io.flow_viz import (  # noqa: F401
    flow_to_rgb,
    write_flow_image_rgb,
    write_magnitude_f32,
)
from tpuflow_torch.io.raw import (  # noqa: F401
    read_frame,
    read_raw_f32,
    read_raw_u8,
    write_raw_f32,
    write_raw_u8,
)
from tpuflow_torch.io.loader import FrameLoader  # noqa: F401
from tpuflow_torch.io.vtk import write_flow_vtk  # noqa: F401

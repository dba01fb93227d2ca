"""VTK export for flow fields (a copy of tpuflow/io/vtk.py, which imports no
JAX; the output is byte for byte the JAX package's).

The reference carries a (never-called) VTK writer on its 3D container
(reference: src/data_types/data3d.h:44-64); this is a working 2D
equivalent: a legacy-format STRUCTURED_POINTS file with the flow as a
VECTORS attribute, loadable by ParaView/VisIt for inspection of synchrotron
sequences.
"""

from __future__ import annotations

import numpy as np


def write_flow_vtk(u: np.ndarray, v: np.ndarray, path: str, name: str = "flow") -> None:
    """Write a legacy ASCII VTK file with the flow as 3-component vectors
    (z component zero)."""
    u = np.asarray(u, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"expected equal (H, W) fields, got {u.shape} {v.shape}")
    h, w = u.shape
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("tpuflow dense 2D optical flow\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {w} {h} 1\n")
        f.write("ORIGIN 0 0 0\n")
        f.write("SPACING 1 1 1\n")
        f.write(f"POINT_DATA {w * h}\n")
        f.write(f"VECTORS {name} float\n")
        rows = np.stack([u.ravel(), v.ravel(), np.zeros(w * h, np.float32)], axis=1)
        np.savetxt(f, rows, fmt="%.6g")

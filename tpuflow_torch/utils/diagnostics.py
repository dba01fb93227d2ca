"""Solver diagnostics: the variational energy of a flow field (the port of
tpuflow/utils/diagnostics.py:33-74), in plain PyTorch on any device.

    E(u, v) = sum psi( (du,dv,1)^T J (du,dv,1) )          [data term]
            + alpha * sum psi( |grad u|^2 + |grad v|^2 )  [smoothness]

with psi(s) = sqrt(s + eps^2), the sub-quadratic penalizer whose
half-derivative is the solver's phi/ksi = 1/(2 sqrt(...)) (reference model:
README.md:30-38, solve_2d.cu §2.5). The motion tensor is the port's own
(``ops.solver_ops.motion_tensor``) at a grid spacing of (hx, hy). Useful for
convergence monitoring and regression tests: solving lowers the energy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.solver_ops import motion_tensor, shifts
from tpuflow_torch.solver.level import LevelScalars


class FlowEnergy(NamedTuple):
    data: torch.Tensor        # scalar
    smoothness: torch.Tensor  # scalar
    total: torch.Tensor       # data + alpha * smoothness


def _field(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


def flow_energy(f0, f1, u, v, cfg: Optional[FlowConfig] = None, hx: float = 1.0,
                hy: float = 1.0, *, device="cuda") -> FlowEnergy:
    """The robust variational energy of (u, v) on a frame pair, as 0-dim
    float32 tensors on ``device`` (``"cuda"`` raises without CUDA).

    Frames and flow at the same (H, W), numpy arrays or tensors; the flow in
    original-pixel units like the solver (converted by 1/h here). The data
    term uses the motion tensor of ``cfg.data_constancy``; the quadratic
    form is evaluated at displacement (u/hx, v/hy), the warped incremental
    solve with du = u (zero prior flow).
    """
    cfg = cfg or FlowConfig()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not available")
    f0, f1 = _field(f0, device), _field(f1, device)
    u = _field(u, device) * np.float32(1.0 / hx)
    v = _field(v, device) * np.float32(1.0 / hy)
    h, w = f0.shape
    sc = LevelScalars.make(w, h, hx, hy, cfg.equation_alpha)

    fxyz, J = motion_tensor(f0, f1, sc, cfg.data_constancy)
    J11, J22, J12, J13, J23 = J
    # J33 from the grey tensor (the constant term of the quadratic form).
    ft = fxyz[2]
    J33 = ft * ft
    s = ((J11 * u + J12 * v + J13) * u
         + (J12 * u + J22 * v + J23) * v
         + (J13 * u + J23 * v + J33))
    e_d = np.float32(cfg.equation_data)
    data = torch.sum(torch.sqrt(torch.clamp_min(s, 0.0) + e_d * e_d))

    _, u_xp, u_xm, u_yp, u_ym = shifts(u)
    _, v_xp, v_xm, v_yp, v_ym = shifts(v)
    ux = (u_xp - u_xm) / np.float32(2.0 * hx)
    uy = (u_yp - u_ym) / np.float32(2.0 * hy)
    vx = (v_xp - v_xm) / np.float32(2.0 * hx)
    vy = (v_yp - v_ym) / np.float32(2.0 * hy)
    e_s = np.float32(cfg.equation_smoothness)
    smooth = torch.sum(torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + e_s * e_s))

    total = data + np.float32(cfg.equation_alpha) * smooth
    return FlowEnergy(data=data, smoothness=smooth, total=total)

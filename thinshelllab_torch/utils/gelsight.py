"""GelSight tactile-sensor calibration utilities (counterpart of
`thinshelllab_tpu/utils/gelsight.py`).

Reference engine/blob.py: fisheye projection / inverse projection of the
tactile sensor's marker dots, used offline to calibrate the simulated pad
against real sensor captures. Elementwise torch on the inputs' device.
"""
from __future__ import annotations

import torch


def fisheye_project(points, f=1.0, center=(0.0, 0.0)):
    """Equidistant fisheye projection of 3D points (sensor frame, +z toward
    the camera): r_img = f * theta, theta = angle from the optical axis.
    points: (..., 3) -> (..., 2)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    scale = torch.where(r > 1e-12, f * theta / torch.clamp(r, min=1e-12),
                        f / torch.clamp(z, min=1e-12))
    u = x * scale + center[0]
    v = y * scale + center[1]
    return torch.stack([u, v], dim=-1)


def fisheye_unproject(uv, depth, f=1.0, center=(0.0, 0.0)):
    """Inverse of fisheye_project at a given z-depth. uv: (..., 2)."""
    du = uv[..., 0] - center[0]
    dv = uv[..., 1] - center[1]
    r_img = torch.sqrt(du * du + dv * dv)
    theta = r_img / f
    r = depth * torch.tan(theta)
    scale = torch.where(r_img > 1e-12, r / torch.clamp(r_img, min=1e-12),
                        torch.zeros_like(r_img))
    return torch.stack([du * scale, dv * scale,
                        torch.broadcast_to(torch.as_tensor(
                            depth, dtype=du.dtype, device=du.device),
                            du.shape)], dim=-1)


def marker_displacements(surface_idx, pad_local_before, pad_local_after,
                         f=1.0):
    """Projected 2D marker-dot displacements between two pad configurations
    (the quantity the reference plots in gripper plot_tactile)."""
    a = fisheye_project(pad_local_before[surface_idx], f)
    b = fisheye_project(pad_local_after[surface_idx], f)
    return b - a

"""Diagnostic 3-D plots: body scatter, contact-force quiver, surface-normal
quiver (counterpart of `thinshelllab_tpu/render/debug_plots.py`; reference
BaseScene.debug_plot:1254-1266, plot_contact_force:1269-1288,
model_elastic_tactile.plot_normal:426-437).

The quantities are computed from (spec, params, state) on the scene's
device -- contact forces as the negated gradient of the masked contact
groups, normals from the face soup -- and drawn by `raster` on a 640x480
canvas (matplotlib's default figure) with matplotlib's 3-D projection at
its default view (elev 30, azim -60): the points and arrows only, without
matplotlib's panes, grid and ticks.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.spec import Params, SceneSpec, SimState
from ..engine import elements, stepper
from ..ops import collision
from . import raster
from .preview import _host

_W, _H = 640, 480
_ELEV, _AZIM = 30.0, -60.0


def _body_slice(spec: SceneSpec, body_idx: int):
    return spec.body_v_start[body_idx], spec.body_v_end[body_idx]


def _plot(path, lims, points=None, point_color=raster.C0, quiver=None):
    """Draw a scatter and/or a quiver (starts, ends, colour) on matplotlib's
    default 3-D axes with the given limits and write the PNG."""
    view = raster.Axes3DView(lims, _ELEV, _AZIM, _W, _H)
    img = torch.full((_H, _W, 3), 255, dtype=torch.uint8)
    to_px = lambda p: view.to_pixels(torch.as_tensor(p, dtype=torch.float64))  # noqa: E731
    if points is not None:
        raster.draw_points(img, to_px(points), point_color, box=view.box)
    if quiver is not None:
        starts, ends, color = quiver
        raster.draw_segments(img, to_px(starts), to_px(ends), color,
                             box=view.box)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return raster.write_png(path, img)


def debug_plot(spec: SceneSpec, pos, body_idx: int, path: str,
               normals: bool = False, zlim=(-0.001, 0.01)):
    """Scatter one body's vertices (reference BaseScene.debug_plot:1254:
    per-body slice, fixed z-limits, optional vertex-normal quiver -- the
    reference keeps the quiver commented out; here it's an option).
    spec and pos on one device (the host spec with numpy pos, or a moved
    spec with its tensors)."""
    vs, ve = _body_slice(spec, body_idx)
    x = _host(pos)[vs:ve]
    quiver = None
    if normals:
        p = torch.as_tensor(pos)
        vn = _host(collision.vertex_normals(
            p, torch.as_tensor(spec.faces, device=p.device), spec.NV))[vs:ve]
        quiver = (*raster.quiver_segments(x, vn, length=0.01, normalize=True),
                  raster.C0)
    lims = raster.auto_lims(x, fixed=None if zlim is None else {2: zlim})
    return _plot(path, lims, points=x, quiver=quiver)


def contact_forces(spec: SceneSpec, params: Params, state: SimState):
    """Per-vertex contact force (-d(barrier+friction)/dx, masked to the
    active set), the quantity the reference quivers from its tmp_f
    analysis buffer (BaseScene.plot_contact_force:1277). spec, params and
    state moved to one device (TaskScene.to); runs there."""
    pos = state.pos
    contact, _, _ = stepper.build_contacts(
        spec, params, pos, pos, state.proj_flag, state.proj_dir)
    force = torch.zeros_like(pos)
    for ev in (elements.barrier_eval, elements.friction_eval):
        _, grp = ev(spec, contact, pos, False, False)
        force.index_add_(0, grp["idx"].reshape(-1),
                         -grp["g"].reshape(-1, 3))
    return force


def plot_contact_force(spec: SceneSpec, params: Params, state: SimState,
                       body_idx: int, path: str,
                       lims=((-0.2, 0.2), (-0.2, 0.2), (-0.3, 0.3))):
    """Quiver of contact forces on one body's vertices (reference
    plot_contact_force:1269-1288: fixed axis box, red arrows, length 1)."""
    vs, ve = _body_slice(spec, body_idx)
    x = _host(state.pos)[vs:ve]
    f = _host(contact_forces(spec, params, state))[vs:ve]
    lims = lims if lims is not None else raster.auto_lims(
        np.concatenate([x, x - f]))
    quiver = (*raster.quiver_segments(x, f, length=1.0), raster.RED)
    return _plot(path, lims, quiver=quiver)


def plot_normal(spec: SceneSpec, pos, body_idx: int, path: str,
                scale: float = 0.001):
    """Face-centroid scatter + outward face-normal quiver for one body's
    surface triangles (reference model_elastic_tactile.get_surf_normal
    :415-423 + plot_normal:426-437: normals scaled to 1 mm, red)."""
    fs, fe = spec.body_f_start[body_idx], spec.body_f_end[body_idx]
    tri = _host(spec.faces)[fs:fe]
    p = _host(pos)
    p1, p2, p3 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    n = np.cross(p2 - p1, p3 - p1)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-30) * scale
    c = (p1 + p2 + p3) / 3.0
    starts, ends = raster.quiver_segments(c, n, length=1.0)
    lims = raster.auto_lims(np.concatenate([c, ends]))
    return _plot(path, lims, points=c, quiver=(starts, ends, raster.RED))

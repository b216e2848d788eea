"""Headless preview renderer (counterpart of
`thinshelllab_tpu/render/preview.py`, which replaces the reference's Taichi
GGUI window, engine/render_engine.TaichiRender): flat-coloured triangles in
painter's order on matplotlib's 3-D axes, one PNG a frame and a GIF of the
frames.

The picture is the JAX package's: the same limits (given, or fitted to a
point set), `view_init(elev=20, azim=-60)`, no axes, the colour of each
face's first vertex, and the faces painted far to near by the distance of
their centroids from the camera point and then, as matplotlib draws them,
by their mean projected depth. The frame is the 600x600 canvas of
the JAX package's 6x6-inch figure at 100 dpi (before `savefig`'s tight
bounding box crops it). Projection and triangle fill run in torch on the
positions' device (`raster`); no anti-aliasing. The painter order is
sorted on the host with numpy, as the JAX package sorts it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import raster

FIG_PX = 600
ELEV, AZIM = 20.0, -60.0


def default_colors(spec):
    """Per-vertex colors following the reference palette
    (BaseScene.get_colors:1477-1487)."""
    colors = np.zeros((spec.NV, 3))
    palette = [
        (1.0, 1.0, 1.0),
        (0.23, 0.66, 0.9),
        (0.33, 0.33, 0.33),
    ]
    agent = [(0.22, 0.72, 0.52), (1.0, 0.334, 0.52)]
    cloth_offsets = set(spec.cloth.offsets)
    ci = 0
    ai = 0
    for b in range(spec.n_bodies):
        vs, ve = spec.body_v_start[b], spec.body_v_end[b]
        if vs in cloth_offsets:
            colors[vs:ve] = palette[min(ci, 2)]
            ci += 1
        elif any(vs == off for off in spec.gripper.pad_offset):
            colors[vs:ve] = agent[ai % 2]
            ai += 1
        else:
            colors[vs:ve] = (0.7, 0.65, 0.6)
    return colors


def painter_order(pos, faces, camera, M):
    """The order the JAX package's figure paints its faces in, from float64
    host positions: its own order argsort(-|centroid - camera|) (numpy's
    sort, ties included), which matplotlib's Poly3DCollection then sorts
    again, stably, by each face's mean projected depth under the axes'
    projection M, farthest first (art3d.Poly3DCollection.do_3d_projection,
    zsort 'average')."""
    p = np.asarray(pos, np.float64)
    f = np.asarray(faces)
    order = np.argsort(-np.linalg.norm(p[f].mean(axis=1) - np.asarray(camera),
                                       axis=1))
    w = np.dot(M, np.vstack([p.T, np.ones(len(p))]))
    depth = (w[2] / w[3])[f[order]].mean(axis=1)
    return order[np.argsort(-depth, kind="stable")]


class PreviewRenderer:
    def __init__(self, spec, save_dir: str, camera=((-0.2, 0.2, 0.05), (0, 0, 0)),
                 lims=None, fit_pos=None):
        self.spec = spec
        self.save_dir = save_dir
        self.colors = default_colors(spec)
        self.camera = camera
        if lims is None and fit_pos is not None:
            p = _host(fit_pos)
            lo, hi = p.min(axis=0), p.max(axis=0)
            c = 0.5 * (lo + hi)
            half = max(float((hi - lo).max()) * 0.6, 0.01)
            lims = tuple((float(c[d] - half), float(c[d] + half)) for d in range(3))
        self.lims = lims or ((-0.08, 0.08), (-0.08, 0.08), (-0.03, 0.06))
        self.view = raster.Axes3DView(self.lims, ELEV, AZIM, FIG_PX, FIG_PX)
        self.face_rgb = raster.to_uint8(
            self.colors[np.asarray(spec.faces)[:, 0]])
        self.saved = []
        self.frames = {}  # path -> the image last written there
        os.makedirs(save_dir, exist_ok=True)

    def set_save_dir(self, d):
        self.save_dir = d
        self.saved = []
        self.frames = {}
        os.makedirs(d, exist_ok=True)

    def image(self, pos):
        """(600, 600, 3) uint8 tensor of the frame at pos (NV, 3), on pos's
        device."""
        pos = torch.as_tensor(pos)
        faces = np.asarray(self.spec.faces)
        order = painter_order(_host(pos), faces, self.camera[0], self.view.M)
        tri = torch.as_tensor(faces[order], dtype=torch.int64,
                              device=pos.device)
        rank = raster.fill_triangles(self.view.to_pixels(pos)[tri], FIG_PX,
                                     FIG_PX, box=self.view.box)
        return raster.paint(rank, self.face_rgb[order])

    def render(self, pos, name: str):
        img = self.image(pos).cpu().numpy()
        path = os.path.join(self.save_dir, f"{name}.png")
        raster.write_png(path, img)
        self.saved.append(path)
        self.frames[path] = img
        return path

    def end_rendering(self, tag=0, duration=0.02):
        """Stitch the saved frames into GIF_{tag}.gif (reference
        TaichiRender:151-194): one frame per render call since the last
        save-dir change, each the image now held at its path, as the JAX
        package reads them back from disk."""
        if not self.saved:
            return None
        gif = os.path.join(self.save_dir, f"GIF_{tag}.gif")
        return raster.write_gif(gif, [self.frames[p] for p in self.saved],
                                duration=duration)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

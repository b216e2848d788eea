"""Procedural and preset textures for the Luisa export path (counterpart
of `thinshelllab_tpu/render/textures.py`).

Ports the reference's crease-line texture painter
(engine/convert_luisa.get_mix_texture:312-347 + process_curve_mix:385-401)
and its material preset tables (engine/render_engine.py:61-111). The BFS
flood fill is replaced by a vectorized nearest-seed dilation (identical
result away from equidistant Voronoi boundaries between differently-colored
seeds, which land inside uniformly white regions for every shipped scene).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from . import raster
from .luisa import Surface, Texture

_RED = (1.0, 0.0, 0.0)
_BLUE = (0.0, 0.0, 1.0)
_WHITE = (1.0, 1.0, 1.0)


def get_mix_texture(n: int, m: int, curve_judge: Callable[[int], Optional[str]],
                    division: int = 4, img_size: int = 1024) -> np.ndarray:
    """Paint the crease texture: sample points on a (n+1)*(m+1) grid (at
    `division` sub-resolution) are red ("down"), blue ("up") or white, and
    every other pixel takes the color of its nearest seed (the reference's
    4-neighbor BFS fill, convert_luisa.py:312-347). Returns (S, S, 3) uint8.
    """
    img = np.zeros((img_size, img_size, 3), np.float64)
    filled = np.zeros((img_size, img_size), bool)

    ii = np.arange((n + 1) * division)
    jj = np.arange((m + 1) * division)
    ci = img_size - 1 - np.minimum((ii / (n * division) * img_size).astype(int),
                                   img_size - 1)
    cj = img_size - 1 - np.minimum((jj / (m * division) * img_size).astype(int),
                                   img_size - 1)
    # classify every vertex once, then broadcast to the sample grid: the
    # reference evaluates curve_judge at pij = (i//div)*(m+1) + (j//div) for
    # EVERY (i, j) sample with i % division == 0 (convert_luisa.py:318-324)
    vert_colors = np.empty((n + 1, m + 1, 3))
    for vi in range(n + 1):
        for vj in range(m + 1):
            name = curve_judge(vi * (m + 1) + vj)
            vert_colors[vi, vj] = (_RED if name == "down"
                                   else _BLUE if name == "up" else _WHITE)
    colors = np.repeat(np.repeat(vert_colors, division, axis=0),
                       division, axis=1)  # ((n+1)*div, (m+1)*div, 3)
    colors[ii % division != 0] = _WHITE
    img[np.repeat(ci, len(cj)), np.tile(cj, len(ci))] = colors.reshape(-1, 3)
    filled[np.repeat(ci, len(cj)), np.tile(cj, len(ci))] = True

    # nearest-seed fill: 4-neighbor dilation until no black pixels remain
    # (seed rows/cols are <= ~img_size/(n*division) apart so this converges
    # in a few dozen sweeps)
    for _ in range(img_size):
        if filled.all():
            break
        for (si, sj) in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            shifted = np.roll(img, (si, sj), axis=(0, 1))
            sh_f = np.roll(filled, (si, sj), axis=(0, 1))
            if si == 1:
                sh_f[0, :] = False
            elif si == -1:
                sh_f[-1, :] = False
            if sj == 1:
                sh_f[:, 0] = False
            elif sj == -1:
                sh_f[:, -1] = False
            take = sh_f & ~filled
            img[take] = shifted[take]
            filled |= take
    return (img * 255).astype(np.uint8)


def save_png(img: np.ndarray, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return raster.write_png(path, img)


def crease_mix_texture(scene, cloth_body: int, base: Texture,
                       out_dir: str, name: str = "crease_mix") -> Texture:
    """Fold-crease painted texture multiplied over the base cloth texture
    (reference process_curve_mix, convert_luisa.py:385-401: row-7 vertices
    "up"/blue, row-8 "down"/red for the folding scene)."""
    c = scene.spec.cloth
    N, M = c.N[cloth_body], c.M[cloth_body]

    def judge(pij):
        row = pij // (M + 1)
        return "up" if row == 7 else "down" if row == 8 else None

    img = get_mix_texture(N, M, judge)
    rel = f"{name}.png"
    save_png(img, os.path.join(out_dir, rel))
    return Texture(mix_top=base, mix_bottom=Texture(file=rel),
                   mix_factor=1.0, mix_method="multiply")


def default_asset_dir() -> Optional[str]:
    """The bundled procedural stand-in pack (render/gen_assets.py), used
    when no external AssetLoader directory is configured."""
    from ..io.tetfile import data_path

    d = data_path("assets")
    return d if os.path.isdir(d) else None


def envmap_path(asset_dir: Optional[str], name: str) -> Optional[str]:
    """Resolve an environment-map preset name (e.g. 'indoor_2' from
    scene_texture_options.json) to an image file, reference
    render_engine.py:103-111 get_asset_env; None -> constant fallback."""
    if not name or not asset_dir:
        return None
    for rel in (os.path.join("envmaps", f"{name}.png"),
                os.path.join("envmaps", f"{name}.exr"),
                f"{name}.png", f"{name}.exr"):
        p = os.path.join(asset_dir, rel)
        if os.path.exists(p):
            return p
    return None


def _image_or_color(asset_dir: Optional[str], rel: str, color) -> Texture:
    """Image texture when the external asset pack is present, else the
    constant fallback (the reference's AssetLoader directory is not shipped
    with its repo either; render_engine.get_asset_cloth)."""
    if asset_dir:
        p = os.path.join(asset_dir, rel)
        if os.path.exists(p):
            return Texture(file=p)
    return Texture(constant=color)


def cloth_presets(asset_dir: Optional[str] = None):
    """reference render_engine.py:61-77."""
    return {
        "cloth_1": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "fabric_pattern_05/fabric_pattern_05_col_01_1k.png",
            (0.8, 0.3, 0.3))),
        "cloth_2": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "fabric_pattern_07/fabric_pattern_07_col_01_1k.png",
            (0.3, 0.3, 0.8))),
        "paper_1": Surface(kind="matte", kd=Texture(constant=(0.9, 0.9, 0.9)),
                           roughness=0.9),
        "iron_1": Surface(kind="metal", kd=Texture(constant=(0.6, 0.6, 0.6)),
                          roughness=0.1, eta="Fe"),
    }


def elastic_presets(asset_dir: Optional[str] = None):
    """reference render_engine.py:78-96."""
    return {
        "wood_1": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "dark_wood/dark_wood_diff_1k.png", (0.35, 0.22, 0.12))),
        "eraser": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "eraser/eraser_col.png", (0.9, 0.85, 0.75))),
        "pure_1": Surface(kind="matte", kd=Texture(constant=(1.0, 0.334, 0.52))),
        "pure_2": Surface(kind="matte", kd=Texture(constant=(0.22, 0.72, 0.52))),
        "pure_3": Surface(kind="matte", kd=Texture(constant=(0.09, 0.63, 0.90))),
    }


def table_presets(asset_dir: Optional[str] = None):
    """reference render_engine.py:97-102."""
    return {
        "wood_table_1": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "wooden_table/wooden_table_diff_1k.png",
            (0.45, 0.30, 0.18)), roughness=0.8),
        "wood_table_2": Surface(kind="matte", kd=_image_or_color(
            asset_dir, "wooden_plane/wooden_plane_diff_1k.png",
            (0.55, 0.40, 0.25)), roughness=0.8),
    }

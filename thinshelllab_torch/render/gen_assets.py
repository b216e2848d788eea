"""Procedural stand-in asset pack for the Luisa export path (counterpart
of `thinshelllab_tpu/render/gen_assets.py`, the same images from the same
seeds).

The reference resolves image textures and environment maps from an external
AssetLoader submodule that is not shipped with its repository
(the reference's .gitmodules:1-3; lookups in engine/render_engine.py:61-111).
So that image-texture presets are demonstrable out of the box, this module
synthesizes small deterministic stand-in textures (woven fabric, wood grain,
speckled rubber, indoor environment gradients) under data/assets/ with the
SAME relative paths the presets reference. `python -m
thinshelllab_torch.render.gen_assets` regenerates them; the PNGs are committed
so no generation step is needed at run time (they are the JAX package's
files; this module writes the same pixels). Point THINSHELL_ASSET_DIR at a
real asset pack to override.
"""
from __future__ import annotations

import os

import numpy as np

from . import raster

SIZE = 256


def _save(img: np.ndarray, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return raster.write_png(
        path, np.clip(img * 255.0, 0, 255).astype(np.uint8))


def _grid(n=SIZE):
    y, x = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return y, x


def _smooth_noise(rng, n=SIZE, octaves=4):
    """Cheap fractal value noise: upsampled random lattices summed over
    octaves (enough texture character for a stand-in diffuse map)."""
    out = np.zeros((n, n))
    amp = 1.0
    for o in range(octaves):
        k = 4 * 2**o
        lat = rng.standard_normal((k + 1, k + 1))
        idx = np.linspace(0, k, n)
        i0 = np.floor(idx).astype(int)
        f = idx - i0
        i1 = np.minimum(i0 + 1, k)
        a = lat[np.ix_(i0, i0)] * np.outer(1 - f, 1 - f)
        b = lat[np.ix_(i0, i1)] * np.outer(1 - f, f)
        c = lat[np.ix_(i1, i0)] * np.outer(f, 1 - f)
        d = lat[np.ix_(i1, i1)] * np.outer(f, f)
        out += amp * (a + b + c + d)
        amp *= 0.5
    return (out - out.min()) / (np.ptp(out) + 1e-12)


def fabric(color, seed):
    """Plain-weave fabric: alternating warp/weft bands with thread ridges."""
    rng = np.random.default_rng(seed)
    y, x = _grid()
    period = 16
    warp_over = ((y // period + x // period) % 2).astype(float)
    ridge = 0.5 + 0.5 * np.where(
        warp_over > 0.5,
        np.sin(np.pi * (x % period) / period),
        np.sin(np.pi * (y % period) / period),
    )
    shade = 0.75 + 0.35 * ridge + 0.08 * (_smooth_noise(rng) - 0.5)
    img = shade[..., None] * np.asarray(color)[None, None, :]
    return img


def wood(base, ring_scale, seed, contrast=0.22):
    """Wood grain: distorted concentric rings modulating a base color."""
    rng = np.random.default_rng(seed)
    y, x = _grid()
    warp = _smooth_noise(rng, octaves=3)
    r = x / SIZE * ring_scale + 3.0 * warp
    rings = 0.5 + 0.5 * np.sin(2 * np.pi * r)
    streak = _smooth_noise(rng, octaves=5)
    shade = 1.0 - contrast * rings * (0.6 + 0.4 * streak)
    return shade[..., None] * np.asarray(base)[None, None, :]


def speckle(base, seed, density=0.02, amount=0.25):
    """Rubber/eraser: flat color with sparse dark speckles."""
    rng = np.random.default_rng(seed)
    img = np.ones((SIZE, SIZE, 3)) * np.asarray(base)[None, None, :]
    mask = rng.random((SIZE, SIZE)) < density
    img[mask] *= 1.0 - amount
    img += 0.03 * (_smooth_noise(rng) - 0.5)[..., None]
    return img


def indoor_env(warmth, seed):
    """Equirectangular indoor environment: vertical luminance gradient
    (bright ceiling, dim floor) with a few soft window hot spots."""
    rng = np.random.default_rng(seed)
    h, w = SIZE // 2, SIZE
    y = np.linspace(0, 1, h)[:, None]
    lum = 1.4 - 1.1 * y  # ceiling bright -> floor dark
    img = np.ones((h, w, 3)) * lum[..., None]
    for _ in range(3):  # window hot spots around the horizon
        cx = rng.integers(0, w)
        cy = int(h * (0.35 + 0.2 * rng.random()))
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        dx = np.minimum(np.abs(xx - cx), w - np.abs(xx - cx))
        g = np.exp(-((dx / 14.0) ** 2 + ((yy - cy) / 9.0) ** 2))
        img += 1.5 * g[..., None]
    tint = np.asarray([1.0, 0.95, 0.85]) if warmth else np.asarray(
        [0.85, 0.92, 1.0])
    return np.clip(img * tint[None, None, :] * 0.55, 0, 1)


ASSETS = {
    "fabric_pattern_05/fabric_pattern_05_col_01_1k.png":
        lambda: fabric((0.80, 0.30, 0.30), 5),
    "fabric_pattern_07/fabric_pattern_07_col_01_1k.png":
        lambda: fabric((0.30, 0.30, 0.80), 7),
    "dark_wood/dark_wood_diff_1k.png":
        lambda: wood((0.35, 0.22, 0.12), 9.0, 11),
    "eraser/eraser_col.png":
        lambda: speckle((0.90, 0.85, 0.75), 13),
    "wooden_table/wooden_table_diff_1k.png":
        lambda: wood((0.45, 0.30, 0.18), 6.0, 17),
    "wooden_plane/wooden_plane_diff_1k.png":
        lambda: wood((0.55, 0.40, 0.25), 12.0, 19, contrast=0.15),
    "envmaps/indoor_1.png": lambda: indoor_env(False, 23),
    "envmaps/indoor_2.png": lambda: indoor_env(True, 29),
}


def generate(out_dir: str) -> list:
    return [_save(fn(), os.path.join(out_dir, rel))
            for rel, fn in ASSETS.items()]


def main():
    from ..io.tetfile import data_path

    out = data_path("assets")
    for p in generate(out):
        print(p)


if __name__ == "__main__":
    main()

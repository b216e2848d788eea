"""Renderer facade (counterpart of `thinshelllab_tpu/render/engine.py`;
reference engine/render_engine.Renderer:246-280): dispatches to the
headless preview raster or LuisaRender script export, with per-environment
texture presets from data/scene_texture_options.json (the port's own copy).

The preview draws on the positions' device; the Luisa export writes text
and OBJ files from host positions (device tensors are taken with .cpu())."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..io.tetfile import data_path
from . import luisa, mesh_ops
from .preview import PreviewRenderer, _host

_SURFACE_PRESETS = {
    # cloth/elastic material presets (subset of render_engine.py:61-111)
    "paper_1": luisa.Surface("matte", luisa.Texture(constant=(0.9, 0.9, 0.85)), 0.8),
    "poker_1": luisa.Surface("plastic", luisa.Texture(constant=(0.9, 0.2, 0.2)), 0.3),
    "poker_2": luisa.Surface("plastic", luisa.Texture(constant=(0.2, 0.5, 0.9)), 0.3),
    "poker_3": luisa.Surface("plastic", luisa.Texture(constant=(0.3, 0.3, 0.3)), 0.3),
    "fabric_1": luisa.Surface(
        "matte",
        luisa.Texture(
            checker_on=luisa.Texture(constant=(0.22, 0.72, 0.52)),
            checker_off=luisa.Texture(constant=(1.0, 0.334, 0.52)),
            checker_scale=8.0,
        ),
        0.9,
    ),
    "pure_1": luisa.Surface("matte", luisa.Texture(constant=(0.22, 0.72, 0.52)), 0.6),
    "pure_2": luisa.Surface("matte", luisa.Texture(constant=(1.0, 0.334, 0.52)), 0.6),
    "pure_3": luisa.Surface("matte", luisa.Texture(constant=(0.6, 0.6, 0.65)), 0.6),
    "wood_table_1": luisa.Surface("matte", luisa.Texture(constant=(0.45, 0.3, 0.18)), 0.7),
    "default": luisa.Surface("matte", luisa.Texture(constant=(0.7, 0.7, 0.7)), 0.7),
}


def load_texture_options(env_name: str) -> dict:
    with open(data_path("scene_texture_options.json")) as f:
        opts = json.load(f)
    return opts.get(env_name, {})


class Renderer:
    """option: 'Preview' (headless raster, PNG+GIF artifacts, stands in for
    the GPU-window-bound Taichi GGUI path) or 'LuisaScript' (offline
    photorealistic export)."""

    def __init__(self, scene, env_name: str, option: str = "Preview",
                 save_dir: Optional[str] = None):
        self.scene = scene
        self.spec = scene.spec
        self.env_name = env_name
        self.option = option
        self.save_dir = save_dir or f"imgs/{env_name}"
        self.settings = load_texture_options(env_name)
        if option in ("Preview", "Taichi"):
            self.backend = PreviewRenderer(
                self.spec, self.save_dir,
                fit_pos=_host(scene.state0.pos),
            )
        elif option == "LuisaScript":
            self.backend = None
            self.scripts = luisa.LuisaScripts(self.save_dir)
            self._setup_luisa_shared()
        else:
            raise ValueError(option)

    def set_save_dir(self, d: str):
        self.save_dir = d
        if self.backend is not None:
            self.backend.set_save_dir(d)
        else:
            self.scripts = luisa.LuisaScripts(d)
            self._setup_luisa_shared()

    # -------------------------------------------------------------- preview

    def render(self, name: str, pos=None, state=None):
        """pos: (NV, 3) numpy array or tensor (or state.pos)."""
        pos = pos if pos is not None else state.pos
        if self.backend is not None:
            return self.backend.render(torch.as_tensor(pos), name)
        return self._render_luisa_frame(name, _host(pos))

    def end_rendering(self, tag=0):
        if self.backend is not None:
            return self.backend.end_rendering(tag)
        return self.scripts.export_all()

    # ---------------------------------------------------------------- luisa

    def _setup_luisa_shared(self):
        from . import textures

        s = self.scripts.shared_script()
        cam_cfg = self.settings.get("camera", {})
        s.cameras.append(
            luisa.Camera(
                position=tuple(cam_cfg.get("position", (0.0, -0.3, 0.2))),
                look_at=tuple(cam_cfg.get("look_at", (0.0, 0.0, 0.0))),
            )
        )
        s.lights.append(
            luisa.AreaLight(position=(0.0, 0.0, 0.5), size=0.3,
                            emission=(20.0, 20.0, 20.0))
        )
        # asset-pack image textures activate when an AssetLoader-style
        # directory is available, matching the reference's
        # render_engine.get_asset_* lookups; the bundled procedural
        # stand-in pack (render/gen_assets.py) is the default
        asset_dir = self.settings.get(
            "asset_dir", os.environ.get("THINSHELL_ASSET_DIR")
        ) or textures.default_asset_dir()
        env_cfg = self.settings.get("environment", {})
        if isinstance(env_cfg, str):  # e.g. "indoor_2" shorthand
            env_cfg = {"type": env_cfg}
        env_file = textures.envmap_path(asset_dir, env_cfg.get("type"))
        s.environment = luisa.Environment(
            file=env_file, constant=(0.8, 0.8, 0.8),
            rotation=env_cfg.get("rotation", 0.0)
        )
        presets = dict(_SURFACE_PRESETS)
        presets.update(textures.cloth_presets(asset_dir))
        presets.update(textures.elastic_presets(asset_dir))
        presets.update(textures.table_presets(asset_dir))
        for key, surf in presets.items():
            s.surfaces[key] = surf
        self._presets = presets

        # crease-painted cloth textures (reference process_curve_mix):
        # a cloth config with "curve": true gets a dedicated surface whose
        # Kd multiplies the painted fold-line image over the base texture
        for k, cfg in enumerate(self.settings.get("clothes", [])):
            if not cfg.get("curve"):
                continue
            base = presets.get(cfg.get("type", "default"),
                               presets["default"])
            mix = textures.crease_mix_texture(
                self.scene, k, base.kd or luisa.Texture(constant=(0.8,) * 3),
                self.save_dir, name=f"crease_mix_{k}")
            s.surfaces[f"cloth_{k}_curve"] = luisa.Surface(
                kind=base.kind, kd=mix, roughness=base.roughness)

    def _body_surface(self, body_idx: int, is_cloth: bool, k: int) -> str:
        cfg_list = self.settings.get("clothes" if is_cloth else "elastics", [])
        if k < len(cfg_list):
            cfg = cfg_list[k]
            if is_cloth and cfg.get("curve"):
                return f"cloth_{k}_curve"
            t = cfg.get("type", "default")
            if t in getattr(self, "_presets", _SURFACE_PRESETS):
                return t
        return "fabric_1" if is_cloth else "default"

    def _render_luisa_frame(self, name: str, pos: np.ndarray):
        s = self.scripts.frame_script(name)
        cloth_offsets = set(self.spec.cloth.offsets)
        ci = ei = 0
        cloth_cfgs = self.settings.get("clothes", [])
        for b in range(self.spec.n_bodies):
            vs, ve = self.spec.body_v_start[b], self.spec.body_v_end[b]
            fs, fe = self.spec.body_f_start[b], self.spec.body_f_end[b]
            faces = np.asarray(self.spec.faces[fs:fe]) - vs
            verts = pos[vs:ve]
            if vs in cloth_offsets:
                thickness = 0.0005
                if ci < len(cloth_cfgs):
                    thickness = cloth_cfgs[ci].get("thickness", 0.0005)
                v, f = mesh_ops.process_cloth(verts, faces, thickness,
                                              subdivisions=1)
                s.add_mesh(f"cloth_{ci}", v, f,
                           self._body_surface(b, True, ci))
                ci += 1
            else:
                s.add_mesh(f"elastic_{ei}", verts, faces,
                           self._body_surface(b, False, ei))
                ei += 1
        return s.export()

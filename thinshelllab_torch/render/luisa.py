"""LuisaRender scene-description script export (counterpart of
`thinshelllab_tpu/render/luisa.py`).

Re-designed compact emitter for the `.luisa` text grammar the reference
targets (engine/build_luisa_script.py): a shared scene of cameras, lights,
surfaces and static meshes, plus one script per frame referencing exported
OBJ files. Pure text emission, device-independent.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import mesh_ops


def _v(x) -> str:
    return ", ".join(str(float(c)) for c in x)


@dataclasses.dataclass
class Texture:
    """Texture node covering the reference grammar's constant / image /
    checkerboard / mix / uvmapping variants
    (build_luisa_script.LuisaTexture:80-155)."""

    constant: Optional[Tuple[float, ...]] = None
    file: Optional[str] = None
    image_scale: float = 1.0
    checker_on: Optional["Texture"] = None
    checker_off: Optional["Texture"] = None
    checker_scale: float = 10.0
    mix_top: Optional["Texture"] = None
    mix_bottom: Optional["Texture"] = None
    mix_factor: float = 1.0
    mix_method: str = "multiply"  # add | substract | multiply | mix
    # uvmapping node (build_luisa_script.py:148-152): remap the UVs fed to
    # a wrapped texture through another texture (e.g. crease-painted cloth)
    uv_remap: Optional["Texture"] = None
    uv_texture: Optional["Texture"] = None

    def emit(self, indent=1) -> str:
        t = "\t" * indent
        if self.constant is not None:
            return f"constant {{\n{t}\tv {{ {_v(self.constant)} }}\n{t}}}"
        if self.file is not None:
            return (f'image {{\n{t}\tfile {{ "{self.file}" }}\n'
                    f"{t}\tscale {{ {float(self.image_scale)} }}\n{t}}}")
        if self.checker_on is not None:
            return (
                f"checkerboard {{\n"
                f"{t}\ton {{ {self.checker_on.emit(indent + 1)} }}\n"
                f"{t}\toff {{ {self.checker_off.emit(indent + 1)} }}\n"
                f"{t}\tscale {{ {self.checker_scale} }}\n{t}}}"
            )
        if self.mix_top is not None:
            return (
                f"mix {{\n"
                f"{t}\ttop {{ {self.mix_top.emit(indent + 1)} }}\n"
                f"{t}\tbottom {{ {self.mix_bottom.emit(indent + 1)} }}\n"
                f"{t}\tfactor {{ {float(self.mix_factor)} }}\n"
                f'{t}\tmethod {{ "{self.mix_method}" }}\n{t}}}'
            )
        if self.uv_remap is not None and self.uv_texture is not None:
            return (
                f"uvmapping {{\n"
                f"{t}\tuv_map {{ {self.uv_remap.emit(indent + 1)} }}\n"
                f"{t}\ttexture {{ {self.uv_texture.emit(indent + 1)} }}\n"
                f"{t}}}"
            )
        return "constant { v { 0.5, 0.5, 0.5 } }"


@dataclasses.dataclass
class Surface:
    kind: str = "matte"  # matte | glass | metal | plastic | mirror
    kd: Optional[Texture] = None
    roughness: float = 0.5
    eta: Optional[str] = None

    def emit(self, name: str) -> str:
        kd = (self.kd or Texture(constant=(0.8, 0.8, 0.8))).emit(1)
        lines = [f"surface {name} : {self.kind} {{", f"\tKd {{ {kd} }}"]
        lines.append(f"\troughness {{ constant {{ v {{ {self.roughness} }} }} }}")
        if self.eta:
            lines.append(f'\teta {{ "{self.eta}" }}')
        lines.append("}")
        return "\n".join(lines)


@dataclasses.dataclass
class Camera:
    position: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    fov: float = 35.0
    resolution: Tuple[int, int] = (1024, 1024)
    spp: int = 64
    name: str = "view"

    def emit(self, file_name: str) -> str:
        front = tuple(np.asarray(self.look_at) - np.asarray(self.position))
        return f"""camera {self.name} : pinhole {{
\tposition {{ {_v(self.position)} }}
\tfront {{ {_v(front)} }}
\tup {{ {_v(self.up)} }}
\tfov {{ {self.fov} }}
\tspp {{ {self.spp} }}
\tfilm {{ : color {{ resolution {{ {self.resolution[0]}, {self.resolution[1]} }} }} }}
\tfile {{ "{file_name}" }}
}}"""


@dataclasses.dataclass
class AreaLight:
    position: Tuple[float, float, float]
    size: float
    emission: Tuple[float, float, float]
    name: str = "light"

    def emit(self) -> str:
        s = self.size / 2
        p = np.asarray(self.position)
        verts = [
            p + (-s, -s, 0), p + (s, -s, 0), p + (s, s, 0), p + (-s, s, 0)
        ]
        vstr = "\n".join(f"\t\t{_v(v)}," for v in verts)[:-1]
        return f"""shape {self.name} : mesh {{
\tpositions {{
{vstr}
\t}}
\tindices {{ 0, 1, 2, 0, 2, 3 }}
\tlight {{ : diffuse {{ emission {{ constant {{ v {{ {_v(self.emission)} }} }} }} }} }}
}}"""


@dataclasses.dataclass
class Environment:
    file: Optional[str] = None
    constant: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rotation: float = 0.0

    def emit(self) -> str:
        if self.file:
            return (
                f'environment : spherical {{\n\temission {{ image {{ file {{ '
                f'"{self.file}" }} }} }}\n\ttransform {{ : srt {{ rotate {{ '
                f"0, 0, 1, {self.rotation} }} }} }}\n}}"
            )
        return (
            f"environment : spherical {{\n\temission {{ constant {{ v {{ "
            f"{_v(self.constant)} }} }} }}\n}}"
        )


class LuisaScript:
    """One frame's scene script + its exported OBJ models."""

    def __init__(self, script_dir: str, mark: str = None,
                 integrator="wavepath_v2", sampler="pmj02bn", spectrum="hero"):
        self.script_dir = script_dir
        self.mark = mark
        self.model_dir = f"models_{mark}" if mark else "models"
        self.script_name = f"scene_{mark}.luisa" if mark else "scene.luisa"
        self.integrator = integrator
        self.sampler = sampler
        self.spectrum = spectrum
        self.cameras: List[Camera] = []
        self.lights: List[AreaLight] = []
        self.surfaces: Dict[str, Surface] = {}
        self.environment: Optional[Environment] = None
        self.meshes: List[Tuple[str, str, str]] = []  # (name, obj_path, surface)

    def add_mesh(self, name, verts, faces, surface: str, uv=None):
        os.makedirs(os.path.join(self.script_dir, self.model_dir), exist_ok=True)
        rel = os.path.join(self.model_dir, f"{name}.obj")
        mesh_ops.export_obj(os.path.join(self.script_dir, rel), verts, faces, uv)
        self.meshes.append((name, rel, surface))

    def add_shared_mesh(self, name, rel_obj_path, surface: str):
        self.meshes.append((name, rel_obj_path, surface))

    def export(self) -> str:
        parts = [
            f"render {{",
            f"\tintegrator {{ : {self.integrator} {{ }} }}",
            f"\tsampler {{ : {self.sampler} {{ }} }}",
            f"\tspectrum {{ : {self.spectrum} {{ }} }}",
            f"}}",
        ]
        for name, surf in self.surfaces.items():
            parts.append(surf.emit(name))
        for i, cam in enumerate(self.cameras):
            img = f"frame_{self.mark or 0}_cam{i}.exr"
            parts.append(cam.emit(img))
        for light in self.lights:
            parts.append(light.emit())
        if self.environment:
            parts.append(self.environment.emit())
        for name, rel, surface in self.meshes:
            parts.append(
                f'shape {name} : mesh {{\n\tfile {{ "{rel}" }}\n'
                f"\tsurface {{ @{surface} }}\n}}"
            )
        text = "\n\n".join(parts)
        os.makedirs(self.script_dir, exist_ok=True)
        path = os.path.join(self.script_dir, self.script_name)
        with open(path, "w") as f:
            f.write(text)
        return path


class LuisaScripts:
    """Shared static objects + one script per frame (reference
    build_luisa_script.LuisaRenderScripts:397-674)."""

    def __init__(self, script_dir: str, **kwargs):
        self.script_dir = script_dir
        self.kwargs = kwargs
        self.shared: Optional[LuisaScript] = None
        self.frames: Dict[str, LuisaScript] = {}

    def shared_script(self) -> LuisaScript:
        if self.shared is None:
            self.shared = LuisaScript(self.script_dir, mark=None, **self.kwargs)
        return self.shared

    def frame_script(self, mark: str) -> LuisaScript:
        if mark not in self.frames:
            s = LuisaScript(self.script_dir, mark=mark, **self.kwargs)
            if self.shared is not None:
                s.cameras = list(self.shared.cameras)
                s.lights = list(self.shared.lights)
                s.surfaces = dict(self.shared.surfaces)
                s.environment = self.shared.environment
                s.meshes = list(self.shared.meshes)
            self.frames[mark] = s
        return self.frames[mark]

    def export_all(self):
        return [s.export() for s in self.frames.values()]

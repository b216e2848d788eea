"""SceneSpec / Params / SimState: the static + dynamic decomposition of a scene.

Counterpart of `thinshelllab_tpu/core/spec.py`. The dataclasses hold numpy
leaves as the builder makes them; `to(device, dtype)` returns a copy whose
array leaves are tensors on one device, made once per scene (index arrays
become int64, masks stay bool, floats take `dtype`). Fields marked static
stay plain Python values. On the moved copy, host-derived tables the
runtime needs (the contact split, the kernel's offset table, the parity
masks of the DIA assembly) are computed once and stored beside the leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


def static_field(**kwargs) -> Any:
    """A field that stays a Python value under `to()`."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def _move(v, device, dtype):
    if v is None:
        return None
    if isinstance(v, _Struct):
        return v.to(device, dtype)
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bool:
            return v.to(device)
        if v.dtype.is_floating_point:
            return v.to(device=device, dtype=dtype)
        return v.to(device=device, dtype=torch.int64)
    return v


class _Struct:
    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def to(self, device, dtype=torch.float64):
        """Copy with every array leaf a tensor on `device` (floats in
        `dtype`); static fields are kept."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v if f.metadata.get("static") else _move(v, device,
                                                                 dtype)
        return dataclasses.replace(self, **kw)


def _dataclass(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_dataclass
class ClothSoup(_Struct):
    """All cloth faces/hinges of the scene, concatenated."""

    f2v: Any            # (NFc, 3) global vertex ids
    cloth_id: Any       # (NFc,)
    l0: Any             # (NFc, 3) rest edge lengths
    rest_area: Any      # (NFc,)
    hinge_verts: Any    # (NH, 4) [v0, v1, v2, v3] stencil
    hinge_sel: Any      # (NH, 4, 4) one-hot selection (energies.hinge_angle)
    hinge_mask: Any     # (NH,) bool: active hinge
    hinge_coef: Any     # (NH,) dx^2 / 3
    hinge_cloth: Any    # (NH,)
    counter_face: Any   # (NFc, 3)
    counter_point: Any  # (NFc, 3)
    n_cloths: int = static_field(default=0)
    NV_per: Tuple[int, ...] = static_field(default=())
    N: Tuple[int, ...] = static_field(default=())
    M: Tuple[int, ...] = static_field(default=())
    offsets: Tuple[int, ...] = static_field(default=())
    face_offsets: Tuple[int, ...] = static_field(default=())
    k_angle: Tuple[float, ...] = static_field(default=())
    dx: Tuple[float, ...] = static_field(default=())


@_dataclass
class TetSoup(_Struct):
    tets: Any   # (T, 4) global vertex ids
    B: Any      # (T, 3, 3) rest shape-matrix inverse
    W: Any      # (T,) rest volume
    group: Any  # (T,) index into the soup's (mu, lam) params


@_dataclass
class ContactSpec(_Struct):
    """Directed contact pair table + fixed-capacity query buffer (see the
    JAX ContactSpec for every field's meaning)."""

    cq_vert: Any
    cq_pair: Any
    cq_mu_id: Any
    cq_fstart: Any
    cq_nf: Any
    cq_self: Any
    n_pairs: int = static_field(default=0)
    capacity: int = static_field(default=0)
    max_src_faces: int = static_field(default=0)
    top_k: int = static_field(default=32)
    query_chunk: int = static_field(default=512)
    pair_desc: Tuple = static_field(default=())
    hash_desc: Tuple = static_field(default=())
    hash_min_faces: int = static_field(default=32768)
    frozen_src: Tuple = static_field(default=())
    src_vrange: Tuple = static_field(default=())
    mm_budget: int = static_field(default=8_000_000)


@_dataclass
class GripperSpec(_Struct):
    bound_idx: Any   # (nb,) pad-local ids of driven (frozen) verts
    pad_rest: Any    # (n_pad_verts, 3)
    mode: str = static_field(default="none")
    n_part: int = static_field(default=0)
    n_pads: int = static_field(default=0)
    pad_offset: Tuple[int, ...] = static_field(default=())
    pad_part: Tuple[int, ...] = static_field(default=())
    pad_sign: Tuple[int, ...] = static_field(default=())
    pad_flip: Tuple[bool, ...] = static_field(default=())
    n_pad_verts: int = static_field(default=0)
    n_bound: int = static_field(default=0)


@_dataclass
class DiaPlan(_Struct):
    """Hybrid DIA storage plan for the regular part of the static Hessian
    (see the JAX DiaPlan). The (n_off, 3, 3, NVp) store is what the
    `dia_spmv` and `dia_precond` kernels stream."""

    row_tab: Any
    o_idx: Any
    rows: Any
    extra_ea: Any
    extra_rows: Any
    offsets: Tuple[int, ...] = static_field(default=())
    max_abs_off: int = static_field(default=0)
    Dr: int = static_field(default=0)
    NVp: int = static_field(default=0)
    cloths: Tuple = static_field(default=())


@_dataclass
class HvpSlots(_Struct):
    """Static pull-based sparsity of the leftover (irregular) blocks."""

    slot_e: Any
    slot_ab: Any
    slot_col: Any
    row_ids: Any
    D: int = static_field(default=0)


@_dataclass
class SceneSpec(_Struct):
    mass: Any
    gravity: Any
    ext_force: Any
    frozen: Any
    faces: Any
    hvp_slots: Any
    dia: Any
    cloth: ClothSoup
    neo: TetSoup
    tact: TetSoup
    contact: ContactSpec
    gripper: GripperSpec
    NV: int = static_field(default=0)
    n_bodies: int = static_field(default=0)
    body_v_start: Tuple[int, ...] = static_field(default=())
    body_v_end: Tuple[int, ...] = static_field(default=())
    body_f_start: Tuple[int, ...] = static_field(default=())
    body_f_end: Tuple[int, ...] = static_field(default=())
    dt: float = static_field(default=5e-3)
    damping: float = static_field(default=1.0)
    k_contact: float = static_field(default=10000.0)
    eps_contact: float = static_field(default=4e-4)
    eps_v: float = static_field(default=1e-2)
    max_newton_iter: int = static_field(default=50)
    newton_tol: float = static_field(default=1e-7)
    linesearch_min_alpha: float = static_field(default=1e-8)
    plastic: bool = static_field(default=False)
    grid_h: float = static_field(default=3e-3)
    solver: str = static_field(default="dense")
    spd_method: str = static_field(default="eigh")
    cg_tol: float = static_field(default=1e-10)
    cg_max_iter: int = static_field(default=400)
    fwd_tol: float | None = static_field(default=None)
    adj_tol: float | None = static_field(default=None)
    precond_smooth: int = static_field(default=0)
    precond_omega: float = static_field(default=0.8)
    hess_refresh: int = static_field(default=1)
    # DIA SpMV route: 'auto' = the CUDA kernels for CUDA tensors and the
    # plain PyTorch versions for CPU tensors; 'kernel' = the CUDA kernels
    # (raises on CPU tensors); 'plain' = the plain versions everywhere.
    # The JAX values 'pallas' / 'xla' map to 'kernel' / 'plain'.
    spmv: str = static_field(default="auto")
    bend_batch: bool = static_field(default=False)
    bcr_cutoff: int = static_field(default=4)
    dtype: Any = static_field(default=torch.float64)
    # DeviceConsts of a moved spec (None on the builder's numpy spec)
    dev: Any = static_field(default=None)


@dataclasses.dataclass(frozen=True)
class DeviceConsts:
    """Loop-invariant tensors of a moved scene, made once by
    `SceneSpec.to` instead of at every call (elements.device_consts)."""

    unf: Any            # (NV, 3) unfrozen mask in the spec dtype
    unf_p: Any          # (NV+1, 3) the same with a zero ghost row
    canon: Any          # (4, 3) canonical stencil of masked-out hinges
    hinge_m: Any        # (NH,) hinge mask in the spec dtype
    contact_split: Any  # plans.contact_static_split of the host spec
    # with a DIA plan:
    unf2: Any = None        # (3, NVp) unfrozen mask, zero in padding
    m2: Any = None          # (NVp,) mass / dt^2, zero in padding
    offsets_t: Any = None   # (n_off,) int32: the kernels' offset table
    off0: int = 0           # lane of offset 0
    par_masks: Tuple = ()   # per cloth (2, N, M) parity masks
    onehot: Any = None      # (Rn, Dr*4, n_off+1) tet-block lane placement
    grid_plan: Tuple = ()   # gridsolve.build_grid_plan of the host spec
    coupling_slots: Tuple = ()  # per planned cloth: (S,) contact slots or None


@_dataclass
class Params(_Struct):
    """Differentiable physical parameters."""

    kl: Any
    ka: Any
    kb: Any
    neo_mu: Any
    neo_lam: Any
    tact_mu: Any
    tact_lam: Any
    mu_pairs: Any


@_dataclass
class GripperState(_Struct):
    pos: Any        # (n_part, 3)
    rot: Any        # (n_part, 4) scalar-first quaternion
    dist: Any       # (n_part,)
    pad_local: Any  # (n_pads, n_pad_verts, 3)


@_dataclass
class SimState(_Struct):
    pos: Any        # (NV, 3)
    vel: Any        # (NV, 3)
    ref_angle: Any  # (NH,)
    proj_flag: Any  # (C,) latched projection validity
    proj_dir: Any   # (C,) latched contact side
    gripper: GripperState


@_dataclass
class ContactSet(_Struct):
    """Constraint buffer built each step (fixed capacity C, masked)."""

    active: Any  # (C,) bool
    idx: Any     # (C, 4) triangle verts (0..2) + projecting vertex (3)
    w: Any       # (C, 3) barycentric weights
    n: Any       # (C, 3) contact normal
    k: Any       # (C,) friction scale
    mu: Any      # (C,)
    dx0: Any     # (C, 3) reference tangential offset
    T: Any       # (C, 2, 3) tangent frame


def zero_params(spec: SceneSpec) -> Params:
    """The JAX package's default Params of a spec (kl = ka = 1000 and
    kb = 100 per cloth, everything else zero), with numpy leaves in the
    spec's dtype as the builder makes them (`Params.to` moves them)."""
    nd = {torch.float32: np.float32, torch.float64: np.float64}[spec.dtype]
    nc = max(spec.cloth.n_cloths, 1)
    return Params(
        kl=np.full((nc,), 1000.0, nd),
        ka=np.full((nc,), 1000.0, nd),
        kb=np.full((nc,), 100.0, nd),
        neo_mu=np.zeros((1,), nd),
        neo_lam=np.zeros((1,), nd),
        tact_mu=np.zeros((1,), nd),
        tact_lam=np.zeros((1,), nd),
        mu_pairs=np.zeros((1,), nd),
    )


def body_of_vertex(spec: SceneSpec, i: int) -> int:
    for b in range(spec.n_bodies):
        if spec.body_v_start[b] <= i < spec.body_v_end[b]:
            return b
    raise ValueError(i)

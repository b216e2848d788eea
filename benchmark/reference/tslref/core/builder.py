"""SceneBuilder: host-side (numpy) construction of SceneSpec, the initial
SimState and Params.

Counterpart of `thinshelllab_tpu/core/builder.py`, for the bodies and
relations the task scenes use: cloths, cube and ball elastics, tactile
pads, directed and self-contact pairs, frozen DOFs and a single/paired
gripper. Every leaf
it makes is numpy and equals the JAX builder's (tests/test_torch_builder.py);
`SceneSpec.to(device, dtype)` moves the result to a device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from . import topology
from .spec import (
    ClothSoup,
    ContactSpec,
    GripperSpec,
    GripperState,
    Params,
    SceneSpec,
    SimState,
    TetSoup,
)


def _np_dtype(d: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[d]


@dataclasses.dataclass
class _Body:
    kind: str  # 'cloth' | 'neo' | 'tact'
    n_verts: int
    n_faces: int
    v_offset: int = 0
    f_offset: int = 0
    cloth_mesh: Optional[topology.ClothMesh] = None
    dx: float = 0.0
    rho: float = 0.0
    k_angle: float = 3.14
    tet_mesh: Optional[topology.TetMesh] = None
    density: float = 2000.0
    E: float = 0.0
    nu: float = 0.0
    group: int = 0
    init_pos: Optional[np.ndarray] = None
    surfaces: Optional[np.ndarray] = None
    gravity_on: bool = True


class SceneBuilder:
    # below this many DOF the JAX package solves densely (its 'auto'
    # solver); the port runs the 'cg' path only and keeps the cutoff so an
    # 'auto' scene resolves the same way in both packages
    DENSE_CUTOFF_DOF = 6000

    def __init__(
        self,
        dt=5e-3,
        k_contact=10000.0,
        eps_contact=4e-4,
        eps_v=1e-2,
        damping=1.0,
        max_newton_iter=50,
        newton_tol=1e-7,
        gravity=(0.0, 0.0, -9.8),
        dtype=torch.float64,
        solver="dense",
        plastic=False,
        grid_h=3e-3,
        contact_top_k=32,
        hess_refresh=1,
        spmv="auto",
    ):
        self.cfg = dict(
            dt=dt,
            k_contact=k_contact,
            eps_contact=eps_contact,
            eps_v=eps_v,
            damping=damping,
            max_newton_iter=max_newton_iter,
            newton_tol=newton_tol,
            grid_h=grid_h,
            solver=solver,
            plastic=plastic,
            dtype=dtype,
            hess_refresh=hess_refresh,
            spmv=spmv,
        )
        self.gravity = np.asarray(gravity, np.float64)
        self.contact_top_k = contact_top_k
        self.bodies: List[_Body] = []
        self.pairs: List[Tuple[int, int, int, bool]] = []  # (src, tgt, mu, self)
        self.mu_init: List[float] = []
        self.frozen_fns: List[Callable] = []
        self.gripper_cfg = None
        self.cloth_params: List[Tuple[float, float, float]] = []  # kl, ka, kb

    # ---------------------------------------------------------------- bodies

    def add_cloth(self, N: int, M: int, size: float, rho: float = 40.0,
                  init_pos: np.ndarray = None, kl=1000.0, ka=1000.0,
                  kb=100.0, k_angle=3.14, gravity_on=True) -> int:
        mesh = topology.build_cloth_mesh(N, M)
        b = _Body(
            kind="cloth",
            n_verts=mesh.NV,
            n_faces=mesh.NF,
            cloth_mesh=mesh,
            dx=size / N,
            rho=rho,
            k_angle=k_angle,
            init_pos=init_pos,
            surfaces=mesh.f2v,
            gravity_on=gravity_on,
        )
        self.bodies.append(b)
        self.cloth_params.append((kl, ka, kb))
        return len(self.bodies) - 1

    def add_cube_elastic(self, nx, ny, nz, length, offset, density=2000.0,
                         E=5e5, nu=0.0, arch=0.0, gravity_on=True) -> int:
        mesh = topology.build_cube_tet_mesh(nx, ny, nz, length)
        pos = mesh.rest_pos.copy()
        if arch != 0.0:
            ix = np.arange(nx)
            z_arch = arch * np.sin(ix / (nx - 1) * 3.1415926)
            pos[:, 2] += np.repeat(z_arch, ny * nz)
        pos = pos + np.asarray(offset)
        return self._add_elastic(mesh, pos, density, E, nu, "neo",
                                 mesh.surfaces, gravity_on)

    def add_ball_elastic(self, offset, density=2000.0, E=5e5, nu=0.0,
                         gravity_on=True) -> int:
        mesh = topology.load_ball_mesh()
        pos = mesh.rest_pos + np.asarray(offset)
        surfaces = topology.orient_surface_outward(
            mesh.surfaces, pos, np.asarray(offset, np.float64))
        return self._add_elastic(mesh, pos, density, E, nu, "neo", surfaces,
                                 gravity_on)

    def add_tactile(self, offset, flip: bool, ratio: float, density=2000.0,
                    E=3e5, nu=0.2, gravity_on=False) -> int:
        mesh = topology.load_tactile_mesh()
        pos = ratio * mesh.rest_pos
        if flip:
            pos = -pos
        pos = pos + np.asarray(offset)
        # inner-circle faces keep inward orientation (reference
        # model_elastic_tactile.init_surface_indices:266-291)
        inner_pt = np.asarray(offset, np.float64) + np.array(
            [0.0, 0.0, -0.002 * ratio if flip else 0.002 * ratio]
        )
        inner_faces = np.all(mesh.is_inner[mesh.surfaces], axis=1)
        surfaces = topology.orient_surface_outward(
            mesh.surfaces, pos, inner_pt, invert_mask=inner_faces
        )
        idx = self._add_elastic(mesh, pos, density, E, nu, "tact", surfaces,
                                gravity_on)
        self.bodies[idx].dx = ratio  # stash ratio for gripper rest coords
        return idx

    def _add_elastic(self, mesh, pos, density, E, nu, kind, surfaces,
                     gravity_on):
        groups = [b.group for b in self.bodies if b.kind == kind]
        group = (max(groups) + 1) if groups else 0
        # share the parameter group when E/nu match an existing body
        for b in self.bodies:
            if b.kind == kind and b.E == E and b.nu == nu:
                group = b.group
                break
        b = _Body(
            kind=kind,
            n_verts=mesh.n_verts,
            n_faces=mesh.n_surfaces,
            tet_mesh=mesh,
            density=density,
            E=E,
            nu=nu,
            group=group,
            init_pos=np.asarray(pos, np.float64),
            surfaces=surfaces,
            gravity_on=gravity_on,
        )
        self.bodies.append(b)
        return len(self.bodies) - 1

    # ------------------------------------------------------------- relations

    def add_contact_pair(self, src_body: int, tgt_body: int, mu_slot: int):
        """Project tgt_body's vertices onto src_body's faces with friction
        params.mu_pairs[mu_slot]."""
        self.pairs.append((src_body, tgt_body, mu_slot, False))

    def add_self_contact_pair(self, body: int, mu_slot: int):
        """Self-contact: project the body's vertices onto its own faces,
        skipping the faces incident to the query vertex and accepting only
        face-interior projections (reference
        engine/geometry_self.projection_query)."""
        self.pairs.append((body, body, mu_slot, True))

    def new_mu_slot(self, mu: float) -> int:
        self.mu_init.append(mu)
        return len(self.mu_init) - 1

    def freeze(self, fn: Callable):
        """fn(builder, frozen (NV,3) bool) -> None, mutates frozen."""
        self.frozen_fns.append(fn)

    def set_gripper(self, mode: str, pad_bodies: List[int], pad_part: List[int],
                    pad_sign: List[int], part_pos: np.ndarray):
        """pad_bodies: builder indices of the tactile pads, in pad order."""
        self.gripper_cfg = dict(
            mode=mode, pad_bodies=pad_bodies, pad_part=pad_part,
            pad_sign=pad_sign, part_pos=np.asarray(part_pos, np.float64),
        )

    # ----------------------------------------------------------------- build

    def _layout(self):
        v, f = 0, 0
        for b in self.bodies:
            b.v_offset, b.f_offset = v, f
            v += b.n_verts
            f += b.n_faces
        return v, f

    def build(self) -> tuple[SceneSpec, SimState, Params]:
        NV, NF = self._layout()
        if self.cfg["solver"] == "auto":
            self.cfg["solver"] = (
                "dense" if 3 * NV <= self.DENSE_CUTOFF_DOF else "cg"
            )
        d = self.cfg["dtype"]
        nd = _np_dtype(d)

        pos0 = np.zeros((NV, 3), np.float64)
        mass = np.zeros((NV,), np.float64)
        gravity = np.zeros((NV, 3), np.float64)
        faces = np.zeros((NF, 3), np.int32)
        for b in self.bodies:
            pos0[b.v_offset : b.v_offset + b.n_verts] = b.init_pos
            faces[b.f_offset : b.f_offset + b.n_faces] = b.surfaces + b.v_offset
            if b.gravity_on:
                gravity[b.v_offset : b.v_offset + b.n_verts] = self.gravity
            if b.kind == "cloth":
                mass[b.v_offset : b.v_offset + b.n_verts] = b.rho * b.dx**2

        cloth = self._build_cloth_soup()
        neo = self._build_tet_soup("neo", pos0, mass)
        tact = self._build_tet_soup("tact", pos0, mass)
        contact = self._build_contact(pos0)
        gripper, gstate = self._build_gripper(pos0)

        frozen = np.zeros((NV, 3), bool)
        for fn in self.frozen_fns:
            fn(self, frozen)

        # pairs whose whole source-face vertex set is frozen: their contact
        # blocks reduce to the query vertex's diagonal block
        fr_all = frozen.all(axis=1)
        frozen_src = []
        for (src, _tgt, _mu, is_self) in self.pairs:
            sb = self.bodies[src]
            svids = np.unique(sb.surfaces) + sb.v_offset
            frozen_src.append(bool(fr_all[svids].all()) and not is_self)
        contact = dataclasses.replace(contact, frozen_src=tuple(frozen_src))

        spec = SceneSpec(
            hvp_slots=None,
            dia=None,
            mass=np.asarray(mass, nd),
            gravity=np.asarray(gravity, nd),
            ext_force=np.zeros((NV, 3), nd),
            frozen=frozen,
            faces=faces,
            cloth=cloth,
            neo=neo,
            tact=tact,
            contact=contact,
            gripper=gripper,
            NV=NV,
            n_bodies=len(self.bodies),
            body_v_start=tuple(b.v_offset for b in self.bodies),
            body_v_end=tuple(b.v_offset + b.n_verts for b in self.bodies),
            body_f_start=tuple(b.f_offset for b in self.bodies),
            body_f_end=tuple(b.f_offset + b.n_faces for b in self.bodies),
            dt=self.cfg["dt"],
            damping=self.cfg["damping"],
            k_contact=self.cfg["k_contact"],
            eps_contact=self.cfg["eps_contact"],
            eps_v=self.cfg["eps_v"],
            max_newton_iter=self.cfg["max_newton_iter"],
            # the reference's 1e-7 (|p|_inf / dt) is below f32 resolution
            newton_tol=(
                max(self.cfg["newton_tol"], 4e-6)
                if d == torch.float32 else self.cfg["newton_tol"]
            ),
            plastic=self.cfg["plastic"],
            grid_h=self.cfg["grid_h"],
            solver=self.cfg["solver"],
            cg_tol=1e-6 if d == torch.float32 else 1e-10,
            precond_smooth=3 if self.cfg["solver"] == "cg" else 0,
            hess_refresh=self.cfg["hess_refresh"],
            spmv=self.cfg["spmv"],
            # the JAX builder's environment overrides, read once here so
            # both packages build the same spec
            bend_batch=os.environ.get("TSL_BEND_BATCH", "0") == "1",
            bcr_cutoff=int(os.environ.get("TSL_BCR_CUTOFF", "4")),
            dtype=d,
        )

        if self.cfg["solver"] == "cg":
            raise NotImplementedError("the frozen builder holds the dense "
                                      "solver's scenes only")

        NH = cloth.hinge_verts.shape[0]
        C = contact.capacity
        state = SimState(
            pos=np.asarray(pos0, nd),
            vel=np.zeros((NV, 3), nd),
            ref_angle=np.zeros((NH,), nd),
            proj_flag=np.zeros((C,), np.int32),
            proj_dir=np.zeros((C,), np.int32),
            gripper=gstate,
        )

        n_neo = int(neo.group.max()) + 1 if neo.tets.shape[0] else 1
        n_tact = int(tact.group.max()) + 1 if tact.tets.shape[0] else 1
        neo_mu = np.zeros(n_neo)
        neo_lam = np.zeros(n_neo)
        tact_mu = np.zeros(n_tact)
        tact_lam = np.zeros(n_tact)
        for b in self.bodies:
            if b.kind == "neo":
                neo_mu[b.group] = b.E / (2 * (1 + b.nu))
                neo_lam[b.group] = b.E * b.nu / ((1 + b.nu) * (1 - 2 * b.nu))
            elif b.kind == "tact":
                tact_mu[b.group] = b.E / (2 * (1 + b.nu))
                tact_lam[b.group] = b.E * b.nu / ((1 + b.nu) * (1 - 2 * b.nu))
        cp = np.array(self.cloth_params or [(1000.0, 1000.0, 100.0)])
        params = Params(
            kl=np.asarray(cp[:, 0], nd),
            ka=np.asarray(cp[:, 1], nd),
            kb=np.asarray(cp[:, 2], nd),
            neo_mu=np.asarray(neo_mu, nd),
            neo_lam=np.asarray(neo_lam, nd),
            tact_mu=np.asarray(tact_mu, nd),
            tact_lam=np.asarray(tact_lam, nd),
            mu_pairs=np.asarray(np.array(self.mu_init or [0.0]), nd),
        )
        return spec, state, params

    # ------------------------------------------------------------- internals

    def _build_cloth_soup(self) -> ClothSoup:
        nd = _np_dtype(self.cfg["dtype"])
        cloths = [b for b in self.bodies if b.kind == "cloth"]
        if not cloths:
            return ClothSoup(
                f2v=np.zeros((0, 3), np.int32),
                cloth_id=np.zeros((0,), np.int32),
                l0=np.zeros((0, 3), nd),
                rest_area=np.zeros((0,), nd),
                hinge_verts=np.zeros((0, 4), np.int32),
                hinge_sel=np.zeros((0, 4, 4), nd),
                hinge_mask=np.zeros((0,), bool),
                hinge_coef=np.zeros((0,), nd),
                hinge_cloth=np.zeros((0,), np.int32),
                counter_face=np.zeros((0, 3), np.int32),
                counter_point=np.zeros((0, 3), np.int32),
            )
        f2v, cid, l0, area = [], [], [], []
        hv, hstencil, hmask, hcoef, hcloth = [], [], [], [], []
        cf_all, cp_all = [], []
        face_off = 0
        for ci, b in enumerate(cloths):
            m = b.cloth_mesh
            f2v.append(m.f2v + b.v_offset)
            cid.append(np.full(m.NF, ci, np.int32))
            l0.append(np.tile(np.array([b.dx, b.dx, b.dx * np.sqrt(2.0)]),
                              (m.NF, 1)))
            area.append(np.full(m.NF, b.dx**2 * 0.5))
            cf_all.append(np.where(m.counter_face >= 0, m.counter_face + face_off,
                                   m.counter_face))
            cp_all.append(m.counter_point)
            sv, st, sm = build_hinges(m, b.init_pos)
            hv.append(sv + b.v_offset)
            hstencil.append(st)
            hmask.append(sm)
            hcoef.append(np.full(m.NF * 3, b.dx**2 / 3.0))
            hcloth.append(np.full(m.NF * 3, ci, np.int32))
            face_off += m.NF
        return ClothSoup(
            f2v=np.concatenate(f2v).astype(np.int32),
            cloth_id=np.concatenate(cid),
            l0=np.concatenate(l0).astype(nd),
            rest_area=np.concatenate(area).astype(nd),
            hinge_verts=np.concatenate(hv).astype(np.int32),
            hinge_sel=_sel_from_stencils(np.concatenate(hstencil)).astype(nd),
            hinge_mask=np.concatenate(hmask),
            hinge_coef=np.concatenate(hcoef).astype(nd),
            hinge_cloth=np.concatenate(hcloth),
            counter_face=np.concatenate(cf_all).astype(np.int32),
            counter_point=np.concatenate(cp_all).astype(np.int32),
            n_cloths=len(cloths),
            NV_per=tuple(b.n_verts for b in cloths),
            N=tuple(b.cloth_mesh.N for b in cloths),
            M=tuple(b.cloth_mesh.M for b in cloths),
            offsets=tuple(b.v_offset for b in cloths),
            face_offsets=tuple(
                int(np.sum([c.n_faces for c in cloths[:i]]))
                for i in range(len(cloths))
            ),
            k_angle=tuple(b.k_angle for b in cloths),
            dx=tuple(b.dx for b in cloths),
        )

    def _build_tet_soup(self, kind, pos0, mass) -> TetSoup:
        nd = _np_dtype(self.cfg["dtype"])
        bodies = [b for b in self.bodies if b.kind == kind]
        if not bodies:
            return TetSoup(
                tets=np.zeros((0, 4), np.int32),
                B=np.zeros((0, 3, 3), nd),
                W=np.zeros((0,), nd),
                group=np.zeros((0,), np.int32),
            )
        tets, Bs, Ws, groups = [], [], [], []
        for b in bodies:
            t = b.tet_mesh.tets + b.v_offset
            x = pos0[t]  # (T, 4, 3)
            D = np.stack([x[:, i] - x[:, 3] for i in range(3)], axis=2)
            W = np.abs(np.linalg.det(D)) / 6.0
            tets.append(t)
            Bs.append(np.linalg.inv(D))
            Ws.append(W)
            groups.append(np.full(len(t), b.group, np.int32))
            # lumped mass (reference init_pos:240-245)
            for i in range(4):
                np.add.at(mass, t[:, i], W / 4.0 * b.density)
        return TetSoup(
            tets=np.concatenate(tets).astype(np.int32),
            B=np.concatenate(Bs).astype(nd),
            W=np.concatenate(Ws).astype(nd),
            group=np.concatenate(groups),
        )

    def _hash_desc_for(self, sb, pos0):
        """Static spatial-hash descriptor (Gx, Gy, Gz, cap) of a source
        body's faces, or None below 2048 faces: the rest extent in cells of
        2 grid_h plus 4 margin cells (run-time coordinates clamp into the
        grid), and a per-cell cap of 4x the rest occupancy rounded up to 8,
        with no upper clamp (an overflowing cell would drop candidates).
        The collision sweep takes the hash from hash_min_faces faces on."""
        if sb.n_faces < 2048:
            return None
        s = 2.0 * self.cfg["grid_h"]
        cent = pos0[sb.v_offset + sb.surfaces].mean(axis=1)
        lo, hi = cent.min(axis=0), cent.max(axis=0)
        G = np.clip(np.ceil((hi - lo) / s).astype(int) + 4, 4, 64)
        cell = np.clip(np.floor((cent - lo) / s).astype(int), 0, G - 1)
        cid = (cell[:, 0] * G[1] + cell[:, 1]) * G[2] + cell[:, 2]
        occ = int(np.bincount(cid).max())
        cap = int(max(16, -(-4 * occ // 8) * 8))
        return (int(G[0]), int(G[1]), int(G[2]), cap)

    def _build_contact(self, pos0) -> ContactSpec:
        cq_vert, cq_pair, cq_mu, cq_fs, cq_nf, cq_self = [], [], [], [], [], []
        pair_desc, hash_desc, src_vrange = [], [], []
        max_nf = 1
        cq_start = 0
        for pi, (src, tgt, mu_slot, is_self) in enumerate(self.pairs):
            sb, tb = self.bodies[src], self.bodies[tgt]
            verts = np.arange(tb.v_offset, tb.v_offset + tb.n_verts,
                              dtype=np.int32)
            pair_desc.append((cq_start, tb.n_verts, sb.f_offset, sb.n_faces,
                              bool(is_self)))
            src_vrange.append((int(sb.v_offset), int(sb.n_verts)))
            hash_desc.append(self._hash_desc_for(sb, pos0))
            cq_start += tb.n_verts
            cq_vert.append(verts)
            cq_pair.append(np.full(len(verts), pi, np.int32))
            cq_mu.append(np.full(len(verts), mu_slot, np.int32))
            cq_fs.append(np.full(len(verts), sb.f_offset, np.int32))
            cq_nf.append(np.full(len(verts), sb.n_faces, np.int32))
            cq_self.append(np.full(len(verts), is_self, bool))
            max_nf = max(max_nf, sb.n_faces)
        if not self.pairs:
            cq_vert = [np.zeros(1, np.int32)]
            cq_pair = [np.zeros(1, np.int32)]
            cq_mu = [np.zeros(1, np.int32)]
            cq_fs = [np.zeros(1, np.int32)]
            cq_nf = [np.zeros(1, np.int32)]
            cq_self = [np.zeros(1, bool)]
        cols = [np.concatenate(a) for a in
                (cq_vert, cq_pair, cq_mu, cq_fs, cq_nf, cq_self)]
        # pad capacity to a multiple of the query chunk (padded slots have
        # nf=0 so they never produce candidates)
        n = len(cols[0])
        chunk = min(512, max(64, 1 << (n - 1).bit_length() // 1))
        chunk = min(chunk, n) or 1
        pad = (-n) % chunk
        if pad:
            cols = [np.concatenate([c, np.zeros(pad, c.dtype)]) for c in cols]
        cq_vert, cq_pair, cq_mu, cq_fs, cq_nf, cq_self = cols
        return ContactSpec(
            cq_vert=cq_vert,
            cq_pair=cq_pair,
            cq_mu_id=cq_mu,
            cq_fstart=cq_fs,
            cq_nf=cq_nf,
            cq_self=cq_self,
            n_pairs=max(len(self.pairs), 1),
            capacity=len(cq_vert),
            max_src_faces=max_nf,
            top_k=self.contact_top_k,
            query_chunk=chunk,
            pair_desc=tuple(pair_desc),
            hash_desc=tuple(hash_desc),
            src_vrange=tuple(src_vrange),
            mm_budget=int(os.environ.get("TSL_CONTACT_MM", "8000000")),
        )

    def _build_gripper(self, pos0):
        nd = _np_dtype(self.cfg["dtype"])
        if self.gripper_cfg is None:
            spec = GripperSpec(
                bound_idx=np.zeros((0,), np.int32),
                pad_rest=np.zeros((0, 3), nd),
            )
            state = GripperState(
                pos=np.zeros((0, 3), nd),
                rot=np.zeros((0, 4), nd),
                dist=np.zeros((0,), nd),
                pad_local=np.zeros((0, 0, 3), nd),
            )
            return spec, state
        cfg = self.gripper_cfg
        pads = [self.bodies[i] for i in cfg["pad_bodies"]]
        mesh = pads[0].tet_mesh
        n_pad_verts = mesh.n_verts
        bound = mesh.bound_idx
        n_part = int(max(cfg["pad_part"])) + 1
        part_pos = cfg["part_pos"]
        pad_local = np.stack(
            [
                pos0[p.v_offset : p.v_offset + n_pad_verts]
                - part_pos[cfg["pad_part"][i]]
                for i, p in enumerate(pads)
            ]
        )
        spec = GripperSpec(
            bound_idx=np.asarray(bound, np.int32),
            pad_rest=np.asarray(mesh.rest_pos, nd),
            mode=cfg["mode"],
            n_part=n_part,
            n_pads=len(pads),
            pad_offset=tuple(p.v_offset for p in pads),
            pad_part=tuple(cfg["pad_part"]),
            pad_sign=tuple(cfg["pad_sign"]),
            pad_flip=tuple(False for _ in pads),
            n_pad_verts=n_pad_verts,
            n_bound=len(bound),
        )
        state = GripperState(
            pos=np.asarray(part_pos, nd),
            rot=np.asarray(np.tile(np.array([1.0, 0, 0, 0]), (n_part, 1)), nd),
            dist=np.zeros((n_part,), nd),
            pad_local=np.asarray(pad_local, nd),
        )
        return spec, state

    def vrange(self, body: int):
        b = self.bodies[body]
        return b.v_offset, b.v_offset + b.n_verts


def _sel_from_stencils(st: np.ndarray) -> np.ndarray:
    NH = st.shape[0]
    sel = np.zeros((NH, 4, 4))
    r = np.arange(NH)[:, None]
    sel[r, np.arange(4)[None, :], st] = 1.0
    return sel


def build_hinges(mesh: topology.ClothMesh, init_pos: np.ndarray):
    """Hinge soup of one cloth: stencils [v0,v1,v2,v3], the counter-face
    cycle order, and the signed-edge orientation that fixes the reference's
    angle-sign convention (see energies.hinge_angle). From the native
    helper, as in the JAX package; TSL_NO_NATIVE=1 takes
    build_hinges_numpy."""
    nat = native.build_hinges(mesh.f2v, mesh.counter_face,
                              mesh.counter_point, init_pos)
    return nat if nat is not None else build_hinges_numpy(mesh, init_pos)


def build_hinges_numpy(mesh: topology.ClothMesh, init_pos: np.ndarray):
    """The numpy version of native.build_hinges."""
    NF = mesh.NF
    NH = NF * 3
    hv = np.zeros((NH, 4), np.int32)
    # default stencil (1,2,1,2) is valid for the canonical configuration used
    # to evaluate masked-out hinges (see elements.bending_eval)
    st = np.tile(np.array([1, 2, 1, 2], np.int32), (NH, 1))
    mask = np.zeros((NH,), bool)
    f2v, cf, cp = mesh.f2v, mesh.counter_face, mesh.counter_point
    x = init_pos
    for i in range(NF):
        for l in range(3):
            h = i * 3 + l
            v0 = f2v[i, l]
            v1 = f2v[i, (l + 1) % 3]
            v2 = f2v[i, (l + 2) % 3]
            hv[h, :3] = (v0, v1, v2)
            j = cf[i, l]
            if not (j > i):
                continue
            p4 = cp[i, l]
            v3 = f2v[j, p4]
            hv[h, 3] = v3
            stencil_of = {v0: 0, v1: 1, v2: 2, v3: 3}
            ja_v = f2v[j, (p4 + 1) % 3]
            jb_v = f2v[j, (p4 + 2) % 3]
            if ja_v not in stencil_of or jb_v not in stencil_of:
                continue  # degenerate table entry
            ja, jb = stencil_of[ja_v], stencil_of[jb_v]
            # shared edge = the two stencil verts of face i also in face j
            shared = [s for s in (0, 1, 2)
                      if hv[h, s] in (ja_v, jb_v, v3) and hv[h, s] != v3]
            if len(shared) != 2:
                continue
            ea, eb = shared
            # reference sign edge: e = x[f2v[i][(l+1)%2]] - x[v0]
            sb_v = f2v[i, (l + 1) % 2]
            # orientation: need (e_hat x n1) . e_sign > 0
            n1 = np.cross(x[v1] - x[v0], x[v2] - x[v1])
            ehat = x[hv[h, eb]] - x[hv[h, ea]]
            e_sign = x[sb_v] - x[v0]
            if np.dot(np.cross(ehat, n1), e_sign) < 0:
                ea, eb = eb, ea
            st[h] = (ja, jb, ea, eb)
            mask[h] = True
    return hv, st, mask

"""TaskScene: a built scene plus its task definition (rewards, adjoint
loss seeds), the task API that CMA-ES and RL call (effector forces, the
early-stop test, observations, the force-loss seed) and the hinge-row
mask of the folding and pick rewards (counterpart of
`thinshelllab_tpu/scenes/base.py`).

The task API takes a scene moved to a device (`TaskScene.to`) and a
SimState of tensors on that device."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.spec import Params, SceneSpec, SimState
from ..engine import elements


def resolve_device(device=None, caller="thinshelllab_torch"):
    """`device`, or the CUDA card when it is None; no card raises: the CPU
    is taken only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA card; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class TaskScene:
    name: str
    spec: SceneSpec
    state0: SimState
    params: Params
    n_part: int
    # reward(name) -> fn(buffers) -> scalar; 'default' is the task reward
    rewards: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    # seed_loss(buffers) -> (pos_grad (T,NV,3), angleref_grad (T,NH))
    seed_loss: Optional[Callable] = None
    seed_losses: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    sys_param: Optional[str] = None
    max_moving_dist: float = 0.001
    builder: object = None

    def reward(self, buffers, name: str = "default"):
        return self.rewards[name](buffers)

    def seed_for(self, name: str = "default"):
        return self.seed_losses.get(name, self.seed_loss)

    def to(self, device=None, dtype=None):
        """(spec, state0, params) moved to `device` in one call. The default
        is the CUDA card, and no card raises: the CPU is taken only when the
        caller asks for it (`to("cpu")`)."""
        device = resolve_device(device, "TaskScene.to")
        dtype = self.spec.dtype if dtype is None else dtype
        return (self.spec.to(device, dtype), self.state0.to(device, dtype),
                self.params.to(device, dtype))


def _bound_forces(spec: SceneSpec, params: Params, pos, with_external):
    """Net force on each effector part's driven boundary, (n_part, 3): the
    tactile soup's -dE/dx (plus gravity and the external force with
    `with_external`) summed over every pad's bound vertices."""
    g = spec.gripper
    _, grp = elements.tact_eval(spec, params, pos, False, False)
    force = torch.zeros_like(pos).index_add(0, grp["idx"].reshape(-1),
                                            -grp["g"].reshape(-1, 3))
    if with_external:
        force = force + spec.mass[:, None] * spec.gravity + spec.ext_force
    out = [pos.new_zeros(3) for _ in range(g.n_part)]
    for p in range(g.n_pads):
        gidx = g.pad_offset[p] + g.bound_idx
        out[g.pad_part[p]] = out[g.pad_part[p]] + torch.sum(force[gidx],
                                                            dim=0)
    return torch.stack(out)


def effector_total_forces(spec: SceneSpec, params: Params, state: SimState):
    """Net internal force on each effector part's driven boundary
    (reference BaseScene.gather_force:1541-1549 over elastics' get_force):
    the tactile soup's -dE/dx plus gravity and the external force, summed
    over `pad_offset + bound_idx` per part. Returns (n_part, 3)."""
    if spec.gripper.mode == "none":
        return state.pos.new_zeros((0, 3))
    return _bound_forces(spec, params, state.pos, True)


def check_early_stop(spec, params, state, frame, rl=False):
    """Reference BaseScene.check_early_stop:1559-1584: NaN positions, any
    effector force component > 10 N, or (trajopt mode) contact lost after
    frame 10. Returns a 0-dim bool tensor."""
    nan = torch.any(torch.isnan(state.pos))
    f = effector_total_forces(spec, params, state)
    too_much = torch.any(torch.abs(f) > 10.0)
    norm = torch.linalg.vector_norm(f, dim=1)
    lost = torch.any(norm < 0.2) & (frame > 10) & (not rl)
    return nan | too_much | lost


def _observation_ids(spec: SceneSpec, n_obs_cloth=4, n_obs_elastic=16):
    """The vertex ids `observation` samples, in its order."""
    ids = []
    c = spec.cloth
    for ci in range(c.n_cloths):
        N, M = c.N[ci], c.M[ci]
        off = c.offsets[ci]
        n_s = N // 4
        m_s = M // 4
        for j in range(n_obs_cloth):
            for k in range(n_obs_cloth):
                jj = n_s // 2 + j * n_s
                kk = m_s // 2 + k * m_s
                # reference parity: BaseScene:1593 indexes jj*cloth_N + kk
                # with cloth_N = N, NOT the (M+1) row stride its own mesh
                # uses -- a skewed but deterministic sample set that RL
                # policies were trained on; reproduced verbatim, clamped
                # into the cloth as the JAX package does (ROADMAP.md §3)
                ids.append(off + min(jj * N + kk, (N + 1) * (M + 1) - 1))
    for b in range(spec.n_bodies):
        vs, ve = spec.body_v_start[b], spec.body_v_end[b]
        if any(off == vs for off in c.offsets):
            continue  # cloth body
        nv = ve - vs
        for j in range(n_obs_elastic):
            # j = 0 reads vertex vs - 1 (the previous body's last, or the
            # scene's last), as the reference does
            ids.append((vs + (nv // n_obs_elastic) * j - 1) % spec.NV)
    return ids


def observation(spec: SceneSpec, state: SimState, n_obs_cloth=4,
                n_obs_elastic=16):
    """Subsampled cloth pos/vel + elastic samples + gripper poses
    (reference BaseScene.get_observation_kernel:1586-1619): each sampled
    vertex's position then velocity, then every part's position and
    quaternion."""
    ids = _observation_ids(spec, n_obs_cloth, n_obs_elastic)
    pos = state.pos
    if ids:
        idx = torch.as_tensor(ids, dtype=torch.int64, device=pos.device)
        flat = torch.stack([pos[idx], state.vel[idx]], dim=1).reshape(-1)
    else:
        flat = pos.new_zeros((0,))
    if spec.gripper.mode != "none":
        g = state.gripper
        flat = torch.cat([flat, torch.cat([g.pos, g.rot], dim=1).reshape(-1)])
    return flat


def force_loss_pos_grad(spec: SceneSpec, params: Params, pos, grad_force):
    """dL/dpos for a loss seeded on the effector boundary force
    (generalizes the reference's tactile compute_force_deri,
    model_elastic_tactile.py:373-414, via one AD vjp): grad_force is
    (n_part, 3) = dL/d(total bound force per part)."""
    p = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        out = _bound_forces(spec, params, p, False)
        (pg,) = torch.autograd.grad(
            out, p, torch.as_tensor(grad_force, dtype=pos.dtype,
                                    device=pos.device))
    return pg


def with_pre_curl_ref_angle(spec, state0):
    """state0 with the plastic rest angles its pre-curled cloth yields at
    build (init_fold -> init_ref_angle, model_fold_offset.py:1053-1057),
    computed in the scene's dtype from the builder's arrays, as the JAX
    package does."""
    from ..engine.stepper import update_ref_angle

    ref0 = update_ref_angle(spec.replace(cloth=spec.cloth.to("cpu",
                                                             spec.dtype)),
                            torch.as_tensor(state0.pos),
                            torch.as_tensor(state0.ref_angle))
    return state0.replace(ref_angle=ref0.numpy())


def like(a, ref):
    """`a` (a host array or list) as a tensor with `ref`'s dtype and
    device: the scenes' masks and targets meet the buffers this way."""
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def hinge_row_mask(builder, cloth_body, row_v0, row_v3):
    """Mask over the hinge soup selecting hinges whose v0 lies in grid row
    `row_v0` and whose v3 lies in row `row_v3` of the given cloth (the
    folding reward; reference Scene_folding.compute_reward:130-147)."""
    m = builder.bodies[cloth_body].cloth_mesh
    Mp1 = m.M + 1
    mask = np.zeros(m.NF * 3, bool)
    for i in range(m.NF):
        for l_ in range(3):
            if m.counter_face[i, l_] > i:
                v0 = m.f2v[i, l_]
                v3 = m.f2v[m.counter_face[i, l_], m.counter_point[i, l_]]
                if v0 // Mp1 == row_v0 and v3 // Mp1 == row_v3:
                    mask[i * 3 + l_] = True
    return mask

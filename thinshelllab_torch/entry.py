"""Entry points (counterpart of the repository's `__graft_entry__.py`).

entry(device=None) -> (fn, args): one implicit time step of the folding
scene in float32 (dense solve, table_n=4, 3 Newton iterations);
`fn(state, action)` returns the new positions. It runs on the CUDA card
unless the caller asks for the CPU.

dryrun_multichip(n, device=None): launches n ranks (`parallel.mesh.launch`:
one card each over NCCL, or gloo ranks on the CPU with device="cpu") and
runs ONE full distributed training step on each of two small scenes, one
env per rank, T=2: the dense folding scene, then the production iterative
path (the bench scene at cloth_N=8 under cg, with an active DIA plan and
grid plan, so the forward CG and the GMRES/BCR adjoint launch both DIA
kernels on the card). On the card more ranks than cards raises; nothing
falls back to the CPU.

    python -m thinshelllab_torch.entry    # entry() on the card
    python -c "from thinshelllab_torch.entry import dryrun_multichip; \
dryrun_multichip(4)"
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import gridsolve, stepper
from .ops import dia_spmv
from .parallel import mesh as pmesh
from .parallel.programs import as_tensors
from .scenes import bench_scene, folding
from .scenes.base import resolve_device

T_DRYRUN = 2


def _small_scene(dtype, max_newton_iter=3, table_n=4):
    return folding.make(dtype=dtype, solver="dense", table_n=table_n,
                        max_newton_iter=max_newton_iter)


def entry(device=None):
    """(fn, (state0, action)): one float32 time step of the small folding
    scene with a zero action, on `device` (default the card)."""
    device = resolve_device(device, "entry")
    sc = _small_scene(torch.float32)
    spec, s0, params = sc.to(device)

    def fn(state, action):
        new_state, _aux = stepper.time_step(spec, params, state, action)
        return new_state.pos

    action = (torch.zeros((sc.n_part, 3), dtype=torch.float32, device=device),
              torch.zeros((sc.n_part, 3), dtype=torch.float32, device=device),
              torch.zeros((sc.n_part,), dtype=torch.float32, device=device))
    return fn, (s0, action)


def _run_sharded_step(mesh, sc, tag):
    """One sharded train step of `sc`, one env per rank, T=2, with the
    JAX entry's seeded actions; returns the loss proxy."""
    spec, s0, params = sc.to(mesh.device)
    B, T = mesh.size, T_DRYRUN
    rng = np.random.default_rng(0)
    actions = (rng.normal(size=(B, T, sc.n_part, 3)) * 1e-4,
               np.zeros((B, T, sc.n_part, 3)), np.zeros((B, T, sc.n_part)))
    traj = torch.zeros((T + 1, sc.n_part, 6), dtype=spec.dtype,
                       device=mesh.device)
    new_traj, loss = pmesh.sharded_train_step(
        mesh, spec, params, s0, sc.seed_loss,
        as_tensors(actions, spec, mesh.device), traj)
    if not (bool(torch.isfinite(loss)) and bool(
            torch.isfinite(new_traj).all())):
        raise RuntimeError(f"dryrun_multichip[{tag}]: loss {float(loss)}")
    if mesh.rank == 0:
        print(f"dryrun_multichip[{tag}] ok: loss proxy {float(loss):.4f}",
              flush=True)
    return float(loss)


def _dryrun_rank(mesh):
    """Both sharded steps on this rank: {"dense", "cg-dia"} loss proxies
    and the DIA kernel launches of the cg step."""
    out = {"dense": _run_sharded_step(
        mesh, _small_scene(torch.float32, max_newton_iter=2), "dense")}
    sc = bench_scene.make(cloth_N=8, table_n=4, dtype=torch.float32,
                          solver="cg", max_newton_iter=2, cg_max_iter=40,
                          cg_tol=1e-5)
    if sc.spec.dia is None:
        raise RuntimeError("DIA plan inactive on the CG dryrun")
    if not gridsolve.build_grid_plan(sc.spec):
        raise RuntimeError("grid plan inactive: the adjoint would not take "
                           "the GMRES/BCR path")
    dia_spmv.reset_launches()
    out["cg-dia"] = _run_sharded_step(mesh, sc, "cg-dia")
    out["launches"] = dict(dia_spmv.LAUNCHES)
    return out


def dryrun_multichip(n_devices: int, device=None,
                     timeout=pmesh.DEFAULT_LAUNCH_TIMEOUT):
    """One distributed training step on n_devices ranks, dense and cg;
    returns rank 0's {"dense", "cg-dia", "launches"}."""
    out = pmesh.launch(_dryrun_rank, n_devices, device, timeout=timeout)
    print(f"dryrun_multichip({n_devices}) ok", flush=True)
    return out


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok", tuple(out.shape), out.dtype)

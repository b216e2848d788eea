"""Multi-environment batching and scale-out over cards (counterpart of
`thinshelllab_tpu/parallel/mesh.py`).

The JAX package runs one controller over a 1-D device mesh: `vmap` batches
the rollouts and `shard_map` splits the batch over the chips, with psum
and pmean as the collectives. PyTorch's idiom is one process per card
under `torch.distributed`, so the port runs the same data-parallel program
as SPMD ranks:

  * every rank builds the same scene and holds the same full batch;
  * rank r takes the contiguous block [r*B/n, (r+1)*B/n) of the leading
    axis, the block `P(axis)` gives device r, so members keep JAX's order;
  * results come back through collectives: NCCL on the card, gloo on the
    CPU (only when the caller asks for `device="cpu"`).

`launch(fn, n)` spawns n ranks on this host, each calling `fn(mesh,
*args)`; under `torchrun` (or any launcher that sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT) `make_mesh` joins that group.
Outside any launch, `make_mesh(1)` makes a world of one of its own.

`batched_rollout` and `batched_rollout_rewards` (the `vmap` counterparts)
run their members one after another on one device and stack what `vmap`
stacks; a true batch dimension through the engine is perf work (ROADMAP.md
queue 1, item 1).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..core.spec import _Struct
from ..engine import adjoint, stepper

# the file store of the launch that spawned this rank (set by `launch`)
_STORE_ENV = "TSL_MESH_STORE"
DEFAULT_LAUNCH_TIMEOUT = 120.0


@dataclasses.dataclass
class Mesh:
    """This rank's view of a 1-D mesh: its axis name, the number of ranks,
    this rank's index and device, and the process group of the
    collectives."""

    axis_names: tuple = ("env",)
    size: int = 1
    rank: int = 0
    device: torch.device = None
    group: object = None
    # the temporary store of a world of one made by make_mesh itself; the
    # group is destroyed by close() only where make_mesh created it
    _owned: bool = False
    _store_dir: str = None

    def close(self):
        """Leave the process group, where make_mesh joined it."""
        if self._owned and dist.is_initialized():
            dist.destroy_process_group()
        self._owned = False
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def _mesh_device(n_devices, device):
    """(backend, device type) for a mesh of n_devices ranks: NCCL on the
    card unless the CPU is asked for; a missing card or NCCL, or too few
    cards, raises."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cpu":
        return "gloo", "cpu"
    if kind != "cuda":
        raise ValueError(f"make_mesh: device {device!r}: a mesh runs on "
                         "CUDA cards (NCCL) or, when asked, the CPU (gloo)")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA card; pass device='cpu' for a "
                           "gloo mesh on the CPU")
    if not dist.is_nccl_available():
        raise RuntimeError("make_mesh: this torch has no NCCL backend")
    if n_devices is not None and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"make_mesh: {n_devices} cards asked for, "
                           f"{torch.cuda.device_count()} on this machine")
    return "nccl", "cuda"


def make_mesh(n_devices: int | None = None, axis: str = "env",
              device=None) -> Mesh:
    """Join the process group of the running launch as a 1-D mesh named
    `axis`: NCCL on `cuda:<LOCAL_RANK>`, or gloo on the CPU when
    `device="cpu"`. `n_devices` must equal the world size (None takes the
    launch's). Outside any launch a world of one is made, with a file
    store in a temporary directory; `Mesh.close()` leaves it."""
    backend, kind = _mesh_device(n_devices, device)
    env = os.environ
    joined = dist.is_initialized()
    store_dir = None
    if joined:
        rank, world = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"make_mesh: the running process group is "
                f"{dist.get_backend()}, a {kind} mesh needs {backend}")
    elif _STORE_ENV in env or "MASTER_ADDR" in env:
        init = env.get(_STORE_ENV, "env://")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        init, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the launch has {world} "
                         "rank(s)")
    local = int(env.get("LOCAL_RANK", rank))
    if kind == "cuda":
        torch.cuda.set_device(local)
    if not joined:
        if init is None:
            store_dir = tempfile.mkdtemp(prefix="tsl_mesh_")
            init = "file://" + os.path.join(store_dir, "store")
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(minutes=10))
    dev = torch.device("cuda", local) if kind == "cuda" else torch.device(
        "cpu")
    return Mesh(axis_names=(axis,), size=world, rank=rank, device=dev,
                group=dist.group.WORLD, _owned=not joined,
                _store_dir=store_dir)


def _to_host(obj):
    """obj with every tensor moved to the CPU (tuples, lists and dicts
    walked), so that it pickles without CUDA."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, n, device, store, fn, args, out):
    """One spawned rank: join the launch's group, run fn(mesh, *args), and
    send (rank, ok, pickled result of rank 0 or the traceback)."""
    os.environ.update({_STORE_ENV: store, "RANK": str(rank),
                       "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank)})
    mesh = None
    try:
        mesh = make_mesh(n, device=device)
        res = fn(mesh, *args)
        out.put((rank, True, pickle.dumps(_to_host(res)) if rank == 0
                 else None))
    except Exception:  # reported to the launch, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if mesh is not None:
            mesh.close()


def launch(fn, n_devices: int, device=None, *args,
           timeout: float = DEFAULT_LAUNCH_TIMEOUT):
    """Run fn(mesh, *args) on n_devices spawned ranks (one card each, or
    gloo ranks on the CPU with device="cpu") and return rank 0's result,
    its tensors on the CPU. `fn` is pickled by its qualified name, so it
    must be a module-level function of an importable module. Each launch
    has its own file store in a temporary directory. A rank that raises
    makes the launch raise with that rank's traceback; at `timeout`
    seconds every rank is killed and the launch raises TimeoutError."""
    _mesh_device(n_devices, device)  # no card or too few raises here
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tsl_launch_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_devices, device, store, fn, args,
                                   out))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        grace = 0.0  # a failed or late launch kills its ranks at once
        try:
            result = _collect(procs, out, n_devices, timeout)
            grace = 10.0  # every rank reported: let each leave its group
            return result
        finally:
            for p in procs:
                p.join(grace)
                if p.is_alive():
                    p.kill()
                    p.join(10)


def _collect(procs, out, n, timeout):
    """Rank 0's result once every rank has reported; raises on a failed,
    vanished or late rank."""
    deadline = time.monotonic() + timeout
    done, result = set(), None
    while len(done) < n:
        try:
            rank, ok, payload = out.get(timeout=0.2)
        except queue.Empty:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"launch: ranks {sorted(set(range(n)) - done)} did not "
                    f"finish within {timeout:.0f} s; every rank was killed")
            gone = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if gone:
                try:  # a rank's last message may still be in the pipe
                    rank, ok, payload = out.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"launch: rank {gone[0]} exited with code "
                        f"{procs[gone[0]].exitcode} without a result"
                    ) from None
            else:
                continue
        if not ok:
            raise RuntimeError(f"launch: rank {rank} raised:\n{payload}")
        done.add(rank)
        if rank == 0:
            result = pickle.loads(payload)
    return result


def block(mesh: Mesh, B: int):
    """This rank's contiguous block [lo, hi) of a leading axis of B, as
    P(axis) splits it; B must be a multiple of the mesh size."""
    if B % mesh.size:
        raise ValueError(f"a batch of {B} does not split over a mesh of "
                         f"{mesh.size}")
    b = B // mesh.size
    return mesh.rank * b, (mesh.rank + 1) * b


def all_gather_blocks(mesh: Mesh, local):
    """Every rank's block of a leading axis, concatenated in rank order,
    on every rank (on the mesh's device)."""
    local = local.to(mesh.device).contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def pmean(mesh: Mesh, x):
    """The mean of x over the ranks (JAX's `pmean`), on every rank."""
    x = x.to(mesh.device).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x / mesh.size


def _stack(items):
    """Stack a list of like structures (tensors, tuples, the package's
    dataclasses) on a new leading axis, as vmap stacks its outputs."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, _Struct):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_stack(list(parts)) for parts in zip(*items))
    raise TypeError(f"cannot stack {type(first).__name__}")


def _member(batched_actions, b):
    return tuple(a[b] for a in batched_actions)


def batched_rollout(spec, params, state0, batched_actions):
    """A full rollout of each member of a leading batch axis of the
    actions, from one initial state and params: (final state, per-step
    tape), each leaf stacked on a leading axis of B as JAX's vmap of
    stepper.rollout returns them (the tape a tuple of (B, T, ...))."""
    finals, tapes = [], []
    for b in range(batched_actions[0].shape[0]):
        final, saved = stepper.rollout(spec, params, state0,
                                       _member(batched_actions, b))
        finals.append(final)
        tapes.append(_stack(saved))
    return _stack(finals), _stack(tapes)


def batched_rollout_rewards(spec, params, state0, batched_actions,
                            reward_fn):
    """CMA-ES style: the (B,) rewards of a population of trajectories, each
    member simulated in turn."""
    return torch.stack([
        reward_fn(stepper.simulate(spec, params, state0,
                                   _member(batched_actions, b))[1])
        for b in range(batched_actions[0].shape[0])])


def sharded_population_rewards(mesh: Mesh, spec, params, state0,
                               batched_actions, reward_fn):
    """Population evaluation sharded over the mesh (B a multiple of the
    mesh size): each rank evaluates its block, and the rewards are
    all-gathered in rank order so every rank holds all B of them."""
    lo, hi = block(mesh, batched_actions[0].shape[0])
    local = batched_rollout_rewards(
        spec, params, state0, tuple(a[lo:hi] for a in batched_actions),
        reward_fn)
    return all_gather_blocks(mesh, local)


def sharded_train_step(mesh: Mesh, spec, params, state0, seed_fn,
                       batched_actions, traj, lr=1e-3):
    """One distributed trajectory-optimisation step: each rank rolls out
    its block of perturbed trajectories and runs the adjoint; the mean
    gripper gradient (pmean over the ranks) updates the shared waypoint
    table. The loss proxy is JAX's: sum(last_pos**2) over the rank's
    members, averaged over the ranks. Returns (new_traj, loss_proxy), the
    same on every rank."""
    lo, hi = block(mesh, batched_actions[0].shape[0])
    grads, last = [], []
    for b in range(lo, hi):
        _, buffers = stepper.simulate(spec, params, state0,
                                      _member(batched_actions, b))
        seed_pos, seed_ar = seed_fn(buffers)
        res = adjoint.backward(spec, params, buffers, seed_pos, seed_ar)
        grads.append(res.gripper_grad)
        last.append(buffers["pos"][-1])
    g_mean = pmean(mesh, torch.stack(grads).mean(dim=0))
    new_traj = traj.to(mesh.device) - lr * g_mean
    loss_proxy = pmean(mesh, torch.sum(torch.stack(last) ** 2))
    return new_traj, loss_proxy

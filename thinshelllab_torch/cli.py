"""Command-line driver (counterpart of `thinshelllab_tpu/cli.py`; reference
training/*.py + code/scripts/*.sh). The port has the `trajopt` and `dp`
subcommands:

  python -m thinshelllab_torch.cli trajopt --env folding --iter 10 --tot_step 50
  python -m thinshelllab_torch.cli dp      --env bouncing --iter 20 --lr 10

Both run on the CUDA card (`--platform gpu`, the default; no card raises)
with the JAX CLI's accelerator defaults: solver 'auto' (dense below 6000
DOF, CG above) and float32 unless --f64. `--solver cg` takes the iterative
path on any scene: CG on the DIA plan with the CUDA kernels and the
GMRES adjoint where the cloth is wide enough for a plan, CG on the pull
operator and the MINRES adjoint where it is not (folding). `--platform cpu`
takes the JAX CLI's CPU defaults: the dense solver and the scene's own
dtype (float64) unless --f32. The other subcommands (cmaes, rl, render,
bench) are not ported yet.
"""
from __future__ import annotations

import argparse
import os

import torch


def _add_common(p):
    p.add_argument("--platform", type=str, default="gpu",
                   choices=("gpu", "cpu"),
                   help="where the scene runs: the CUDA card (default; "
                        "raises without one) or the CPU")
    p.add_argument("--env", type=str, default="folding")
    p.add_argument("--tot_step", type=int, default=50)
    p.add_argument("--Kb", type=float, default=None)
    p.add_argument("--mu", type=float, default=None)
    p.add_argument("--dense", type=float, default=None,
                   help="box density of the interact scene (reference "
                        "run_cmaes_separate_soft.sh --dense)")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--solver", type=str, default=None,
                   help="dense|cg|auto (default: auto on the card -- dense "
                        "below 6000 DOF, cg above; dense on the CPU). cg: "
                        "CG on the DIA plan (the CUDA kernels) and the "
                        "GMRES adjoint, or on a cloth too narrow for a plan "
                        "CG on the pull operator and the MINRES adjoint")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--max_newton_iter", type=int, default=None)


def _device(args):
    if args.platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: no CUDA card; pass --platform "
                           "cpu to run on the CPU")
    return torch.device("cuda")


def _make_scene(args, device):
    from .scenes import registry

    on_card = device.type == "cuda"
    kwargs = {}
    if args.Kb is not None:
        kwargs["kb"] = args.Kb
    if args.mu is not None:
        kwargs["mu_cloth_elastic"] = args.mu
    if args.dense is not None:
        kwargs["dense"] = args.dense
    if args.max_newton_iter is not None:
        kwargs["max_newton_iter"] = args.max_newton_iter
    kwargs["solver"] = args.solver or ("auto" if on_card else "dense")
    if args.f32 or (on_card and not args.f64):
        kwargs["dtype"] = torch.float32
    return registry.make_scene(args.env, **kwargs)


def _default_load_state(args):
    """Balancing/throwing default to the bundled pre-grasped state, like the
    reference's `--load_state ../data/balance_state` default
    (trajopt_balancing.py:23). Pass --load_state none to start cold."""
    ls = args.load_state
    if ls and ls.lower() == "none":
        return None
    if ls is None and args.env in ("balancing", "balance", "throwing"):
        from .scenes.balancing import bundled_state_path

        p = bundled_state_path()
        return p if os.path.exists(p) else None
    return ls


def _load_scene_state(scene, path, device):
    """Full-state warm start (reference Scene_balancing.load_all:202-222):
    float leaves in the scene's dtype, on the run's device."""
    from .utils import checkpoint

    scene.state0 = checkpoint.load_state(path, scene.spec.dtype, device)


def _init_traj(agent, name):
    fn = getattr(agent, f"init_traj_{name}", None)
    if fn is None:
        raise KeyError(f"unknown --init_traj '{name}'; "
                       "available: forming, pick_fold, card, slide")
    fn()


def cmd_trajopt(args):
    from .train.trajopt import TrajOptDriver

    if args.render_every:
        raise NotImplementedError("--render_every: rendering is not ported "
                                  "yet (ROADMAP queue item 7)")
    device = _device(args)
    scene = _make_scene(args, device)
    ls = _default_load_state(args)
    if ls:
        _load_scene_state(scene, ls, device)
    save_dir = args.save_dir or f"imgs/traj_opt_{args.env}"
    drv = TrajOptDriver(scene, args.tot_step, lr=args.lr,
                        max_dist=args.max_dist, save_dir=save_dir,
                        reward_name=args.reward_name or "default",
                        fwd_chunk=args.fwd_chunk or None, device=device)
    if args.load_traj:
        drv.agent.load(args.load_traj)
    if args.init_traj:
        _init_traj(drv.agent, args.init_traj)
    for i in range(args.iter):
        info = drv.iteration()
        print(f"iter {i}: reward {info['reward']:.6f} "
              f"|g| {info['grad_norm']:.4g} t {info['wall_time']:.2f}s",
              flush=True)
    print("best reward:", drv.best_reward)


def cmd_dp(args):
    from .agent.traj_opt import TrajAgent
    from .train.dp import ParamCMAESDriver, ParamOptDriver, _get_param

    device = _device(args)
    scene = _make_scene(args, device)
    T = args.tot_step
    n = scene.n_part
    if args.load_traj or args.init_traj:
        agent = TrajAgent(T, n, device=device)
        if args.load_traj:
            agent.load(args.load_traj)
        else:
            # fixed warm-start trajectory while the parameter is optimized
            # (reference run_cmaes_parameter.py --traj init_traj_slide)
            _init_traj(agent, args.init_traj)
        actions = agent.actions()
    else:
        actions = tuple(torch.zeros(shape, dtype=torch.float64, device=device)
                        for shape in ((T - 1, n, 3), (T - 1, n, 3),
                                      (T - 1, n)))
    if args.method == "cmaes":
        # gradient-free system ID (reference run_cmaes_parameter.py)
        base = float(_get_param(scene.params, scene.sys_param))
        drv = ParamCMAESDriver(scene, actions, base_value=base,
                               scale=args.cmaes_scale, pop_size=args.pop_size,
                               sigma=args.sigma, device=device)
        for i in range(args.iter):
            info = drv.generation()
            print(f"gen {i}: best_param {info['best_param']:.4f} "
                  f"best_reward {info['best_reward']:.5f}", flush=True)
        return
    drv = ParamOptDriver(scene, actions, lr=args.lr, device=device)
    for i in range(args.iter):
        info = drv.iteration()
        print(f"iter {i}: reward {info['reward']:.5f} "
              f"param {info['param']:.4f} grad {info['grad']:.3g}", flush=True)


def build_parser():
    ap = argparse.ArgumentParser("thinshelllab_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("trajopt")
    _add_common(p)
    p.add_argument("--iter", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_dist", type=float, default=0.015)
    p.add_argument("--reward_name", type=str, default=None,
                   help="objective variant; selects the matching adjoint "
                        "seed when the scene defines one")
    p.add_argument("--load_traj", type=str, default=None)
    p.add_argument("--init_traj", type=str, default=None,
                   help="warm start: forming|pick_fold|card|slide "
                        "(reference traj_opt_single.py:50-109)")
    p.add_argument("--load_state", type=str, default=None,
                   help="npz full-state warm start (reference "
                        "Scene_balancing.load_all / data/balance_state); "
                        "balancing/balance/throwing default to the bundled "
                        "pre-grasped state, 'none' starts cold")
    p.add_argument("--render_every", type=int, default=0,
                   help="render every n iterations (not ported yet)")
    p.add_argument("--render_option", type=str, default="Preview")
    p.add_argument("--fwd_chunk", type=int, default=0,
                   help="the JAX package's rollout segments of this many "
                        "steps (0: none); the port's rollout is one host "
                        "loop either way")
    p.set_defaults(fn=cmd_trajopt)

    p = sub.add_parser("dp")
    _add_common(p)
    p.add_argument("--iter", type=int, default=10)
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--load_traj", type=str, default=None)
    p.add_argument("--init_traj", type=str, default=None,
                   help="fixed warm-start trajectory during system ID "
                        "(reference run_cmaes_parameter.py --traj)")
    p.add_argument("--method", type=str, default="grad",
                   choices=["grad", "cmaes"],
                   help="'grad': adjoint descent; 'cmaes': gradient-free "
                        "(reference run_cmaes_parameter.py)")
    p.add_argument("--pop_size", type=int, default=8)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--cmaes_scale", type=float, default=1.0,
                   help="parameter = base + sample * scale")
    p.set_defaults(fn=cmd_dp)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

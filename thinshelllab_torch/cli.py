"""Command-line driver (counterpart of `thinshelllab_tpu/cli.py`; reference
training/*.py + code/scripts/*.sh). The port has the `trajopt`, `cmaes`,
`dp` and `rl` subcommands:

  python -m thinshelllab_torch.cli trajopt --env folding --iter 10 --tot_step 50
  python -m thinshelllab_torch.cli cmaes   --env lifting --pop_size 8 --iter 15
  python -m thinshelllab_torch.cli dp      --env bouncing --iter 20 --lr 10
  python -m thinshelllab_torch.cli rl      --env folding --timesteps 100000
  python -m thinshelllab_torch.cli render  --env folding --frames 20

All run on the CUDA card (`--platform gpu`, the default; no card raises)
with the JAX CLI's accelerator defaults: solver 'auto' (dense below 6000
DOF, CG above) and float32 unless --f64. `--solver cg` takes the iterative
path on any scene: CG on the DIA plan with the CUDA kernels and the
GMRES adjoint where the cloth is wide enough for a plan, CG on the pull
operator and the MINRES adjoint where it is not (folding). `--platform cpu`
takes the JAX CLI's CPU defaults: the dense solver and the scene's own
dtype (float64) unless --f32. `render` (and `trajopt --render_every`)
simulates on the run's device and draws each frame there (`render/`:
PNG frames and a GIF, or LuisaRender scripts with OBJ files). The
`bench` subcommand waits for the port's benchmark.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
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
    from .render.engine import Renderer
    from .train.trajopt import TrajOptDriver

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
    renderer = Renderer(scene, args.env, option=args.render_option,
                        save_dir=save_dir) if args.render_every else None
    for i in range(args.iter):
        info = drv.iteration()
        print(f"iter {i}: reward {info['reward']:.6f} "
              f"|g| {info['grad_norm']:.4g} t {info['wall_time']:.2f}s",
              flush=True)
        if renderer and i % args.render_every == 0:
            _render_rollout(drv.spec, drv.params, drv.state0,
                            drv.agent.actions(), renderer, tag=i)
    print("best reward:", drv.best_reward)


def _render_rollout(spec, params, state0, actions, renderer, tag=0):
    """Simulate the actions from state0 on the scene's device and render
    every frame of the tape (frame t = the state after step t)."""
    from .engine import stepper

    _, buffers = stepper.simulate(spec, params, state0, actions)
    pos = buffers["pos"]
    for t in range(pos.shape[0]):
        renderer.render(str(t), pos=pos[t])
    return renderer.end_rendering(tag)


def cmd_render(args):
    """A rollout of `--frames` steps with the grippers still, rendered
    frame by frame (JAX cli.cmd_render)."""
    from .render.engine import Renderer

    device = _device(args)
    scene = _make_scene(args, device)
    renderer = Renderer(scene, args.env, option=args.render_option,
                        save_dir=args.save_dir or f"imgs/{args.env}")
    T, n = args.frames, scene.n_part
    actions = tuple(torch.zeros(shape, dtype=torch.float64, device=device)
                    for shape in ((T, n, 3), (T, n, 3), (T, n)))
    spec, state0, params = scene.to(device)
    _render_rollout(spec, params, state0, actions, renderer)


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


def cmd_cmaes(args):
    from .train.cmaes import CMAESDriver
    from .utils.plotting import save_reward_curve

    device = _device(args)
    scene = _make_scene(args, device)
    ls = _default_load_state(args)
    if ls:
        _load_scene_state(scene, ls, device)
    skip = 5 if args.env == "interact" else 0
    drv = CMAESDriver(scene, args.tot_step, args.abs_step,
                      pop_size=args.pop_size, sigma=args.sigma,
                      max_dist=args.max_dist, skip_first=skip,
                      reward_name=args.reward_name or "default",
                      device=device)
    save_dir = args.save_dir or f"data/cmaes_traj_{args.env}"
    os.makedirs(save_dir, exist_ok=True)
    for g in range(args.iter):
        info = drv.generation()
        print(f"gen {g}: best {info['best_reward']:.4f} "
              f"mean {info['gen_mean']:.4f}", flush=True)
        drv.best_agent().save(os.path.join(save_dir, f"traj_{g}.npy"))
        np.save(os.path.join(save_dir, "plot_data.npy"),
                np.asarray(drv.history))
        # reference parity: reward-curve PNG every generation
        # (run_cmaes_all.py:182-184)
        save_reward_curve(os.path.join(save_dir, "plot.png"), drv.history)


def _eval_policy(trainer, env, n_steps):
    """One deterministic episode on the batched env; the summed reward of
    env 0 (the EvalCallback measurement, reference training_env.py:86)."""
    obs = env.reset()
    total = 0.0
    carry = None
    recurrent = hasattr(trainer, "hidden")
    for _ in range(n_steps):
        if recurrent:  # recurrent policies carry hidden state
            act, carry = trainer.act(obs, carry)
        else:
            act = trainer.act(obs)
        obs, rew, done = env.step(act)
        total += float(rew[0])
        if bool(done[0]):
            break
    return total


def cmd_rl(args):
    """RL training (reference training/training_env.py:54-96): algo in
    {ppo, sac, recurrent_ppo}, n_envs environments, EvalCallback-style
    best-model checkpointing into checkpoints/<env>/.

    Uses stable-baselines3 when it imports (the reference's dependency);
    otherwise the native trainers (train/{ppo,sac,recurrent_ppo}.py) over
    a BatchedEnv, with the policy in the scene's dtype."""
    device = _device(args)
    scene = _make_scene(args, device)
    save_dir = args.save_dir or f"checkpoints/{args.env}"
    os.makedirs(save_dir, exist_ok=True)
    algo = args.algo.lower()
    try:
        import stable_baselines3  # noqa: F401
    except ImportError:
        pass
    else:
        _sb3_train(args, scene, algo, save_dir, device)
        return

    from .train.ppo import PPOTrainer
    from .train.recurrent_ppo import RecurrentPPOTrainer
    from .train.rl_env import BatchedEnv
    from .train.sac import SACTrainer

    trainers = {"ppo": PPOTrainer, "sac": SACTrainer,
                "recurrent_ppo": RecurrentPPOTrainer}
    if algo not in trainers:
        raise KeyError(f"unknown --algo '{algo}'; available: "
                       f"{sorted(trainers)}")
    batched = BatchedEnv(scene, args.n_envs, time_limit=args.tot_step,
                         reward_name=args.reward_name, device=device)
    kwargs = {} if algo == "sac" else {"horizon": args.horizon}
    trainer = trainers[algo](batched, total_steps=args.timesteps,
                             device=device, dtype=scene.spec.dtype, **kwargs)

    best = {"reward": -float("inf")}

    def eval_callback(steps_done):
        r = _eval_policy(trainer, batched, args.tot_step)
        if r > best["reward"]:
            best["reward"] = r
            trainer.save(os.path.join(save_dir, "best_model.pkl"))
        print(f"eval @ {steps_done}: return {r:.4f} "
              f"(best {best['reward']:.4f})", flush=True)

    trainer.train(callback=eval_callback)
    trainer.save(os.path.join(save_dir, "final_model.pkl"))
    print(f"saved models to {save_dir}")


def _sb3_train(args, scene, algo, save_dir, device):
    """stable-baselines3 path, matching reference training_env.py:54-96."""
    from stable_baselines3 import PPO, SAC
    from stable_baselines3.common.callbacks import EvalCallback

    from .train.rl_env import Env, make_sb3_vec_env

    kwargs = dict(time_step=args.tot_step, reward_name=args.reward_name,
                  scene=scene, device=device)
    venv = make_sb3_vec_env(args.env, args.n_envs, **kwargs)
    eval_env = Env(sys_name=args.env, **kwargs)
    cb = EvalCallback(eval_env, best_model_save_path=save_dir,
                      eval_freq=max(args.timesteps // 20 // args.n_envs, 1),
                      deterministic=True)
    if algo == "ppo":
        model = PPO("MlpPolicy", venv, verbose=1)
    elif algo == "sac":
        model = SAC("MlpPolicy", venv, verbose=1)
    elif algo == "recurrent_ppo":
        from sb3_contrib import RecurrentPPO

        model = RecurrentPPO("MlpLstmPolicy", venv, verbose=1)
    else:
        raise KeyError(f"unknown --algo '{algo}'")
    model.learn(total_timesteps=args.timesteps, callback=cb)
    model.save(os.path.join(save_dir, "final_model"))


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
                   help="render the rollout every n iterations (0: never)")
    p.add_argument("--render_option", type=str, default="Preview",
                   help="Preview (PNG frames + GIF) or LuisaScript")
    p.add_argument("--fwd_chunk", type=int, default=0,
                   help="the JAX package's rollout segments of this many "
                        "steps (0: none); the port's rollout is one host "
                        "loop either way")
    p.set_defaults(fn=cmd_trajopt)

    p = sub.add_parser("cmaes")
    _add_common(p)
    p.add_argument("--iter", type=int, default=10)
    p.add_argument("--pop_size", type=int, default=8)
    p.add_argument("--abs_step", type=int, default=10)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--max_dist", type=float, default=0.002,
                   help="kept for the reference's interface: genomes are "
                        "limited at 0.015 whatever it says, as in the JAX "
                        "package (ROADMAP.md §3)")
    p.add_argument("--reward_name", type=str, default=None,
                   help="scene reward variant (reference run_cmaes_all.py)")
    p.add_argument("--load_state", type=str, default=None,
                   help="npz full-state warm start; balancing/balance/"
                        "throwing default to the bundled pre-grasped state, "
                        "'none' starts cold")
    p.set_defaults(fn=cmd_cmaes)

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

    p = sub.add_parser("rl")
    _add_common(p)
    p.add_argument("--timesteps", type=int, default=100000)
    p.add_argument("--n_envs", type=int, default=8)
    p.add_argument("--algo", type=str, default="ppo",
                   help="ppo|sac|recurrent_ppo (training_env.py algo arg)")
    p.add_argument("--reward_name", type=str, default=None,
                   help="scene reward variant (reference RL_env.py:198)")
    p.add_argument("--horizon", type=int, default=64,
                   help="on-policy rollout chunk length (ppo/recurrent_ppo)")
    p.set_defaults(fn=cmd_rl)

    p = sub.add_parser("render")
    _add_common(p)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--render_option", type=str, default="Preview",
                   help="Preview (PNG frames + GIF), Taichi (the same) or "
                        "LuisaScript")
    p.set_defaults(fn=cmd_render)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

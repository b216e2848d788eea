"""Trajectory optimisation: the window calls TrajOptDriver.iteration()
again and again; a unit is one iteration, its steps the tot_step - 1
simulated steps, each through the forward and the adjoint.

Set-up builds the scene and the driver from the configuration, moves the
cloth by the seed's jitter, sets the seed's warm-start waypoints and runs
the traffic's `compare_iterations` first iterations through the same
call: they warm every shape up, and the reference follows them. The
window goes on from that same driver.

Traffic keys: lr, max_dist, dz_per_step (warm start: row t of the
waypoint table lowered t * dz_per_step), waypoint_sigma_m (the seed's
move of rows 1..), cloth_jitter_m, compare_iterations."""
from __future__ import annotations

import contextlib
import dataclasses
import math

from ..harness import checks, inputs, program
from ..harness.window import WindowClosed

# benchmark spans that name the host's work in the profiler's idle gaps
SPANS = [("thinshelllab_torch.engine.stepper", "time_step", "time_step"),
         ("thinshelllab_torch.engine.adjoint", "backward", "adjoint"),
         ("thinshelllab_torch.optim.adam", "Adam.step", "adam"),
         ("thinshelllab_torch.agent.traj_opt", "TrajAgent.fix_action",
          "fix_action")]


def _windowed():
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    class Windowed(TrajOptDriver):
        """TrajOptDriver that stops at the window's close before a forward
        or a backward starts, and opens a span around each in a traced
        run."""
        window = None
        record = None

        def _span(self, label):
            if self.record is not None and self.record.traced:
                return self.record.spans.span(label)
            return contextlib.nullcontext()

        def forward(self, actions, stats=None):
            if self.window is not None:
                self.window.check()
            with self._span("forward"):
                return super().forward(actions, stats)

        def backward(self, buffers, seed_pos, seed_ar, **kw):
            if self.window is not None:
                self.window.check()
            with self._span("backward"):
                return super().backward(buffers, seed_pos, seed_ar, **kw)

    return Windowed


@dataclasses.dataclass
class State:
    drv: object
    T: int
    compared: list


TAPE = ("pos", "ref_angle", "gripper_rot", "pad_local", "yield_gate",
        "final_proj_flag", "final_proj_dir")


def outputs(info, traj):
    """What an iteration produced, on the host: the tape (positions, rest
    angles, the gripper's pose, the yield gates and the final contact
    latch), the gripper gradient, the waypoints after the Adam step and
    the reward."""
    buf = info["buffers"]
    return {"tape": {k: buf[k].cpu() for k in TAPE},
            "grad": info["gripper_grad"].cpu(), "traj": traj.copy(),
            "reward": float(info["reward"])}


def setup(ctx):
    tr, cfg = ctx.traffic, ctx.config
    T = int(cfg["tot_step"])
    sc = inputs.jitter(program.make_scene(cfg, ctx.dtype), ctx.seed,
                       tr["cloth_jitter_m"])
    drv = _windowed()(sc, T, lr=tr["lr"], max_dist=tr["max_dist"],
                      device=ctx.device)
    drv.agent.traj = inputs.waypoints(ctx.seed, T, sc.n_part,
                                      tr["dz_per_step"],
                                      tr["waypoint_sigma_m"])
    compared = []
    for _ in range(int(tr["compare_iterations"])):
        info = drv.iteration()
        compared.append(outputs(info, drv.agent.traj))
    return State(drv=drv, T=T, compared=compared)


def run_window(state, win, rec):
    drv = state.drv
    drv.window, drv.record = win, rec
    rec.install(SPANS)
    steps = state.T - 1
    try:
        while not win.closed():
            win.begin()
            try:
                with rec.unit(steps):
                    info = drv.iteration()
            except WindowClosed:
                break
            st = info["stats"]
            unit = {"steps": steps, "forward_s": info["forward_s"],
                    "backward_s": info["backward_s"],
                    "wall_time": info["wall_time"],
                    "newton_per_step": list(st.get("newton_per_step", [])),
                    "reward": info["reward"], "grad_norm": info["grad_norm"]}
            if not win.complete(steps, unit):
                break
            rec.count(unit)
    finally:
        rec.restore()
        drv.window = drv.record = None


def failed(unit):
    """A counted iteration whose reward or gradient is not finite."""
    return not (math.isfinite(unit["reward"])
                and math.isfinite(unit["grad_norm"]))


def release(state, rec, ctx):
    """The compared outputs; the program's state goes."""
    out = state.compared
    state.drv = None
    return out


def reference(ctx, got):
    """The plain reference's iterations from the same inputs, in float64,
    on ctx.device, as many as `got` holds; and, for each of the program's
    iterations, the reference's adjoint sweep over the program's own tape
    (the gradient judged apart from the forward it follows)."""
    from ..reference import plain, scenes

    tr, cfg = ctx.traffic, ctx.config
    T = int(cfg["tot_step"])
    sc = inputs.jitter(scenes.make(cfg), ctx.seed, tr["cloth_jitter_m"])
    opt = plain.TrajOpt(sc, T, tr["lr"], tr["max_dist"], ctx.device)
    opt.traj = inputs.waypoints(ctx.seed, T, sc.n_part, tr["dz_per_step"],
                                tr["waypoint_sigma_m"])
    want = []
    for g in got:
        info = opt.iteration()
        out = outputs(info, opt.traj)
        tape = {k: v.to(ctx.device) for k, v in g["tape"].items()}
        for k in ("pos", "ref_angle", "gripper_rot", "pad_local"):
            tape[k] = tape[k].double()
        out["grad_on_tape"] = opt.m.backward(tape, *sc.seed_for()(tape))
        want.append(out)
    return want


def compare(got, want, lr):
    """The numbers of the output check, each the worst over the compared
    iterations:
    - pos_gap_step1_m: positions after the first step (m);
    - pos_gap_m: positions at every step of the tape (m);
    - ref_angle_gap_rad: rest angles at every step (rad);
    - contact_mismatch: the final contact latch's differing entries;
    - grad_gap: the gripper gradient's relative distance from the
      reference's;
    - adjoint_gap: the same from the reference's adjoint sweep over the
      program's own tape;
    - adam_gap_lr: the waypoints after Adam, in units of lr (Adam's
      largest step);
    - reward_gap: the reward's relative distance.
    limits/<cell>.json says which of them a cell compares."""
    nums = {"pos_gap_step1_m": 0.0, "pos_gap_m": 0.0,
            "ref_angle_gap_rad": 0.0, "contact_mismatch": 0,
            "grad_gap": 0.0, "adjoint_gap": 0.0, "adam_gap_lr": 0.0,
            "reward_gap": 0.0}
    if len(got) != len(want):
        return {k: float("inf") for k in nums}
    for g, w in zip(got, want):
        gt, wt = g["tape"], w["tape"]
        nums["pos_gap_step1_m"] = max(
            nums["pos_gap_step1_m"],
            checks.max_abs_gap(gt["pos"][1], wt["pos"][1]))
        nums["pos_gap_m"] = max(nums["pos_gap_m"],
                                checks.max_abs_gap(gt["pos"], wt["pos"]))
        nums["ref_angle_gap_rad"] = max(
            nums["ref_angle_gap_rad"],
            checks.max_abs_gap(gt["ref_angle"], wt["ref_angle"]))
        nums["contact_mismatch"] += sum(
            checks.mismatches(gt[k], wt[k])
            for k in ("final_proj_flag", "final_proj_dir"))
        nums["grad_gap"] = max(nums["grad_gap"],
                               checks.rel_gap(g["grad"], w["grad"]))
        nums["adjoint_gap"] = max(
            nums["adjoint_gap"], checks.rel_gap(g["grad"],
                                                w["grad_on_tape"]))
        nums["adam_gap_lr"] = max(
            nums["adam_gap_lr"], checks.max_abs_gap(g["traj"], w["traj"]) / lr)
        nums["reward_gap"] = max(
            nums["reward_gap"], abs(g["reward"] - w["reward"])
            / max(abs(w["reward"]), 1e-300))
    return nums


def check(ctx, got):
    return compare(got, reference(ctx, got), ctx.traffic["lr"])

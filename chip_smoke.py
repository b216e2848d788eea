"""Smoke run of thinshelllab_torch on one CUDA card.

Builds the two DIA kernels (csrc/dia_spmv.cu) and the two element kernels
(csrc/elements.cu) with nvcc, holds each DIA kernel against
its plain PyTorch version (and times a PyTorch sparse product beside
dia_spmv) on the full bench scene's assembled operator, with the L2 warm
from the call before and cold (a 64 MiB buffer written between calls),
holds the preconditioner against its plain version on a store that
overflows the card's shared memory as well, holds a small f64
rollout and a small f64 forward+backward against the JAX package's saved
positions and gradients (tests/data/bench8_golden.npz,
tests/data/bench8_adjoint_golden.npz), then runs the bench scene's main
path at full size (cloth_N=70: 5,605 vertices, 9,800 cloth triangles) in
f32 with the kernels: the forward rollout, `seed_loss` and the adjoint
backward. Both halves run once more on the plain path, the backward once
more in f64 on the same tape, and the forward+backward once under phase
timers and once under the profiler. On the bench's actions the pad never
touches the cloth (the cloth sinks faster than the pad's 0.4 mm a step),
so the bench's gripper gradient is zero; a later phase runs the full-size
forward+backward with the pad pressing 2 mm a step, where it is not.
A short bench forward then takes the full-Newton branch (hess_refresh=1)
through both kernels.

The folding task's trajectory optimisation follows, on the dense solve
(no DIA kernel: cuSOLVER's batched eigh, the LU solve; the element kernels
build every Hessian, and [folding-trajopt] holds their launches to the
Hessian builds plus the backward steps): the small f64
folding trajopt against the JAX package's saved run
(tests/data/folding_trajopt_golden.npz), then the published scene in f32
through `registry.make_scene("folding", solver="auto")` and
`TrajOptDriver` at T=FOLD_T for FOLD_ITERS iteration (the CLI runs more),
the f32 gradient held against an f64 backward on the same tape, and phase
timers and a profiler pass over a shorter rollout.

Every other task scene of the registry follows (lifting, sliding, card,
pick, forming, balancing, bouncing, interact), each at its published
size: [scenes-golden] holds the CPU tests' small f64 runs against the
JAX package's saved runs (tests/data/scenes_golden.npz; the scenes whose
contact ties the two packages decide differently are held on the JAX
tape instead: each step replayed from the JAX state with the JAX contact
set, and the backward); [scenes] runs a 1-step f64 forward and
backward at the published Newton cap; [scenes-trajopt] one f32
TrajOptDriver iteration of every scene with a gripper; [dp] the system
identification driver on bouncing. The policy-search layers follow:
[cmaes-golden] holds the CPU test's f64 CMAESDriver generation and
rollout_stop_step on the JAX package's rammed-pad tape against the JAX
runs (tests/data/cmaes_golden.npz); [cmaes] runs one f32 generation on
the published folding scene (Newton capped at TRAJOPT_NEWTON); [cmaes-cg]
one f32 generation on forming under solver="cg", which must launch both
kernels, under torch's deterministic algorithms (so that [mesh] can hold
the mesh's generation to it bit for bit); [rl-golden] holds the
CPU test's f64 Env, EvalEnv and BatchedEnv runs against the JAX runs
(tests/data/rl_golden.npz); [rl] runs one update of each native trainer
(PPO, SAC, recurrent PPO) on a BatchedEnv of the published folding scene
in f32, timing env steps and policy updates.

The engine's iterative paths follow, under `solver="cg"`: [cg-kernels]
holds both kernels against their plain versions on the DIA plan of each
task scene (21 to 351 offsets over 1024 or 2048 rows) in f32 and f64;
[cg-scenes] runs every task scene's f64 forward (CG: the kernels, or on
folding, whose cloth is too narrow for a plan, the pull operator) and
backward (GMRES with the BCR preconditioner, or MINRES on folding)
against the JAX package's runs (tests/data/cg_scenes_golden.npz; the tie
scenes on the JAX tape), and folding's MINRES backward at published size
against the dense backward on one tape; [cg-trajopt] one f32
TrajOptDriver iteration under cg on folding and balancing; [bench-40k] the
bench at cloth_N=140 (the JAX package's 40k-triangle row: 39,200
triangles a sheet, so the spatial-hash broadphase) forward and backward,
both kernels on its 52 MB store, and the hash against the exhaustive
sweep. [self-contact], run right after the first kernel checks and again
at the end of the process, holds the self-contact hairpin on the card
against the CPU and the JAX run (tests/data/hairpin_golden.npz), and counts
what cuSOLVER's batched eigh returns on its batches as they stand.

Right after the early [self-contact] (where torch.profiler's traces are
still complete) come the render and utility phases: [render] runs `cli
render` on forming under cg (both kernels in every CG solve) with the
Preview and the LuisaScript options and `cli trajopt --render_every 1`,
holding the GIF's frames against the PNGs, the card's preview image and
frame 0's Luisa script and OBJ files against the CPU port's; [debug]
holds `check_differential` and `contact_forces` at a lifting state
(tests/data/debug_golden.npz) against the CPU port; [bend-batch] runs the
full bench with the batch hinge form against the default one, and the
small f64 bench against the JAX run (tests/data/bend_batch_golden.npz);
[profile-trace] writes a `utils.profiling.device_trace` of one bench
step, which must name both kernels; [native] holds the native helper's
cloth tables, hinges and cube lattices against the numpy paths.

[element-kernels], after [profile-trace], holds the element layer's two
kernels (ops/element_kernels, csrc/elements.cu; every all_groups call of
the run goes through them) against the plain torch.func route
(elements.plain_groups) on the published folding scene pressed 3 steps
and on forming under cg, in f64 and f32, and times each kernel at
folding's shapes beside its byte bound, and the whole all_groups call on
both routes.

[mesh], last (parallel/mesh.py and entry.py): sharded_train_step on a
world of one over NCCL on the full bench in f32, the pad pressing, against
the mean of serial backwards (both kernels launched: `launches_mesh`); one
CMAESDriver generation through the mesh against [cmaes-cg]'s of the same
run, both under torch's deterministic algorithms (bit for bit); `entry()` on the card
and `dryrun_multichip(1)` (one spawned NCCL rank); on a machine with more
cards, the train step at world = device_count as well.

    python3 chip_smoke.py

Every phase that builds a Hessian on the card is held to its element
kernel launches: element_eval as many as element_fuse, more than none, and
where the phase can count them, one of each for every Hessian build and
every backward step. Prints one line per phase, then a JSON line of
per-kernel results (with each kernel's launches on every path the run
drove, `launches_<path>`), the
card's `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises, exits non-zero and
prints no result line. Needs CUDA; there is no CPU path.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "bench8_golden.npz")
GOLDEN_ADJ = os.path.join(ROOT, "tests", "data", "bench8_adjoint_golden.npz")
GOLDEN_FOLD = os.path.join(ROOT, "tests", "data",
                           "folding_trajopt_golden.npz")

# kernel vs plain version, max |kernel - plain| / max |plain|: both sum the
# same 9 * n_off products per row in another order; the preconditioner
# adds three D^-1 sweeps on top. f32 keeps ~7 digits, f64 ~16.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# small f64 rollout vs the JAX positions (metres, scene size 0.1 m, 8e-4 m
# of motion): both run CG to fwd_tol 1e-10, so the fused preconditioner's
# variant and the summation order move positions far below this
GOLDEN_ATOL = 1e-8
# full-size f32 rollout, plain path vs kernels, max |dpos| / max cloth
# displacement. The two use different preconditioners (the fused kernel
# drops the leftover rows' off-diagonal couplings), so their inexact
# (fwd_tol 1e-3) CG directions differ; and at the bench settings Newton
# stops at max_newton_iter = 8 in every step, short of newton_tol, so each
# step keeps an unconverged remainder that follows those directions. The
# positions therefore agree to a few percent of the motion, not to
# rounding; a wrong operator or preconditioner moves them by the whole
# displacement.
PLAIN_VS_KERNEL_RTOL = 1e-1
# small f64 forward+backward vs the JAX gradients, max |d| / max |JAX|:
# forward CG to 1e-10, GMRES to adj_tol 1e-10 on both sides, sums in
# another order (the CPU port agrees to 1e-12)
GOLDEN_ADJ_RTOL = 1e-7
# full-size f32 backward, plain path vs kernels on one tape, max |d| / max
# |plain| of gripper_grad and pos_grad0: f32 GMRES stops at its residual
# floor, so operators that differ by rounding end at different points
# near it
ADJ_PLAIN_RTOL = 5e-2
T_STEPS = 8
# the profiler pass's rollout: reading back the trace of T_STEPS took a
# minute of the script's time budget
T_PROFILE = 2
DISPLACEMENT_Z = -4e-4  # bench.py:143-149: the pad moves 0.4 mm down a step
# the pressing run: the pad moves 2 mm down a step and reaches the cloth
T_PRESS, PRESS_Z = 4, -2e-3
# the small f64 folding trajopt vs the JAX run: Newton to newton_tol 1e-7
# and dense LU solves on both sides, sums in another order (the CPU port
# agrees to 1e-13 and below)
FOLD_POS_ATOL, FOLD_REF_ATOL = 1e-8, 1e-9  # metres, radians
FOLD_REWARD_RTOL, FOLD_GRAD_RTOL = 1e-9, 1e-6
# an Adam step of lr 1e-3 moves a waypoint by at most ~1e-3 per unit of
# m_hat / sqrt(v_hat); a 1e-6 relative error of g moves it by ~1e-9 m
FOLD_TRAJ_ATOL = 1e-8
# the f32 folding gradient vs an f64 backward on the same f32 tape,
# |g32 - g64| / |g64| in the L2 norm: the definition of the JAX package's
# CPU-f32 dense figure of 4.3e-3 (BASELINE.md:211, scripts/grad_accuracy.py)
FOLD_F32_RTOL = 1e-2
# the published folding trajopt, cut in depth from the reference's 50
# waypoints (run_trajopt_folding.sh) to make room for the task scenes and
# the cg paths within the script's time target; its T=50 and T=10 times
# are in PERF.md
FOLD_T, FOLD_ITERS = 4, 1
# the shorter rollout of the folding phase timers and f32 spread, and the
# Newton cap of the profiler pass over its first step
FOLD_PHASE_STEPS, FOLD_PROFILE_NEWTON = 1, 3
# the task scenes beside folding and bench, at their published sizes
NEW_SCENES = ("lifting", "sliding", "card", "pick", "forming", "balancing",
              "bouncing", "interact")
GOLDEN_SCENES = os.path.join(ROOT, "tests", "data", "scenes_golden.npz")
# [scenes-golden]: the CPU test's f64 run (T=2, max_newton_iter=5, the
# JAX smoke test's actions) against the JAX package's saved run, with the
# CPU test's tolerances: dense LU on both sides, sums in another order
SCENE_GOLDEN_T, SCENE_GOLDEN_NEWTON = 2, 5
SCENE_POS_ATOL, SCENE_GRAD_RTOL = 1e-9, 1e-7
# the scenes whose CPU rollout test is a strict xfail
# (tests/test_torch_scene_rollouts.py TIES, ROADMAP.md §3): the packages
# decide tied contact slots differently, so the rollout is printed, not
# gated, and the backward is gated on the JAX package's own tape
SCENE_TIES = {
    "sliding": "36 contact slots decided differently at the initial state",
    "card": "20-21 contact slots decided differently after step 1",
    "pick": "2 active slots take the other of two tied coplanar pad faces",
    "interact": "20 contact slots decided differently at the initial state",
}
# [scenes]: each scene in f64 at its published Newton cap, T steps of the
# JAX smoke test's actions (each pad 0.2 mm down a step; T cut from 4 to 2
# for the script's time target, PERF.md); its bound on the displacement
# (tests/test_scenes.py:36)
SCENES_T, SCENE_DZ, SCENE_DISP_MAX = 2, -2e-4, 0.05
# [scenes-trajopt]: one f32 TrajOptDriver iteration (the CLI's card
# default) at this T for every scene with a gripper (cut from 3 to 2, one
# step, for the script's time target, PERF.md)
SCENES_TRAJOPT_T = 2
# the Newton cap of the f32 iterations of [scenes-trajopt] and
# [cg-trajopt], and of [cmaes]'s generation, cut from the published
# 50 (lifting's own is 15) to make room for the policy-search phases and
# [mesh] within the script's time target: the
# f32 Newton stalls at whatever cap it has (PERF.md §5), so the cut
# shortens each stalled step and changes no gate
TRAJOPT_NEWTON = 15
# [dp]: ParamOptDriver iterations and one ParamCMAESDriver generation of
# DP_POP on bouncing, f32 as the CLI runs them on a card (T cut from 3 to
# 2, one step, and the CMA-ES generation moved from card to bouncing, one
# scene, for the script's time target; 2 iterations and a population of 4
# cut to 1 and 2 to make room for the policy-search phases, PERF.md)
DP_T, DP_ITERS, DP_LR, DP_POP = 2, 1, 1.0, 2
# the task scenes under solver="cg" (tests/test_torch_solver_paths.py
# made the JAX runs in tests/data/cg_scenes_golden.npz: f64, T=CG_T,
# max_newton_iter=CG_NEWTON, each pad 0.2 mm down a step; folding, with no
# DIA plan, at table_n=4 and pressed 0.6 mm a step so that its pad reaches
# the cloth)
GOLDEN_CG = os.path.join(ROOT, "tests", "data", "cg_scenes_golden.npz")
CG_SCENES = ("folding",) + NEW_SCENES
CG_T, CG_NEWTON = 2, 5
CG_FOLD_TABLE_N, CG_FOLD_DZ = 4, -6e-4
# a tie scene's step replayed on the JAX tape in which some CG solve
# stopped at its cap of cg_max_iter: the unconverged remainder carries the
# rounding of the two packages' arithmetic. The same arithmetic (JAX's f64
# preconditioner, the JAX state and contact set) leaves them 2.2e-8 m
# apart on card's second step and 6.3e-9 m on pick's first (PERF.md);
# 1e-7 m is 1/2000 of the pads' 0.2 mm step, where a wrong operator or
# preconditioner moves them by a fair part of it. The scenes without ties
# (lifting, forming, balancing, bouncing, folding) are held to
# SCENE_POS_ATOL even where their solves stop at the cap
CAPPED_POS_ATOL = 1e-7
# the iterations of a GMRES or MINRES solve on inputs that differ by
# rounding (the exit test's last iteration may fall either side): gated
# within this slack. The forward CG iterations are printed beside the
# golden's, not gated: on the card the preconditioner is the fused
# dia_precond kernel, which drops the leftover pull rows' off-diagonal
# couplings, and the golden ran the JAX package's XLA polynomial, which
# keeps them (the JAX package takes its kernel only in f32 on a TPU)
CG_ITER_SLACK = 2
# folding at its published size: the MINRES backward against the dense
# backward on one tape, max |d| / max |dense| of gripper_grad (the bound
# tests/test_assembly.py holds one MINRES solve to)
MINRES_DENSE_RTOL = 1e-6
# [cg-trajopt]: one f32 TrajOptDriver iteration under solver="cg" at this
# T. Folding's waypoint table presses its pads CG_FOLD_DZ a step over two
# steps: over one step (T=2) its gripper gradient is exactly 0, pressed or
# not, and the comparison with the f64 backward would measure nothing
CG_TRAJOPT_T = {"folding": 3, "balancing": 2}
# [bench-40k]: the bench at the JAX package's 40k-triangle row
# (BENCH_CLOTH_N=140), the pad pressing as [adjoint-press] does
BENCH40K_N, BENCH40K_T = 140, 4
# the hash against the exhaustive sweep: the JAX package's criterion
# (tests/test_collision.py:181-222)
HASH_DIST_ATOL = 1.01e-5
# [self-contact]: the hairpin (thinshelllab_torch/scenes/hairpin.py) on the
# card against the CPU and against the JAX run
# (tests/data/hairpin_golden.npz)
GOLDEN_HAIRPIN = os.path.join(ROOT, "tests", "data", "hairpin_golden.npz")
# the JAX package's hash projection of the 40k bench's initial positions in
# f64 (tests/test_torch_collision_hash.py writes it)
GOLDEN_HASH40K = os.path.join(ROOT, "tests", "data", "hash40k_golden.npz")
HAIRPIN_CPU_ATOL, HAIRPIN_JAX_ATOL = 1e-12, 1e-9
# the policy-search layers (tests/test_torch_cmaes.py and
# tests/test_torch_rl.py made the JAX runs in these files: f64, folding at
# table_n=4 with max_newton_iter=5)
GOLDEN_CMAES = os.path.join(ROOT, "tests", "data", "cmaes_golden.npz")
GOLDEN_RL = os.path.join(ROOT, "tests", "data", "rl_golden.npz")
POLICY_GOLDEN_CFG = dict(table_n=4, max_newton_iter=5)
# [cmaes-golden]: the CPU test's generation (pop 4, tot_step 2, abs_step 2,
# seed 0) and the rammed-pad tape of tests/test_training.py (table_n=4,
# max_newton_iter=4, T=8, 2.5 mm down a step); the CPU test's tolerances:
# dense LU on both sides, sums in another order
CMAES_POP, CMAES_TOT, CMAES_ABS = 4, 2, 2
CMAES_REWARD_RTOL, CMAES_ES_TOL = 1e-9, 1e-9
RAM_CFG, RAM_T, RAM_DZ = dict(table_n=4, max_newton_iter=4), 8, -2.5e-3
# [cmaes-cg]: forming (a 63-offset DIA plan, no contact ties) under
# solver="cg" in f32 as `cli cmaes --solver cg` runs it on a card, Newton
# capped at CG_NEWTON (a depth cut: f32 Newton stalls at the published cap
# of 50, each iteration a ~200-iteration CG solve, PERF.md §5)
CMAES_CG_SCENE = "forming"
# [rl-golden] (tests/test_torch_rl.py's runs): Env and EvalEnv on
# Env("folding", ...), BatchedEnv(n=2) on folding with env 1 started at
# t=1; float64 observations within 1e-9 m, the float32 ones within one
# float32 rounding, rewards within 1e-9 relative
RL_LIMIT, RL_OBS_ATOL, RL_REWARD_RTOL = 3, 1e-9, 1e-9
RL_BATCHED_T0 = (0, 1)
# [rl]: published folding in f32, BatchedEnv(n=2), one update of each
# trainer (horizon 2; SAC start_steps 2, batch_size 4), Newton capped at 5
# (a depth cut, as [scenes-golden] cuts it: the f32 Newton stalls at the
# published cap of 50, about 10 s a step, PERF.md §5)
RL_NEWTON, RL_ENVS, RL_HORIZON = 5, 2, 2
# [mesh] (parallel/mesh.py): (a) sharded_train_step on a world of one over
# NCCL on the main path's bench (BENCH_CFG) in f32, MESH_B members of
# MESH_T steps, each pressing PRESS_Z a step plus JAX's dryrun jitter
# (numpy seed 0, 1e-4 m): on the bench's own 0.4 mm a step the gripper
# gradient is zero. Held against the mean of MESH_B serial backwards,
# both under torch's deterministic algorithms (deterministic()): as they
# stand, the scatter-adds sum with atomics in
# another order each run, and at t=1 of this tape f32 GMRES stops at a
# stagnation exit (relative residual 0.06-0.58), so two runs of the same
# code part by up to the whole gradient (scripts/probe_mesh_grad_spread.py,
# PERF.md). In one summation order they do the same operations; the
# new waypoints and the loss proxy (2 x 5,605 squared f32 positions,
# summed per member for the reference) differ at most by the roundings of
# the sums' order: 1e-6 relative.
BENCH_CFG = dict(cloth_N=70, table_n=12, dtype=torch.float32, hess_refresh=8,
                 fwd_tol=1e-3, max_newton_iter=8)
MESH_T, MESH_B = 2, 2
MESH_GRAD_RTOL, MESH_LOSS_RTOL = 1e-6, 1e-6
# (b) one CMAESDriver generation through a mesh of one, with [cmaes-cg]'s
# scene, seed and settings, against [cmaes-cg]'s rewards of the same run,
# both under deterministic algorithms: equal bit for bit. As it stands
# the generation does not repeat: a member's reward took three values up
# to 3.5e-6 apart over 13 runs (scripts/cmaes_cg_spread.py, PERF.md),
# so a tolerance from the spread of a few runs would not hold.
# the card's published peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# written between calls for a cold-L2 time: larger than the 50 MB L2
FLUSH_BYTES = 64 * 2**20
# a store whose f32 slice per CTA overflows shared memory: the bench's 71
# offsets over 16384 rows (128 rows a CTA, 46 of 71 lanes held on an H100)
SPILL_NVP = 16384


T_START = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def reset_launches():
    """Zero the launch counters of the DIA and the element kernels."""
    from thinshelllab_torch.ops import dia_spmv, element_kernels

    dia_spmv.reset_launches()
    element_kernels.reset_launches()


def launch_counts():
    """{kernel: launches since reset_launches()} of all four kernels."""
    from thinshelllab_torch.ops import dia_spmv, element_kernels

    return {**dia_spmv.LAUNCHES, **element_kernels.LAUNCHES}


def check_element_launches(tag, counts, want=None):
    """The path went through the element kernels: element_eval and
    element_fuse launched alike, more than once, and `want` times (the
    path's all_groups calls with the Hessian) when given."""
    n = counts["element_eval"]
    if not (n == counts["element_fuse"] > 0 and want in (None, n)):
        raise AssertionError(
            f"{tag}: element kernel launches {counts}, expected "
            f"{'> 0' if want is None else want} of each")


def timed(name, fn, *args, **kw):
    """fn(*args, **kw), and a line with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def bench_actions(T, dtype, device, dz=None):
    dpos = torch.zeros((T, 1, 3), dtype=dtype, device=device)
    dpos[:, 0, 2] = DISPLACEMENT_Z if dz is None else dz
    return (dpos, torch.zeros((T, 1, 3), dtype=dtype, device=device),
            torch.zeros((T, 1), dtype=dtype, device=device))


def call_ms(fn, n=60, warmup=5):
    """Time per call (ms) of n back-to-back calls between two CUDA events:
    what a caller pays, the host's launch cost included where it exceeds
    the device's work."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def event_ms(fn, n, flush=None):
    """Device time per call (ms) between two CUDA events around n calls.
    The stream first sleeps on the card (~60 ms) while the host queues
    every call behind it, so the events time the calls' kernels back to
    back and not the host's launches. flush: written before each call; the
    same n writes alone are timed the same way and taken off."""
    def queued(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(n):
            call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    if flush is None:
        return queued(fn)
    return (queued(lambda: (flush.fill_(1.0), fn()))
            - queued(lambda: flush.fill_(1.0)))


def device_ms(fn, n=60, key=None, cold=False, tries=2, per_call=None):
    """Device time per call (ms): the summed time of every CUDA kernel the
    n calls ran (of those whose name holds `key`, if given), from the
    profiler's trace of the card. cold: FLUSH_BYTES are written between
    calls, so that each call finds its inputs outside L2. per_call: the
    kernels a call launches, where known. A trace that holds none of the
    kernels, or not per_call * n of them, is taken again, up to `tries`
    traces in all; late in a long process the profiler can return empty or
    partial traces of the card, and then the calls are timed with CUDA
    events (event_ms) instead."""
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in events if key is None or key in e.key]
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in mine)
        count = sum(e.count for e in mine)
        if us > 0 and per_call in (None, count / n):
            return us / 1e3 / n
        log(f"[profile] a trace of {count} launches of "
            f"{key or 'any kernel'} for {n} calls"
            + (f" of {per_call} launches" if per_call else "")
            + f", {us:.1f} us: {[e.key[:50] for e in events]}")
    ms = event_ms(fn, n, flush)
    log(f"[profile] timed with CUDA events instead: {ms:.4f} ms a call")
    return ms


def operator_inputs(sc, device, dtype):
    """The full bench scene's assembled DIA store and preconditioner inputs
    at its initial state, as the first Newton iteration builds them."""
    from thinshelllab_torch.engine import elements, solver, stepper

    spec, s0, params = sc.to(device, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                           s0.proj_flag, s0.proj_dir)
    groups = elements.all_groups(spec, params, s0.pos, s0.ref_angle, contact,
                                 with_hess=True, spd=True)
    st = solver.prepare_solver_state(spec, groups, dtype)
    D, Dinv = st["D"], solver._inv3x3(st["D"])
    NV, NVp = spec.NV, spec.dia.NVp
    dia_pre = st["dia"].clone()
    dia_pre[spec.dev.off0, :, :, :NV] = D.permute(1, 2, 0)
    dinv = torch.zeros((3, 3, NVp), dtype=dtype, device=device)
    dinv[:, :, :NV] = Dinv.permute(1, 2, 0)
    return spec, st["dia"], dia_pre, dinv


def bound_ms(n_bytes, n_flop):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_work(name, dia, sweeps):
    """(bytes, operations) a kernel call needs on a store of dia's shape:
    dia_spmv reads the store and x and writes y, 2 operations per store
    entry; dia_precond reads the store, r, unf and D^-1 and writes z, and
    per sweep does one SpMV plus the residual, D^-1 product and update on
    3 NVp rows."""
    n_off, _, _, NVp = dia.shape
    it = dia.element_size()
    if name == "dia_spmv":
        return (dia.numel() + 6 * NVp) * it + 4 * n_off, 2 * dia.numel()
    return ((dia.numel() + 18 * NVp) * it + 4 * n_off,
            sweeps * 2 * dia.numel() + (sweeps + 1) * 24 * NVp)


def sparse_matvec(dia, offsets, layout):
    """The DIA store as one PyTorch sparse matrix over the vertex-major
    vector (3 NVp,): 'bsr' with the (3, 3) blocks, 'csr' with scalars.
    Block (n, n + o) is dia[o_index, :, :, n]; out-of-range columns drop."""
    n_off, _, _, NVp = dia.shape
    n = torch.arange(NVp, device=dia.device)
    rows, cols, vals = [], [], []
    for oi, o in enumerate(offsets):
        c = n + o
        ok = (c >= 0) & (c < NVp)
        rows.append(n[ok])
        cols.append(c[ok])
        vals.append(dia[oi][:, :, ok].permute(2, 0, 1))
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    size = (3 * NVp, 3 * NVp)
    if layout == "bsr":
        order = torch.argsort(rows * NVp + cols)
        crow = torch.zeros(NVp + 1, dtype=torch.int64, device=dia.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=NVp), 0)
        return torch.sparse_bsr_tensor(crow, cols[order], vals[order],
                                       size=size)
    ij = torch.arange(3, device=dia.device)
    r = (3 * rows[:, None, None] + ij[None, :, None]).expand_as(vals)
    c = (3 * cols[:, None, None] + ij[None, None, :]).expand_as(vals)
    coo = torch.sparse_coo_tensor(torch.stack([r.reshape(-1), c.reshape(-1)]),
                                  vals.reshape(-1), size=size)
    return coo.coalesce().to_sparse_csr()


def library_spmv(dia, x2, offsets):
    """One PyTorch sparse matrix-vector call computing dia_spmv (BSR with
    3x3 blocks, else CSR): (call, layout, error text of a layout that did
    not run). The port never calls it."""
    xv = x2.T.contiguous().reshape(-1, 1)
    errors = []
    for layout in ("bsr", "csr"):
        try:
            S = sparse_matvec(dia, offsets, layout)
            S @ xv
            return (lambda: S @ xv), layout, "; ".join(errors)
        except (RuntimeError, NotImplementedError) as e:
            errors.append(f"{layout}: {str(e).splitlines()[0]}")
    return None, None, "; ".join(errors)


def precond_geometry(K, device, NVp, offsets, dtype):
    """The preconditioner's launch geometry as the wrapper sizes it, and a
    line of text that names it."""
    plan = K.device_precond_plan(device.index, NVp, tuple(offsets), dtype)
    text = (f"rows per CTA {plan.rows}, grid {plan.grid} CTAs of "
            f"{plan.threads} threads, {plan.staged} of {len(offsets)} lanes "
            f"staged, {plan.smem_bytes} B of shared memory per CTA")
    return plan, text


def spill_check(device):
    """The preconditioner on a random f32 store of the bench's offsets over
    SPILL_NVP rows, whose slice per CTA does not fit shared memory."""
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    offs = bench_scene.make(cloth_N=70, table_n=12).spec.dia.offsets
    rng = np.random.default_rng(1)
    n_off, dtype = len(offs), torch.float32

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=dtype,
                               device=device)

    dia, dinv = t(n_off, 3, 3, SPILL_NVP), t(3, 3, SPILL_NVP, scale=0.1)
    unf2 = torch.as_tensor(rng.random((3, SPILL_NVP)) > 0.1, dtype=dtype,
                           device=device)
    r2 = t(3, SPILL_NVP) * unf2
    plan, geo = precond_geometry(K, device, SPILL_NVP, offs, dtype)
    if plan.staged >= n_off:
        raise AssertionError(f"the spill store fits shared memory: {geo}")
    reset_launches()
    z = K.dia_precond(dia, r2, unf2, dinv, offs, 0.8, 3)
    torch.cuda.synchronize()
    launches = K.LAUNCHES["dia_precond"]
    zp = K.dia_precond_plain(dia, r2, unf2, dinv, offs, 0.8, 3)
    rel = float((z - zp).abs().max() / zp.abs().max())
    ms = device_ms(lambda: K.dia_precond(dia, r2, unf2, dinv, offs, 0.8, 3))
    log(f"[kernel] dia_precond float32 spill store {tuple(dia.shape)}: {geo};"
        f" {launches} launch per call; max rel err {rel:.3e} (tol "
        f"{KERNEL_RTOL[dtype]:.0e}); device time per call {ms:.4f} ms")
    if launches != 1 or not rel <= KERNEL_RTOL[dtype]:
        raise AssertionError(f"dia_precond on the spill store: {launches} "
                             f"launches, error {rel:.3e}")


def kernel_checks(sc, device):
    from thinshelllab_torch.ops import dia_spmv as K

    rng = np.random.default_rng(0)
    out = {}
    keys = {"dia_spmv": "dia_spmv_kernel",
            "dia_precond": "dia_precond_kernel"}
    for dtype in (torch.float32, torch.float64):
        spec, dia, dia_pre, dinv = operator_inputs(sc, device, dtype)
        unf2 = spec.dev.unf2
        NVp, offs, offs_t = spec.dia.NVp, spec.dia.offsets, spec.dev.offsets_t
        x2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                             device=device) * unf2
        r2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                             device=device) * unf2
        w, sweeps = spec.precond_omega, spec.precond_smooth
        cases = {
            "dia_spmv": (lambda: K.dia_spmv(dia, x2, offs, offs_t),
                         lambda: K.dia_spmv_plain(dia, x2, offs)),
            "dia_precond": (
                lambda: K.dia_precond(dia_pre, r2, unf2, dinv, offs, w,
                                      sweeps, offs_t),
                lambda: K.dia_precond_plain(dia_pre, r2, unf2, dinv, offs, w,
                                            sweeps)),
        }
        for name, (kern, plain) in cases.items():
            reset_launches()
            yk = kern()
            torch.cuda.synchronize()
            per_call = K.LAUNCHES[name]
            yp = plain()
            abs_err = float((yk - yp).abs().max())
            rel = abs_err / float(yp.abs().max())
            tol = KERNEL_RTOL[dtype]
            ms, plain_ms = device_ms(kern, per_call=1), device_ms(plain)
            cold_ms = device_ms(kern, 30, key=keys[name], cold=True,
                                per_call=1)
            call, plain_call = call_ms(kern), call_ms(plain)
            queued = event_ms(kern, 60)  # device_ms's fallback timer
            geo = ""
            if name == "dia_precond":
                plan, geo = precond_geometry(K, device, NVp, offs, dtype)
                geo = f"{geo}; "
            log(f"[kernel] {name} {str(dtype)[6:]} shape {tuple(dia.shape)}: "
                f"{geo}{per_call} launch per call; max rel err {rel:.3e} "
                f"(tol {tol:.0e}), max abs err {abs_err:.3e}; device time "
                f"per call: kernel {ms:.4f} ms with a warm L2, {cold_ms:.4f} "
                f"ms with a cold L2, plain {plain_ms:.4f} ms; per call "
                f"between CUDA events: kernel {call:.4f} ms, plain "
                f"{plain_call:.4f} ms (60 calls); kernel queued behind a "
                f"sleep, between CUDA events {queued:.4f} ms")
            if not rel <= tol:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with "
                                     f"its plain version ({rel:.3e} > {tol})")
            if per_call != 1:
                raise AssertionError(f"{name}: {per_call} launches per call")
            n_bytes, n_flop = kernel_work(name, dia, sweeps)
            if name == "dia_spmv":
                lib, layout, lib_note = library_spmv(dia, x2, offs)
            else:
                lib, layout, lib_note = None, None, (
                    "none: no single PyTorch call computes the polynomial")
            b_ms, b_by = bound_ms(n_bytes, n_flop)
            lib_ms = None
            if lib is not None:
                y_lib = lib().reshape(NVp, 3).T
                lib_rel = float((y_lib - yp).abs().max() / yp.abs().max())
                lib_ms = device_ms(lib)
                lib_note = (f"{layout} matmul, {call_ms(lib):.4f} ms "
                           f"between CUDA events, max rel err vs plain "
                           f"{lib_rel:.3e}; " + lib_note)
            log(f"[kernel] {name} {str(dtype)[6:]}: bound {b_ms:.4f} ms by "
                f"{b_by} ({n_bytes / 1e6:.2f} MB, {n_flop / 1e6:.2f} MFLOP); "
                f"library call "
                + (f"{lib_ms:.4f} ms of device time" if lib_ms is not None
                   else "none") + f" ({lib_note.rstrip('; ')})")
            if dtype == torch.float32:
                out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, cold_ms=cold_ms,
                                 launches_per_call=per_call)
                if name == "dia_precond":
                    out[name].update(rows_per_cta=plan.rows, grid=plan.grid,
                                     staged_lanes=plan.staged,
                                     smem_bytes_per_cta=plan.smem_bytes)
    spill_check(device)
    return out


def golden_check(device):
    from thinshelllab_torch.engine import stepper
    from thinshelllab_torch.scenes import bench_scene

    g = np.load(GOLDEN)
    sc = bench_scene.make(cloth_N=int(g["cloth_N"]), table_n=int(g["table_n"]),
                          dtype=torch.float64, solver="cg", hess_refresh=8,
                          max_newton_iter=int(g["max_newton_iter"]),
                          fwd_tol=float(g["fwd_tol"]))
    spec, s0, params = sc.to(device, torch.float64)
    s0 = s0.replace(pos=torch.as_tensor(g["pos0"], device=device))
    T = g["pos"].shape[0] - 1
    _, buf = stepper.simulate(spec, params, s0,
                              bench_actions(T, torch.float64, device))
    err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    log(f"[golden] f64 cloth_N={int(g['cloth_N'])} T={T} with kernels vs the "
        f"JAX positions: max |dpos| {err:.3e} m (tol {GOLDEN_ATOL:.0e})")
    if not err <= GOLDEN_ATOL:
        raise AssertionError(f"golden rollout off by {err:.3e} m")


def golden_adjoint_check(device):
    """The small f64 scene's forward and default backward with the kernels
    against the JAX package's gradients (the bench's no-tape path)."""
    from thinshelllab_torch.engine import adjoint, stepper
    from thinshelllab_torch.scenes import bench_scene

    g = np.load(GOLDEN_ADJ)
    sc = bench_scene.make(cloth_N=int(g["cloth_N"]), table_n=int(g["table_n"]),
                          dtype=torch.float64, solver="cg", hess_refresh=8,
                          max_newton_iter=int(g["max_newton_iter"]),
                          fwd_tol=float(g["fwd_tol"]),
                          adj_tol=float(g["adj_tol"]))
    spec, s0, params = sc.to(device, torch.float64)
    s0 = s0.replace(pos=torch.as_tensor(g["pos0"], device=device))
    dpos = torch.as_tensor(g["dpos"], device=device)
    T = dpos.shape[0]
    acts = (dpos, torch.zeros_like(dpos),
            torch.zeros((T, 1), dtype=torch.float64, device=device))
    reset_launches()
    _, buf = stepper.simulate(spec, params, s0, acts)
    seeds = sc.seed_loss(buf)
    res = adjoint.backward(spec, params, buf, *seeds)
    iters = adjoint.backward(spec, params, buf, *seeds,
                             debug_iters=True).pos_grad0.cpu().numpy()
    torch.cuda.synchronize()
    launches = launch_counts()
    pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    gg, pg0 = res.gripper_grad.cpu().numpy(), res.pos_grad0.cpu().numpy()
    gg_rel = float(np.abs(gg - g["gripper_grad"]).max()
                   / np.abs(g["gripper_grad"]).max())
    pg_rel = float(np.abs(pg0 - g["pos_grad0"]).max()
                   / np.abs(g["pos_grad0"]).max())
    d_it = int(np.abs(iters.astype(np.int64) - g["iters"]).max())
    nonzero = int((np.abs(gg).max(axis=(1, 2)) > 0).sum())
    log(f"[golden-adjoint] f64 cloth_N={int(g['cloth_N'])} T={T}, pad "
        f"{float(g['dpos'][0, 0, 2]) * 1e3:.1f} mm a step, forward + default "
        f"backward with kernels vs JAX: max |dpos| {pos_err:.3e} m (tol "
        f"{GOLDEN_ATOL:.0e}); gripper_grad max rel err {gg_rel:.3e}, "
        f"pos_grad0 {pg_rel:.3e} (tol {GOLDEN_ADJ_RTOL:.0e}); GMRES iters "
        f"{iters.tolist()} vs JAX {g['iters'].tolist()}; {nonzero} steps "
        f"with a gripper gradient; launches {launches}")
    if not (pos_err <= GOLDEN_ATOL and gg_rel <= GOLDEN_ADJ_RTOL
            and pg_rel <= GOLDEN_ADJ_RTOL):
        raise AssertionError("the small adjoint disagrees with the JAX golden "
                             "gradients")
    if d_it > 2 or nonzero < 3 or launches["dia_spmv"] <= 0:
        raise AssertionError(f"golden adjoint: iteration counts off by {d_it},"
                             f" {nonzero} non-zero steps, launches {launches}")
    check_element_launches("[golden-adjoint]", launches)


def rollout(spec, s0, params, device, T=None, dz=None):
    from thinshelllab_torch.engine import stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, buf = stepper.simulate(spec, params, s0,
                              bench_actions(T or T_STEPS, spec.dtype, device,
                                            dz),
                              stats=stats)
    torch.cuda.synchronize()
    return buf, stats, time.perf_counter() - t0


def backward(sc, spec, params, buf, **kw):
    """seed_loss and adjoint.backward on a forward tape: (result, seconds)."""
    from thinshelllab_torch.engine import adjoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf), **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def gmres_residuals(fn):
    """Run fn() with every GMRES solve's iterations and final relative true
    residual |b - A x| / |b| recorded (one extra operator apply a solve):
    (fn's result, [(iterations, residual), ...] in sweep order)."""
    from thinshelllab_torch.engine import solver

    loop, out = solver._gmres_loop, []

    def logged(A, M, b, tol, m, max_total=None, x0=None, return_iters=False):
        x, it = loop(A, M, b, tol, m, max_total, x0=x0, return_iters=True)
        rel = torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b)
        out.append((it, float(f"{float(rel):.2e}")))
        return (x, it) if return_iters else x

    solver._gmres_loop = logged
    try:
        return fn(), out
    finally:
        solver._gmres_loop = loop


def rel_err(a, b):
    """max |a - b| / max |b| (max |a| where b is all zero)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def adjoint_phase(sc, spec, params, buf, fwd_secs, device):
    """The bench backward at full size in f32 on the [main] tape: a
    warm-up backward (its gradients are the kernel path's), a timed one
    with debug_iters, the plain path on the same tape, and the same tape
    in f64 (printed, not gated)."""
    from thinshelllab_torch.ops import dia_spmv as K

    (res, _), resid = gmres_residuals(  # warm-up
        lambda: backward(sc, spec, params, buf))
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res_t, secs = backward(sc, spec, params, buf, debug_iters=True)
    launches = launch_counts()
    check_element_launches("[adjoint]", launches, T_STEPS)
    peak = torch.cuda.max_memory_allocated(device)
    iters = res_t.pos_grad0.cpu().tolist()
    gg, pg0 = res.gripper_grad, res.pos_grad0
    if (tuple(gg.shape) != (T_STEPS + 1, 1, 6)
            or pg0.shape != buf["pos"][0].shape):
        raise AssertionError(f"gradient shapes {tuple(gg.shape)}, "
                             f"{tuple(pg0.shape)}")
    if gg.dtype != torch.float32 or pg0.dtype != torch.float32:
        raise AssertionError(f"gradient types {gg.dtype}, {pg0.dtype}")
    if not all(bool(torch.isfinite(v).all()) for v in (gg, pg0)):
        raise AssertionError("non-finite gradients in the main backward")
    if not float(pg0.abs().max()) > 0:
        raise AssertionError("the residual dL/dx_0 is zero")
    nonzero = int((gg.abs().amax(dim=(1, 2)) > 0).sum())
    if launches["dia_spmv"] <= 0 or launches["dia_precond"] != 0:
        raise AssertionError(f"backward launches {launches}: dia_spmv must "
                             "run and dia_precond must not")
    n_it = sum(iters)
    # the kernel path twice: atomic scatter-adds sum in another order
    rerun = rel_err(backward(sc, spec, params, buf)[0].pos_grad0, pg0)
    log(f"[adjoint] f32 T={T_STEPS} backward with kernels on the [main] "
        f"tape: {secs:.3f} s; fwd+bwd {T_STEPS / (fwd_secs + secs):.4f} "
        f"steps/s (forward {fwd_secs:.3f} s); GMRES iters per step "
        f"(t = {T_STEPS}..1) {iters}, {n_it} in all; launches {launches}, "
        f"{launches['dia_spmv'] / n_it:.3f} dia_spmv per GMRES iteration; "
        f"peak memory {peak / 2**20:.1f} MiB; {nonzero} steps with a gripper "
        f"gradient, max |gripper_grad| {float(gg.abs().max()):.4e}, max "
        f"|pos_grad0| {float(pg0.abs().max()):.4e}; kernel path run twice: "
        f"pos_grad0 {rerun:.3e}; {contact_gap(sc, buf)}; GMRES (iterations, "
        f"final relative residual) per step in the warm-up: {resid}")

    spec_p = spec.replace(spmv="plain")
    reset_launches()
    res_p, secs_p = backward(sc, spec_p, params, buf)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"plain backward launched kernels: {K.LAUNCHES}")
    e_gg = rel_err(gg, res_p.gripper_grad)
    e_pg = rel_err(pg0, res_p.pos_grad0)
    log(f"[adjoint] f32 plain path on the same tape: {secs_p:.3f} s; kernels "
        f"vs plain max rel err gripper_grad {e_gg:.3e}, pos_grad0 "
        f"{e_pg:.3e} (tol {ADJ_PLAIN_RTOL:.0e})")
    if not (e_gg <= ADJ_PLAIN_RTOL and e_pg <= ADJ_PLAIN_RTOL):
        raise AssertionError("kernel and plain backwards disagree")

    f64_check(sc, params, buf, res, device, "[adjoint-f64]")
    return launches, secs


def f64_check(sc, params, buf, res, device, tag):
    """The same tape cast to f64, backward with kernels: the f32 backward's
    own error (printed, not gated)."""
    spec64, _, params64 = sc.to(device, torch.float64)
    buf64 = {k: v.double() if v.is_floating_point() else v
             for k, v in buf.items()}
    (res64, secs64), resid = gmres_residuals(
        lambda: backward(sc, spec64, params64, buf64))
    log(f"{tag} f64 backward with kernels on the same tape: {secs64:.3f} s; "
        f"the f32 backward's max rel err against it: gripper_grad "
        f"{rel_err(res.gripper_grad.double(), res64.gripper_grad):.3e}, "
        f"pos_grad0 {rel_err(res.pos_grad0.double(), res64.pos_grad0):.3e} "
        f"(printed, not gated); GMRES (iterations, final relative residual) "
        f"per step: {resid}")


def contact_gap(sc, buf):
    """Where the pad's lowest vertex is against the cloth, per step."""
    b, pos = sc.builder, buf["pos"]
    (cs, ce), (ps, pe) = b.vrange(0), b.vrange(2)
    return ("pad lowest z minus cloth highest z (mm) per step: " + str([
        round(float(p[ps:pe, 2].min() - p[cs:ce, 2].max()) * 1e3, 3)
        for p in pos]))


def press_phase(sc, spec, s0, params, device):
    """The full-size f32 forward+backward with the pad pressing PRESS_Z a
    step: the gripper gradient is non-zero, and the kernel and plain
    backwards agree on it."""
    buf, stats, secs = rollout(spec, s0, params, device, T_PRESS, PRESS_Z)
    reset_launches()
    res, secs_b = backward(sc, spec, params, buf)
    launches = launch_counts()
    check_element_launches("[adjoint-press]", launches, T_PRESS)
    (res_p, _), resid = gmres_residuals(
        lambda: backward(sc, spec.replace(spmv="plain"), params, buf))
    gg, pg0 = res.gripper_grad, res.pos_grad0
    nonzero = int((gg.abs().amax(dim=(1, 2)) > 0).sum())
    e_gg = rel_err(gg, res_p.gripper_grad)
    e_pg = rel_err(pg0, res_p.pos_grad0)
    log(f"[adjoint-press] f32 T={T_PRESS}, pad {PRESS_Z * 1e3:.1f} mm a step: "
        f"forward {secs:.3f} s (CG iters {stats['cg_iters']}), backward "
        f"{secs_b:.3f} s, launches {launches}; {nonzero} steps with a gripper "
        f"gradient, max |gripper_grad| {float(gg.abs().max()):.4e}; kernels "
        f"vs plain max rel err gripper_grad {e_gg:.3e}, pos_grad0 {e_pg:.3e} "
        f"(tol {ADJ_PLAIN_RTOL:.0e}); {contact_gap(sc, buf)}; GMRES "
        f"(iterations, final relative residual) per step, plain path: "
        f"{resid}")
    if not all(bool(torch.isfinite(v).all()) for v in (gg, pg0)):
        raise AssertionError("non-finite gradients in the pressing backward")
    if nonzero < 1 or launches["dia_spmv"] <= 0:
        raise AssertionError("the pressing backward has no gripper gradient")
    if not (e_gg <= ADJ_PLAIN_RTOL and e_pg <= ADJ_PLAIN_RTOL):
        raise AssertionError("kernel and plain pressing backwards disagree")
    f64_check(sc, params, buf, res, device, "[adjoint-press-f64]")


class PhaseTimer:
    """Inclusive wall time per wrapped function, with a synchronize() on
    both sides of each call (so the phases cost more than they do
    unwrapped, and nested phases are counted in their callers too)."""

    def __init__(self):
        self.ms, self.calls, self._orig = {}, {}, []

    def timed(self, fn, label):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) + (
                time.perf_counter() - t0) * 1e3
            self.calls[label] = self.calls.get(label, 0) + 1
            return out

        return run

    def wrap(self, owner, name, label, factory=False):
        """Time owner.name, or with factory=True the function it returns."""
        fn = getattr(owner, name)
        setattr(owner, name, (lambda *a, **k: self.timed(fn(*a, **k), label))
                if factory else self.timed(fn, label))
        self._orig.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._orig):
            setattr(owner, name, fn)
        self._orig = []

    def report(self, tag):
        for label, ms in sorted(self.ms.items(), key=lambda kv: -kv[1]):
            n = self.calls[label]
            log(f"[phases] {tag} {label}: {ms:.1f} ms, {n} calls, "
                f"{ms / n:.3f} ms per call")
        self.ms, self.calls = {}, {}


def phase_timers(sc, spec, s0, params, device):
    """One more forward + backward with a synchronize() around each phase."""
    from thinshelllab_torch.engine import (adjoint, elements, gridsolve,
                                           solver, stepper)
    from thinshelllab_torch.ops import spd

    pt = PhaseTimer()
    fwd = [(elements, "all_groups", "element Hessians (all_groups)"),
           (solver, "_solve_cg_prepared_T", "PCG solve"),
           (elements, "total_energy", "total_energy"),
           (stepper, "build_contacts", "contacts"),
           (elements, "assemble_residual", "assemble_residual"),
           (solver, "prepare_solver_state", "operator build")]
    bwd = [(adjoint, "_rebuild_contact", "contact rebuild"),
           (elements, "all_groups", "element Hessians (all_groups)"),
           (solver, "prepare_solver_state", "operator build"),
           (spd, "abs_inv_3x3", "|D|^-1 blocks"),
           (gridsolve, "add_contact_couplings", "contact couplings"),
           (gridsolve.GridPreconditioner, "__init__", "BCR factor"),
           (gridsolve, "extract_cloth_tridiag", "BCR factor: tridiagonal"),
           (gridsolve, "factor_tridiag", "BCR factor: reduction"),
           (gridsolve, "_safe_inv", "BCR factor: block inverses"),
           (solver, "_gmres_loop", "GMRES loop"),
           (elements, "hvp_dia", "operator apply (hvp_dia)"),
           (gridsolve.GridPreconditioner, "apply", "BCR apply"),
           (elements, "frozen_column_product", "frozen-column product"),
           (adjoint, "_contact_energy_backprop", "contact chain"),
           (adjoint, "_hinge_grads", "hinge gradients")]
    try:
        for owner, name, label in fwd:
            pt.wrap(owner, name, label)
        pt.wrap(elements, "linesearch_ef_fn", "line-search trial",
                factory=True)
        buf, _, secs = rollout(spec, s0, params, device)
        pt.restore()
        pt.report(f"forward ({secs:.3f} s with the syncs):")
        for owner, name, label in bwd:
            pt.wrap(owner, name, label)
        _, secs = backward(sc, spec, params, buf)
        pt.restore()
        pt.report(f"backward ({secs:.3f} s with the syncs):")
    finally:
        pt.restore()


def traced(fn):
    """fn() under torch.profiler: (fn's result, wall s, device us, kernel
    launches, {DIA kernel: (us, launches)}, the 6 largest entries)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total_us, total_n, mine, top = 0.0, 0, {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        total_us += us
        total_n += e.count
        top.append((us, e.count, e.key[:60]))
        for k in ("dia_spmv_kernel", "dia_precond_kernel"):
            if k in e.key:
                a, n = mine.get(k, (0.0, 0))
                mine[k] = (a + us, n + e.count)
    return out, wall, total_us, total_n, mine, sorted(top)[::-1][:6]


def report_trace(tag, wall, total_us, total_n, mine, top=()):
    if total_us <= 0:
        log(f"{tag} under the profiler: wall {wall:.3f} s; the trace holds "
            "no device time (the profiler can stop tracing the card late in "
            "a long process): device time and busy share not measured")
        return
    shares = ", ".join(f"{k} {us / 1e3:.2f} ms over {n} launches = "
                       f"{us / total_us:.4f} of device time"
                       for k, (us, n) in sorted(mine.items()))
    log(f"{tag} under the profiler: wall {wall:.3f} s, device time "
        f"{total_us / 1e3:.1f} ms over {total_n} kernel launches, busy "
        f"share {total_us / 1e6 / wall:.4f}; {shares or 'no DIA kernel'}")
    for us, n, key in top:
        log(f"{tag}: {us / 1e3:.2f} ms over {n} launches: {key}")


def profile_phase(sc, spec, s0, params, device):
    """One forward and one backward of T_PROFILE steps, each under
    torch.profiler: device time, launches, busy share, and each kernel's
    share of the device time."""
    buf, *fwd = traced(lambda: rollout(spec, s0, params, device,
                                       T=T_PROFILE)[0])
    _, *bwd = traced(lambda: backward(sc, spec, params, buf))
    tag = f"[profile] f32 T={T_PROFILE}"
    report_trace(f"{tag} forward", *fwd)
    report_trace(f"{tag} backward", *bwd)
    both = {k: tuple(a + b for a, b in zip(fwd[3].get(k, (0.0, 0)),
                                          bwd[3].get(k, (0.0, 0))))
            for k in set(fwd[3]) | set(bwd[3])}
    report_trace(f"{tag} forward + backward", fwd[0] + bwd[0],
                 fwd[1] + bwd[1], fwd[2] + bwd[2], both)


def full_newton_phase(device):
    """The full-size bench forward on the full-Newton branch
    (hess_refresh=1: Hessian, operator and PCG every Newton iteration, an
    energy-only line search) through both kernels, 2 steps."""
    from thinshelllab_torch.scenes import bench_scene

    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float32,
                          hess_refresh=1, fwd_tol=1e-3, max_newton_iter=8)
    spec, s0, params = sc.to(device, torch.float32)
    reset_launches()
    buf, stats, secs = rollout(spec, s0, params, device, T=2)
    launches = launch_counts()
    log(f"[full-newton] bench f32 T=2 hess_refresh=1: {secs:.3f} s, Newton "
        f"iters {stats['newton_iters']}, operator builds "
        f"{stats['hess_builds']}, CG iters {stats['cg_iters']}, line-search "
        f"trials {stats['ls_trials']}, launches {launches}")
    if not bool(torch.isfinite(buf["pos"]).all()):
        raise AssertionError("non-finite positions on the full-Newton branch")
    if stats["hess_builds"] != stats["newton_iters"] or min(
            launches.values()) <= 0:
        raise AssertionError(f"full-Newton branch: stats {stats}, launches "
                             f"{launches}")
    check_element_launches("[full-newton]", launches, stats["hess_builds"])
    return launches


def folding_golden_check(device):
    """The small f64 folding trajopt (TrajOptDriver, dense solve, plastic
    rest angles) against the JAX package's saved run."""
    from thinshelllab_torch.scenes import folding
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    g = np.load(GOLDEN_FOLD)
    sc = folding.make(table_n=int(g["table_n"]),
                      max_newton_iter=int(g["max_newton_iter"]),
                      dtype=torch.float64)
    T = int(g["T"])
    drv = TrajOptDriver(sc, T, lr=float(g["lr"]),
                        max_dist=float(g["max_dist"]), device=device)
    t0 = time.perf_counter()
    infos = [drv.iteration() for _ in range(len(g["rewards"]))]
    secs = time.perf_counter() - t0
    buf = infos[0]["buffers"]
    pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    ref_err = float(np.abs(buf["ref_angle"].cpu().numpy()
                           - g["ref_angle"]).max())
    gate_ok = bool(np.array_equal(buf["yield_gate"].cpu().numpy(),
                                  g["yield_gate"]))
    rewards = np.asarray(drv.history)
    rew_rel = float((np.abs(rewards - g["rewards"])
                     / np.abs(g["rewards"])).max())
    gg = infos[0]["gripper_grad"].cpu().numpy()
    gg_rel = float(np.abs(gg - g["gripper_grad"]).max()
                   / np.abs(g["gripper_grad"]).max())
    traj_err = float(np.abs(drv.agent.traj - g["traj"]).max())
    log(f"[folding-golden] f64 table_n={int(g['table_n'])} T={T}, "
        f"{len(rewards)} TrajOptDriver iterations on the card in "
        f"{secs:.2f} s vs the JAX run: max |dpos| {pos_err:.3e} m (tol "
        f"{FOLD_POS_ATOL:.0e}), ref_angle {ref_err:.3e} rad (tol "
        f"{FOLD_REF_ATOL:.0e}), yield_gate equal {gate_ok}, rewards "
        f"{rewards.tolist()} max rel err {rew_rel:.3e} (tol "
        f"{FOLD_REWARD_RTOL:.0e}), gripper_grad max rel err {gg_rel:.3e} "
        f"(tol {FOLD_GRAD_RTOL:.0e}), waypoint table after the Adam steps "
        f"max |d| {traj_err:.3e} m (tol {FOLD_TRAJ_ATOL:.0e}); Newton "
        f"iterations per step {infos[0]['stats']['newton_per_step']}")
    if not (pos_err <= FOLD_POS_ATOL and ref_err <= FOLD_REF_ATOL and gate_ok
            and rew_rel <= FOLD_REWARD_RTOL and gg_rel <= FOLD_GRAD_RTOL
            and traj_err <= FOLD_TRAJ_ATOL):
        raise AssertionError("the small folding trajopt disagrees with the "
                             "JAX golden run")


def folding_trajopt(device):
    """The published folding scene in f32 as the CLI builds it on a card,
    FOLD_ITERS TrajOptDriver iterations at T=FOLD_T: (scene, driver, the
    first iteration's info, the kernels' launches over the iterations)."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    t0 = time.perf_counter()
    sc = registry.make_scene("folding", solver="auto", dtype=torch.float32)
    s = sc.spec
    log(f"[folding-trajopt] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: NV {s.NV} ({3 * s.NV} DOF), "
        f"solver '{s.solver}' (from 'auto'), {s.dtype}, contact capacity "
        f"{s.contact.capacity}, hinges {s.cloth.hinge_verts.shape[0]}, tets "
        f"{s.neo.tets.shape[0]} + {s.tact.tets.shape[0]}, newton_tol "
        f"{s.newton_tol}, max_newton_iter {s.max_newton_iter}")
    if s.solver != "dense":
        raise AssertionError(f"folding resolved to solver '{s.solver}'")
    drv = TrajOptDriver(sc, FOLD_T, lr=1e-3, max_dist=0.015, device=device)
    reset_launches()
    first, calls = None, 0
    for i in range(FOLD_ITERS):
        torch.cuda.reset_peak_memory_stats(device)
        info = drv.iteration()
        peak = torch.cuda.max_memory_allocated(device)
        st, per = info["stats"], info["stats"]["newton_per_step"]
        at_cap = sum(n >= s.max_newton_iter for n in per)
        log(f"[folding-trajopt] f32 T={FOLD_T} iter {i}: forward "
            f"{info['forward_s']:.3f} s, backward {info['backward_s']:.3f} s; "
            f"Newton iterations per step mean {np.mean(per):.2f}, max "
            f"{max(per)}, {at_cap} of {len(per)} steps at the cap, "
            f"{st['newton_iters']} in all; line-search trials "
            f"{st['ls_trials']}; peak memory {peak / 2**20:.1f} MiB; per "
            f"step {per}")
        log(f"iter {i}: reward {info['reward']:.6f} |g| "
            f"{info['grad_norm']:.4g} t {info['wall_time']:.2f}s")
        gg = info["gripper_grad"]
        if not (np.isfinite(info["reward"]) and bool(torch.isfinite(gg).all())
                and info["grad_norm"] > 0):
            raise AssertionError(f"folding iteration {i}: reward "
                                 f"{info['reward']}, |g| {info['grad_norm']}")
        if first is None:
            first = info
        # a Hessian each build in the forward and each step of the backward
        calls += st["hess_builds"] + len(per)
    launches = launch_counts()
    log(f"[folding-trajopt] launches over the {FOLD_ITERS} iterations: "
        f"{launches}; all_groups calls with the Hessian (Hessian builds + "
        f"backward steps) {calls}")
    check_element_launches("[folding-trajopt]", launches, calls)
    if launches["dia_spmv"] or launches["dia_precond"]:
        raise AssertionError(f"the dense folding path launched DIA kernels: "
                             f"{launches}")
    return sc, drv, first, launches


def folding_f32_adjoint(sc, info, device):
    """The first iteration's f32 tape cast to f64 and its backward: the
    f32 gripper gradient's error."""
    from thinshelllab_torch.engine import adjoint

    buf = info["buffers"]
    spec64, _, params64 = sc.to(device, torch.float64)
    buf64 = {k: v.double() if v.is_floating_point() else v
             for k, v in buf.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res64 = adjoint.backward(spec64, params64, buf64, *sc.seed_loss(buf64))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g32, g64 = info["gripper_grad"].double(), res64.gripper_grad
    err = float(torch.linalg.vector_norm(g32 - g64)
                / torch.linalg.vector_norm(g64))
    worst = int((g32 - g64).abs().amax(dim=(1, 2)).argmax())
    log(f"[folding-f32-adjoint] f64 backward on the first iteration's f32 "
        f"tape: {secs:.3f} s; the f32 gripper_grad's error against it "
        f"|g32 - g64| / |g64| {err:.3e} (tol {FOLD_F32_RTOL:.0e}), max "
        f"|g32 - g64| / max |g64| {rel_err(g32, g64):.3e} (printed, not "
        f"gated; largest at step {worst}: f32 {g32[worst, 0].tolist()}, f64 "
        f"{g64[worst, 0].tolist()}); |g| f32 {float(info['grad_norm']):.6g},"
        f" f64 {float(torch.linalg.vector_norm(g64)):.6g}")
    if not err <= FOLD_F32_RTOL:
        raise AssertionError(f"f32 folding gradient off by {err:.3e}")


def folding_phases(sc, drv, device):
    """FOLD_PHASE_STEPS steps of the driver's current waypoint table:
    forward + backward under phase timers, the f32 reward of one more run
    of that rollout, and the backward and a forward step cut to
    FOLD_PROFILE_NEWTON Newton iterations under the profiler."""
    from thinshelllab_torch.engine import adjoint, elements, solver, stepper
    from thinshelllab_torch.ops import spd

    acts = tuple(a[:FOLD_PHASE_STEPS] for a in drv.agent.actions())
    tag = f"f32 {FOLD_PHASE_STEPS} steps"
    pt = PhaseTimer()
    fwd = [(elements, "all_groups", "element Hessians (all_groups)"),
           (spd, "project_psd", "eigh projection (project_psd)"),
           (elements, "dense_hessian", "dense_hessian"),
           (solver, "solve_dense", "dense solve (dense_hessian + LU)"),
           (elements, "total_energy", "total_energy"),
           (stepper, "build_contacts", "contacts"),
           (elements, "assemble_residual", "assemble_residual")]
    bwd = [(adjoint, "_rebuild_contact", "contact rebuild"),
           (elements, "all_groups", "element Hessians (all_groups)"),
           (elements, "dense_hessian", "dense_hessian"),
           (solver, "solve_dense", "dense solve (dense_hessian + LU)"),
           (elements, "frozen_column_product", "frozen-column product"),
           (adjoint, "_contact_energy_backprop", "contact chain"),
           (adjoint, "_hinge_grads", "hinge gradients (plastic chain)"),
           (adjoint, "_gather_gripper_grad", "gripper gradient gather")]
    try:
        for owner, name, label in fwd:
            pt.wrap(owner, name, label)
        pt.wrap(elements, "linesearch_energy_fn", "line-search trial",
                factory=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, buf = drv.forward(acts)
        torch.cuda.synchronize()
        pt.restore()
        pt.report(f"folding forward {tag} ({time.perf_counter() - t0:.3f} s "
                  f"with the syncs):")
        for owner, name, label in bwd:
            pt.wrap(owner, name, label)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.backward(buf, *sc.seed_loss(buf))
        torch.cuda.synchronize()
        pt.restore()
        pt.report(f"folding backward {tag} ({time.perf_counter() - t0:.3f} s "
                  f"with the syncs):")
    finally:
        pt.restore()
    buf2 = drv.forward(acts)[1]
    rewards = [float(sc.reward(b)) for b in (buf, buf2)]
    dpos = float((buf2["pos"] - buf["pos"]).abs().max())
    log(f"[folding-spread] {tag}, the same actions twice: rewards "
        f"{rewards}, difference {rewards[1] - rewards[0]:.3e}; max |dpos| "
        f"between the runs {dpos:.3e} m")
    # the profiler's trace of a whole step (~600,000 launches) takes minutes
    # to read back: the first step with the Newton cap cut instead
    spec_p = drv.spec.replace(max_newton_iter=FOLD_PROFILE_NEWTON)
    acts1 = tuple(a[:1] for a in acts)
    _, *fw = traced(lambda: stepper.simulate(spec_p, drv.params, drv.state0,
                                             acts1))
    _, *bw = traced(lambda: drv.backward(buf, *sc.seed_loss(buf)))
    report_trace(f"[folding-profile] f32 1 step, {FOLD_PROFILE_NEWTON} Newton "
                 f"iterations, forward", *fw)
    report_trace(f"[folding-profile] {tag} backward", *bw)


def scene_state(name, sc, device):
    """Balancing starts from the bundled pre-grasped state, as `cli
    trajopt` does; every other scene from its own initial state."""
    from thinshelllab_torch.scenes import balancing
    from thinshelllab_torch.utils import checkpoint

    if name == "balancing":
        sc.state0 = checkpoint.load_state(balancing.bundled_state_path(),
                                          sc.spec.dtype, device)
    return sc


def scene_actions(n_part, T, dtype, device):
    dpos = torch.zeros((T, n_part, 3), dtype=dtype, device=device)
    dpos[:, :, 2] = SCENE_DZ
    return (dpos, torch.zeros((T, n_part, 3), dtype=dtype, device=device),
            torch.zeros((T, n_part), dtype=dtype, device=device))


def scene_run(sc, spec, s0, params, T, buf=None):
    """Forward (unless a tape is given) and the default seed's backward:
    (buffers, AdjointResult, solver stats, forward s, backward s)."""
    from thinshelllab_torch.engine import adjoint, stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if buf is None:
        acts = scene_actions(sc.n_part, T, spec.dtype, s0.pos.device)
        _, buf = stepper.simulate(spec, params, s0, acts, stats=stats,
                                  save_contacts=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                           with_param_grad=sc.sys_param is not None)
    torch.cuda.synchronize()
    return buf, res, stats, t1 - t0, time.perf_counter() - t1


def scenes_golden_check(device):
    """The CPU tests' small f64 runs of every new scene on the card against
    the JAX package's saved runs (tests/data/scenes_golden.npz)."""
    from thinshelllab_torch.core.convert import (golden_grad_errors,
                                                 tape_from_entries)
    from thinshelllab_torch.engine import stepper
    from thinshelllab_torch.scenes import registry

    z = np.load(GOLDEN_SCENES)
    for name in NEW_SCENES:
        g = {k[len(name) + 1:]: z[k] for k in z.files
             if k.startswith(name + ".")}
        sc = scene_state(name, registry.make_scene(
            name, solver="auto", max_newton_iter=SCENE_GOLDEN_NEWTON,
            dtype=torch.float64), device)
        spec, s0, params = sc.to(device)
        buf, res, stats, fs, bs = scene_run(sc, spec, s0, params,
                                            SCENE_GOLDEN_T)
        pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
        gg_rel, pg_rel, sys_rel = golden_grad_errors(res, g, sc.sys_param)
        line = (f"[scenes-golden] {name} f64 T={SCENE_GOLDEN_T} "
                f"max_newton_iter={SCENE_GOLDEN_NEWTON} vs the JAX run "
                f"({fs:.2f} s + {bs:.2f} s): max |dpos| {pos_err:.3e} m, "
                f"gripper_grad rel err {gg_rel:.3e}, param_grad {pg_rel:.3e}"
                f", sys_param {sys_rel:.3e}; Newton per step "
                f"{stats['newton_per_step']}")
        if name in SCENE_TIES:
            tape = tape_from_entries(g, device)
            acts = scene_actions(sc.n_part, SCENE_GOLDEN_T, spec.dtype,
                                 device)
            replay = [float((stepper.replay_step(
                spec, params, tape, t, tuple(a[t] for a in acts), s0.vel)
                - tape["pos"][t + 1]).abs().max())
                for t in range(SCENE_GOLDEN_T)]
            _, rt, _, _, bt = scene_run(sc, spec, s0, params, SCENE_GOLDEN_T,
                                        buf=tape)
            t_gg, t_pg, t_sys = golden_grad_errors(rt, g, sc.sys_param)
            log(f"{line} (not gated: {SCENE_TIES[name]}, ROADMAP.md §3); "
                f"each step replayed from the JAX state with the JAX "
                f"contact set: max |dpos| "
                f"{', '.join(f'{e:.3e}' for e in replay)} m (tol "
                f"{SCENE_POS_ATOL:.0e}); backward on the JAX tape ({bt:.2f} "
                f"s): gripper_grad {t_gg:.3e}, param_grad {t_pg:.3e}, "
                f"sys_param {t_sys:.3e} (tol {SCENE_GRAD_RTOL:.0e})")
            if not max(replay) <= SCENE_POS_ATOL:
                raise AssertionError(f"{name}: a step replayed on the JAX "
                                     "tape disagrees with the JAX positions")
            if not max(t_gg, t_pg, t_sys) <= SCENE_GRAD_RTOL:
                raise AssertionError(f"{name}: the backward on the JAX tape "
                                     "disagrees with the JAX gradients")
            continue
        log(f"{line} (tol {SCENE_POS_ATOL:.0e} m, {SCENE_GRAD_RTOL:.0e})")
        if not (pos_err <= SCENE_POS_ATOL
                and max(gg_rel, pg_rel, sys_rel) <= SCENE_GRAD_RTOL):
            raise AssertionError(f"{name} disagrees with the JAX golden run")


def scenes_phase(device):
    """Every new scene at its published size and Newton cap in f64 on the
    card: SCENES_T steps forward, the default seed, the backward."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train import dp

    for name in NEW_SCENES:
        sc = scene_state(name, registry.make_scene(name, solver="auto",
                                                   dtype=torch.float64),
                         device)
        s = sc.spec
        spec, s0, params = sc.to(device)
        reset_launches()
        buf, res, stats, fs, bs = scene_run(sc, spec, s0, params, SCENES_T)
        launches = launch_counts()
        check_element_launches(f"[scenes] {name}", launches)
        per = stats["newton_per_step"]
        at_cap = sum(n >= s.max_newton_iter for n in per)
        pos = buf["pos"]
        disp = float((pos[-1] - pos[0]).abs().max())
        gg = float(res.gripper_grad.abs().max())
        pg = (abs(float(dp._get_param(res.param_grad, sc.sys_param)))
              if sc.sys_param else float("nan"))
        reward = float(sc.reward(buf))
        log(f"[scenes] {name}: NV {s.NV} ({3 * s.NV} DOF), solver "
            f"'{s.solver}', f64 T={SCENES_T}; Newton per step {per} ({at_cap}"
            f" of {len(per)} at the cap {s.max_newton_iter}); forward "
            f"{fs:.3f} s, backward {bs:.3f} s; reward {reward:.6g}; max "
            f"|gripper_grad| {gg:.4g}; |param_grad| of "
            f"{sc.sys_param} {pg:.4g}; max displacement {disp:.3e} m; "
            f"launches {launches}")
        finite = bool(torch.isfinite(res.gripper_grad).all()) and all(
            bool(torch.isfinite(getattr(res.param_grad, f.name)).all())
            for f in dataclasses.fields(res.param_grad))
        if not (bool(torch.isfinite(pos).all()) and disp < SCENE_DISP_MAX
                and finite and np.isfinite(reward)):
            raise AssertionError(f"{name}: positions finite "
                                 f"{bool(torch.isfinite(pos).all())}, "
                                 f"displacement {disp}, gradients finite "
                                 f"{finite}, reward {reward}")


def scenes_trajopt_phase(device):
    """One f32 TrajOptDriver iteration at T=SCENES_TRAJOPT_T, as `cli
    trajopt` runs it on a card but with Newton capped at TRAJOPT_NEWTON,
    for every new scene with a gripper."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    for name in NEW_SCENES:
        sc = registry.make_scene(name, solver="auto", dtype=torch.float32,
                                 max_newton_iter=TRAJOPT_NEWTON)
        if sc.n_part == 0:
            continue
        sc = scene_state(name, sc, device)
        drv = TrajOptDriver(sc, SCENES_TRAJOPT_T, lr=1e-3, max_dist=0.015,
                            device=device)
        info = drv.iteration()
        per = info["stats"]["newton_per_step"]
        cap = sc.spec.max_newton_iter
        log(f"[scenes-trajopt] {name} f32 T={SCENES_TRAJOPT_T}: Newton per "
            f"step {per} ({sum(n >= cap for n in per)} of {len(per)} at the "
            f"cap {cap}), line-search trials {info['stats']['ls_trials']}; "
            f"forward {info['forward_s']:.3f} s, backward "
            f"{info['backward_s']:.3f} s")
        log(f"iter 0: reward {info['reward']:.6f} |g| "
            f"{info['grad_norm']:.4g} t {info['wall_time']:.2f}s")
        if not (np.isfinite(info["reward"])
                and np.isfinite(info["grad_norm"])):
            raise AssertionError(f"{name}: reward {info['reward']}, |g| "
                                 f"{info['grad_norm']}")


def dp_phase(device):
    """System identification as `cli dp` runs it on a card (f32, solver
    auto, a zero trajectory) on bouncing's Kb: ParamOptDriver iterations,
    then one ParamCMAESDriver generation."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.dp import (ParamCMAESDriver,
                                             ParamOptDriver, _get_param)

    def zeros(n):
        return tuple(torch.zeros(sh, dtype=torch.float64, device=device)
                     for sh in ((DP_T - 1, n, 3), (DP_T - 1, n, 3),
                                (DP_T - 1, n)))

    sc = registry.make_scene("bouncing", solver="auto", dtype=torch.float32)
    t0 = time.perf_counter()
    drv = ParamOptDriver(sc, zeros(0), lr=DP_LR, device=device)
    for i in range(DP_ITERS):
        info = drv.iteration()
        log(f"iter {i}: reward {info['reward']:.5f} "
            f"param {info['param']:.4f} grad {info['grad']:.3g}")
        if not all(np.isfinite(v) for v in info.values()):
            raise AssertionError(f"dp bouncing: {info}")
    log(f"[dp] bouncing f32 T={DP_T}: {DP_ITERS} ParamOptDriver iterations "
        f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    drv = ParamCMAESDriver(sc, zeros(0),
                           base_value=float(_get_param(sc.params,
                                                       sc.sys_param)),
                           pop_size=DP_POP, device=device)
    info = drv.generation()
    log(f"gen 0: best_param {info['best_param']:.4f} "
        f"best_reward {info['best_reward']:.5f}")
    log(f"[dp] bouncing f32 T={DP_T}: one ParamCMAESDriver generation of "
        f"{DP_POP} in {time.perf_counter() - t0:.2f} s")
    if not all(np.isfinite(v) for v in info.values()):
        raise AssertionError(f"dp bouncing CMA-ES: {info}")


def cmaes_golden_check(device):
    """[cmaes-golden]: the CPU test's CMAESDriver generation in f64 on the
    card against the JAX run (each member's reward, stop step and early
    flag, the strategy's mean and sigma after tell), and rollout_stop_step
    on the JAX package's rammed-pad tape."""
    from thinshelllab_torch.core.convert import buffers_from_reference
    from thinshelllab_torch.scenes import folding
    from thinshelllab_torch.train.cmaes import CMAESDriver, rollout_stop_step

    z = np.load(GOLDEN_CMAES)
    t0 = time.perf_counter()
    drv = CMAESDriver(folding.make(**POLICY_GOLDEN_CFG), CMAES_TOT,
                      CMAES_ABS, pop_size=CMAES_POP, seed=0, device=device)
    info = drv.generation()
    secs = time.perf_counter() - t0
    want = z["gen.rewards"]
    rel = float(np.max(np.abs(info["rewards"] - want) / np.abs(want)))
    es_err = max(float(np.abs(drv.es.mean - z["gen.mean"]).max()),
                 abs(drv.es.sigma - float(z["gen.sigma"])))
    same = (info["stop_steps"] == z["gen.stop_steps"].tolist()
            and info["early"] == z["gen.early"].tolist())
    keys = [k[len("ram."):] for k in z.files if k.startswith("ram.")
            and k not in ("ram.stop_step", "ram.early")]
    tape = {k: v.to(device) for k, v in buffers_from_reference(
        {k: z["ram." + k] for k in keys}).items()}
    spec, _, params = folding.make(**RAM_CFG).to(device)
    stop, early = rollout_stop_step(spec, params, tape)
    ram_ok = (stop, early) == (int(z["ram.stop_step"]), bool(z["ram.early"]))
    log(f"[cmaes-golden] folding table_n=4 f64 pop {CMAES_POP} tot_step "
        f"{CMAES_TOT} abs_step {CMAES_ABS}: one generation in {secs:.2f} s; "
        f"rewards {info['rewards'].tolist()} against the JAX run: max rel "
        f"err {rel:.3e} (tol {CMAES_REWARD_RTOL:.0e}); stop steps "
        f"{info['stop_steps']}, early {info['early']} equal: {same}; ES mean "
        f"and sigma after tell {es_err:.3e} (tol {CMAES_ES_TOL:.0e}); "
        f"rollout_stop_step on the JAX rammed-pad tape ({stop}, {early}) "
        f"equal: {ram_ok}")
    if not (rel <= CMAES_REWARD_RTOL and same and es_err <= CMAES_ES_TOL
            and ram_ok):
        raise AssertionError("CMAESDriver disagrees with the JAX run")


def cmaes_phase(device, name, **kw):
    """One CMAESDriver generation (pop CMAES_POP, tot_step CMAES_TOT,
    abs_step CMAES_ABS) on a published scene in f32, as `cli cmaes` runs
    it on a card: finite rewards. Returns (the launches of the four kernels
    in the generation, its seconds, the member rewards)."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.cmaes import CMAESDriver

    sc = registry.make_scene(name, dtype=torch.float32, **kw)
    drv = CMAESDriver(sc, CMAES_TOT, CMAES_ABS, pop_size=CMAES_POP, seed=0,
                      device=device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = drv.generation()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    tag = "cmaes-cg" if kw.get("solver") == "cg" else "cmaes"
    s = sc.spec
    plan = (f"DIA n_off {len(s.dia.offsets)}, NVp {s.dia.NVp}"
            if s.dia is not None else "no DIA plan")
    log(f"[{tag}] {name} f32 solver '{s.solver}' max_newton_iter "
        f"{s.max_newton_iter}, {plan}: one generation of {CMAES_POP} "
        f"(tot_step {CMAES_TOT}, abs_step {CMAES_ABS}) in {secs:.3f} s "
        f"({secs / CMAES_POP:.3f} s a member); rewards "
        f"{info['rewards'].tolist()}, stop steps {info['stop_steps']}, "
        f"early {info['early']}; launches {launches}")
    log(f"gen 0: best {info['best_reward']:.4f} mean {info['gen_mean']:.4f}")
    if not np.all(np.isfinite(info["rewards"])):
        raise AssertionError(f"{tag} {name}: rewards {info['rewards']}")
    check_element_launches(f"[{tag}] {name}", launches)
    return launches, secs, info["rewards"]


def _rl_obs_err(obs32, obs64, want32, want64):
    """Largest |obs64 - want64| (m); raises where the float32 observation
    is not obs64's rounding or is off want32 by more than one rounding."""
    if not np.array_equal(obs32, obs64.astype(np.float32)):
        raise AssertionError("float32 observation is not the rounded state")
    if not np.all(np.abs(obs32 - want32)
                  <= 2.0**-23 * np.abs(want64) + RL_OBS_ATOL):
        raise AssertionError("float32 observation off the JAX one")
    return float(np.abs(obs64 - want64).max())


def rl_golden_check(device):
    """[rl-golden]: the CPU test's Env, EvalEnv and BatchedEnv runs in f64
    on the card against the JAX runs (tests/data/rl_golden.npz)."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.scenes.base import observation
    from thinshelllab_torch.train.rl_env import BatchedEnv, Env, EvalEnv

    z = np.load(GOLDEN_RL)

    def obs64(env, state):
        return observation(env.spec, state).cpu().numpy()

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1e-300)))

    errs, rels, same = [], [], True
    env = Env("folding", time_step=RL_LIMIT, device=device,
              **POLICY_GOLDEN_CFG)
    obs, _ = env.reset()
    errs.append(_rl_obs_err(obs, obs64(env, env.state), z["env.obs0"],
                            z["env.obs64_0"]))
    a = np.zeros((RL_LIMIT, 6))
    a[:, 0], a[:, 2], a[:, 4] = 1e-4, -6e-4, 2e-3
    for t in range(RL_LIMIT):
        obs, rew, done, _, _ = env.step(a[t].astype(np.float32))
        o64 = obs64(env, env.state)
        errs.append(float(np.abs(o64 - z["env.obs64"][t]).max()))
        if not done:
            errs.append(_rl_obs_err(obs, o64, z["env.obs"][t],
                                    z["env.obs64"][t]))
        elif obs.any() or rew != 0.0:
            raise AssertionError("a done Env step returned a reward or obs")
        if z["env.rew"][t] != 0.0:
            rels.append(rel(rew, z["env.rew"][t]))
        same &= done == bool(z["env.done"][t])
    env = EvalEnv("folding", time_step=RL_LIMIT, device=device,
                  **POLICY_GOLDEN_CFG)
    env.reset()
    for t in range(2):
        obs, delta, _, _, _ = env.step(np.array([0, 0, -1.2e-3, 0, 0, 0]))
        errs.append(_rl_obs_err(obs, obs64(env, env.state), z["eval.obs"][t],
                                z["eval.obs64"][t]))
        rels.append(rel(delta, z["eval.delta"][t]))
    env = BatchedEnv(registry.make_scene("folding", **POLICY_GOLDEN_CFG), 2,
                     time_limit=RL_LIMIT, device=device)
    env.reset()
    env.t[:] = RL_BATCHED_T0
    a = np.zeros((RL_LIMIT, 2, 6))
    a[:, 0, 0], a[:, 0, 2] = 3e-4, -1.8e-3
    a[:, 1, 2], a[:, 1, 4] = -5e-4, 2e-3
    for t in range(RL_LIMIT):
        obs, rew, done = env.step(a[t])
        o64 = np.stack([obs64(env, s) for s in env.states])
        errs.append(_rl_obs_err(obs, o64, z["batched.obs"][t],
                                z["batched.obs64"][t]))
        rels.append(rel(rew, z["batched.rew"][t]))
        same &= (np.array_equal(done, z["batched.done"][t])
                 and np.array_equal(env.t, z["batched.t"][t]))
    log(f"[rl-golden] folding table_n=4 f64: Env reset + {RL_LIMIT} steps, "
        f"EvalEnv 2 steps, BatchedEnv(n=2) {RL_LIMIT} steps (an early stop, "
        f"a time limit, both auto-reset) against the JAX runs: max |dobs| "
        f"{max(errs):.3e} m (tol {RL_OBS_ATOL:.0e}), reward max rel err "
        f"{max(rels):.3e} (tol {RL_REWARD_RTOL:.0e}), done flags and episode "
        f"times equal: {same}")
    if not (max(errs) <= RL_OBS_ATOL and max(rels) <= RL_REWARD_RTOL
            and same):
        raise AssertionError("the RL environments disagree with the JAX runs")


class _Timed:
    """Wraps obj.name with synchronized wall seconds per call."""

    def __init__(self, obj, name):
        self.secs = []
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out

        setattr(obj, name, wrapped)


def rl_phase(device):
    """[rl]: published folding in f32 (Newton capped at RL_NEWTON) on a
    BatchedEnv of RL_ENVS, one update of each native trainer as `cli rl`
    drives it on a card: parameters finite after each; the ms a policy
    update takes beside the s a batched env step takes."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.ppo import PPOTrainer
    from thinshelllab_torch.train.recurrent_ppo import RecurrentPPOTrainer
    from thinshelllab_torch.train.rl_env import BatchedEnv
    from thinshelllab_torch.train.sac import SACTrainer

    sc = registry.make_scene("folding", solver="auto", dtype=torch.float32,
                             max_newton_iter=RL_NEWTON)
    steps = RL_ENVS * RL_HORIZON
    trainers = {
        "ppo": lambda env: PPOTrainer(env, total_steps=steps,
                                      horizon=RL_HORIZON, device=device,
                                      dtype=torch.float32),
        "sac": lambda env: SACTrainer(env, total_steps=steps, start_steps=2,
                                      batch_size=4, device=device,
                                      dtype=torch.float32),
        "recurrent_ppo": lambda env: RecurrentPPOTrainer(
            env, total_steps=steps, horizon=RL_HORIZON, device=device,
            dtype=torch.float32),
    }
    for algo, make in trainers.items():
        env = BatchedEnv(sc, RL_ENVS, time_limit=RL_HORIZON + 1,
                         device=device)
        tr = make(env)
        t_env, t_upd = _Timed(env, "step"), _Timed(tr, "update")
        tr.train(verbose=False)
        params = [p for g in tr.__dict__.values()
                  if isinstance(g, torch.optim.Optimizer)
                  for grp in g.param_groups for p in grp["params"]]
        finite = all(bool(torch.isfinite(p).all()) for p in params)
        obs = env.reset()
        a = tr.act(obs)
        a = a[0] if isinstance(a, tuple) else a
        log(f"[rl] {algo} folding f32 max_newton_iter {RL_NEWTON}, "
            f"BatchedEnv(n={RL_ENVS}): {len(t_env.secs)} env steps "
            f"{sum(t_env.secs) / len(t_env.secs):.3f} s each (s per "
            f"batched step of {RL_ENVS}), {len(t_upd.secs)} policy updates "
            f"{1e3 * sum(t_upd.secs) / len(t_upd.secs):.3f} ms each "
            f"(first {1e3 * t_upd.secs[0]:.3f} ms); parameters finite: "
            f"{finite}; |action| max {float(np.abs(a).max()):.3e}")
        if not (finite and t_upd.secs and np.all(np.isfinite(a))):
            raise AssertionError(f"[rl] {algo}: finite {finite}, "
                                 f"{len(t_upd.secs)} updates")


def store_inputs(spec, s0, params, dtype):
    """A moved scene's assembled DIA store at its initial state, as the
    first Newton iteration builds it, and the preconditioner's inputs:
    (store, store with D on the offset-0 lane, D^-1 in (3, 3, NVp))."""
    from thinshelllab_torch.engine import elements, solver, stepper

    contact, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                           s0.proj_flag, s0.proj_dir)
    groups = elements.all_groups(spec, params, s0.pos, s0.ref_angle, contact,
                                 with_hess=True, spd=True)
    st = solver.prepare_solver_state(spec, groups, dtype)
    NV, NVp = spec.NV, spec.dia.NVp
    dia_pre = st["dia"].clone()
    dia_pre[spec.dev.off0, :, :, :NV] = st["D"].permute(1, 2, 0)
    dinv = st["D"].new_zeros((3, 3, NVp))
    dinv[:, :, :NV] = solver._inv3x3(st["D"]).permute(1, 2, 0)
    return st["dia"], dia_pre, dinv


def plan_kernel_check(tag, sc, device, dtype, seed=0):
    """Both kernels on a scene's own plan: its assembled store at the
    initial state (in dtype), random seeded vectors, each held against its
    plain version within KERNEL_RTOL, one launch a call, the warm device
    time and the bound. Returns {kernel: {ms, bound_ms, ...}}."""
    from thinshelllab_torch.ops import dia_spmv as K

    spec, s0, params = sc.to(device, dtype)
    dia, dia_pre, dinv = store_inputs(spec, s0, params, dtype)
    plan, unf2 = spec.dia, spec.dev.unf2
    offs, offs_t, NVp = plan.offsets, spec.dev.offsets_t, plan.NVp
    rng = np.random.default_rng(seed)
    x2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                         device=device) * unf2
    r2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                         device=device) * unf2
    w, sweeps = spec.precond_omega, spec.precond_smooth
    pplan, geo = precond_geometry(K, device, NVp, offs, dtype)
    cases = {
        "dia_spmv": (lambda: K.dia_spmv(dia, x2, offs, offs_t),
                     lambda: K.dia_spmv_plain(dia, x2, offs)),
        "dia_precond": (
            lambda: K.dia_precond(dia_pre, r2, unf2, dinv, offs, w, sweeps,
                                  offs_t),
            lambda: K.dia_precond_plain(dia_pre, r2, unf2, dinv, offs, w,
                                        sweeps)),
    }
    out, parts = {}, []
    for name, (kern, plain) in cases.items():
        reset_launches()
        yk = kern()
        torch.cuda.synchronize()
        per_call = K.LAUNCHES[name]
        yp = plain()
        abs_err = float((yk - yp).abs().max())
        rel = abs_err / float(yp.abs().max())
        ms = device_ms(kern, n=20, per_call=1)
        plain_ms = call_ms(plain, n=10, warmup=2)
        b_ms, b_by = bound_ms(*kernel_work(name, dia, sweeps))
        parts.append(f"{name} max rel err {rel:.3e}, {per_call} launch a "
                     f"call, device {ms:.4f} ms against a bound of "
                     f"{b_ms:.4f} ms by {b_by} (plain {plain_ms:.4f} ms "
                     f"between CUDA events)")
        if not rel <= KERNEL_RTOL[dtype] or per_call != 1:
            raise AssertionError(f"{tag} {name} {dtype}: error {rel:.3e} "
                                 f"(tol {KERNEL_RTOL[dtype]}), {per_call} "
                                 "launches a call")
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=abs_err, plain_call_ms=plain_ms)
    mb = dia.numel() * dia.element_size() / 1e6
    log(f"{tag} {str(dtype)[6:]}: n_off {len(offs)}, NVp {NVp}, max |offset| "
        f"{max(abs(o) for o in offs)}, store {mb:.2f} MB; {geo}; "
        + "; ".join(parts) + f" (tol {KERNEL_RTOL[dtype]:.0e})")
    out["geometry"] = dict(rows=pplan.rows, grid=pplan.grid,
                           staged=pplan.staged, n_off=len(offs), NVp=NVp)
    return out


def cg_kernel_checks(device):
    """[cg-kernels]: both kernels on the plan of each DIA task scene under
    solver="cg", at published size, in f32 and f64."""
    from thinshelllab_torch.scenes import registry

    out = {}
    for name in NEW_SCENES:
        sc = scene_state(name, registry.make_scene(name, solver="cg"), device)
        if sc.spec.dia is None:
            raise AssertionError(f"{name} built no DIA plan under cg")
        out[name] = {str(dt)[6:]: plan_kernel_check(f"[cg-kernels] {name}",
                                                    sc, device, dt)
                     for dt in (torch.float32, torch.float64)}
    return out


def first_cg_per_step(stats):
    """The CG iterations of each step's first Newton solve."""
    out, i = [], 0
    for n in stats["newton_per_step"]:
        out.append(stats["cg_per_newton"][i])
        i += n
    return out


def cg_actions(name, n_part, dtype, device):
    dpos = torch.zeros((CG_T, n_part, 3), dtype=dtype, device=device)
    dpos[:, :, 2] = CG_FOLD_DZ if name == "folding" else SCENE_DZ
    return (dpos, torch.zeros((CG_T, n_part, 3), dtype=dtype, device=device),
            torch.zeros((CG_T, n_part), dtype=dtype, device=device))


def cg_scene(name, device, published=False):
    """A task scene as GOLDEN_CG ran it (folding at its published size with
    `published`)."""
    from thinshelllab_torch.scenes import registry

    kw = {}
    if name == "folding" and not published:
        kw["table_n"] = CG_FOLD_TABLE_N
    return scene_state(name, registry.make_scene(
        name, solver="cg", max_newton_iter=CG_NEWTON, dtype=torch.float64,
        **kw), device)


@contextlib.contextmanager
def jax_f64_preconditioner():
    """Within the block, CG preconditions with the smoothing polynomial
    sweep by sweep (solver._polynomial_precond_T, its SpMVs through the
    dia_spmv kernel), as the JAX package does in f64, instead of the fused
    dia_precond kernel, which drops the leftover pull rows' off-diagonal
    couplings. Where CG stops at its cap the two preconditioners leave
    different iterates, so a comparison with the JAX runs needs this one."""
    from thinshelllab_torch.engine import elements, solver

    fused = solver._fused_precond_T

    def poly(spec, st, D, Dinv, w, smooth, dtype, unf2):
        m2 = elements.t2_consts(spec, dtype)[1]
        return solver._polynomial_precond_T(spec, st, Dinv, w, smooth, dtype,
                                            unf2, m2)

    solver._fused_precond_T = poly
    try:
        yield
    finally:
        solver._fused_precond_T = fused


def replay_pos_tol(stats, spec):
    """The position tolerance of a tie scene's step replayed on the JAX
    tape with these solver stats: SCENE_POS_ATOL, or CAPPED_POS_ATOL where
    a CG solve stopped at its cap. The other scenes are held to
    SCENE_POS_ATOL whatever their solves did."""
    capped = max(stats["cg_per_newton"]) >= spec.cg_max_iter
    return CAPPED_POS_ATOL if capped else SCENE_POS_ATOL


def cg_run(sc, spec, s0, params, acts, tape=None):
    """Forward (unless a tape is given) and the default seed's backward with
    debug_iters: (buffers, result, stats, forward s, backward s)."""
    from thinshelllab_torch.engine import adjoint, stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = tape
    if buf is None:
        _, buf = stepper.simulate(spec, params, s0, acts, stats=stats,
                                  save_contacts=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                           with_param_grad=sc.sys_param is not None,
                           debug_iters=True)
    torch.cuda.synchronize()
    return buf, res, stats, t1 - t0, time.perf_counter() - t1


def cg_scenes_phase(device):
    """[cg-scenes]: every task scene under solver="cg" in f64 on the card,
    forward (CG with both kernels, or on folding CG on the pull operator)
    and backward (GMRES + BCR, or MINRES on folding), against the JAX runs
    in GOLDEN_CG, to SCENE_POS_ATOL. The scenes whose contact ties part
    them from JAX are held on the JAX tape, each step replayed with JAX's
    f64 preconditioner (jax_f64_preconditioner) from JAX's state, a step
    whose CG solve stopped at its cap to CAPPED_POS_ATOL. Then folding
    at its published size: its MINRES backward against the dense backward
    on one tape. Returns the kernel launches of the main runs."""
    from thinshelllab_torch.core.convert import (golden_grad_errors,
                                                 tape_from_entries)
    from thinshelllab_torch.engine import stepper

    z = np.load(GOLDEN_CG)
    total = {k: 0 for k in launch_counts()}
    for name in CG_SCENES:
        g = {k[len(name) + 1:]: z[k] for k in z.files
             if k.startswith(name + ".")}
        sc = cg_scene(name, device)
        spec, s0, params = sc.to(device)
        acts = cg_actions(name, sc.n_part, spec.dtype, device)
        reset_launches()
        buf, res, stats, fs, bs = cg_run(sc, spec, s0, params, acts)
        launches = launch_counts()
        check_element_launches(f"[cg-scenes] {name}", launches)
        for k, v in launches.items():
            total[k] += v
        cgs = stats["cg_per_newton"]
        pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
        gg, pg, sy = golden_grad_errors(res, g, sc.sys_param)
        plan = (f"DIA n_off {len(spec.dia.offsets)}, NVp {spec.dia.NVp}"
                if spec.dia is not None else "no DIA plan (pull operator)")
        solve = "MINRES" if spec.dia is None else "GMRES"
        log(f"[cg-scenes] {name} f64 T={CG_T}, NV {spec.NV}, {plan}: "
            f"forward {fs:.2f} s, backward {bs:.2f} s; Newton per step "
            f"{stats['newton_per_step']}, CG per Newton iteration {cgs} "
            f"({sum(c >= spec.cg_max_iter for c in cgs)} at the cap "
            f"{spec.cg_max_iter}); first-solve CG per step "
            f"{first_cg_per_step(stats)} (JAX {g['cg_first'].tolist()}), "
            f"{solve} per backward step {res.pos_grad0.tolist()} (JAX "
            f"{g['adj_iters'].tolist()}); launches {launches}; against the "
            f"JAX run: max |dpos| {pos_err:.3e} m, gripper_grad {gg:.3e}, "
            f"param_grad {pg:.3e}, sys_param {sy:.3e}")
        if not (bool(torch.isfinite(buf["pos"]).all())
                and bool(torch.isfinite(res.gripper_grad).all())):
            raise AssertionError(f"{name}: non-finite run")
        if spec.dia is not None and min(launches.values()) <= 0:
            raise AssertionError(f"{name}: launches {launches}")
        if name in SCENE_TIES:
            tape = tape_from_entries(g, device)
            replay, tols = [], []
            with jax_f64_preconditioner():
                for t in range(CG_T):
                    st = {}
                    p = stepper.replay_step(spec, params, tape, t,
                                            tuple(a[t] for a in acts),
                                            s0.vel, stats=st)
                    replay.append(float((p - tape["pos"][t + 1]).abs().max()))
                    tols.append(replay_pos_tol(st, spec))
            _, rt, _, _, bt = cg_run(sc, spec, s0, params, acts, tape=tape)
            t_gg, t_pg, t_sy = golden_grad_errors(rt, g, sc.sys_param)
            d_it = int(np.abs(rt.pos_grad0.cpu().numpy()
                              - g["adj_iters"]).max())
            log(f"[cg-scenes] {name} on the JAX tape ({SCENE_TIES[name]}): "
                f"each step replayed from the JAX state with the JAX "
                f"contact set and JAX's f64 preconditioner: max |dpos| "
                f"{', '.join(f'{e:.3e}' for e in replay)} m (tol "
                f"{', '.join(f'{e:.0e}' for e in tols)}); backward "
                f"({bt:.2f} s): gripper_grad {t_gg:.3e}, param_grad "
                f"{t_pg:.3e} (tol {SCENE_GRAD_RTOL:.0e}), sys_param "
                f"{t_sy:.3e}; {solve} per step {rt.pos_grad0.tolist()} "
                f"(within {CG_ITER_SLACK})")
            ok = (all(e <= tol for e, tol in zip(replay, tols))
                  and d_it <= CG_ITER_SLACK
                  and max(t_gg, t_pg) <= SCENE_GRAD_RTOL)
        else:
            d_it = int(np.abs(res.pos_grad0.cpu().numpy()
                              - g["adj_iters"]).max())
            tol = SCENE_POS_ATOL
            ok = (pos_err <= tol and d_it <= CG_ITER_SLACK
                  and max(gg, pg) <= SCENE_GRAD_RTOL)
            log(f"[cg-scenes] {name}: gated against the JAX run (tol "
                f"{tol:.0e} m, {SCENE_GRAD_RTOL:.0e} for gripper_grad and "
                f"param_grad, {solve} iterations within {CG_ITER_SLACK}): "
                f"{ok}")
        if not ok:
            raise AssertionError(f"{name} under cg disagrees with the JAX "
                                 "run")
    minres_vs_dense(device)
    return total


def minres_vs_dense(device):
    """Folding at its published size under cg in f64: the MINRES backward
    against the dense backward on the same tape."""
    from thinshelllab_torch.engine import adjoint, stepper

    sc = cg_scene("folding", device, published=True)
    spec, s0, params = sc.to(device)
    stats = {}
    t0 = time.perf_counter()
    _, buf = stepper.simulate(spec, params, s0,
                              cg_actions("folding", sc.n_part, spec.dtype,
                                         device), stats=stats)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seeds = sc.seed_loss(buf)
    res = adjoint.backward(spec, params, buf, *seeds)
    its = adjoint.backward(spec, params, buf, *seeds,
                           debug_iters=True).pos_grad0.tolist()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ref = adjoint.backward(spec.replace(solver="dense"), params, buf, *seeds)
    err = rel_err(res.gripper_grad, ref.gripper_grad)
    log(f"[cg-scenes] folding published (NV {spec.NV}, no DIA plan) f64 "
        f"T={CG_T}: forward {t1 - t0:.2f} s (Newton per step "
        f"{stats['newton_per_step']}, CG {stats['cg_iters']}), MINRES "
        f"backward {t2 - t1:.2f} s for two runs, MINRES per step {its}; "
        f"gripper_grad max |d| / max |dense| {err:.3e} (tol "
        f"{MINRES_DENSE_RTOL:.0e}), max |gripper_grad| "
        f"{float(ref.gripper_grad.abs().max()):.4g}")
    if spec.dia is not None or not err <= MINRES_DENSE_RTOL:
        raise AssertionError(f"folding MINRES backward off by {err:.3e}")


def cg_trajopt_phase(device):
    """[cg-trajopt]: one f32 TrajOptDriver iteration under solver="cg"
    (Newton capped at TRAJOPT_NEWTON) on folding (pull CG, MINRES) and
    balancing (351 offsets), and the f32 folding gradient against an f64
    dense backward on its tape."""
    from thinshelllab_torch.engine import adjoint
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    for name, T in CG_TRAJOPT_T.items():
        sc = scene_state(name, registry.make_scene(
            name, solver="cg", dtype=torch.float32,
            max_newton_iter=TRAJOPT_NEWTON), device)
        drv = TrajOptDriver(sc, T, lr=1e-3, max_dist=0.015, device=device)
        if name == "folding":
            drv.agent.traj[:, :, 2] = CG_FOLD_DZ * np.arange(T)[:, None]
        reset_launches()
        info = drv.iteration()
        st = info["stats"]
        per, cap = st["newton_per_step"], sc.spec.max_newton_iter
        cgs = st["cg_per_newton"]
        log(f"[cg-trajopt] {name} f32 T={T}: forward "
            f"{info['forward_s']:.3f} s, backward {info['backward_s']:.3f} s;"
            f" Newton per step {per} ({sum(n >= cap for n in per)} at the cap"
            f" {cap}), CG {st['cg_iters']} in all, per Newton iteration mean "
            f"{np.mean(cgs):.1f}, max {max(cgs)} ({sum(c >= sc.spec.cg_max_iter for c in cgs)}"
            f" at the cap {sc.spec.cg_max_iter}); line-search trials "
            f"{st['ls_trials']}; launches {launch_counts()}")
        check_element_launches(f"[cg-trajopt] {name}", launch_counts(),
                               st["hess_builds"] + len(per))
        log(f"iter 0: reward {info['reward']:.6f} |g| "
            f"{info['grad_norm']:.4g} t {info['wall_time']:.2f}s")
        if not (np.isfinite(info["reward"])
                and np.isfinite(info["grad_norm"])):
            raise AssertionError(f"{name}: reward {info['reward']}, |g| "
                                 f"{info['grad_norm']}")
        if name != "folding":
            continue
        buf = info["buffers"]
        spec64, _, params64 = sc.to(device, torch.float64)
        buf64 = {k: v.double() if v.is_floating_point() else v
                 for k, v in buf.items()}
        res64 = adjoint.backward(spec64.replace(solver="dense"), params64,
                                 buf64, *sc.seed_loss(buf64))
        g32, g64 = info["gripper_grad"].double(), res64.gripper_grad
        den = float(torch.linalg.vector_norm(g64))
        err = float(torch.linalg.vector_norm(g32 - g64)) / den
        log(f"[cg-trajopt] folding: the f32 MINRES gripper_grad against an "
            f"f64 dense backward on its tape |g32 - g64| / |g64| {err:.3e} "
            f"(|g32| {float(torch.linalg.vector_norm(g32)):.4g}, |g64| "
            f"{den:.4g}; gated on |g64| > 0 and a finite distance)")
        if not (den > 0 and np.isfinite(err)):
            raise AssertionError(f"the f32 folding gradient: |g64| {den}, "
                                 f"distance {err}")


def hash_rows(con):
    """(capacity,) bool: the query slots of the pairs that take the hash."""
    rows = np.zeros(con.capacity, bool)
    for hd, (cqs, cnt, _, nf, _) in zip(con.hash_desc, con.pair_desc):
        if hd is not None and nf >= con.hash_min_faces:
            rows[cqs : cqs + cnt] = True
    return rows


def hash_compare(con, pos, got, want, rows):
    """Two projections (flag, dir, tri, w; tensors or arrays) of the numpy
    positions pos on the query slots `rows`: (flags equal, directions
    equal, found rows, rows on another face, largest distance by which
    got's face is farther than want's, largest by which it is nearer)."""
    f1, d1, t1, w1 = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                      for a in got)
    f2, d2, t2, w2 = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                      for a in want)
    m = f1.astype(bool) & rows
    q = pos[con.cq_vert.cpu().numpy()[m]]

    def dist(t, w):
        return np.linalg.norm(q - np.einsum("ck,cki->ci", w[m], pos[t[m]]),
                              axis=1)

    dd = dist(t1, w1) - dist(t2, w2) if m.any() else np.zeros(1)
    return (np.array_equal(f1[rows], f2[rows]),
            np.array_equal(d1[rows], d2[rows]), int(m.sum()),
            int((~(t1[m] == t2[m]).all(axis=1)).sum()),
            max(0.0, float(dd.max())), max(0.0, float(-dd.min())))


def bench40k_phase(device):
    """[bench-40k]: the bench at cloth_N=140 (39,200 cloth triangles a
    sheet, above hash_min_faces: the spatial hash) in f32, the pad pressing
    PRESS_Z a step for BENCH40K_T steps, then the adjoint; both kernels on
    its store; the hash against the exhaustive sweep on the first and last
    positions. Returns (kernel results, launches of the forward+backward)."""
    from thinshelllab_torch.engine import gridsolve
    from thinshelllab_torch.scenes import bench_scene

    t0 = time.perf_counter()
    sc = bench_scene.make(cloth_N=BENCH40K_N, table_n=12,
                          dtype=torch.float32, hess_refresh=8, fwd_tol=1e-3,
                          max_newton_iter=8)
    s, con = sc.spec, sc.spec.contact
    hashed = [(pd, hd) for pd, hd in zip(con.pair_desc, con.hash_desc)
              if hd is not None and pd[3] >= con.hash_min_faces]
    log(f"[bench-40k] cloth_N={BENCH40K_N} built on the host in "
        f"{time.perf_counter() - t0:.2f} s: NV {s.NV}, faces "
        f"{s.faces.shape[0]}, NVp {s.dia.NVp}, {len(s.dia.offsets)} offsets "
        f"(max |offset| {max(abs(o) for o in s.dia.offsets)}), contact "
        f"capacity {con.capacity}; pairs on the hash (queries, source "
        f"faces, grid, cap): "
        f"{[(pd[1], pd[3], hd[:3], hd[3]) for pd, hd in hashed]}")
    if len(hashed) != 2:
        raise AssertionError("the 40k bench should take the hash on its two "
                             "cloth-source pairs")
    kres = {str(dt)[6:]: plan_kernel_check("[bench-40k] kernels", sc, device,
                                           dt)
            for dt in (torch.float32, torch.float64)}
    spec, s0, params = sc.to(device, torch.float32)
    reset_launches()
    buf, stats, secs = rollout(spec, s0, params, device, BENCH40K_T, PRESS_Z)
    fwd = launch_counts()
    pt = PhaseTimer()
    pt.wrap(gridsolve.GridPreconditioner, "__init__", "BCR factor")
    try:
        reset_launches()
        res, secs_b = backward(sc, spec, params, buf)
        bwd = launch_counts()
    finally:
        pt.restore()
    pos, gg = buf["pos"], res.gripper_grad
    disp = float((pos[-1] - pos[0]).abs().max())
    bcr_ms = pt.ms.get("BCR factor", float("nan"))
    n_bcr = pt.calls.get("BCR factor", 0)
    log(f"[bench-40k] f32 T={BENCH40K_T}, pad {PRESS_Z * 1e3:.1f} mm a step: "
        f"forward {secs:.3f} s (Newton {stats['newton_iters']}, CG "
        f"{stats['cg_iters']}, line-search trials {stats['ls_trials']}), "
        f"backward {secs_b:.3f} s with a sync around each BCR factor "
        f"({bcr_ms / max(n_bcr, 1):.1f} ms a backward step, {n_bcr} "
        f"factors); launches forward {fwd}, backward {bwd}; max displacement"
        f" {disp:.3e} m, max |gripper_grad| {float(gg.abs().max()):.4e}; "
        f"{contact_gap(sc, buf)}")
    if not (bool(torch.isfinite(pos).all()) and disp < SCENE_DISP_MAX
            and bool(torch.isfinite(gg).all())):
        raise AssertionError(f"bench-40k: displacement {disp}, gradient "
                             f"finite {bool(torch.isfinite(gg).all())}")
    if min(fwd.values()) <= 0 or bwd["dia_spmv"] <= 0:
        raise AssertionError(f"bench-40k launches: forward {fwd}, backward "
                             f"{bwd}")
    check_element_launches("[bench-40k] forward", fwd, stats["hess_builds"])
    check_element_launches("[bench-40k] backward", bwd, BENCH40K_T)
    hash_checks(spec, pos, device, z_dtype=s0.proj_flag.dtype, sc=sc)
    return kres, {k: fwd[k] + bwd[k] for k in fwd}


def hash_checks(spec, pos, device, z_dtype, sc):
    """The hash projection of the 40k bench against the exhaustive sweep
    (top_k = max_src_faces) on the first and last positions of the run,
    and against the JAX package's hash on the initial positions in f64
    (GOLDEN_HASH40K). The JAX package's own hash keeps the 2K nearest
    faces by centroid L-inf distance, and at this resolution more faces
    than that tie at the pad's height above the cloth: it picks a farther
    face than the exhaustive sweep on about half the found rows (ROADMAP
    §3). So against the exhaustive sweep the found sets and directions
    must be equal and the hash never nearer (beyond the 1e-5 window);
    against the JAX hash, the criterion of the JAX package's hash test
    less its count (which differs between any two roundings)."""
    from thinshelllab_torch.ops import collision

    con = spec.contact
    rows = hash_rows(con)
    oracle = spec.replace(contact=con.replace(
        hash_desc=(None,) * len(con.hash_desc), top_k=con.max_src_faces))
    z = torch.zeros((con.capacity,), dtype=z_dtype, device=device)
    for label, p in (("initial", pos[0]), ("final", pos[-1])):
        vn = collision.vertex_normals(p, spec.faces, spec.NV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = collision.projection_query(spec, p, vn, z, z)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = collision.projection_query(oracle, p, vn, z, z)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fe, de, n, n_mis, farther, nearer = hash_compare(
            con, p.cpu().double().numpy(), got, want, rows)
        log(f"[bench-40k] hash vs exhaustive sweep, {label} positions: "
            f"found sets equal {fe}, directions equal {de}; {n} found rows "
            f"on the hash pairs, {n_mis} on another face, the hash's face "
            f"farther by up to {farther:.3e} m and nearer by up to "
            f"{nearer:.3e} m (tol {HASH_DIST_ATOL:.2e}); projection "
            f"{t1 - t0:.3f} s with the hash, {t2 - t1:.3f} s exhaustive")
        if not (fe and de and n > 0 and nearer <= HASH_DIST_ATOL):
            raise AssertionError(f"bench-40k {label}: the hash disagrees "
                                 "with the exhaustive sweep")
    g = np.load(GOLDEN_HASH40K)
    spec64, s064, _ = sc.to(device, torch.float64)
    p = s064.pos
    vn = collision.vertex_normals(p, spec64.faces, spec64.NV)
    got = collision.projection_query(spec64, p, vn, z, z)
    fe, de, n, n_mis, farther, nearer = hash_compare(
        con, p.cpu().numpy(), got, (g["flag"], g["dir"], g["tri"], g["w"]),
        rows)
    log(f"[bench-40k] hash vs the JAX package's hash, f64 initial "
        f"positions: found sets equal {fe}, directions equal {de}; {n} "
        f"found rows, {n_mis} on another face, distances within "
        f"{max(farther, nearer):.3e} m (tol {HASH_DIST_ATOL:.2e})")
    if not (fe and de and max(farther, nearer) <= HASH_DIST_ATOL):
        raise AssertionError("bench-40k: the hash disagrees with the JAX "
                             "package's")


@contextlib.contextmanager
def raw_eigh_record():
    """Within the block, every batch that ops/spd._eigh decomposes on the
    card is first handed to cuSOLVER's batched eigh as it stands, all-zero
    blocks included, and the outcome counted: batches, blocks, all-zero
    blocks, refused batches, and blocks with a non-finite result (all-zero
    or not). _eigh then runs as always (it keeps all-zero blocks away from
    cuSOLVER and raises on any other failure)."""
    from thinshelllab_torch.ops import spd

    rec = dict(batches=0, blocks=0, zero=0, refused=0, bad=0, bad_zero=0)
    inner = spd._eigh

    def recording(Hs):
        H = Hs.double()
        if H.is_cuda:
            k = H.shape[-1]
            zero = ~H.reshape(-1, k * k).any(dim=-1)
            rec["batches"] += 1
            rec["blocks"] += zero.numel()
            rec["zero"] += int(zero.sum())
            try:
                w, v = torch.linalg.eigh(H)
                bad = ~(torch.isfinite(w).all(dim=-1)
                        & torch.isfinite(v).all(dim=(-1, -2))).reshape(-1)
                rec["bad"] += int(bad.sum())
                rec["bad_zero"] += int((bad & zero).sum())
            except torch.linalg.LinAlgError:
                rec["refused"] += 1
        return inner(Hs)

    spd._eigh = recording
    try:
        yield rec
    finally:
        spd._eigh = inner


def self_contact_phase(device, when):
    """[self-contact]: the hairpin's projection, contact-set gradient and
    one implicit step on the card, against the CPU and the JAX run
    (GOLDEN_HAIRPIN). Faces and weights are compared on the found slots,
    the ones the contact set consumes. Run early in the process and again
    at its end (`when`), where a float64 hairpin batch once failed in
    cuSOLVER's eigh; cuSOLVER's own result on each batch is counted
    (raw_eigh_record)."""
    from thinshelllab_torch.scenes import hairpin

    spec, s0, params = hairpin.make(torch.float64)
    with raw_eigh_record() as rec:
        card = {k: v.cpu().numpy() for k, v in hairpin.probe(
            spec.to(device), s0.to(device), params.to(device)).items()}
    cpu = {k: v.numpy() for k, v in hairpin.probe(
        spec.to("cpu"), s0.to("cpu"), params.to("cpu")).items()}
    jx = dict(np.load(GOLDEN_HAIRPIN))
    found = card["flag"].astype(bool)
    out = []
    for ref, tol in ((cpu, HAIRPIN_CPU_ATOL), (jx, HAIRPIN_JAX_ATOL)):
        same = all(np.array_equal(card[k], ref[k])
                   for k in ("flag", "dir", "active"))
        same &= np.array_equal(card["tri"][found], ref["tri"][found])
        e_w = float(np.abs(card["w"][found] - ref["w"][found]).max())
        e_x = float(np.abs(card["pos1"] - ref["pos1"]).max())
        e_g = float(np.abs(card["grad"] - ref["grad"]).max()
                    / np.abs(ref["grad"]).max())
        out.append((same, e_w, e_x, e_g, tol))
    log(f"[self-contact] {when}, {time.perf_counter() - T_START:.0f} s into "
        f"the process: cuSOLVER's batched eigh on the hairpin's "
        f"{rec['batches']} batches as they stand ({rec['blocks']} blocks, "
        f"{rec['zero']} all-zero): {rec['refused']} batches refused, "
        f"{rec['bad']} blocks non-finite ({rec['bad_zero']} of them "
        f"all-zero)")
    log(f"[self-contact] hairpin {hairpin.N}x{hairpin.M} f64 on the card: "
        f"{int(found.sum())} self-projections found, "
        f"{int(card['active'].sum())} active; " + "; ".join(
            f"against {who}: flags, directions, active and the found faces "
            f"equal {same}, weights {e_w:.3e}, one step {e_x:.3e} m (tol "
            f"{tol:.0e}), energy gradient rel err {e_g:.3e}"
            for who, (same, e_w, e_x, e_g, tol) in zip(("the CPU", "JAX"),
                                                      out)))
    if not (found.sum() > 0 and all(
            same and max(e_w, e_x) <= tol and e_g <= 1e-9
            for same, e_w, e_x, e_g, tol in out)):
        raise AssertionError("the hairpin on the card disagrees")


# --------------------------------------------------------------------------
# render, the debug and host utilities, the native helper, the batch hinges
# --------------------------------------------------------------------------

RENDER_SCENE = "forming"
RENDER_FRAMES = 3
RENDER_NEWTON = 5  # f32 Newton stalls at any cap (ROADMAP.md §3)
RENDER_OUT = os.path.join(ROOT, "imgs", "smoke_render")
GOLDEN_DEBUG = os.path.join(ROOT, "tests", "data", "debug_golden.npz")
GOLDEN_BEND = os.path.join(ROOT, "tests", "data", "bend_batch_golden.npz")
# check_differential on the card against the CPU port, f64: the energy
# differences (~2e-5 J of energies ~1 J, summed in another order) relative;
# the two error ratios, themselves relative errors of a cancellation, to
# 1e-9 absolute (the CPU port and JAX differ by 1e-14 absolute there)
DEBUG_DE_RTOL = 1e-9
DEBUG_RATIO_ATOL = 1e-9
FORCE_RTOL = 1e-12  # contact forces, of the largest (~0.3 N)
# the two hinge forms on the small f64 bench, card: the same arithmetic
BEND_F64_ATOL = 1e-12
BEND_JAX_ATOL = 1e-9  # against the JAX golden, as tests/test_torch_native_bend
BEND_SMALL_CFG = dict(cloth_N=8, table_n=4, solver="dense", max_newton_iter=4)
BEND_SMALL_DZ = -2e-3
BEND_T = 2


def _render_cli(args, out):
    """cli.main(args + --save_dir out) on the card with the kernels'
    launches counted: (launches, seconds)."""
    from thinshelllab_torch import cli

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(args + ["--save_dir", out])
    torch.cuda.synchronize()
    return launch_counts(), time.perf_counter() - t0


def render_phase(device):
    """[render]: `cli render` on forming under cg (both kernels in every
    CG solve) with Preview and with LuisaScript, and `cli trajopt
    --render_every 1`. Checks the PNG frames against the GIF's decoded
    frames, frame 0's Luisa script and OBJ files against the CPU port's
    from the same positions, and the card's preview image against the
    CPU's. Returns the Preview run's launches of the four kernels."""
    import shutil

    from thinshelllab_torch.render import raster
    from thinshelllab_torch.render.engine import Renderer
    from thinshelllab_torch.scenes import registry

    shutil.rmtree(RENDER_OUT, ignore_errors=True)
    common = ["--env", RENDER_SCENE, "--solver", "cg", "--max_newton_iter",
              str(RENDER_NEWTON)]
    d_prev = os.path.join(RENDER_OUT, "preview")
    launches, secs = _render_cli(["render", *common, "--frames",
                                  str(RENDER_FRAMES)], d_prev)
    names = [f"{t}.png" for t in range(RENDER_FRAMES + 1)]
    if sorted(os.listdir(d_prev)) != sorted(names + ["GIF_0.gif"]):
        raise AssertionError(f"[render] wrote {sorted(os.listdir(d_prev))}")
    pngs = [raster.read_png(os.path.join(d_prev, n)) for n in names]
    frames, delays = raster.read_gif(os.path.join(d_prev, "GIF_0.gif"))
    gif_ok = len(frames) == len(pngs) and all(
        np.array_equal(f, p) for f, p in zip(frames, pngs))
    drawn = [int((p != 255).any(axis=2).sum()) for p in pngs]
    log(f"[render] cli render --env {RENDER_SCENE} --solver cg --frames "
        f"{RENDER_FRAMES} --max_newton_iter {RENDER_NEWTON} (f32) on the "
        f"card: {secs:.3f} s, launches {launches}; {len(pngs)} PNG "
        f"frames {pngs[0].shape}, {drawn} pixels drawn; GIF frames equal "
        f"to the PNGs: {gif_ok}, delays {delays} (1/100 s)")
    if not (gif_ok and min(drawn) > 0):
        raise AssertionError("[render] the GIF does not hold the PNG frames")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[render] kernel {name} was not launched")
    check_element_launches("[render]", launches)

    # the raster alone: the card's image against the CPU's, and its time
    sc = registry.make_scene(RENDER_SCENE, solver="cg", dtype=torch.float32)
    _, s0, _ = sc.to(device)
    r = Renderer(sc, RENDER_SCENE, save_dir=os.path.join(RENDER_OUT, "raster"))
    same = torch.equal(r.backend.image(s0.pos).cpu(),
                       r.backend.image(s0.pos.cpu()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(RENDER_FRAMES + 1):
        r.render(str(t), pos=s0.pos)
    t1 = time.perf_counter()
    r.end_rendering(0)
    t2 = time.perf_counter()
    log(f"[render] preview raster on the card: {(t1 - t0) * 1e3 / (RENDER_FRAMES + 1):.1f} ms "
        f"a frame (projection, fill, PNG), GIF of {RENDER_FRAMES + 1} "
        f"frames {(t2 - t1) * 1e3:.1f} ms; card image equal to the CPU's "
        f"pixel for pixel: {same}")
    if not same:
        raise AssertionError("[render] the card's preview differs from the "
                             "CPU's")

    d_lu = os.path.join(RENDER_OUT, "luisa")
    launches_lu, secs_lu = _render_cli(
        ["render", *common, "--frames", str(RENDER_FRAMES),
         "--render_option", "LuisaScript"], d_lu)
    want = {f"scene_{t}.luisa" for t in range(RENDER_FRAMES + 1)} | {
        f"models_{t}" for t in range(RENDER_FRAMES + 1)}
    files = set(os.listdir(d_lu))
    n_obj = [len(os.listdir(os.path.join(d_lu, f"models_{t}")))
             for t in range(RENDER_FRAMES + 1)] if want <= files else []
    # frame 0 = the scene's f32 initial positions: the CPU port writes the
    # same script and OBJ files from them
    d_cpu = os.path.join(RENDER_OUT, "luisa_cpu")
    rc = Renderer(sc, RENDER_SCENE, option="LuisaScript", save_dir=d_cpu)
    rc.render("0", pos=sc.to("cpu", torch.float32)[1].pos)
    with open(os.path.join(d_lu, "scene_0.luisa")) as f:
        card_text = f.read().replace(d_lu, "<save>")
    with open(os.path.join(d_cpu, "scene_0.luisa")) as f:
        cpu_text = f.read().replace(d_cpu, "<save>")
    objs = sorted(os.listdir(os.path.join(d_cpu, "models_0")))
    objs_same = objs == sorted(os.listdir(os.path.join(d_lu, "models_0")))
    for name in objs if objs_same else ():
        with open(os.path.join(d_lu, "models_0", name), "rb") as a, \
                open(os.path.join(d_cpu, "models_0", name), "rb") as b:
            objs_same &= a.read() == b.read()
    log(f"[render] cli render --render_option LuisaScript: {secs_lu:.3f} s, "
        f"launches {launches_lu}; scripts and model directories "
        f"{sorted(files & want) == sorted(want)}, OBJ files a frame {n_obj}; "
        f"frame 0's script equal to the CPU port's: "
        f"{card_text == cpu_text}, its OBJ files: {objs_same}")
    if not (want <= files and min(n_obj) > 0 and card_text == cpu_text
            and objs_same):
        raise AssertionError("[render] the LuisaScript export is wrong")

    d_tr = os.path.join(RENDER_OUT, "trajopt")
    launches_tr, secs_tr = _render_cli(
        ["trajopt", *common, "--tot_step", "2", "--iter", "1",
         "--render_every", "1"], d_tr)
    files = set(os.listdir(d_tr))
    log(f"[render] cli trajopt --env {RENDER_SCENE} --solver cg --tot_step 2 "
        f"--iter 1 --render_every 1: {secs_tr:.3f} s, launches "
        f"{launches_tr}; wrote {sorted(files)}")
    if not ({"0.png", "1.png", "GIF_0.gif"} <= files
            and min(launches_tr.values()) > 0
            and launches_tr["element_eval"] == launches_tr["element_fuse"]):
        raise AssertionError("[render] trajopt --render_every did not render")
    return launches


def debug_phase(device):
    """[debug]: check_differential and contact_forces at the lifting state
    of debug_golden.npz (scenes_golden's lifting.pos[-1] moved off
    equilibrium by seeded 2e-4 m noise), f64, on the card against the CPU
    port."""
    from thinshelllab_torch.engine.debug import check_differential
    from thinshelllab_torch.render.debug_plots import contact_forces
    from thinshelllab_torch.scenes import registry

    gold = np.load(GOLDEN_DEBUG)
    sc = registry.make_scene("lifting")
    out, forces, secs = {}, {}, {}
    for who, dev in (("card", device), ("cpu", torch.device("cpu"))):
        spec, s0, params = sc.to(dev, torch.float64)
        st = s0.replace(pos=torch.as_tensor(gold["pos"], device=dev))
        t0 = time.perf_counter()
        out[who] = check_differential(spec, params, st, verbose=False)
        forces[who] = contact_forces(spec, params, st).cpu().numpy()
        secs[who] = time.perf_counter() - t0
    card, cpu = out["card"], out["cpu"]
    d_rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k])
             for k in ("dE_fd", "dE_analytic")}
    d_abs = {k: abs(card[k] - cpu[k]) for k in ("grad_rel_err",
                                                "hess_rel_err")}
    big = float(np.abs(forces["cpu"]).max())
    e_f = float(np.abs(forces["card"] - forces["cpu"]).max()) / big
    nz = int(np.count_nonzero(np.abs(forces["card"]).max(axis=1)))
    log(f"[debug] lifting f64, check_differential on the card "
        f"({secs['card']:.2f} s with contact_forces; CPU {secs['cpu']:.2f} s):"
        f" {card}; against the CPU port: dE relative "
        f"{ {k: f'{v:.2e}' for k, v in d_rel.items()} }, error ratios "
        f"absolute { {k: f'{v:.2e}' for k, v in d_abs.items()} }; "
        f"contact_forces: {nz} vertices with a force, the largest "
        f"{big:.6f} N, card vs CPU {e_f:.2e} of it (tol {FORCE_RTOL:.0e})")
    if not (card["grad_rel_err"] < 1e-4 and card["hess_rel_err"] < 1e-3
            and max(d_rel.values()) <= DEBUG_DE_RTOL
            and max(d_abs.values()) <= DEBUG_RATIO_ATOL
            and e_f <= FORCE_RTOL and nz > 0):
        raise AssertionError("[debug] check_differential or contact_forces "
                             "on the card disagrees")


def bend_batch_phase(device):
    """[bend-batch]: the full bench (cloth_N=70, f32) forward with
    bend_batch=True against the default hinge form (in turns: default,
    batch, batch, default), T=2, and the adjoint; the small f64 bench with
    both forms on the card against each other and the JAX golden."""
    from thinshelllab_torch.engine import stepper
    from thinshelllab_torch.scenes import bench_scene

    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float32,
                          hess_refresh=8, fwd_tol=1e-3, max_newton_iter=8)
    spec, s0, params = sc.to(device, torch.float32)
    spec_b = spec.replace(bend_batch=True)
    runs = {}
    reset_launches()
    for sp, tag in ((spec, "default"), (spec_b, "batch"), (spec_b, "batch"),
                    (spec, "default")):
        buf, stats, secs = rollout(sp, s0, params, device, T=BEND_T)
        runs.setdefault(tag, []).append((buf, stats, secs))
    launches = launch_counts()
    res, bsecs = backward(sc, spec_b, params, runs["batch"][0][0])
    pos_b, pos_d = runs["batch"][0][0]["pos"], runs["default"][0][0]["pos"]
    cloth_nv = (70 + 1) ** 2
    disp = float((pos_d[-1, :cloth_nv] - pos_d[0, :cloth_nv]).abs().max())
    rel = float((pos_b - pos_d).abs().max()) / disp
    finite = bool(torch.isfinite(pos_b).all()) and bool(
        torch.isfinite(res.gripper_grad).all())
    rate = {k: [BEND_T / r[2] for r in v] for k, v in runs.items()}
    log(f"[bend-batch] bench cloth_N=70 f32 T={BEND_T}: steps/s default "
        f"{[f'{x:.4f}' for x in rate['default']]}, bend_batch "
        f"{[f'{x:.4f}' for x in rate['batch']]} (in turns), Newton iters "
        f"{runs['batch'][0][1]['newton_iters']} vs "
        f"{runs['default'][0][1]['newton_iters']}; launches over the four "
        f"forwards {launches}; adjoint {bsecs:.3f} s, |gripper_grad| "
        f"{float(torch.linalg.vector_norm(res.gripper_grad)):.4e}; positions "
        f"vs the default form {rel:.3e} of the largest cloth displacement "
        f"(tol {PLAIN_VS_KERNEL_RTOL:.0e}); finite {finite}")
    check_element_launches("[bend-batch]", launches)
    if not (finite and rel <= PLAIN_VS_KERNEL_RTOL
            and min(launches.values()) > 0):
        raise AssertionError("[bend-batch] the batch form's bench run fails")

    small = bench_scene.make(dtype=torch.float64, **BEND_SMALL_CFG)
    sp, s0, params = small.to(device, torch.float64)
    gold = np.load(GOLDEN_BEND)["pos"]
    s0 = s0.replace(pos=torch.as_tensor(gold[0], device=device))
    acts = bench_actions(BEND_T, torch.float64, device, BEND_SMALL_DZ)
    pos = [stepper.simulate(x, params, s0, acts)[1]["pos"].cpu().numpy()
           for x in (sp.replace(bend_batch=True), sp)]
    e_forms = float(np.abs(pos[0] - pos[1]).max())
    e_jax = float(np.abs(pos[0] - gold).max())
    log(f"[bend-batch] bench cloth_N=8 f64 dense T={BEND_T} (pad 2 mm a "
        f"step) on the card: the two forms {e_forms:.3e} m apart (tol "
        f"{BEND_F64_ATOL:.0e}), the batch form vs the JAX golden "
        f"{e_jax:.3e} m (tol {BEND_JAX_ATOL:.0e})")
    if not (e_forms <= BEND_F64_ATOL and e_jax <= BEND_JAX_ATOL):
        raise AssertionError("[bend-batch] the two hinge forms disagree")


# [element-kernels]: the published folding scene, pressed ELEMENT_STEPS
# steps of FOLD_DZ, and one cg task scene at its jittered initial state
ELEMENT_STEPS = 3
FOLD_DZ = -3e-4
ELEMENT_CG_SCENE = "forming"


def _element_inputs(sc, device, dtype, steps, dz):
    """(spec, params, pos, ref_angle, contact) of a scene on the card after
    `steps` steps of the pad moving dz a step (the kernels' route), each
    vertex then moved by 1e-6 m at random; steps=0: the initial state."""
    from thinshelllab_torch.engine import stepper

    spec, s0, params = sc.to(device, dtype)
    pos, prev, ref = s0.pos, s0.pos, s0.ref_angle
    if steps:
        acts = scene_actions(spec.gripper.n_part, steps, dtype, device)
        acts[0][:, :, 2] = dz
        _, buf = stepper.simulate(spec, params, s0, acts)
        pos, prev, ref = buf["pos"][-1], buf["pos"][-2], buf["ref_angle"][-1]
    g = torch.Generator().manual_seed(0)
    pos = pos + 1e-6 * torch.randn(pos.shape, generator=g,
                                   dtype=torch.float64).to(device, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, pos, prev,
                                           s0.proj_flag, s0.proj_dir)
    return spec, params, pos, ref, contact


def _element_compare(tag, sc, device, steps, dz):
    """The kernel route of all_groups against plain_groups on the same
    inputs, f64 and f32, eigh-projected; f32 also against the f64 plain
    route at the f32 state, where both f32 routes are held alike."""
    from thinshelllab_torch.engine import elements
    from thinshelllab_torch.ops import element_kernels as ek

    for dt in (torch.float64, torch.float32):
        spec, params, pos, ref, contact = _element_inputs(sc, device, dt,
                                                          steps, dz)
        ek.reset_launches()
        got = elements.all_groups(spec, params, pos, ref, contact)
        torch.cuda.synchronize()
        launches = dict(ek.LAUNCHES)
        want = elements.plain_groups(spec, params, pos, ref, contact)
        errs = {k: rel_err(got[k], want[k]) for k in ("g", "H")}
        line = (f"[element-kernels] {tag} {dt}: {int(contact.active.sum())} "
                f"active contacts; kernels vs plain max rel err g "
                f"{errs['g']:.3e}, H {errs['H']:.3e}; launches {launches}")
        ok = (torch.equal(got["idx"], want["idx"])
              and launches == {"element_eval": 1, "element_fuse": 1})
        if dt == torch.float64:
            ok = ok and max(errs.values()) <= KERNEL_RTOL[dt]
            spec64, params64 = spec, params
        else:
            c64 = dataclasses.replace(contact, **{
                f.name: getattr(contact, f.name).double()
                for f in dataclasses.fields(contact)
                if getattr(contact, f.name).is_floating_point()})
            want64 = elements.plain_groups(spec64, params64, pos.double(),
                                           ref.double(), c64)
            e64 = {k: (rel_err(got[k].double(), want64[k]),
                       rel_err(want[k].double(), want64[k]))
                   for k in ("g", "H")}
            line += (f"; vs the f64 plain route at this state: kernels g "
                     f"{e64['g'][0]:.3e} H {e64['H'][0]:.3e}, plain g "
                     f"{e64['g'][1]:.3e} H {e64['H'][1]:.3e}")
            # f32 rounding: each route within KERNEL_RTOL of the other, or
            # the kernels no farther from the f64 value than twice plain's
            ok = ok and all(errs[k] <= KERNEL_RTOL[dt]
                            or e64[k][0] <= 2 * e64[k][1] for k in errs)
        log(line)
        if not ok:
            raise AssertionError(f"[element-kernels] {tag} {dt}: the kernel "
                                 "route disagrees with the plain route")


def element_kernels_phase(device):
    """[element-kernels]: ops/element_kernels against the plain torch.func
    route (elements.plain_groups) on the published folding scene and on a
    cg task scene, then each kernel's device ms per call at folding's
    shapes in f64 beside its byte bound, and the whole all_groups call on
    both routes."""
    from thinshelllab_torch.engine import elements
    from thinshelllab_torch.ops import element_kernels as ek
    from thinshelllab_torch.scenes import registry

    fold = registry.make_scene("folding")
    _element_compare("folding", fold, device, ELEMENT_STEPS, FOLD_DZ)
    _element_compare(f"{ELEMENT_CG_SCENE} (cg)", registry.make_scene(
        ELEMENT_CG_SCENE, solver="cg"), device, 0, 0.0)

    spec, params, pos, ref, contact = _element_inputs(
        fold, device, torch.float64, ELEMENT_STEPS, FOLD_DZ)
    blocks = ek.element_eval(spec, params, pos, ref, contact, True)
    fused = ek.element_fuse(spec, contact, blocks)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    c = spec.cloth
    soups = [spec.neo, spec.tact]
    inputs = ([pos, ref, c.f2v, c.cloth_id, c.l0, c.rest_area, c.hinge_verts,
               c.hinge_sel, c.hinge_mask, c.hinge_coef, c.hinge_cloth,
               spec.dev.canon, params.kl, params.ka, params.kb, params.neo_mu,
               params.neo_lam, params.tact_mu, params.tact_lam, contact.idx,
               contact.w, contact.dx0, contact.T, contact.k]
              + [t for s in soups for t in (s.tets, s.B, s.W, s.group)])
    read_by_fuse = ([blocks[k] for k in ("Hm", "gm", "Hb", "gb", "Hn", "Gn",
                                         "Ht", "Gt", "Hr", "Gr", "g1f", "h1f")]
                    + [c.f2v, c.hinge_verts, spec.neo.tets, spec.tact.tets,
                       contact.idx, contact.active, contact.w])
    work = {"element_eval": nbytes(inputs) + nbytes(blocks.values()),
            "element_fuse": nbytes(read_by_fuse) + nbytes(fused.values())}
    calls = {"element_eval": lambda: ek.element_eval(spec, params, pos, ref,
                                                     contact, True),
             "element_fuse": lambda: ek.element_fuse(spec, contact, blocks)}
    out = {}
    for name, fn in calls.items():
        ms = device_ms(fn, key=f"{name}_kernel", per_call=1)
        b_ms = work[name] / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, bound_ms=b_ms, bytes=work[name])
        log(f"[kernel] {name} folding f64 (E = {fused['idx'].shape[0]} fused "
            f"rows): {ms:.4f} ms device a call; bound {b_ms:.4f} ms by "
            f"bytes ({work[name] / 1e6:.2f} MB); events "
            f"{event_ms(fn, 60):.4f} ms")
    route = call_ms(lambda: elements.all_groups(spec, params, pos, ref,
                                                contact), n=20)
    route_nospd = call_ms(lambda: elements.all_groups(
        spec, params, pos, ref, contact, spd=False), n=20)
    plain = call_ms(lambda: elements.plain_groups(spec, params, pos, ref,
                                                  contact), n=5, warmup=2)
    plain_nospd = call_ms(lambda: elements.plain_groups(
        spec, params, pos, ref, contact, False), n=5, warmup=2)
    log(f"[element-kernels] folding f64 all_groups(with_hess=True) per call: "
        f"kernels {route:.3f} ms ({route_nospd:.3f} ms without the eigh "
        f"projection), plain {plain:.3f} ms ({plain_nospd:.3f} ms without)")
    for v in out.values():
        v.update(route_ms=route, plain_ms=plain)
    return out


def profile_trace_phase(device):
    """[profile-trace]: utils.profiling.device_trace around one bench step
    (f32, full size): the Chrome trace it writes names both DIA kernels;
    PhaseTimer times the step traced and untraced."""
    import tempfile

    from thinshelllab_torch.scenes import bench_scene
    from thinshelllab_torch.utils.profiling import PhaseTimer, device_trace

    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float32,
                          hess_refresh=8, fwd_tol=1e-3, max_newton_iter=8)
    spec, s0, params = sc.to(device, torch.float32)
    pt = PhaseTimer()
    with pt.phase("bench step, untraced", sync=s0.pos):
        buf = rollout(spec, s0, params, device, T=1)[0]
    with tempfile.TemporaryDirectory() as d:
        with pt.phase("bench step, traced", sync=buf["pos"]):
            with device_trace(d):
                buf = rollout(spec, s0, params, device, T=1)[0]
        path = os.path.join(d, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    counts = {k: sum(1 for e in events if e.get("cat") == "kernel"
                     and k in e.get("name", ""))
              for k in ("dia_spmv_kernel", "dia_precond_kernel")}
    log(f"[profile-trace] device_trace of one bench step: trace.json "
        f"{size / 2**20:.1f} MiB, kernel events {counts}")
    for line in pt.report().splitlines():
        log(f"[profile-trace] {line.strip()}")
    if min(counts.values()) <= 0:
        raise AssertionError("[profile-trace] the trace misses a DIA kernel")


def native_phase():
    """[native]: the cloth tables, hinge stencils and cube lattices of the
    bench (cloth_N 70 and 140) and of every task scene and the hairpin,
    from the native helper against the numpy paths, integer for integer."""
    from thinshelllab_torch import native
    from thinshelllab_torch.core import builder, topology
    from thinshelllab_torch.scenes import bench_scene, hairpin, registry

    t0 = time.perf_counter()
    scenes = {f"bench {n}": bench_scene.make(cloth_N=n, table_n=12).spec
              for n in (70, 140)}
    scenes["hairpin"] = hairpin.make(torch.float64)[0]
    for name in ("folding",) + NEW_SCENES:
        scenes[name] = registry.make_scene(name).spec
    checked, mismatched = [], []
    for name, spec in scenes.items():
        c = spec.cloth
        for N, M in set(zip(c.N, c.M)):
            tables = native.cloth_mesh_tables(N, M)
            same = all(np.array_equal(a, b) for a, b in zip(
                tables, topology.cloth_tables_numpy(N, M)))
            mesh = topology.build_cloth_mesh(N, M)
            pos = np.random.default_rng(N * 1000 + M).normal(
                size=(mesh.NV, 3)) * 0.01
            same &= all(np.array_equal(a, b) for a, b in zip(
                native.build_hinges(mesh.f2v, mesh.counter_face,
                                    mesh.counter_point, pos),
                builder.build_hinges_numpy(mesh, pos)))
            checked.append(f"{name} {N}x{M}")
            if not same:
                mismatched.append(f"{name} {N}x{M}")
    for dims in ((12, 12, 2), (4, 4, 2), (5, 5, 5)):
        checked.append(f"cube {dims}")
        if not np.array_equal(native.cube_tets(*dims),
                              topology.cube_tets_numpy(*dims)):
            mismatched.append(f"cube {dims}")
    log(f"[native] {len(checked)} tables, native helper against numpy "
        f"({time.perf_counter() - t0:.1f} s with the host builds): "
        f"{', '.join(checked)}; mismatched: {mismatched or 'none'}")
    if mismatched:
        raise AssertionError(f"[native] tables differ: {mismatched}")


@contextlib.contextmanager
def deterministic(on=True):
    """torch's deterministic algorithms inside the block (with `on`): the
    CUDA scatter-adds then sum in one order, so a run repeats bit for bit.
    cuBLAS asks for a fixed workspace (CUBLAS_WORKSPACE_CONFIG) before it
    takes part; this process runs one stream, on which cuBLAS repeats its
    results anyway."""
    if not on:
        yield
        return
    key = "CUBLAS_WORKSPACE_CONFIG"
    before = os.environ.get(key)
    os.environ.setdefault(key, ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if before is None:
            del os.environ[key]


def deterministic_train_step(mesh, *args):
    """parallel.programs.train_step on a launched rank, under torch's
    deterministic algorithms."""
    from thinshelllab_torch.parallel import programs

    with deterministic():
        return programs.train_step(mesh, *args)


def mesh_actions(n_part, B, dtype, device):
    """MESH_B members of MESH_T steps: the pad pressing PRESS_Z a step plus
    the JAX dryrun's seeded jitter (numpy seed 0, 1e-4 m)."""
    dpos = np.random.default_rng(0).normal(size=(B, MESH_T, n_part, 3)) * 1e-4
    dpos[..., 2] += PRESS_Z
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (
        dpos, np.zeros((B, MESH_T, n_part, 3)), np.zeros((B, MESH_T, n_part))))


def serial_train_reference(sc, spec, s0, params, acts):
    """The mean gripper gradient and the loss proxy of sharded_train_step
    computed member by member without a mesh."""
    from thinshelllab_torch.engine import adjoint, stepper

    grads, loss = [], 0.0
    for b in range(acts[0].shape[0]):
        _, buf = stepper.simulate(spec, params, s0, tuple(a[b] for a in acts))
        grads.append(adjoint.backward(spec, params, buf,
                                      *sc.seed_loss(buf)).gripper_grad)
        loss += float(torch.sum(buf["pos"][-1] ** 2))
    return torch.stack(grads).mean(dim=0), loss


def mesh_phase(sc, spec, s0, params, device, rewards_cmaes_cg):
    """[mesh]: (a) sharded_train_step on a world of one over NCCL on the
    full bench, pressing, against serial backwards, both kernels launched;
    (b) a CMAESDriver generation through the mesh against [cmaes-cg]'s
    (both in one summation order); (c) entry() and dryrun_multichip(1). Where the
    machine has more cards, (a) also runs at world = device_count through
    launch(). Returns the DIA kernel launches of (a)."""
    import torch.distributed as dist

    from thinshelllab_torch import entry as tentry
    from thinshelllab_torch.parallel import mesh as pmesh
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.cmaes import CMAESDriver

    acts = mesh_actions(sc.n_part, MESH_B, spec.dtype, device)
    traj = torch.zeros((MESH_T + 1, sc.n_part, 6), dtype=spec.dtype,
                       device=device)
    lr = 1e-3
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(1)
    try:
        log(f"[mesh] make_mesh(1): {dist.get_backend()} world {mesh.size} on "
            f"{mesh.device} in {time.perf_counter() - t0:.2f} s")

        with deterministic():
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_traj, loss = pmesh.sharded_train_step(
                mesh, spec, params, s0, sc.seed_loss, acts, traj, lr)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = launch_counts()
            t0 = time.perf_counter()
            g_ref, loss_ref = serial_train_reference(sc, spec, s0, params,
                                                     acts)
            secs_ref = time.perf_counter() - t0
        g_mesh = (traj - new_traj) / lr
        e_g = rel_err(new_traj, traj - lr * g_ref)
        e_loss = abs(float(loss) - loss_ref) / abs(loss_ref)
        log(f"[mesh] (a) sharded_train_step, bench f32 T={MESH_T} B={MESH_B} "
            f"pressing {PRESS_Z * 1e3:.1f} mm a step, world 1 over NCCL, "
            f"deterministic algorithms: {secs:.3f} s (serial reference "
            f"{secs_ref:.3f} s), launches {launches}; max |g_mean| "
            f"{float(g_mesh.abs().max()):.4e}; new_traj vs traj - lr x the "
            f"mean of {MESH_B} serial backwards max rel err {e_g:.3e} (tol "
            f"{MESH_GRAD_RTOL:.0e}), loss proxy {float(loss):.6f} vs "
            f"{loss_ref:.6f}, rel err {e_loss:.3e} (tol {MESH_LOSS_RTOL:.0e})")
        check_element_launches("[mesh] (a)", launches)
        if not (float(g_mesh.abs().max()) > 0 and bool(
                torch.isfinite(new_traj).all()) and e_g <= MESH_GRAD_RTOL
                and e_loss <= MESH_LOSS_RTOL):
            raise AssertionError("the sharded train step disagrees with the "
                                 "serial backwards, or has no gradient")
        if min(launches.values()) <= 0:
            raise AssertionError(f"[mesh] (a) launched {launches}")

        cg_sc = registry.make_scene(CMAES_CG_SCENE, dtype=torch.float32,
                                    solver="cg", max_newton_iter=CG_NEWTON)

        drv = CMAESDriver(cg_sc, CMAES_TOT, CMAES_ABS, pop_size=CMAES_POP,
                          seed=0, mesh=mesh)
        with deterministic():
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = drv.generation()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches_b = launch_counts()
        want = np.asarray(rewards_cmaes_cg)
        log(f"[mesh] (b) CMAESDriver(mesh=make_mesh(1)) {CMAES_CG_SCENE} f32 "
            f"cg, pop {CMAES_POP}, deterministic algorithms: {secs:.3f} s, "
            f"launches {launches_b}; rewards {info['rewards'].tolist()}, "
            f"stop steps {info['stop_steps']}, early {info['early']}; equal "
            f"to [cmaes-cg]'s {want.tolist()}: "
            f"{np.array_equal(info['rewards'], want)}")
        check_element_launches("[mesh] (b)", launches_b)
        if not (np.array_equal(info["rewards"], want)
                and min(launches_b.values()) > 0):
            raise AssertionError("the mesh's CMA-ES generation differs from "
                                 "[cmaes-cg]'s")
    finally:
        mesh.close()

    t0 = time.perf_counter()
    fn, args = tentry.entry()
    pos = fn(*args)
    torch.cuda.synchronize()
    log(f"[mesh] (c) entry(): positions {tuple(pos.shape)} {pos.dtype} on "
        f"{pos.device} in {time.perf_counter() - t0:.2f} s, finite "
        f"{bool(torch.isfinite(pos).all())}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("entry() gave non-finite positions")
    t0 = time.perf_counter()
    dry = tentry.dryrun_multichip(1)
    log(f"[mesh] (c) dryrun_multichip(1): {time.perf_counter() - t0:.2f} s "
        f"(a spawned NCCL rank), loss proxies dense {dry['dense']:.6f}, "
        f"cg-dia {dry['cg-dia']:.6f}, the cg step's launches "
        f"{dry['launches']}")
    if min(dry["launches"].values()) <= 0:
        raise AssertionError("dryrun_multichip(1)'s cg step launched "
                             f"{dry['launches']}")

    if torch.cuda.device_count() < 2:
        log("[mesh] one card on this machine: no multi-card run of (a)")
    else:
        mesh_multicard(sc, spec, s0, params, device)
    return launches


def mesh_multicard(sc, spec, s0, params, device):
    """[mesh] (a) at world = device_count through launch(), one member a
    card, under deterministic algorithms, against the serial backwards of
    the same members."""
    from thinshelllab_torch.parallel import mesh as pmesh

    n, lr = torch.cuda.device_count(), 1e-3
    traj = torch.zeros((MESH_T + 1, sc.n_part, 6), dtype=spec.dtype,
                       device=device)
    acts_n = mesh_actions(sc.n_part, n, spec.dtype, device)
    t0 = time.perf_counter()
    out = pmesh.launch(deterministic_train_step, n, None, "bench", BENCH_CFG,
                       tuple(a.cpu().numpy() for a in acts_n),
                       traj.cpu().numpy(), lr, timeout=600)
    secs = time.perf_counter() - t0
    with deterministic():
        g_ref, loss_ref = serial_train_reference(sc, spec, s0, params,
                                                 acts_n)
    e_g = rel_err(out["new_traj"], (traj - lr * g_ref).cpu())
    e_loss = abs(float(out["loss"]) * n - loss_ref) / abs(loss_ref)
    log(f"[mesh] (a) at world {n} over NCCL, one member a card, under "
        f"deterministic algorithms: {secs:.2f} s with the ranks' start; "
        f"rank 0 launches {out['launches']}; new_traj vs serial max rel err "
        f"{e_g:.3e}, loss proxy x {n} vs serial {e_loss:.3e}")
    if not (e_g <= MESH_GRAD_RTOL and e_loss <= MESH_LOSS_RTOL
            and min(out["launches"].values()) > 0):
        raise AssertionError(f"the {n}-card train step disagrees")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available; the port's "
                         "smoke run needs one CUDA card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.ops import element_kernels as EK
    from thinshelllab_torch.scenes import bench_scene

    for mod in (K, EK):
        t0 = time.perf_counter()
        mod.build(verbose=True)
        mod._load()
        log(f"[build] nvcc sm_90a -> {os.path.relpath(mod._LIB_PATH, ROOT)} "
            f"in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    sc = bench_scene.make(**BENCH_CFG)
    s = sc.spec
    log(f"[scene] bench cloth_N=70 built on the host in "
        f"{time.perf_counter() - t0:.2f} s: NV {s.NV}, faces "
        f"{s.faces.shape[0]}, NVp {s.dia.NVp}, {len(s.dia.offsets)} offsets, "
        f"contact capacity {s.contact.capacity}, hinges "
        f"{s.cloth.hinge_verts.shape[0]}")

    kres = timed("kernel checks", kernel_checks, sc, device)
    timed("self-contact", self_contact_phase, device, "early")
    launches_render = timed("render", render_phase, device)
    timed("debug", debug_phase, device)
    timed("bend-batch", bend_batch_phase, device)
    timed("profile-trace", profile_trace_phase, device)
    ekres = timed("element-kernels", element_kernels_phase, device)
    timed("native", native_phase)
    timed("golden", golden_check, device)
    timed("golden-adjoint", golden_adjoint_check, device)
    t_main = time.perf_counter()

    spec, s0, params = sc.to(device, torch.float32)
    gp = spec.dev.grid_plan
    log(f"[scene] grid plan {[(N, M, v, len(l)) for N, M, v, l in gp]} "
        f"(N, M, first vertex, lanes), bcr_cutoff {spec.bcr_cutoff}, "
        f"GMRES restart {min(spec.cg_max_iter, 64)}, adjoint tol "
        f"{spec.cg_tol if spec.adj_tol is None else spec.adj_tol}")
    buf_w, _, _ = rollout(spec, s0, params, device)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    precond_calls, wrapper = [0], K.dia_precond

    def counted(*a, **k):
        precond_calls[0] += 1
        return wrapper(*a, **k)

    K.dia_precond = counted  # the CG preconditioner's calls
    try:
        reset_launches()
        buf, stats, secs = rollout(spec, s0, params, device)
        launches = launch_counts()
    finally:
        K.dia_precond = wrapper
    peak = torch.cuda.max_memory_allocated(device)
    pos = buf["pos"]
    cloth_nv = (70 + 1) ** 2
    if pos.shape != (T_STEPS + 1, spec.NV, 3):
        raise AssertionError(f"positions have shape {tuple(pos.shape)}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite positions in the main rollout")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if launches["dia_precond"] != precond_calls[0]:
        raise AssertionError(f"{launches['dia_precond']} dia_precond launches"
                             f" for {precond_calls[0]} preconditioner calls")
    check_element_launches("[main]", launches, stats["hess_builds"])
    reward = float(sc.reward({"pos": pos}))
    log(f"[main] f32 T={T_STEPS} with kernels: {T_STEPS / secs:.4f} steps/s "
        f"({secs:.3f} s), Newton iters {stats['newton_iters']}, operator "
        f"builds {stats['hess_builds']}, CG iters {stats['cg_iters']}, "
        f"line-search trials {stats['ls_trials']}, CG preconditioner calls "
        f"{precond_calls[0]}, launches {launches}, peak "
        f"memory {peak / 2**20:.1f} MiB, reward -sum(z_cloth) {reward:.6f}")

    spec_p = spec.replace(spmv="plain")
    rollout(spec_p, s0, params, device)  # warm-up
    reset_launches()
    buf_p, stats_p, secs_p = rollout(spec_p, s0, params, device)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {K.LAUNCHES}")
    disp = float((pos[-1, :cloth_nv] - pos[0, :cloth_nv]).abs().max())
    dpos = float((buf_p["pos"] - pos).abs().max())
    rel = dpos / disp
    # the kernel path twice: scatter-adds with atomics sum in another order
    # each run
    rerun = float((buf_w["pos"] - pos).abs().max()) / disp
    log(f"[plain] f32 T={T_STEPS} plain path: {T_STEPS / secs_p:.4f} steps/s "
        f"({secs_p:.3f} s), Newton iters {stats_p['newton_iters']}, CG iters "
        f"{stats_p['cg_iters']}; max |dpos| vs kernels {dpos:.3e} m = "
        f"{rel:.3e} of the largest cloth displacement {disp:.3e} m "
        f"(tol {PLAIN_VS_KERNEL_RTOL:.0e}); kernel path run twice: "
        f"{rerun:.3e}")
    if not rel <= PLAIN_VS_KERNEL_RTOL:
        raise AssertionError(f"plain and kernel rollouts differ ({rel:.3e})")

    log(f"[time] main and plain: {time.perf_counter() - t_main:.1f} s")
    launches_bwd, _ = timed("adjoint", adjoint_phase, sc, spec, params, buf,
                            secs, device)
    timed("phases", phase_timers, sc, spec, s0, params, device)
    timed("profile", profile_phase, sc, spec, s0, params, device)
    timed("adjoint-press", press_phase, sc, spec, s0, params, device)
    launches_fn = timed("full-newton", full_newton_phase, device)

    timed("folding-golden", folding_golden_check, device)
    fsc, fdrv, finfo, launches_fold = timed("folding-trajopt",
                                            folding_trajopt, device)
    timed("folding-f32-adjoint", folding_f32_adjoint, fsc, finfo, device)
    timed("folding-phases", folding_phases, fsc, fdrv, device)

    timed("scenes-golden", scenes_golden_check, device)
    timed("scenes", scenes_phase, device)
    timed("scenes-trajopt", scenes_trajopt_phase, device)
    timed("dp", dp_phase, device)
    timed("cmaes-golden", cmaes_golden_check, device)
    timed("cmaes", cmaes_phase, device, "folding", solver="auto",
          max_newton_iter=TRAJOPT_NEWTON)
    with deterministic():
        launches_cmaes_cg, _, rewards_cmaes_cg = timed(
            "cmaes-cg", cmaes_phase, device, CMAES_CG_SCENE, solver="cg",
            max_newton_iter=CG_NEWTON)
    for name, n in launches_cmaes_cg.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"CMA-ES generation under cg ({n})")
    timed("rl-golden", rl_golden_check, device)
    timed("rl", rl_phase, device)

    cg_k = timed("cg-kernels", cg_kernel_checks, device)
    launches_cg = timed("cg-scenes", cg_scenes_phase, device)
    timed("cg-trajopt", cg_trajopt_phase, device)
    k40, launches_40k = timed("bench-40k", bench40k_phase, device)
    timed("self-contact-late", self_contact_phase, device, "late")
    launches_mesh = timed("mesh", mesh_phase, sc, spec, s0, params, device,
                          rewards_cmaes_cg)
    for name in launches_cg:
        if launches_cg[name] <= 0 or launches_40k[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the cg "
                                 f"scenes ({launches_cg[name]}) or the 40k "
                                 f"bench ({launches_40k[name]})")

    src = "thinshelllab_torch/csrc/dia_spmv.cu"
    replaces = {"dia_spmv": "thinshelllab_tpu/ops/dia_spmv.py:93",
                "dia_precond": "thinshelllab_tpu/ops/dia_spmv.py:237"}
    log(f"[done] {time.perf_counter() - T_START:.1f} s in all")

    def plans(name):
        """Device ms against the bound on each plan this run launched on."""
        out = [dict(plan=f"{scene} {dt}", **{
            k: r[name][k] for k in ("ms", "bound_ms", "max_abs_err")},
            **r["geometry"])
            for scene, by_dt in cg_k.items() for dt, r in by_dt.items()]
        return out + [dict(plan=f"bench-40k {dt}", **{
            k: r[name][k] for k in ("ms", "bound_ms", "max_abs_err")},
            **r["geometry"]) for dt, r in k40.items()]

    paths = dict(forward=launches, backward=launches_bwd,
                 full_newton=launches_fn, folding_trajopt=launches_fold,
                 cg_scenes=launches_cg, bench_40k=launches_40k,
                 cmaes_cg=launches_cmaes_cg, render=launches_render,
                 mesh=launches_mesh)

    def counts(name):
        """The kernel's launches on each path this run drove."""
        return dict(launches=launches[name] + launches_bwd[name],
                    **{f"launches_{p}": c[name] for p, c in paths.items()})

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces[name],
             **counts(name), plans=plans(name), **kres[name])
        for name in ("dia_spmv", "dia_precond")] + [
        dict(name=name, route="cuda", source="thinshelllab_torch/csrc/"
             "elements.cu", replaces=None, **counts(name), **ekres[name])
        for name in ("element_eval", "element_fuse")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

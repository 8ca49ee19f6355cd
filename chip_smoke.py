#!/usr/bin/env python3
"""Smoke run of the PyTorch port (srl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. build both CUDA kernels from the checkout with nvcc, in parallel: the
   Kuka ray tracer (srl_tpu_torch/csrc/render3d.cu) and the MobileRobot
   sprite compositor (srl_tpu_torch/csrc/render2d.cu); print each kernel's
   registers and spills (ptxas) and its SASS instruction counts (cuobjdump);
2. hold each kernel against its plain PyTorch twin on the card: render3d on
   every Kuka render configuration (agreement: over 99.5% of the values
   equal and under 0.5% off by more than 2), and bit-equal to its own
   launch with culling off; render2d bit for bit on the four MobileRobot
   variants at 256 envs x 224x224, reset and after 20 steps, and on the
   top-down half of the 6-channel first-person output;
3. time each kernel (over rotating outputs larger than the 50 MB L2, and
   into one output as earlier versions were timed) and its twin with CUDA
   events at its main path's shape, and compute the bound from the work
   these inputs need (render3d: the (pixel, primitive) pairs its culling
   rectangles keep); then conv1's two kernels (csrc/conv1.cu): the forward
   (with and without the mask of the double backward) and the weight
   gradient against their plain twins on uint8 and float32 frames at the
   main paths' shapes and at odd ones (forward within one bf16 unit of the
   output's scale, gradients within 1e-4, a repeated call bit-equal), each
   timed at 224x224x3 (N=256, 8,192) and the folded 112x112x3 (N=1,024,
   32,768) beside its byte bound, its twin and the cuDNN call it replaced
   (``library_ms``), and one PPO2 update of MobileRobot 224x224 (256 envs)
   and of Kuka 112x112 (1,024 envs) launching the forward exactly 129 + 16
   and the weight gradient 16 times;
4. drive the main paths through the training CLI, each with the launch
   counts set to 0 just before and read just after, and check their
   outputs: PPO2 on KukaButtonGymEnv-v0 from raw pixels (256 envs, render
   scale 2, coarse observations, 2 updates), PPO2 on MobileRobotGymEnv-v0
   from 224x224 raw pixels (256 envs, 3 updates), and the ground-truth
   quickstart (4096 envs, 2 updates); the two pixel runs launch conv1's
   forward exactly 145 and its weight gradient 16 times an update;
5. drive the SRL workflow through its three CLIs, each step with the launch
   counts set to 0 just before and read just after: record a MobileRobot
   dataset (32 envs, 32 episodes of 64 frames, 224x224x3; render2d), train
   an autoencoder on it (state dim 3, batch 128, 2 epochs; every logged
   loss finite), serve it to PPO2 through SRLEncodedEnv (256 envs, 3
   updates, observations [256, 3]; render2d); then record a Kuka dataset at
   render scale 2 (32 envs, 32 episodes of up to 32 frames, 224x224x3;
   render3d), train an autoencoder on it for 1 epoch and serve it to PPO2
   (512 envs, 2 updates; render3d);
6. drive the new envs through the training CLI, the counts set to 0 just
   before each run and read just after: PPO2 on the mixed Kuka + Omnirobot
   pixel batch (``--mixed-envs KukaButtonGymEnv-v0 OmnirobotEnv-v0``, 256
   envs: 128 Kuka traced at render scale 2 by render3d and upsampled, 128
   Omnirobot rasterised, one [256, 224, 224, 3] batch, 2 updates; render3d
   must have run), CarRacing from 224x224 pixels (256 envs, 2 updates) and
   Omnirobot from ground truth (1024 envs, 2 updates); then the Kuka IK
   debugger (``srl_tpu_torch.envs.debug --target 0.4 0.1 0.35 --steps 200
   --out DIR``), whose frame render3d traces;
7. PPO2's full surface and the other agents on the Kuka pixel path (256
   envs, 112x112 coarse traces, the Nature CNN), the counts set to 0 just
   before each run: one rollout storing env states, one minibatch of 8,192
   of them re-rendered by render3d and bit-equal to the frames the rollout
   saw; render3d at N=8,192 against its twin (run in chunks of 256 envs)
   and timed with its bound; ``--recompute-obs --checkpoint-interval 1``
   for 2 updates (render3d launches 16 more times an update than the
   frame-storing run of step 4); ``--resume`` of that run for 2 more updates
   (the checkpoint's steps grow, the monitor keeps one header, the final
   model loads); ``--load-rl-model-path`` of its first model with
   ``--hyperparam learning_rate:0`` for 1 update (the saved parameters equal
   the loaded ones bit for bit); A2C (256 envs), PPO1 (64 envs, 256 steps)
   and TRPO (64 envs) for 2 updates each, every loss finite and render3d
   launched;
8. the recurrent agents and ACKTR at the reference's widths (Nature CNN
   32/64/64/fc512, an LSTM of 64, 256 envs), each through the training CLI
   with the counts set to 0 just before: 8a, PPO2 with ``--policy cnnlstm``
   on the Kuka pixel path for one update at the tuned n_steps 609 (155,904
   env steps; render3d must launch exactly 610 times), its saved
   ``ppo2_lstm`` model reloaded and acting as the trained agent (the
   run's checkpoint) does; 8b, A2C with ``--policy cnnlnlstm`` on the same
   path (5 steps, 2 updates); 8c, ACKTR with the CNN on MobileRobot 224x224
   pixels (render2d; 20 steps, 2 updates: the 2305x2305 fc factor and its
   inverse), its ``eta`` printed; 8d, ACKTR with ``--policy cnnlstm`` on the
   Kuka pixel path (2 updates);
9. the replay agents at the reference's widths (256 envs, each agent's
   default config), through the training CLI with the counts set to 0 just
   before each run: 9a, ACER with the Nature CNN on the Kuka pixel path for
   6 iterations of 20 x 256 steps (render3d exactly 121 launches; 4 replay
   updates in each of iterations 4-6 from its 10.1 GB segment store; conv1's
   forward 20 + 2 and its weight gradient 1 an iteration, 2 and 1 more a
   replay update; every
   logged loss finite), its saved ``acer`` model reloaded and acting as the
   trained agent does on two steps of 8 Kuka frames; 9b, RecurrentACER with
   ``--policy cnnlstm`` there for 5 iterations (render3d exactly 101; replays
   in iterations 4-5), its ``acer_lstm`` model reloaded and acting as the
   trained agent with a ``dones`` mask; 9c, DQN on MobileRobot 224x224
   pixels for 2 chunks of 64 x 256 steps (render2d exactly 129 launches, 32
   TD updates, conv1's forward once a step and 3 times a TD update, its
   weight gradient once a TD update, a target copy wherever the global
   step modulo 500 is below 256), its ``deepq`` model reloaded and acting greedily as the trained
   agent;
10. the last five agents at the reference's widths, each agent's default
   config, through the training CLI with the counts set to 0 just before
   each run: 10a, SAC with the Nature CNN on the continuous Kuka pixel path
   (``-c``, 3-d actions) for 2 chunks of 64 x 256 steps (render3d exactly
   129 launches, 128 updates from its 3.76 GB store, every loss finite,
   ``alpha`` moved), its ``sac`` model reloaded and acting as the trained
   agent (``tanh`` of the mean, within 1e-6) on two steps of 8 Kuka frames;
   10b, DDPG with the Nature CNN on continuous MobileRobot 224x224 pixels
   (render2d exactly 129, 128 updates from its 15.05 GB store, OU noise),
   its ``ddpg`` model reloaded likewise; 10c, ARS on the Kuka pixel path
   with the shaped reward (20 envs, ``M`` [37,632, 6]) for 2 generations
   (render3d exactly 522, ``M`` moved), its ``ars`` model reloaded and
   acting as the trained agent; 10d, CMA-ES with its CNN on MobileRobot 224x224 pixels (20 envs,
   n = 7,572, the 7,572 x 7,572 float64 covariance and its ``eigh`` on the
   card, whose seconds it prints) for 2 generations (render2d exactly 522,
   ``sigma`` finite), ``best_model`` acting as the reloaded ``cma-es``
   pickle; 10e, the random agent on the Kuka pixel path (256 envs, one
   chunk of 256 steps: render3d exactly 257), its rate the Kuka env and
   render rate with no policy in the loop;
11. replays and the host-side tools. Each of six kept runs replayed by
   ``srl_tpu_torch.replay.enjoy`` at 256 envs for 64 steps with ``--plot``,
   the counts set to 0 just before each: 11a the Kuka pixel run of step 4
   and 11b the MobileRobot pixel run, each with ``--render`` (render3d,
   render2d exactly 1 + 64 + 7 launches: the reset, the steps, the strip's
   frames, each frame against the twin's render of its state); 11c the
   PPO2 cnnlstm run of 8a (reloaded as RecurrentPPO2, render3d 65); 11d
   SAC's continuous Kuka run of 10a (65); 11e the mixed Kuka + Omnirobot
   run of step 6 (the pod rebuilt, render3d 72 for its Kuka half and the
   strip); 11f the MobileRobot SRL serving run of step 5 ([N, 3] encoder
   states, render2d 72). conv1 launches 2 x 64 times in each replay of a
   discrete pixel policy (the action and ``--plot``'s probabilities), 64 in
   SAC's, none in 11f. Each reloaded agent acts as the trained one, and
   every return is finite. Then, over the smoke's own log root: a pipeline
   grid of 2 seeds of the quickstart, a Hyperband search (``--max-eval 3``)
   on MobileRobot ground truth, plots, aggregate_plots, compare_plots and
   gather_results, the live server's ``data.json``, ``dataset_fusioner`` of
   two recorded MobileRobot datasets and ``change_to_relative_pos``, and a
   frame store round trip of [2048, 224, 224, 3] uint8. Whether matplotlib
   and pyzmq import is printed; without matplotlib only the figures are
   left out;
12. the ZMQ layer over loopback, each server in a daemon thread on a free
   port: 12a, the SRL training service (``srl_tpu_torch.srl.server.serve``
   on the card) answers an ``SRLClient``'s HELLO, then its LEARN on the
   MobileRobot dataset of step 5 (2,048 frames of 224x224x3; autoencoder,
   state dim 3, 1 epoch) with READY and a checkpoint that exists; that
   checkpoint, named by an ``srl_models.yaml``, is served to PPO2 through
   SRLEncodedEnv by the training CLI (256 envs, 2 updates: render2d
   exactly 1 + 2 x 128 = 257 launches, the counts set to 0 just before),
   its observations [256, 3] and the frames it renders after step 128
   (kept as they are served) bit-equal to the twin's; a LEARN on a folder
   that does not exist answers ERROR, the server then still answers
   HELLO, and EXIT stops it within 5 s. 12b, the
   Omnirobot simulator server (``real_robots.sim_server``, its env on the
   card) driven by ``real_robots.remote_env.OmniRobotRemoteEnv`` through
   one episode of 224x224 raw pixels (reset and 251 steps: ``done`` turns
   true at step 251, after ``Omnirobot.MAX_STEPS`` = 250); every frame,
   reward and position that arrives over the socket equals, bit for bit,
   the in-process ``OmniRobotEnv`` stepped on the card from the same
   generator seed and actions; the loopback steps/s and the bytes per frame
   are printed. Each phase prints its seconds;
13. the data-parallel layer (``srl_tpu_torch.parallel``) through
   ``srl_tpu_torch.parallel.dp_ppo``, PPO2 with its state laid out by
   ``shard_ppo_state``: 13a, a one-rank NCCL world in this process
   (``distributed.initialize(device="cuda")`` with ``WORLD_SIZE=1``) runs the
   Kuka pixel run (256 envs, 112x112 coarse traces, the Nature CNN, 2
   updates); its losses and parameters equal the same run without a mesh
   within the reference's one-update bar (pg_loss 1e-4, parameters 1e-3),
   and render3d launches as often (1 + 2 x 128). 13b, two processes on the
   one card (each on cuda:0), joined by gloo over 127.0.0.1, run MobileRobot
   224x224 pixels at 256 global envs (128 a rank) for 2 updates, after 260
   steps of fixed actions whose rewards, dones and per-env frame
   fingerprints equal, bit for bit, one process stepping all 256 envs;
   pg_loss is within the reference's curve bar (5e-3) of that process's run
   and the parameters within a tenth of the step they took (a rank's
   bfloat16 convolutions round its rows otherwise: see STEP_RTOL), and
   render2d launches 2 x 128 times on each rank at N=128. 13c, the
   reference's mixed pod (Kuka + Omnirobot pixels, 256 global envs over two
   processes, 1 update, 64 fingerprinted steps): each rank holds one
   family, so rank 0 traces its 128 Kuka envs with render3d and rank 1
   launches no kernel; the same checks. Each prints
   the global and per-rank env-steps/s, the collectives' seconds an update,
   each rank's launches and peak memory. The child processes run under a
   hard timeout and are killed on failure;
14. tensor parallelism (``dp_ppo --tp 2``): each rank holds its half of
   every weight's output features and of Adam's moments and gathers the
   whole weights over its tp group before a forward. 14a, dp1 x tp2: two
   gloo processes on the card each step all 256 MobileRobot 224x224 envs
   of 13b's run (2 updates, 260 fingerprinted steps, equal bit for bit to
   13b's one process, whose run is reused); each rank runs the one-process
   shapes, so it is held to the one-update bar against that run, both
   ranks' gathered parameters are equal, and render2d launches 2 x 128
   times on each rank at N=256. 14b, dp2 x tp2: 13c's mixed pod over four
   processes, ranks 0 and 1 the Kuka rows, 2 and 3 the Omnirobot rows
   (render3d 128, 128, 0 and 0 launches), held to 13c's bars against 13c's
   one process and to the one-update bar against 13c's dp2 x tp1 ranks. Each
   prints each rank's ``state_mb`` (its parameters and Adam moments) beside
   the one process's, and the tp group's collectives' seconds apart;
15. the other agents whose state ``shard_ppo_state`` lays out, each through
   ``dp_ppo --algo ... [--policy cnnlstm]`` at 256 global envs over two gloo
   processes on the card (128 a rank), against one process on the same
   batch, each agent's default config cut in depth only (``DP_AGENT_RUNS``):
   15a PPO1, 15b A2C, 15c TRPO, 15f ACER on the Kuka pixel path (render3d),
   15d the recurrent PPO2 and 15e the recurrent A2C (``cnnlstm``) and 15g
   RecurrentACER (``cnnlstm``) on MobileRobot 224x224 (render2d); 15h TRPO
   on dp1 x tp2, each rank stepping all 256 envs, against 15c's one process.
   Each run: 16 fingerprinted steps equal to one process's rows, finite
   losses, 13b's bars (the loss within the curve bar: pg_loss, TRPO's kl,
   ACER's entropy; the parameters within a tenth of their step; 15h, whose
   ranks run the one-process shapes, the one-update bar), and each rank's
   launches exactly n_steps an update (at N=128; N=256 in 15h); in 15c
   (each rank and the one process) and 15h, conv1's weight gradient
   exactly 16 an update and its forward 39 to 57 (``trpo_conv1``: the
   line search's trials vary).

The line before the last is a JSON object with each kernel's numbers, the
last ``{"ok": true, "device": {...}}``. Needs the card and the rest of the
repository; imports nothing of JAX.
"""
import contextlib
import copy
import dataclasses
import http.client
import itertools
import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# bf16 on them (dense), and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Timing writes into outputs that together hold more than twice the L2.
ROTATE_BYTES = 128 << 20

# (env class, kwargs, N): the Kuka render configurations.
RENDER_CASES = [
    ("KukaButtonEnv", dict(render_scale=1), 64),
    ("KukaButtonEnv", dict(render_scale=2, coarse_obs=True), 256),
    ("KukaRandButtonEnv", dict(render_scale=1), 64),
    ("Kuka2ButtonEnv", dict(render_scale=1), 64),
    ("KukaButtonEnv", dict(render_scale=2, multi_view=True), 64),
]
# (env class, kwargs, N): the MobileRobot render configurations; the first
# is the main path's.
RENDER2D_CASES = [
    ("MobileRobotEnv", {}, 256),
    ("MobileRobotEnv", dict(random_target=True), 256),
    ("MobileRobot1DEnv", dict(random_target=True), 256),
    ("MobileRobot2TargetEnv", dict(random_target=True), 256),
    ("MobileRobotLineTargetEnv", dict(random_target=True), 256),
    ("MobileRobotEnv", dict(fpv=True, random_target=True), 64),
]
KUKA_ARGS = ["--env", "KukaButtonGymEnv-v0", "--srl-model", "raw_pixels",
             "--algo", "ppo2", "--num-envs", "256", "--render-scale", "2",
             "--coarse-obs", "--num-timesteps", "60000", "--no-vis"]
MOBILE_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "raw_pixels",
               "--algo", "ppo2", "--num-envs", "256", "--num-timesteps", "90000",
               "--no-vis"]
QUICKSTART_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                   "--algo", "ppo2", "--num-envs", "4096", "--num-timesteps", "960000",
                   "--no-vis"]
SRL_MOBILE_DATA = ["--env", "MobileRobotGymEnv-v0", "--num-envs", "32", "--max-steps", "63",
                   "--num-episode", "32", "--name", "mobile"]
SRL_KUKA_DATA = ["--env", "KukaButtonGymEnv-v0", "--num-envs", "32", "--max-steps", "31",
                 "--num-episode", "32", "--render-scale", "2", "--name", "kuka"]
SRL_TRAIN = ["--srl-model", "autoencoder", "--state-dim", "3", "--batch-size", "128"]
SRL_MOBILE_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "autoencoder",
                   "--algo", "ppo2", "--num-envs", "256", "--num-timesteps", "90000",
                   "--no-vis"]
SRL_KUKA_ARGS = ["--env", "KukaButtonGymEnv-v0", "--srl-model", "autoencoder",
                 "--algo", "ppo2", "--num-envs", "512", "--render-scale", "2",
                 "--num-timesteps", "120000", "--no-vis"]
MIXED_ARGS = ["--env", "KukaButtonGymEnv-v0", "--mixed-envs", "KukaButtonGymEnv-v0",
              "OmnirobotEnv-v0", "--srl-model", "raw_pixels", "--algo", "ppo2",
              "--render-scale", "2", "--num-envs", "256", "--num-timesteps", "65536",
              "--no-vis"]
CAR_ARGS = ["--env", "CarRacingGymEnv-v0", "--srl-model", "raw_pixels", "--algo", "ppo2",
            "--num-envs", "256", "--num-timesteps", "60000", "--no-vis"]
OMNI_GT_ARGS = ["--env", "OmnirobotEnv-v0", "--srl-model", "ground_truth", "--algo", "ppo2",
                "--num-envs", "1024", "--num-timesteps", "240000", "--no-vis"]
RUN_FILES = ("args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
             "ppo2_final_model.pkl")


def log(msg: str) -> None:
    print(msg, flush=True)


# csrc/render3d.cu's warp sub-tile, TILE_W x TILE_H traced pixels.
SUBTILE_W, SUBTILE_H = 4, 8

# Float32 operations of csrc/render3d.cu that depend on the ray, per traced
# pixel and view: per primitive traced there, and the shade.
PRIM_FLOPS = {"cylinder": 25, "capsule": 28, "sphere": 11}
SHADE_FLOPS = 16


def render_flops_per_pixel(render3d, cfg) -> int:
    """Float32 operations per traced pixel and view when every primitive is
    traced at every pixel, as without culling: PRIM_FLOPS of each primitive
    plus the shade. They count the operations on the ray's components; an
    IEEE square root or division counts as 1 (on this card each is a
    sequence of several instructions through the MUFU pipe), and neither the
    per-env terms, computed once per block, nor the normals of winners are
    counted. So the bound is a lower bound."""
    return sum(PRIM_FLOPS[k] for k in render3d.primitive_kinds(cfg)) + SHADE_FLOPS


def bound_ms(flops: float, n_bytes: float) -> tuple:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def render_bound_ms(render3d, cfg, scene) -> dict:
    """The bound of render3d on these inputs: the operations of the (pixel,
    primitive) pairs that the culling rectangles keep (``kept_pixels``,
    computed on the host from this scene) plus the shade of every pixel,
    against the output written once plus the scene, rays and background
    planes read once; and, for comparison, the bound without culling."""
    n, views = scene.shape[0], len(cfg.views)
    pixels = cfg.trace_h * cfg.trace_w
    kinds = render3d.primitive_kinds(cfg)
    kept = sum(render3d.kept_pixels(cfg, scene, v).sum(0) for v in range(views))
    pair_flops = sum(int(kept[i]) * PRIM_FLOPS[k] for i, k in enumerate(kinds))
    out_bytes = n * pixels * cfg.up * cfg.up * 3 * views
    in_bytes = scene.numel() * 4 + views * 10 * pixels * 4  # scene, rays, bg
    bound, by = bound_ms(pair_flops + SHADE_FLOPS * n * pixels * views, out_bytes + in_bytes)
    unculled, unculled_by = bound_ms(render_flops_per_pixel(render3d, cfg) * n * pixels * views,
                                     out_bytes + in_bytes)
    # Sub-tiles that a rectangle meets: where the kernel traces at all.
    import torch

    ty = torch.arange(math.ceil(cfg.trace_h / SUBTILE_H), device=scene.device) * SUBTILE_H
    tx = torch.arange(math.ceil(cfg.trace_w / SUBTILE_W), device=scene.device) * SUBTILE_W
    busy = pairs = 0
    for v in range(views):
        r = render3d.cull_rects(cfg, scene, v)[..., None]
        meets = (((r[..., 0, :] <= ty + SUBTILE_H - 1) & (r[..., 1, :] >= ty))[..., :, None]
                 & ((r[..., 2, :] <= tx + SUBTILE_W - 1) & (r[..., 3, :] >= tx))[..., None, :])
        busy += int(meets.any(1).sum())
        pairs += int(meets.sum())
    return dict(bound_ms=bound, bound_by=by, bound_unculled_ms=unculled,
                bound_unculled_by=unculled_by, n_prims=len(kinds),
                kept_per_pixel=float(kept.sum()) / (n * pixels * views),
                subtiles=len(ty) * len(tx), busy_subtiles=busy / (n * views),
                pairs_per_busy=pairs / max(busy, 1))


def render2d_flops_per_pixel(env) -> int:
    """Float32 operations of csrc/render2d.cu per pixel: the target disk 6
    (2 subtractions, 2 products, 1 sum, 1 compare) or the line band 4, the
    second disk 6, the body box 4 and the wheel pads 4 (2 subtractions and
    2 compares each); absolute values are free operand modifiers."""
    first = 4 if env.line_target else 6
    second = 6 if env.n_targets > 1 and not env.line_target else 0
    return first + second + 4 + 4


def render2d_bound_ms(env, n) -> tuple:
    h, w = env.render_shape
    flops = render2d_flops_per_pixel(env) * n * h * w
    out_bytes = n * h * w * 3  # channels 0-2
    in_bytes = h * w * 4 + (h + w) * 4 + n * 8 * 4  # background, xs, ys, scene
    return bound_ms(flops, out_bytes + in_bytes)


# conv1 on the main paths, (H, W, C, k, N): MobileRobot's 224x224x3 frames
# (8x8 stride 4) at a rollout step's 256 and a minibatch of 8,192; Kuka's
# 112x112x3 traces (the 2x upsample folded in: 4x4 stride 2) at 1,024 and
# 32,768. Then odd shapes and deep frame stacks (the first-person view's 6
# channels x 4; RGB x 15, which both kernels take at 224x224 in two passes
# of 23 channels, the last with a zero channel) for the comparison only.
CONV1_CASES = [(224, 224, 3, 8, 256), (224, 224, 3, 8, 8192), (112, 112, 3, 4, 1024),
               (112, 112, 3, 4, 32768)]
CONV1_ODD = [(37, 41, 3, 8, 5), (29, 35, 6, 4, 7), (40, 36, 12, 8, 3), (224, 224, 6, 8, 16),
             (224, 224, 24, 8, 16), (112, 112, 24, 4, 16), (224, 224, 45, 8, 4)]
# The weight gradient against float32 autograd, as a relative norm: sound
# runs read 1e-7 to 4.0e-5 (the larger with float32 frames, where cuDNN's
# float32 reference is the less exact side); losing one block's partial
# sum fails every uint8 case of the gpu test.
CONV1_GRAD_RTOL = 1e-4
# PPO2's update at 128 steps, 4 minibatches and 4 epochs: a forward for each
# rollout step and the last value, one forward and one weight gradient a
# minibatch.
CONV1_PER_UPDATE = {"conv1": 128 + 1 + 16, "conv1_wgrad": 16}


def ppo2_conv1(updates: int, n_steps: int = 128, minibatches: int = 4, epochs: int = 4) -> dict:
    """conv1's launches in ``updates`` PPO2 updates: a forward for each
    rollout step and the last value, a forward and a weight gradient a
    minibatch and epoch."""
    return {"conv1": updates * (n_steps + 1 + minibatches * epochs),
            "conv1_wgrad": updates * minibatches * epochs}


def trpo_conv1(accepted: list, n_steps: int) -> dict:
    """conv1's launches in TRPO updates (the default config), ``accepted``
    each update's line_search_accepted: {"conv1_wgrad": n, "conv1": (least,
    most)}. An update runs a forward for each rollout step and the last
    value, the old policy's, the surrogate's and the KL's (each of these two
    with a weight gradient, the KL's differentiable), one masked forward and
    one weight gradient for each Fisher-vector product (cg_iters + 1), the
    surrogate before the line search, one or two forwards for each trial
    (the KL only where the surrogate improved), the surrogate and KL at the
    step taken, and a forward and a weight gradient for each value step."""
    from srl_tpu_torch.agents.trpo import TRPOConfig

    cfg = TRPOConfig()
    fixed = n_steps + 1 + 3 + (cfg.cg_iters + 1) + 1 + 2 + cfg.vf_iters
    # Trials: accepted at i, i + 2 to 2 i + 2; none accepted, ls_steps to 2 ls_steps.
    least = sum(fixed + (2 if a else cfg.ls_steps) for a in accepted)
    most = sum(fixed + 2 * cfg.ls_steps for _ in accepted)
    return {"conv1": (least, most),
            "conv1_wgrad": len(accepted) * (2 + cfg.cg_iters + 1 + cfg.vf_iters)}


def hold_conv1(what: str, launches: dict, expected: dict) -> dict:
    """conv1's launches of a run against ``expected`` (a count, or a (least,
    most) range); returns the run's counts."""
    got = {k: launches[k] for k in expected}
    for k, want in expected.items():
        lo, hi = want if isinstance(want, tuple) else (want, want)
        if not lo <= got[k] <= hi:
            raise AssertionError(f"{what}: {k} launched {got[k]} times, not {want}")
    log(f"[main] {what}: conv1 launches {got}, expected {expected}")
    return got


def conv1_bound_ms(h, w, c, k, n, wgrad: bool) -> tuple:
    """The least time of conv1's forward (or weight gradient) on the card:
    its bf16 tensor-core operations, against the frames read once, the bf16
    output written once (the weight gradient reads it and its gradient) and
    the weight."""
    from srl_tpu_torch.ops import conv1

    ho, wo = conv1.out_hw(h, w, k, conv1.GEOMETRY[k])
    flops = 2 * n * ho * wo * 32 * k * k * c
    n_bytes = n * h * w * c + n * ho * wo * 32 * 2 * (2 if wgrad else 1) + 32 * (k * k * c + 1) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", n_bytes


def conv1_kernels(torch, dev, train) -> dict:
    """Step 3's conv1 part: the kernels against their twins, their times and
    the launches of one PPO2 update in each cell's shape."""
    import torch.nn.functional as F

    from srl_tpu_torch import ops
    from srl_tpu_torch.ops import conv1

    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(h, w, c, k, n, float_frames=False):
        frames = torch.randint(0, 256, (n, h, w, c), device=dev, dtype=torch.uint8, generator=gen)
        if float_frames:
            frames = frames.float() + torch.rand(frames.shape, device=dev, generator=gen)
        weight = torch.randn((32, c, k, k), device=dev, generator=gen) * (2 / (k * k * c)) ** 0.5
        return frames, weight, torch.randn(32, device=dev, generator=gen) * 0.1

    worst = {"fprop_ulps": 0.0, "masked_ulps": 0.0, "dw_rel": 0.0, "db_rel": 0.0}
    for h, w, c, k, n in [(*case[:4], min(case[4], 1024)) for case in CONV1_CASES] + CONV1_ODD:
        s = conv1.GEOMETRY[k]
        for float_frames in (False, True):
            frames, weight, bias = inputs(h, w, c, k, n, float_frames)
            out = conv1.fprop_cuda(frames, weight, bias, s)
            masked = conv1.fprop_cuda(frames, weight, -bias, s, mask=out)
            g = torch.randn(out.shape, device=dev, generator=gen).to(bf16)
            dw, db = conv1.wgrad_cuda(frames, out, g, k, s)
            again = conv1.fprop_cuda(frames, weight, bias, s), conv1.wgrad_cuda(frames, out, g, k, s)
            torch.cuda.synchronize()
            ulps = {}
            for name, got, want in (
                    ("fprop_ulps", out, conv1.fprop_plain(frames, weight, bias, s)),
                    ("masked_ulps", masked, conv1.fprop_plain(frames, weight, -bias, s, mask=out))):
                scale = want.float().abs().max().item()
                unit = 2.0 ** (math.floor(math.log2(scale)) - 7)
                ulps[name] = (got.float() - want.float()).abs().max().item() / unit
            x = conv1._scaled(frames).float()
            gm = torch.where(out > 0, g, 0).permute(0, 3, 1, 2).float()
            _, dw_ref, db_ref = torch.ops.aten.convolution_backward(
                gm, x, weight, [32], [s, s], [0, 0], [1, 1], False, [0, 0], 1, [False, True, True])
            rel = {"dw_rel": ((dw - dw_ref).norm() / dw_ref.norm()).item(),
                   "db_rel": ((db - db_ref).norm() / db_ref.norm()).item()}
            same = (torch.equal(again[0], out) and torch.equal(again[1][0], dw)
                    and torch.equal(again[1][1], db))
            log(f"[compare] conv1 {h}x{w}x{c} k{k} N={n} {'float32' if float_frames else 'uint8'}: "
                f"forward {ulps['fprop_ulps']:.3f} bf16 units of the output's scale from the "
                f"twin, masked {ulps['masked_ulps']:.3f}; dW {rel['dw_rel']:.2e}, db "
                f"{rel['db_rel']:.2e} from float32; repeated calls bit-equal: {same}")
            for key, v in {**ulps, **rel}.items():
                worst[key] = max(worst[key], v)
            if max(ulps.values()) > 1.0 or max(rel.values()) > CONV1_GRAD_RTOL or not same:
                raise AssertionError(f"conv1 kernels disagree with their twins at {h}x{w}x{c} "
                                     f"k{k} N={n}: {ulps} {rel}, repeatable {same}")

    times = []
    for h, w, c, k, n in CONV1_CASES:
        s = conv1.GEOMETRY[k]
        frames, weight, bias = inputs(h, w, c, k, n)
        out = conv1.fprop_cuda(frames, weight, bias, s)
        g = torch.randn(out.shape, device=dev, generator=gen).to(bf16)
        xb, wb, bb = conv1._scaled(frames), weight.to(bf16), bias.to(bf16)
        gm = torch.where(out > 0, g, 0).permute(0, 3, 1, 2)
        iters = max(3, min(200, int(2e9 / (n * h * w * c))))
        row = {"shape": [h, w, c, k, n]}
        for what, kernel, plain, library in (
                ("fprop", lambda: conv1.fprop_cuda(frames, weight, bias, s),
                 lambda: conv1.fprop_plain(frames, weight, bias, s),
                 lambda: F.conv2d(xb, wb, bb, stride=s)),
                ("wgrad", lambda: conv1.wgrad_cuda(frames, out, g, k, s),
                 lambda: conv1.wgrad_plain(frames, out, g, k, s),
                 lambda: torch.ops.aten.convolution_backward(
                     gm, xb, wb, [32], [s, s], [0, 0], [1, 1], False, [0, 0], 1,
                     [False, True, True]))):
            bound, by, n_bytes = conv1_bound_ms(h, w, c, k, n, what == "wgrad")
            ms = time_ms(kernel, iters)
            row[what] = dict(ms=ms, bound_ms=bound, bound_by=by, share=bound / ms,
                             plain_ms=time_ms(plain, max(3, iters // 4)),
                             library_ms=time_ms(library, max(3, iters // 4)))
            r = row[what]
            log(f"[time] conv1 {what} {h}x{w}x{c} k{k} N={n}: kernel {ms:.4f} ms "
                f"({r['share']:.1%} of the bound {bound:.4f} ms, {by}; "
                f"{n_bytes / ms / 1e9:.3f} TB/s), twin {r['plain_ms']:.4f} ms, the cuDNN "
                f"call alone (library_ms) {r['library_ms']:.4f} ms")
        times.append(row)
        del frames, out, g, xb, gm
        torch.cuda.empty_cache()

    launches = {}
    for env_id, options, n_envs in (
            ("MobileRobotGymEnv-v0", dict(srl_model="raw_pixels"), 256),
            ("KukaButtonGymEnv-v0", dict(srl_model="raw_pixels", render_scale=2,
                                         coarse_obs=True), 1024)):
        cls = train.resolve_policy_class("ppo2", "cnn")
        agent = cls(env=train.make_with_options(env_id, options), num_envs=n_envs, policy="cnn",
                    config=cls.config_class(n_steps=128, nminibatches=4, noptepochs=4),
                    device=dev)
        gen_env = agent._start(5)
        state = agent.init_state(gen_env, 5)
        ops.reset_launches()
        state, _ = agent.train_iteration(state, gen_env)
        torch.cuda.synchronize()
        got = {k: ops.launches()[k] for k in CONV1_PER_UPDATE}
        log(f"[main] conv1 launches in one PPO2 update of {env_id} ({n_envs} envs): {got}")
        if got != CONV1_PER_UPDATE:
            raise AssertionError(f"{env_id}: conv1 launched {got}, not {CONV1_PER_UPDATE}")
        launches[env_id] = got
        del agent, state
        torch.cuda.empty_cache()
    return {"worst": worst, "times": times, "launches": launches}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call. The stream first sleeps for 50 ms, so that the
    host has queued every launch before the first one runs and host-side
    launch cost does not show up as gaps between them."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50e-3 * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(torch, shape, device):
    """An endless cycle over fresh uint8 outputs of ``shape`` that together
    hold at least ROTATE_BYTES, so that no timed launch finds its output in
    the L2 cache."""
    k = max(2, math.ceil(ROTATE_BYTES / math.prod(shape)))
    return itertools.cycle([torch.empty(shape, dtype=torch.uint8, device=device)
                            for _ in range(k)])


SASS_CLASSES = {"MUFU": r"MUFU", "FP32": r"F(FMA|ADD|MUL|MNMX|SETP|SEL)",
                "LDG": r"LDG", "STG": r"STG", "LDS": r"LDS", "STS": r"STS",
                "CTRL": r"BRA|BRX|WARPSYNC|BSYNC|BSSY"}


def sass_counts(text: str) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing: its instruction
    count (NOPs left out) and the count of each class of SASS_CLASSES."""
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((k for k in ("render3d_kernel", "render2d_kernel", "conv1_fprop_kernel",
                                   "conv1_wgrad_kernel", "conv1_wgrad_reduce")
                       if k in m.group(1)), m.group(1))
            if fn.startswith("conv1_") and fn != "conv1_wgrad_reduce":
                fn += "<uint8>" if "IhE" in m.group(1) else "<float>"
            counts[fn] = {"instructions": 0, **{k: 0 for k in SASS_CLASSES}}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is None or not m or m.group(1) == "NOP":
            continue
        counts[fn]["instructions"] += 1
        for k, pattern in SASS_CLASSES.items():
            if re.match(pattern, m.group(1)):
                counts[fn][k] += 1
    return counts


def build_kernels(cuda_build) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    names = ("render3d", "render2d", "conv1")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(cuda_build.build, names)))
    for name in names:
        info = cuda_build.BUILD_INFO[name]
        log(f"[build] {os.path.relpath(paths[name], REPO)}: nvcc {info['seconds']:.1f} s"
            + (" (found built)" if not info["log"] else ""))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for fn, c in sass_counts(cuda_build.sass(name)).items():
            log(f"[sass] {fn}: {c['instructions']} instructions, "
                + ", ".join(f"{k} {c[k]}" for k in SASS_CLASSES))


def compare_render3d(torch, dev, kuka, render3d):
    """Kernel against twin, and culled against unculled bit for bit, on
    every Kuka configuration: (max |diff| to the twin, the main path's
    inputs)."""
    max_err, main_inputs = 0, None
    for name, kwargs, n in RENDER_CASES:
        env = getattr(kuka, name)(srl_model="raw_pixels", **kwargs)
        gen = torch.Generator(device=dev).manual_seed(0)
        states = env.reset(gen, n)
        for _ in range(10):  # move the arm off its rest pose
            states, _, _ = env.step(states, env.action_space.sample(gen, n), gen)
        cfg, scene = render3d._scene_table(env, states)
        cam = render3d.camera_tensors(cfg, dev)
        out = render3d.render_kuka_cuda(cfg, scene, cam)
        unculled = render3d.render_kuka_cuda(cfg, scene, cam, cull=False)
        plain = render3d.render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)
        torch.cuda.synchronize()
        if not torch.equal(out, unculled):
            raise AssertionError(f"render3d {name} {kwargs}: culling changed "
                                 f"{int((out != unculled).sum())} values")
        if out.shape != plain.shape:
            raise AssertionError(f"{name} {kwargs}: {tuple(out.shape)} vs {tuple(plain.shape)}")
        diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
        equal = (diff == 0).double().mean().item()
        off = (diff > 2).double().mean().item()
        max_err = max(max_err, int(diff.max()))
        log(f"[compare] render3d {name} {kwargs} N={n} {tuple(out.shape)}: bit-equal "
            f"to the unculled launch; against the twin {equal:.6f} equal, {off:.6f} off "
            f"by more than 2, max |diff| {int(diff.max())}")
        if not (equal > 0.995 and off < 0.005):
            raise AssertionError(f"render3d kernel disagrees with the twin for {name} {kwargs}")
        if kwargs == dict(render_scale=2, coarse_obs=True):
            main_inputs = (cfg, scene, cam)
    return max_err, main_inputs


def compare_render2d(torch, dev, mobile_robot, render2d):
    """Kernel against twin, bit for bit, on every MobileRobot configuration,
    reset and after 20 steps: (max |diff|, the main path's env and kernel
    inputs)."""
    from srl_tpu_torch import ops

    max_err, main_inputs = 0, None
    for name, kwargs, n in RENDER2D_CASES:
        env = getattr(mobile_robot, name)(srl_model="raw_pixels", **kwargs)
        gen = torch.Generator(device=dev).manual_seed(1)
        states = env.reset(gen, n)
        for n_steps in (0, 20):
            for _ in range(n_steps):
                states, _, _ = env.step(states, env.action_space.sample(gen, n), gen)
            ops.reset_launches()
            out = render2d.render_mobile_robot(env, states)
            if ops.launches()["render2d"] != 1:
                raise AssertionError(f"render2d {name}: the kernel was not launched")
            scene = render2d.scene_params(env, states)
            xs, ys, bg = render2d.static_tensors(env.dim, *env.render_shape, dev)
            plain = render2d.render_mobile_robot_plain(scene, xs, ys, bg)
            torch.cuda.synchronize()
            top = out[..., :3]
            if top.shape != plain.shape or out.shape[-1] != (6 if env.fpv else 3):
                raise AssertionError(f"render2d {name}: {tuple(out.shape)} vs "
                                     f"{tuple(plain.shape)}")
            err = int((top.to(torch.int32) - plain.to(torch.int32)).abs().max())
            max_err = max(max_err, err)
            log(f"[compare] render2d {name} {kwargs} N={n} after {n_steps} steps "
                f"{tuple(out.shape)}: max |diff| {err} over {top.numel()} values")
            if err:
                raise AssertionError(f"render2d kernel differs from the twin for {name}")
            if main_inputs is None:
                main_inputs = (env, (scene, xs, ys, render2d.background_rgb(
                    env.dim, *env.render_shape, dev)))
    return max_err, main_inputs


# The metrics each agent logs per update, all of which must be finite.
PPO_KEYS = ("pg_loss", "vf_loss", "entropy", "approx_kl", "explained_variance",
            "mean_reward_per_step")
A2C_KEYS = ("pg_loss", "vf_loss", "entropy", "explained_variance", "mean_reward_per_step")
TRPO_KEYS = ("surrogate_improve", "kl", "line_search_accepted", "mean_reward_per_step")
LSTM_PPO_KEYS = ("loss",) + PPO_KEYS
ACKTR_KEYS = ("loss", "eta", "mean_reward_per_step")


def run_cli(torch, train, argv, what, keys=PPO_KEYS):
    """Run the CLI with every launch count set to 0 just before; returns
    (log dir, seconds, launches per kernel, this run's metrics lines), every
    logged metric of ``keys`` finite. A resumed run's rate counts its own
    steps only."""
    from srl_tpu_torch import ops

    prior = []
    if "--resume" in argv:
        with open(os.path.join(argv[argv.index("--resume") + 1], "metrics.jsonl")) as fh:
            prior = [json.loads(line) for line in fh]
    ops.reset_launches()
    t0 = time.perf_counter()
    log_dir = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launches()
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        entries = [json.loads(line) for line in fh][len(prior):]
    for e in entries:
        for k in keys:
            if not math.isfinite(e[k]):
                raise AssertionError(f"{what}, update {e['update']}: {k} = {e[k]}")
    steps = entries[-1]["num_timesteps"] - (prior[-1]["num_timesteps"] if prior else 0)
    log(f"[main] {what}: {len(entries)} updates, {steps} env steps in "
        f"{seconds:.1f} s: {steps / seconds:.0f} env-steps/s end to end (last update's "
        f"running rate {entries[-1]['fps']:.0f}); launches {launches}; finite: "
        + ", ".join(" ".join(f"{k} {e[k]:.4g}" for k in keys[:2]) for e in entries))
    return log_dir, seconds, launches, entries


# Step 11 replays runs of steps 4-10: their log dirs go under KEPT["root"]
# (made by main), and KEPT[name] is (the run's log dir, the trained agent).
KEPT = {}


def log_root(keep=None):
    """The log root of a CLI run: KEPT["root"]/logs for a run that step 11
    replays, else a temporary directory."""
    if keep is None:
        return tempfile.TemporaryDirectory()
    return contextlib.nullcontext(os.path.join(KEPT["root"], "logs"))


def drive(torch, train, argv, what, obs_shape=None, keys=PPO_KEYS, keep=None):
    """A CLI run in a temporary log dir: (seconds, launches per kernel,
    metrics lines). With ``obs_shape``, the run's observation normalizer
    must have that shape (the observations the agent saw). With ``keep``,
    the run and its trained agent are kept as KEPT[keep]."""
    algo = argv[argv.index("--algo") + 1]
    policy = argv[argv.index("--policy") + 1] if "--policy" in argv else "auto"
    cls = train.resolve_policy_class(algo, policy)
    with log_root(keep) as tmp, Trained(cls, best=keep is not None) as trained:
        log_dir, seconds, launches, entries = run_cli(
            torch, train, argv + ["--log-dir", tmp, "--device", "cuda"], what, keys)
        if keep:
            KEPT[keep] = (log_dir, trained.replayed())
        for f in RUN_FILES:
            if not os.path.isfile(os.path.join(log_dir, f.replace("ppo2", algo))):
                raise AssertionError(f"{what}: run dir lacks {f}")
        if obs_shape is not None:
            with open(os.path.join(log_dir, f"{algo}_final_model.pkl"), "rb") as fh:
                mean = pickle.load(fh)["obs_norm"]["mean"]
            if tuple(mean.shape) != tuple(obs_shape):
                raise AssertionError(f"{what}: observations {mean.shape}, not {obs_shape}")
    return seconds, launches, entries


def record(torch, generator, episode_saver, argv, what, root):
    """The dataset generator CLI with the launch counts set to 0 just
    before; returns (dataset folder, launches per kernel)."""
    from srl_tpu_torch import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    folder = generator.main(argv + ["--save-path", root, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launches()
    data = episode_saver.load_dataset(folder)
    obs, n = data["observations"], len(data["rewards"])
    if obs.shape != (n, 224, 224, 3) or obs.dtype.name != "uint8":
        raise AssertionError(f"{what}: frames {obs.shape} {obs.dtype}")
    if int(data["episode_starts"].sum()) != 32 or not obs.any():
        raise AssertionError(f"{what}: {int(data['episode_starts'].sum())} episodes")
    log(f"[srl] record {what}: {n} frames of 224x224x3 in 32 episodes, {seconds:.2f} s "
        f"with start-up: {n / seconds:.0f} frames/s; launches {launches}")
    return folder, launches


def train_encoder(torch, train_srl, folder, epochs, what, log_dir):
    """The train_srl CLI; returns its history.json (losses finite)."""
    from srl_tpu_torch import ops

    ops.reset_launches()
    path = train_srl.main(["--data-folder", folder, "--epochs", str(epochs), "--log-dir",
                           log_dir, "--device", "cuda"] + SRL_TRAIN)
    with open(os.path.join(log_dir, "history.json")) as fh:
        hist = json.load(fh)
    for e, logs in enumerate(hist["history"]):
        for k, v in logs.items():
            if not math.isfinite(v):
                raise AssertionError(f"{what}, epoch {e}: {k} = {v}")
    if len(hist["history"]) != epochs or not os.path.isfile(path):
        raise AssertionError(f"{what}: {len(hist['history'])} epochs logged")
    log(f"[srl] train_srl {what}: {hist['images_trained']} images of 224x224x3 at batch 128 "
        f"in {hist['seconds']:.2f} s: {hist['img_per_s']:.0f} img/s; reconstruction by "
        f"epoch " + ", ".join(f"{h['reconstruction']:.5f}" for h in hist["history"]))
    return hist


def srl_workflow(torch, train) -> dict:
    """Step 5: record, train, serve, on MobileRobot then on Kuka."""
    from srl_tpu_torch.data import dataset_generator
    from srl_tpu_torch.experiments import train_srl
    from srl_tpu_torch.srl import episode_saver

    out = {}
    root = os.path.join(KEPT["root"], "srl")  # kept: step 11 replays the MobileRobot run
    os.makedirs(root)
    logs = {env: os.path.join(root, "srl_logs", env)
            for env in ("MobileRobotGymEnv-v0", "KukaButtonGymEnv-v0")}
    config = os.path.join(root, "srl_models.yaml")
    with open(config, "w") as fh:
        for env, folder in logs.items():
            fh.write(f"{env}:\n  log_folder: {folder}/\n"
                     f"  autoencoder: autoencoder/srl_model.pkl\n")
    for env, data_args, epochs, run_args, n_envs, kernel in (
            ("MobileRobotGymEnv-v0", SRL_MOBILE_DATA, 2, SRL_MOBILE_ARGS, 256, "render2d"),
            ("KukaButtonGymEnv-v0", SRL_KUKA_DATA, 1, SRL_KUKA_ARGS, 512, "render3d")):
        folder, rec_launches = record(torch, dataset_generator, episode_saver, data_args,
                                      env, root)
        if env == "MobileRobotGymEnv-v0":
            KEPT["mobile dataset"] = folder
        if rec_launches[kernel] <= 0:
            raise AssertionError(f"recording {env} never launched the {kernel} kernel")
        train_encoder(torch, train_srl, folder, epochs, env,
                      os.path.join(logs[env], "autoencoder"))
        seconds, launches, entries = drive(
            torch, train, run_args + ["--srl-config-file", config],
            f"{env} autoencoder (SRLEncodedEnv) {n_envs} envs", obs_shape=(3,),
            keep="mobile srl" if env == "MobileRobotGymEnv-v0" else None)
        if launches[kernel] <= 0:
            raise AssertionError(f"serving on {env} never launched the {kernel} kernel")
        out[env] = {"record": rec_launches, "serve": launches}
    return out


def new_envs(torch, train) -> dict:
    """Step 6: the mixed Kuka + Omnirobot pixel run, CarRacing from pixels,
    Omnirobot from ground truth, and the IK debugger."""
    from srl_tpu_torch import ops
    from srl_tpu_torch.core.env import VecEnv
    from srl_tpu_torch.envs import debug

    _, mixed, entries = drive(torch, train, MIXED_ARGS,
                              "mixed KukaButtonGymEnv-v0 + OmnirobotEnv-v0 raw_pixels 256 envs",
                              keep="mixed")
    if mixed["render3d"] <= 0:
        raise AssertionError("the mixed pixel path never launched the render3d kernel")
    log(f"[main] mixed run launches: render3d {mixed['render3d']}, render2d "
        f"{mixed['render2d']}")
    # The batch the learner saw: 128 Kuka frames then 128 Omnirobot frames.
    env = train.build_env(train.parse_args(MIXED_ARGS + ["--device", "cuda"]), "cuda")
    vec = VecEnv(env, 256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    vstate, obs = vec.reset(gen)
    vstate, tr = vec.step(vstate, env.action_space.sample(gen, 256), gen)
    torch.cuda.synchronize()
    if tuple(tr.obs.shape) != (256, 224, 224, 3) or tr.obs.dtype != torch.uint8 \
            or vec.counts != [128, 128]:
        raise AssertionError(f"mixed batch {tuple(tr.obs.shape)} {tr.obs.dtype} {vec.counts}")
    kuka_mean, omni_mean = (float(tr.obs[sl].float().mean()) for sl in (slice(0, 128),
                                                                        slice(128, 256)))
    log(f"[main] mixed batch {tuple(tr.obs.shape)} {tr.obs.dtype}, families {vec.counts}: "
        f"mean byte {kuka_mean:.1f} (Kuka) and {omni_mean:.1f} (Omnirobot)")
    _, car, _ = drive(torch, train, CAR_ARGS, "CarRacingGymEnv-v0 raw_pixels 256 envs")
    drive(torch, train, OMNI_GT_ARGS, "OmnirobotEnv-v0 ground_truth 1024 envs",
          obs_shape=(2,))
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launches()
        errors = debug.main(["--target", "0.4", "0.1", "0.35", "--steps", "200", "--out", tmp])
        files = os.listdir(tmp)
    if len(errors) != 1 or not math.isfinite(errors[0]) or len(files) != 1 \
            or ops.launches()["render3d"] <= 0:
        raise AssertionError(f"envs.debug: errors {errors}, files {files}")
    log(f"[main] envs.debug: tip error {errors[0]:.4f} after 200 servo steps; wrote {files[0]} "
        f"(render3d launches {ops.launches()['render3d']})")
    return {"mixed": mixed, "car": car}


def with_flags(args, **flags):
    """``args`` with each ``--flag value`` of ``flags`` (``num_timesteps=...``)
    set, replaced where ``args`` has it."""
    args = list(args)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if flag in args:
            args[args.index(flag) + 1] = str(value)
        else:
            args += [flag, str(value)]
    return args


# Phase 7's runs on the Kuka pixel path (KUKA_ARGS: 256 envs, 112x112 coarse
# traces, the Nature CNN): a fine-tune of 1 PPO2 update; A2C (5 steps an
# update), PPO1 (64 envs, 256 steps) and TRPO (64 envs, 128 steps), 2 updates
# each.
FINETUNE_ARGS = with_flags(KUKA_ARGS, num_timesteps=30000)
A2C_ARGS = with_flags(KUKA_ARGS, algo="a2c", num_timesteps=2400)
PPO1_ARGS = with_flags(KUKA_ARGS, algo="ppo1", num_envs=64, num_timesteps=30000)
TRPO_ARGS = with_flags(KUKA_ARGS, algo="trpo", num_envs=64, num_timesteps=15000)
# PPO2's minibatch: 128 steps x 256 envs / 4 minibatches.
MINIBATCH = 128 * 256 // 4


def final_params(path) -> list:
    """The parameter arrays of a saved policy, in sorted-path order."""
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    leaves = []

    def walk(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k])
            else:
                leaves.append(node[k])

    walk(payload["params"])
    return leaves


def recompute_minibatch(torch, train, render3d, dev) -> dict:
    """One Kuka pixel rollout (256 envs, 128 steps) storing env states, its
    frames recorded as the policy saw them; one minibatch of 8,192 re-rendered
    by render3d must equal its stored frames bit for bit. Then render3d at
    that N against its twin (in chunks of 256 envs), timed, with its bound."""
    from srl_tpu_torch import ops
    from srl_tpu_torch.agents.common import collect_rollout
    from srl_tpu_torch.agents.ppo import PPO2
    from srl_tpu_torch.core.env import state_map

    env = train.build_env(train.parse_args(KUKA_ARGS + ["--device", "cuda"]), "cuda")
    agent = PPO2(env=env, num_envs=256, recompute_obs=True, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = agent.init_state(gen)
    seen = []

    def policy(obs):
        seen.append(obs)
        return agent.apply(state.params, obs)

    batch = collect_rollout(agent.vec_env, policy, state.vstate, state.obs, None, gen, 128,
                            store_states=True)[-1]
    frames = torch.stack(seen).flatten(0, 1)
    states = state_map(lambda x: x.flatten(0, 1), batch.obs)
    idx = torch.randperm(frames.shape[0], generator=gen, device=dev)[:MINIBATCH]
    mb = state_map(lambda x: x[idx], states)
    ops.reset_launches()
    again = env.observe(mb)
    torch.cuda.synchronize()
    launched = ops.launches()["render3d"]
    if launched != 1 or not torch.equal(again, frames[idx]):
        raise AssertionError(f"re-rendered minibatch: {launched} launches, "
                             f"{int((again != frames[idx]).sum())} values differ")
    log(f"[recompute] one minibatch of {MINIBATCH} env states re-rendered by render3d "
        f"{tuple(again.shape)}: bit-equal to the frames the rollout stored")
    cfg, scene = render3d._scene_table(env, mb)
    cam = render3d.camera_tensors(cfg, dev)
    out = render3d.render_kuka_cuda(cfg, scene, cam)
    plain = torch.cat([render3d.render_kuka_plain(cfg, scene[i:i + 256], cam.eyes, cam.rays,
                                                  cam.bg) for i in range(0, MINIBATCH, 256)])
    diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
    equal, off = (diff == 0).double().mean().item(), (diff > 2).double().mean().item()
    log(f"[compare] render3d N={MINIBATCH} {tuple(out.shape)}: against the twin "
        f"{equal:.6f} equal, {off:.6f} off by more than 2, max |diff| {int(diff.max())}")
    if not (equal > 0.995 and off < 0.005):
        raise AssertionError(f"render3d disagrees with the twin at N={MINIBATCH}")
    outs = rotating(torch, out.shape, dev)
    ms = time_ms(lambda: render3d.render_kuka_cuda(cfg, scene, cam, out=next(outs)), 50)
    bound = render_bound_ms(render3d, cfg, scene)
    log(f"[time] render3d N={MINIBATCH} trace {cfg.trace_h}x{cfg.trace_w}: kernel "
        f"{ms:.4f} ms over rotating outputs; bound_ms {bound['bound_ms']:.5f} "
        f"({bound['bound_by']}; {bound['bound_ms'] / ms:.1%} of it); culling keeps "
        f"{bound['kept_per_pixel']:.4f} primitives per pixel")
    return dict(ms=ms, max_abs_err=int(diff.max()), **bound)


def full_surface(torch, train, stored_launches: int, stored_seconds: float) -> dict:
    """Step 7: PPO2's --recompute-obs with checkpoints, --resume,
    --load-rl-model-path, and A2C, PPO1 and TRPO, on the Kuka pixel path."""
    from srl_tpu_torch.agents.base import BaseRLAgent
    from srl_tpu_torch.agents.ppo import PPO2
    from srl_tpu_torch.ops import render3d

    out = {}
    with tempfile.TemporaryDirectory() as root:
        argv = KUKA_ARGS + ["--recompute-obs", "--checkpoint-interval", "1",
                            "--log-dir", os.path.join(root, "a"), "--device", "cuda"]
        log_dir, seconds, launches, entries = run_cli(
            torch, train, argv, "KukaButtonGymEnv-v0 raw_pixels 256 envs "
            "--recompute-obs --checkpoint-interval 1")
        extra = launches["render3d"] - stored_launches
        log(f"[recompute] render3d launches {launches['render3d']} against {stored_launches} "
            f"storing frames: {extra} in {len(entries)} updates; {seconds:.1f} s against "
            f"{stored_seconds:.1f} s storing frames")
        if extra != 16 * len(entries):
            raise AssertionError(f"--recompute-obs added {extra} render3d launches, not "
                                 f"16 per update")
        out["recompute_obs"] = launches["render3d"]
        first_model = os.path.join(root, "first_model.pkl")
        os.replace(os.path.join(log_dir, "ppo2_final_model.pkl"), first_model)

        ckpt = os.path.join(log_dir, "checkpoint.pkl")
        _, meta = BaseRLAgent.load_checkpoint(ckpt)
        with open(os.path.join(log_dir, "args.json")) as fh:
            stored = json.load(fh)
        stored["num_timesteps"] *= 2
        with open(os.path.join(log_dir, "args.json"), "w") as fh:
            json.dump(stored, fh)
        _, _, launches, _ = run_cli(
            torch, train, ["--resume", log_dir, "--checkpoint-interval", "1", "--device",
                           "cuda"], "the same run resumed (--resume)")
        _, meta2 = BaseRLAgent.load_checkpoint(ckpt)
        with open(os.path.join(log_dir, "0.monitor.csv")) as fh:
            headers = fh.read().count("r,l,t")
        env = train.build_env(train.parse_args(KUKA_ARGS + ["--device", "cuda"]), "cuda")
        resumed = PPO2.load(os.path.join(log_dir, "ppo2_final_model.pkl"), env, None,
                            device="cuda")
        action = resumed.getAction(np.zeros((2, 112, 112, 3), np.uint8), None, True)
        log(f"[resume] checkpoint num_timesteps {meta['num_timesteps']} -> "
            f"{meta2['num_timesteps']}, update {meta2['update']}; monitor headers "
            f"{headers}; the final model loads and acts {action.tolist()}")
        if not (meta2["num_timesteps"] > meta["num_timesteps"] and headers == 1
                and launches["render3d"] > 0):
            raise AssertionError(f"resume: meta {meta} -> {meta2}, {headers} headers")

        ft_dir, _, launches, _ = run_cli(
            torch, train, FINETUNE_ARGS + ["--load-rl-model-path", first_model,
                                           "--hyperparam", "learning_rate:0", "--log-dir",
                                           os.path.join(root, "c"), "--device", "cuda"],
            "fine-tune (--load-rl-model-path, learning_rate:0)")
        before = final_params(first_model)
        after = final_params(os.path.join(ft_dir, "ppo2_final_model.pkl"))
        same = all(np.array_equal(a, b) for a, b in zip(before, after))
        log(f"[finetune] {len(after)} parameter arrays bit-equal to the loaded model: {same}")
        if not same or len(before) != len(after) or launches["render3d"] <= 0:
            raise AssertionError("fine-tuning at learning rate 0 changed the parameters")

    for name, args, keys in (("a2c", A2C_ARGS, A2C_KEYS), ("ppo1", PPO1_ARGS, PPO_KEYS),
                             ("trpo", TRPO_ARGS, TRPO_KEYS)):
        n_envs = args[args.index("--num-envs") + 1]
        _, launches, entries = drive(torch, train, args,
                                     f"{name} KukaButtonGymEnv-v0 raw_pixels {n_envs} envs",
                                     keys=keys)
        if launches["render3d"] <= 0 or len(entries) != 2:
            raise AssertionError(f"{name}: {len(entries)} updates, launches {launches}")
        if name == "trpo":
            log("[main] trpo line_search_accepted, kl by update: " + ", ".join(
                f"{e['line_search_accepted']:.0f}, {e['kl']:.5f}" for e in entries))
        out[name] = launches["render3d"]
    return out


# Step 8's runs at the reference's widths, 256 envs: the recurrent PPO2 for
# one update at its tuned 609 steps (int(155,904 * 1.1) // (609 * 256) = 1),
# the recurrent A2C (5 steps) and both ACKTRs (20 steps) for 2 updates.
LSTM_PPO_ARGS = with_flags(KUKA_ARGS, policy="cnnlstm", num_timesteps=609 * 256)
LSTM_A2C_ARGS = with_flags(KUKA_ARGS, algo="a2c", policy="cnnlnlstm", num_timesteps=2400)
ACKTR_ARGS = with_flags(MOBILE_ARGS, algo="acktr", num_timesteps=9400)
LSTM_ACKTR_ARGS = with_flags(KUKA_ARGS, algo="acktr", policy="cnnlstm", num_timesteps=9400)


def acts_alike(torch, saved, trained, env, what, dones_seq=(None, None), atol=0.0) -> list:
    """Deterministic actions of ``saved`` and ``trained`` on two steps of 8
    envs of ``env`` (each step's ``dones`` from ``dones_seq``), equal
    (continuous ones within ``atol``)."""
    from srl_tpu_torch.core.env import VecEnv

    gen = torch.Generator(device="cuda").manual_seed(1)
    vec = VecEnv(env, 8)
    vstate, obs = vec.reset(gen)
    acts = []
    for dones in dones_seq:
        frames = obs.cpu().numpy()
        a, b = (agent.getAction(frames, dones, deterministic=True)
                for agent in (saved, trained))
        if a.shape != b.shape or not np.allclose(a, b, rtol=0.0, atol=atol):
            raise AssertionError(f"{what}: the reloaded model acts {a.tolist()}, the "
                                 f"trained agent {b.tolist()}")
        acts.append(a.tolist())
        vstate, tr = vec.step(vstate, torch.as_tensor(a, device="cuda"), gen)
        obs = tr.obs
    return acts


def recurrent_agents(torch, train) -> dict:
    """Step 8: the recurrent PPO2 (8a, the slice's main path), A2C (8b) and
    ACKTR (8d) on the Kuka pixel path, ACKTR with the CNN on MobileRobot
    pixels (8c)."""
    from srl_tpu_torch.agents.base import BaseRLAgent
    from srl_tpu_torch.agents.recurrent_ppo import RecurrentPPO2

    out = {}
    with log_root("lstm") as root, Trained(RecurrentPPO2, best=True) as run:
        log_dir, seconds, launches, entries = run_cli(
            torch, train, LSTM_PPO_ARGS + ["--checkpoint-interval", "1", "--log-dir", root,
                                           "--device", "cuda"],
            "8a ppo2 --policy cnnlstm KukaButtonGymEnv-v0 raw_pixels 256 envs, "
            "n_steps 609", LSTM_PPO_KEYS)
        if len(entries) != 1 or launches["render3d"] != 609 + 1:
            raise AssertionError(f"8a: {len(entries)} updates, render3d launched "
                                 f"{launches['render3d']} times, not 610")
        out["lstm_ppo"] = launches["render3d"]
        # The saved model and the trained state (the run's checkpoint) act alike.
        env = train.build_env(train.parse_args(LSTM_PPO_ARGS + ["--device", "cuda"]), "cuda")
        saved = RecurrentPPO2.load(os.path.join(log_dir, "ppo2_final_model.pkl"), env, None,
                                   device="cuda")
        ckpt, _ = BaseRLAgent.load_checkpoint(os.path.join(log_dir, "checkpoint.pkl"))
        trained = RecurrentPPO2(env=env, num_envs=256, policy="cnnlstm", device="cuda")
        trained.state = trained.loaded_state(trained._state_dict(ckpt.params), None)
        acts = acts_alike(torch, saved, trained, env, "8a",
                          (None, np.array([True] + [False] * 7)))
        name = BaseRLAgent._load_pickle(os.path.join(log_dir, "ppo2_final_model.pkl"))["name"]
        log(f"[lstm] 8a: the saved '{name}' model reloads and acts as the trained agent on "
            f"two steps of 8 Kuka frames: {acts}; metrics loss {entries[0]['loss']:.5g}, "
            f"explained_variance {entries[0]['explained_variance']:.4g}")
        if name != "ppo2_lstm":
            raise AssertionError(f"8a: the policy pickle is named {name}")
        KEPT["lstm"] = (log_dir, run.replayed())

    for step, args, keys, kernel in (
            ("8b a2c --policy cnnlnlstm", LSTM_A2C_ARGS, A2C_KEYS, "render3d"),
            ("8c acktr (cnn) MobileRobotGymEnv-v0 raw_pixels 224x224", ACKTR_ARGS, ACKTR_KEYS,
             "render2d"),
            ("8d acktr --policy cnnlstm", LSTM_ACKTR_ARGS, ACKTR_KEYS, "render3d")):
        _, launches, entries = drive(torch, train, args, f"{step} 256 envs", keys=keys)
        if launches[kernel] <= 0 or len(entries) != 2:
            raise AssertionError(f"{step}: {len(entries)} updates, launches {launches}")
        if "eta" in keys:
            log(f"[acktr] {step}: eta by update " + ", ".join(f"{e['eta']:.6g}" for e in entries))
        out[step.split()[0]] = launches[kernel]
    return out


# Step 9's runs at the reference's widths, 256 envs, each agent's default
# config: ACER for int(28,000 * 1.1) // (20 * 256) = 6 iterations,
# RecurrentACER (cnnlstm) for 5, DQN for 2 chunks of 64 x 256 steps (while
# fewer than int(20,000 * 1.1) steps are done).
ACER_ARGS = with_flags(KUKA_ARGS, algo="acer", num_timesteps=28000)
LSTM_ACER_ARGS = with_flags(KUKA_ARGS, algo="acer", policy="cnnlstm", num_timesteps=23500)
DQN_ARGS = with_flags(MOBILE_ARGS, algo="deepq", num_timesteps=20000)
ACER_KEYS = ("loss_policy", "loss_q", "entropy", "mean_reward_per_step")
DQN_KEYS = ("td_loss", "mean_reward_per_step")


def flag(args, name) -> int:
    return int(args[args.index(name) + 1])


def acer_expected(args) -> tuple:
    """(render launches, replay updates by iteration) of an ACER run with
    the default config (n_steps 20, replays of 4 once 4 segments are
    stored): 121 and [0, 0, 0, 4, 4, 4] for ACER_ARGS."""
    n = flag(args, "--num-envs")
    iterations = int(flag(args, "--num-timesteps") * 1.1) // (20 * n)
    return 20 * iterations + 1, [4 if i >= 3 else 0 for i in range(iterations)]


def dqn_expected(args, chunk: int = 64) -> tuple:
    """(vector steps, TD updates, target copies) of a DQN run with the
    default config (learning_starts 500, train_freq 4, a target copy every
    500 env steps): 128, 32 and the steps k with 256 k % 500 < 256 for
    DQN_ARGS."""
    n = flag(args, "--num-envs")
    total = int(flag(args, "--num-timesteps") * 1.1)
    steps = chunk * -(-total // (chunk * n))
    ks = range(1, steps + 1)
    return (steps, sum(n * k >= 500 and k % 4 == 0 for k in ks),
            sum((n * k) % 500 < n for k in ks))


class Trained:
    """The agent a CLI run trains with ``cls``: its ``learn`` is wrapped
    for the run to keep the agent (``self.agent``), so that a reloaded
    policy can be held against the trained one. With ``best``, its ``save``
    is wrapped too, to keep a copy of the state (without a replay store)
    at each save of the best model, ``{algo}_model.pkl``, which a replay
    loads before the final model."""

    def __init__(self, cls, best: bool = False):
        self.cls, self.best, self.agent, self.best_state = cls, best, None, None

    def __enter__(self):
        self.own = {name: self.cls.__dict__.get(name) for name in ("learn", "save")}
        learn, save = self.cls.learn, self.cls.save

        def keep(agent, *args, **kwargs):
            self.agent = agent
            return learn(agent, *args, **kwargs)

        def keep_best(agent, path, *args, **kwargs):
            if not path.endswith("_final_model.pkl"):
                state = agent.state
                if hasattr(state, "buffer"):
                    state = dataclasses.replace(state, buffer=None)
                self.best_state = copy.deepcopy(state)
            return save(agent, path, *args, **kwargs)

        self.cls.learn = keep
        if self.best:
            self.cls.save = keep_best
        return self

    def __exit__(self, *exc):
        for name, own in self.own.items():
            if own is None:
                if name in self.cls.__dict__:
                    delattr(self.cls, name)
            else:
                setattr(self.cls, name, own)

    def replayed(self):
        """The trained agent as a replay loads it: at its last save of the
        best model when it saved one, else as it ended."""
        if self.best_state is not None:
            self.agent.state = self.best_state
        return self.agent


def replay_agents(torch, train) -> dict:
    """Step 9: ACER (9a, the slice's main path) and RecurrentACER (9b) on the
    Kuka pixel path, DQN on MobileRobot pixels (9c)."""
    from srl_tpu_torch.agents.acer import ACER, RecurrentACER
    from srl_tpu_torch.agents.base import BaseRLAgent
    from srl_tpu_torch.agents.dqn import DQN

    out = {}
    one_done = np.array([True] + [False] * 7)
    for step, args, cls, kernel, dones_seq in (
            ("9a acer (cnn)", ACER_ARGS, ACER, "render3d", (None, None)),
            ("9b acer --policy cnnlstm", LSTM_ACER_ARGS, RecurrentACER, "render3d",
             (None, one_done))):
        launches_expected, replays_expected = acer_expected(args)
        with tempfile.TemporaryDirectory() as root, Trained(cls) as trained:
            log_dir, seconds, launches, entries = run_cli(
                torch, train, args + ["--log-dir", root, "--device", "cuda"],
                f"{step} KukaButtonGymEnv-v0 raw_pixels 256 envs", ACER_KEYS)
            replays = [int(e["replays"]) for e in entries]
            if launches[kernel] != launches_expected or replays != replays_expected:
                raise AssertionError(f"{step}: {kernel} launched {launches[kernel]} times, "
                                     f"not {launches_expected}; replays by iteration "
                                     f"{replays}, not {replays_expected}")
            buffer = trained.agent.state.buffer
            store_gb = sum(getattr(buffer, n).nbytes for n in buffer.tensor_names()) / 1e9
            env = trained.agent.env
            path = os.path.join(log_dir, "acer_final_model.pkl")
            saved = cls.load(path, env, None, device="cuda")
            acts = acts_alike(torch, saved, trained.agent, env, step, dones_seq)
            name = BaseRLAgent._load_pickle(path)["name"]
            if name != (cls.pickle_name or cls.name):
                raise AssertionError(f"{step}: the policy pickle is named {name}")
            log(f"[replay] {step}: {sum(replays)} replay updates (by iteration {replays}) "
                f"from a {tuple(buffer.obs.shape)} {buffer.obs.dtype} store, {store_gb:.2f} GB "
                f"on the card; the saved '{name}' model reloads and acts as the trained agent "
                f"on two steps of 8 Kuka frames: {acts}; loss_q by iteration "
                + ", ".join(f"{e['loss_q']:.4g}" for e in entries))
            out[step.split()[0]] = launches[kernel]
            if cls is ACER:
                # An iteration: a forward each step; the update from its
                # segment and each replay, a forward with grad, the
                # average policy's forward and a weight gradient.
                out["9a_conv1"] = hold_conv1(step, launches, {
                    "conv1": sum(20 + 2 * (1 + r) for r in replays),
                    "conv1_wgrad": sum(1 + r for r in replays)})
            trained.agent = saved = None  # the segment store's 10 GB
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root, Trained(DQN) as trained:
        log_dir, seconds, launches, entries = run_cli(
            torch, train, DQN_ARGS + ["--log-dir", root, "--device", "cuda"],
            "9c deepq (cnn) MobileRobotGymEnv-v0 raw_pixels 224x224 256 envs", DQN_KEYS)
        updates = sum(e["td_updates"] for e in entries)
        copies = sum(e["target_copies"] for e in entries)
        n_steps, updates_expected, copies_expected = dqn_expected(DQN_ARGS)
        if (launches["render2d"] != n_steps + 1 or len(entries) != n_steps // 64
                or updates != updates_expected or copies != copies_expected):
            raise AssertionError(f"9c: {len(entries)} chunks, render2d launched "
                                 f"{launches['render2d']} times (not {n_steps + 1}), "
                                 f"{updates} TD updates (not {updates_expected}), {copies} "
                                 f"target copies (not {copies_expected})")
        buffer = trained.agent.state.buffer
        env = trained.agent.env
        path = os.path.join(log_dir, "deepq_final_model.pkl")
        saved = DQN.load(path, env, None, device="cuda")
        acts = acts_alike(torch, saved, trained.agent, env, "9c")
        store_mb = (buffer.obs.nbytes + buffer.next_obs.nbytes) / 1e6
        log(f"[replay] 9c: {updates} TD updates, {copies} target copies, a "
            f"{tuple(buffer.obs.shape)} store of obs and next_obs ({store_mb:.0f} MB); the "
            f"saved 'deepq' model reloads and acts greedily as the trained agent on two "
            f"steps of 8 MobileRobot frames: {acts}; td_loss by chunk "
            + ", ".join(f"{e['td_loss']:.4g}" for e in entries))
        out["9c"] = launches["render2d"]
        # A greedy forward each vector step; a TD update's online forward with
        # grad, the online and the target networks' on next_obs, a weight
        # gradient.
        out["9c_conv1"] = hold_conv1("9c", launches, {"conv1": n_steps + 3 * updates,
                                                      "conv1_wgrad": updates})
    return out


# Step 10's runs at the reference's widths, each agent's default config:
# SAC (-c: 3-d continuous actions) on the Kuka pixel path and DDPG (-c) on
# MobileRobot 224x224 pixels, each 2 chunks of 64 x 256 steps (while fewer
# than int(20,000 * 1.1) steps are done), an update every vector step from
# env step 100; ARS (20 envs) on the Kuka pixel path and CMA-ES (20 envs,
# its CNN) on MobileRobot pixels, each int(10,000 * 1.1) // (260 * 20) = 2
# generations of a reset and 260 steps; the random agent on the Kuka pixel
# path (256 envs), one chunk of 256 steps.
SAC_ARGS = with_flags(KUKA_ARGS, algo="sac", num_timesteps=20000) + ["-c"]
DDPG_ARGS = with_flags(MOBILE_ARGS, algo="ddpg", num_timesteps=20000) + ["-c"]
# ARS's Kuka run takes the shaped reward (minus the distance to the button
# each step): from M = 0, no member presses the button within 2 generations
# of the sparse reward, every return ties at 0, and M cannot move.
ARS_ARGS = with_flags(KUKA_ARGS, algo="ars", num_timesteps=10000) + ["--shape-reward"]
CMAES_ARGS = with_flags(MOBILE_ARGS, algo="cma-es", num_timesteps=10000)
RANDOM_ARGS = with_flags(KUKA_ARGS, algo="random_agent", num_timesteps=50000)
OFF_POLICY_KEYS = ("critic_loss", "actor_loss", "mean_reward_per_step")
ES_KEYS = ("mean_return", "max_return")
CMAES_KEYS = ("mean_return", "best_return", "sigma", "eigh_s")


def off_policy_expected(args, chunk: int = 64) -> tuple:
    """(vector steps, updates) of a SAC or DDPG run with the default config
    (learning_starts 100, an update every vector step from there): 128 and
    128 for SAC_ARGS and DDPG_ARGS."""
    n = flag(args, "--num-envs")
    steps = chunk * -(-int(flag(args, "--num-timesteps") * 1.1) // (chunk * n))
    return steps, sum(n * k >= 100 for k in range(1, steps + 1))


def es_expected(args, population: int) -> int:
    """Render launches of an ARS or CMA-ES run: a reset and 260 steps a
    generation, int(num_timesteps * 1.1) // (260 P) generations (522 for
    ARS_ARGS and CMAES_ARGS)."""
    return (260 + 1) * max(1, int(flag(args, "--num-timesteps") * 1.1) // (260 * population))


def last_agents(torch, train) -> dict:
    """Step 10: SAC (10a, the slice's main path) and ARS (10c) and the
    random agent (10e) on the Kuka pixel path, DDPG (10b) and CMA-ES (10d)
    on MobileRobot 224x224 pixels."""
    from srl_tpu_torch.agents.ars import ARS
    from srl_tpu_torch.agents.base import BaseRLAgent
    from srl_tpu_torch.agents.cma_es import CMAES
    from srl_tpu_torch.agents.ddpg import DDPG
    from srl_tpu_torch.agents.random_agent import RandomAgent
    from srl_tpu_torch.agents.sac import SAC

    out = {}
    for step, args, cls, kernel in (
            ("10a sac (cnn) KukaButtonGymEnv-v0 raw_pixels -c", SAC_ARGS, SAC, "render3d"),
            ("10b ddpg (cnn) MobileRobotGymEnv-v0 raw_pixels 224x224 -c", DDPG_ARGS, DDPG,
             "render2d")):
        n_steps, updates_expected = off_policy_expected(args)
        with log_root("sac" if cls is SAC else None) as root, \
                Trained(cls, best=cls is SAC) as trained:
            log_dir, seconds, launches, entries = run_cli(
                torch, train, args + ["--log-dir", root, "--device", "cuda"],
                f"{step} 256 envs", OFF_POLICY_KEYS)
            updates = sum(e["updates"] for e in entries)
            if launches[kernel] != n_steps + 1 or updates != updates_expected:
                raise AssertionError(f"{step}: {kernel} launched {launches[kernel]} times "
                                     f"(not {n_steps + 1}), {updates} updates (not "
                                     f"{updates_expected})")
            agent = trained.agent
            alphas = [e["alpha"] for e in entries if "alpha" in e]
            if cls is SAC and not (all(map(math.isfinite, alphas)) and alphas[-1] != 1.0):
                raise AssertionError(f"{step}: alpha by chunk {alphas}")
            buffer = agent.state.buffer
            store_gb = (buffer.obs.nbytes + buffer.next_obs.nbytes) / 1e9
            path = os.path.join(log_dir, f"{cls.name}_final_model.pkl")
            saved = cls.load(path, agent.env, None, device="cuda")
            acts = acts_alike(torch, saved, agent, agent.env, step, atol=1e-6)
            name = BaseRLAgent._load_pickle(path)["name"]
            if name != cls.name:
                raise AssertionError(f"{step}: the policy pickle is named {name}")
            log(f"[last] {step}: {updates} updates, a {tuple(buffer.obs.shape)} "
                f"{buffer.obs.dtype} store of obs and next_obs ({store_gb:.2f} GB on the card); "
                f"the saved '{name}' model reloads and acts as the trained agent on two steps "
                f"of 8 frames (first actions {np.round(acts[0][0], 4).tolist()}); critic_loss "
                f"by chunk " + ", ".join(f"{e['critic_loss']:.4g}" for e in entries)
                + ("; alpha by chunk " + ", ".join(f"{a:.6g}" for a in alphas)
                   if alphas else ""))
            out[step.split()[0]] = launches[kernel]
            if cls is SAC:  # step 11 replays the run; the agent without its store
                agent.state = dataclasses.replace(agent.state, buffer=None)
                KEPT["sac"] = (log_dir, trained.replayed())
            trained.agent = agent = saved = buffer = None  # the store's GB
        torch.cuda.empty_cache()

    for step, args, cls, kernel, keys in (
            ("10c ars KukaButtonGymEnv-v0 raw_pixels", ARS_ARGS, ARS, "render3d", ES_KEYS),
            ("10d cma-es (cnn) MobileRobotGymEnv-v0 raw_pixels 224x224", CMAES_ARGS, CMAES,
             "render2d", CMAES_KEYS)):
        with tempfile.TemporaryDirectory() as root, Trained(cls) as trained:
            log_dir, seconds, launches, entries = run_cli(
                torch, train, args + ["--log-dir", root, "--device", "cuda"],
                f"{step} 20 envs", keys)
            agent = trained.agent
            expected = es_expected(args, agent.num_envs)
            if launches[kernel] != expected or agent.num_envs != 20:
                raise AssertionError(f"{step}: {kernel} launched {launches[kernel]} times, not "
                                     f"{expected}; {agent.num_envs} envs")
            if cls is ARS:
                changed = bool(agent.M.abs().max() > 0)
                detail = f"M {tuple(agent.M.shape)} moved: max |M| {float(agent.M.abs().max()):.4g}"
            else:
                changed = math.isfinite(entries[-1]["sigma"])
                detail = (f"n = {agent.dim}, C {agent.dim}x{agent.dim} float64; sigma by "
                          f"generation " + ", ".join(f"{e['sigma']:.6g}" for e in entries)
                          + "; eigh " + ", ".join(f"{e['eigh_s']:.3f}" for e in entries)
                          + " s on the card")
            if not changed:
                raise AssertionError(f"{step}: {detail}")
            path = os.path.join(log_dir, f"{cls.name}_final_model.pkl")
            saved = cls.load(path, agent.env, None, device="cuda")
            acts = acts_alike(torch, saved, agent, agent.env, step)
            log(f"[last] {step}: {len(entries)} generations; {detail}; the saved '{cls.name}' "
                f"model reloads and acts as the trained agent on two steps of 8 frames: {acts}; "
                f"mean return by generation " + ", ".join(f"{e['mean_return']:.4g}"
                                                          for e in entries))
            out[step.split()[0]] = launches[kernel]

    with tempfile.TemporaryDirectory() as root:
        log_dir, seconds, launches, entries = run_cli(
            torch, train, RANDOM_ARGS + ["--log-dir", root, "--device", "cuda"],
            "10e random_agent KukaButtonGymEnv-v0 raw_pixels 256 envs", ("mean_reward_per_step",))
        if launches["render3d"] != 257 or len(entries) != 1:
            raise AssertionError(f"10e: render3d launched {launches['render3d']} times, not 257")
        saved = RandomAgent.load(os.path.join(log_dir, "random_agent_final_model.pkl"), None,
                                 None, device="cuda")
        log(f"[last] 10e: the Kuka env and render rate with no policy in the loop, "
            f"{entries[-1]['fps']:.0f} env-steps/s over 256 x 256 steps (the agent's own "
            f"count, after the reset); the saved model reloads with {saved.num_envs} envs")
        out["10e"] = launches["render3d"]
    return out


# Step 11's replays: 256 envs for 64 vector steps (16,384 env steps) each,
# with --plot, and --render where a kernel draws the strip.
ENJOY_ENVS, ENJOY_STEPS = 256, 64
# (name, kept run, kernel, --render, dones of acts_alike's two steps, atol)
REPLAYS = [
    ("11a Kuka pixel PPO2 (step 4)", "kuka", "render3d", True, (None, None), 0.0),
    ("11b MobileRobot 224x224 pixel PPO2 (step 4)", "mobile", "render2d", True, (None, None),
     0.0),
    ("11c PPO2 cnnlstm on Kuka (8a)", "lstm", "render3d", False,
     (None, np.array([True] + [False] * 7)), 0.0),
    ("11d SAC on continuous Kuka (10a)", "sac", "render3d", False, (None, None), 1e-6),
    ("11e mixed Kuka + Omnirobot (step 6)", "mixed", "render3d", True, (None, None), 0.0),
    ("11f MobileRobot SRL serving (step 5)", "mobile srl", "render2d", True, (None, None),
     0.0),
]


# conv1's forwards a replay step: the action's, and with a discrete action
# space the action probabilities ``--plot`` records; the SRL run's policy
# reads states, not frames.
ENJOY_CONV1_PER_STEP = {"kuka": 2, "mobile": 2, "lstm": 2, "sac": 1, "mixed": 2,
                        "mobile srl": 0}


def enjoy_expected(enjoy, render: bool) -> int:
    """Launches of the kernel that draws a replay's env: the reset, each of
    ENJOY_STEPS steps, and with --render a frame every FRAME_EVERY steps
    (at most MAX_FRAMES)."""
    frames = min(enjoy.MAX_FRAMES, -(-ENJOY_STEPS // enjoy.FRAME_EVERY)) if render else 0
    return 1 + ENJOY_STEPS + frames


def hold_frames(torch, result, env, render2d, render3d, what) -> float:
    """Each frame of a replay's strip against the plain twin's render of
    the state it came from: render3d within its agreement metric, render2d
    bit for bit; returns the largest |diff|."""
    src = env.families[0] if hasattr(env, "families") else env
    src = getattr(src, "_env", src)  # the pixels inside SRLEncodedEnv
    worst = 0
    for frame, state in zip(result["frames"], result["frame_states"]):
        if hasattr(src, "dim"):  # MobileRobot
            xs, ys, bg = render2d.static_tensors(src.dim, *src.render_shape, "cuda")
            plain = render2d.render_mobile_robot_plain(render2d.scene_params(src, state),
                                                       xs, ys, bg)
        else:
            cfg, scene = render3d._scene_table(src, state)
            cam = render3d.camera_tensors(cfg, "cuda")
            plain = render3d.render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)
        diff = (torch.as_tensor(frame, device="cuda").to(torch.int32)
                - plain[0, ..., :3].to(torch.int32)).abs()
        worst = max(worst, int(diff.max()))
        exact = hasattr(src, "dim")
        if exact and worst or not exact and not (
                (diff == 0).double().mean() > 0.995 and (diff > 2).double().mean() < 0.005):
            raise AssertionError(f"{what}: a frame of the strip disagrees with the twin "
                                 f"(max |diff| {int(diff.max())})")
    return worst


def replays(torch, render2d, render3d) -> dict:
    """Step 11a-f: each kept run replayed through ``replay.enjoy``'s CLI at
    its width, the launch counts set to 0 just before and read just after."""
    from srl_tpu_torch import ops
    from srl_tpu_torch.replay import enjoy

    out = {}
    for what, name, kernel, render, dones_seq, atol in REPLAYS:
        log_dir, trained = KEPT[name]
        ops.reset_launches()
        t0 = time.perf_counter()
        result = enjoy.main(["--log-dir", log_dir, "--num-envs", str(ENJOY_ENVS),
                             "--num-timesteps", str(ENJOY_ENVS * ENJOY_STEPS), "--plot",
                             "--device", "cuda"] + (["--render"] if render else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launches()
        expected = {k: enjoy_expected(enjoy, render) if k == kernel else 0 for k in launches}
        expected["conv1"] = ENJOY_CONV1_PER_STEP[name] * ENJOY_STEPS
        if launches != expected:
            raise AssertionError(f"{what}: launches {launches}, not {expected}")
        returns = result["episode_returns"]
        mean = result["mean_return"]
        if not all(map(math.isfinite, returns)) or not (mean is None or math.isfinite(mean)):
            raise AssertionError(f"{what}: returns {returns[:8]}, mean {mean}")
        _, env, loaded = enjoy.load_config_and_setup(log_dir, "cuda")
        if hasattr(trained, "_act_carry"):  # start from a zero LSTM context, as `loaded`
            trained._act_carry = trained._act_ctx = None
        acts = acts_alike(torch, loaded, trained, env, what, dones_seq, atol)
        detail = []
        if name == "lstm":
            if type(loaded).__name__ != "RecurrentPPO2" or "mean_proba" not in result:
                raise AssertionError(f"{what}: {type(loaded).__name__}, {sorted(result)}")
            detail.append(f"reloads as {type(loaded).__name__}, mean action probabilities "
                          f"{np.round(result['mean_proba'], 4).tolist()}")
        if name.endswith("srl") and tuple(env.observation_space.shape) != (3,):
            raise AssertionError(f"{what}: observations {env.observation_space.shape}")
        if "mixed" in name and not hasattr(env, "families"):
            raise AssertionError(f"{what}: the mixed pod was not rebuilt")
        if render:
            worst = hold_frames(torch, result, env, render2d, render3d, what)
            detail.append(f"{len(result['frames'])} frames {result['frames'][0].shape} agree "
                          f"with the twin (max |diff| {worst})")
        traj = result["trajectory"]
        if traj.shape != (ENJOY_STEPS, 2) or not np.isfinite(traj).all():
            raise AssertionError(f"{what}: trajectory {traj.shape}")
        rate = result["env_steps"] / result["rollout_seconds"]
        log(f"[replay] {what}: {result['env_steps']} env steps in "
            f"{result['rollout_seconds']:.2f} s: {rate:.0f} env-steps/s ({seconds:.2f} s with "
            f"set-up); {len(returns)} episodes, mean return {mean}; launches {launches}; "
            f"acts as the trained agent on two steps of 8 envs (first "
            f"{np.round(np.asarray(acts[0])[:2], 4).tolist()}); "
            + "; ".join(detail) + f"; figures {result.get('plot_path')}, "
            f"{result.get('frames_path')}")
        out[what.split()[0]] = launches[kernel]
    return out


def get_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"GET {path}: HTTP {resp.status}")
        return json.loads(resp.read())
    finally:
        conn.close()


def host_tools(torch, has_matplotlib: bool) -> None:
    """Step 11's tools over the smoke's own log root: a pipeline grid, a
    Hyperband search, the plots, the live curves, the dataset tools and a
    frame store round trip."""
    from srl_tpu_torch.data import change_to_relative_pos, dataset_fusioner, dataset_generator
    from srl_tpu_torch.experiments import hyperparam_search, live_vis, pipeline
    from srl_tpu_torch.native import FrameStoreReader, FrameStoreWriter
    from srl_tpu_torch.replay import aggregate_plots, compare_plots, gather_results, plots
    from srl_tpu_torch.srl.episode_saver import load_dataset
    from srl_tpu_torch.utils.monitor import load_results

    logs = os.path.join(KEPT["root"], "logs")
    env_logs = os.path.join(logs, "MobileRobotGymEnv-v0")
    t0 = time.perf_counter()
    runs = pipeline.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                          "--num-iteration", "2", "--seed", "5", "--num-timesteps", "960000",
                          "--log-dir", logs, "--srl-config-file",
                          os.path.join(REPO, "config", "srl_models.yaml"), "--device", "cuda",
                          "--num-envs", "4096"])
    episodes = [len(load_results(r)[0]["r"]) for r in runs]
    if len(runs) != 2 or min(episodes) < 4096:
        raise AssertionError(f"pipeline: runs {runs}, episodes {episodes}")
    log(f"[tools] pipeline: 2 seeds of the quickstart (4096 envs) in "
        f"{time.perf_counter() - t0:.1f} s, {episodes} episodes")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "hyperband.csv")
        best, params = hyperparam_search.main([
            "--algo", "ppo2", "--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
            "--optimizer", "hyperband", "--max-eval", "3", "--num-timesteps", "8000",
            "--log-dir", tmp, "--output", csv_path, "--device", "cuda"])
        with open(csv_path) as fh:
            rows = fh.read().splitlines()
    if not math.isfinite(best) or len(rows) != 7:
        raise AssertionError(f"hyperband: best {best}, {len(rows) - 1} trials")
    log(f"[tools] hyperband --max-eval 3 on MobileRobot ground truth (16 envs): 3 "
        f"configurations, {len(rows) - 1} training runs in {time.perf_counter() - t0:.1f} s; "
        f"best score {best:.4g} with n_steps {params['n_steps']}")

    t0 = time.perf_counter()
    curves = os.path.join(KEPT["root"], "curves")
    png = plots.main(["--log-dir", runs[0]])
    aggregate_plots.main(["--log-dir", env_logs, "--output", curves])
    npz = sorted(f for f in os.listdir(curves) if f.endswith(".npz"))
    if npz != ["autoencoder.npz", "ground_truth.npz", "raw_pixels.npz"]:
        raise AssertionError(f"aggregate_plots: {npz}")
    compare = compare_plots.main(["-i", curves, "--title", "chip smoke"])
    results_csv, tests = gather_results.main(["--log-dir", env_logs, "--timesteps", "100000",
                                              "1000000"])
    with open(results_csv) as fh:
        table = fh.read().splitlines()
    if len(table) != 4:
        raise AssertionError(f"gather_results: {table}")
    drawn = [png, compare, os.path.join(curves, "aggregated_curves.png")]
    if has_matplotlib != all(p and os.path.isfile(p) for p in drawn):
        raise AssertionError(f"figures {drawn} with matplotlib {has_matplotlib}")
    server = live_vis.LiveVisServer(runs[0], port=0)
    if not server.start():
        raise AssertionError("live_vis: no free port")
    try:
        data = get_json(server.port, "/data.json")
    finally:
        server.stop()
    if data != json.loads(json.dumps(live_vis.read_run_data(runs[0]))):
        raise AssertionError("live_vis: data.json differs from read_run_data")
    log(f"[tools] plots, aggregate_plots ({', '.join(npz)}), compare_plots, gather_results "
        f"({table[0]}; {len(tests)} t-tests) and the live server's data.json "
        f"({len(data['episodes'])} episodes) in {time.perf_counter() - t0:.1f} s"
        + ("" if has_matplotlib else "; matplotlib is missing: no figure drawn"))

    t0 = time.perf_counter()
    first = KEPT["mobile dataset"]
    root = os.path.dirname(first)
    second = dataset_generator.main(["--env", "MobileRobotGymEnv-v0", "--num-envs", "32",
                                     "--max-steps", "15", "--num-episode", "32", "--name",
                                     "mobile2", "--save-path", root, "--device", "cuda"])
    merged = dataset_fusioner.main(["--merge", first, second, os.path.join(root, "merged"),
                                    "--keep-sources"])
    change_to_relative_pos.main(["--data-folder", merged])
    d1, d2, dm = load_dataset(first), load_dataset(second), load_dataset(merged)
    n1 = len(d1["rewards"])
    idx = np.cumsum(dm["episode_starts"]) - 1
    relative = np.concatenate([d1["ground_truth_states"], d2["ground_truth_states"]]) \
        - dm["target_positions"][idx]
    if not (np.array_equal(dm["observations"][:n1], d1["observations"])
            and np.array_equal(dm["observations"][n1:], d2["observations"])
            and np.array_equal(dm["ground_truth_states"], relative)
            and dm["episode_starts"].sum() == 64):
        raise AssertionError("dataset_fusioner / change_to_relative_pos: merged data differ")
    log(f"[tools] dataset_fusioner of {n1} + {len(d2['rewards'])} MobileRobot frames "
        f"(224x224x3), then change_to_relative_pos, in {time.perf_counter() - t0:.1f} s")

    frames = d1["observations"]
    path = os.path.join(root, "store.srlf")
    t0 = time.perf_counter()
    writer = FrameStoreWriter(path, frames.shape[1:])
    for i in range(0, len(frames), 256):
        writer.push(frames[i:i + 256])
    t_push = time.perf_counter() - t0
    n = writer.close()
    t_close = time.perf_counter() - t0
    with FrameStoreReader(path) as reader:
        same = np.array_equal(reader.frames, frames)
    if n != len(frames) or not same or frames.shape != (2048, 224, 224, 3):
        raise AssertionError(f"framestore: {n} frames of {frames.shape}, equal {same}")
    log(f"[tools] framestore: {frames.shape} uint8 ({frames.nbytes / 1e6:.0f} MB) pushed in "
        f"{t_push:.3f} s, on disk at close after {t_close:.3f} s, read back equal")


SRL_SERVE_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "autoencoder",
                  "--algo", "ppo2", "--num-envs", "256", "--num-timesteps",
                  str(2 * 128 * 256), "--no-vis"]
SERVICE_TIMEOUT = 60.0  # seconds a loopback exchange may take, training aside
SERVED_CALL = 129  # the served run's render after step 128: its second rollout's start


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def within(seconds: float, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a daemon thread, so that a server that
    stopped answering fails the phase instead of hanging the script."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        raise AssertionError(f"{getattr(fn, '__qualname__', fn)} did not return in {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def serving(target, *args, **kwargs) -> threading.Thread:
    thread = threading.Thread(target=target, args=args, kwargs=kwargs, daemon=True)
    thread.start()
    return thread


def stopped(thread: threading.Thread, what: str) -> None:
    thread.join(5)
    if thread.is_alive():
        raise AssertionError(f"{what}: the server did not stop within 5 s of EXIT")


@contextlib.contextmanager
def served_batch(call: int):
    """Keeps the ``call``-th batch that a run renders and encodes through
    SRLEncodedEnv on MobileRobot: the env, a copy of the state, the frames
    and the observations. Nothing is launched that the run would not launch."""
    from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
    from srl_tpu_torch.srl.models import SRLEncodedEnv

    render, observe = MobileRobotEnv.render_pixels, SRLEncodedEnv.observe
    kept, calls = {}, {"render": 0, "observe": 0}

    def render_pixels(self, state):
        frames = render(self, state)
        calls["render"] += 1
        if calls["render"] == call:
            kept.update(env=self, frames=frames.clone(), state=dataclasses.replace(
                state, **{f.name: getattr(state, f.name).clone()
                          for f in dataclasses.fields(state)}))
        return frames

    def encode(self, state):
        obs = observe(self, state)
        calls["observe"] += 1
        if calls["observe"] == call:
            kept["obs"] = obs.clone()
        return obs

    MobileRobotEnv.render_pixels, SRLEncodedEnv.observe = render_pixels, encode
    try:
        yield kept
    finally:
        MobileRobotEnv.render_pixels, SRLEncodedEnv.observe = render, observe
    kept["calls"] = calls


def srl_service(torch, train, render2d) -> int:
    """Step 12a: train an encoder through the SRL service and serve it;
    returns render2d's launches while serving."""
    from srl_tpu_torch.srl import client, server

    t0 = time.perf_counter()
    port = free_port()
    thread = serving(server.serve, port, device="cuda")
    cli = within(SERVICE_TIMEOUT, client.SRLClient, KEPT["mobile dataset"], port=port)
    t_learn = time.perf_counter()
    cli.sendLearnSignal("autoencoder", state_dim=3, epochs=1)
    ok, path = cli.waitForSRLModel(timeout_s=600)
    learn_s = time.perf_counter() - t_learn
    if not ok or not os.path.isfile(path):
        raise AssertionError(f"12a: LEARN answered ({ok}, {path})")
    with open(os.path.join(os.path.dirname(path), "history.json")) as fh:
        hist = json.load(fh)
    if len(hist["history"]) != 1 or not all(map(math.isfinite, hist["history"][0].values())):
        raise AssertionError(f"12a: history {hist['history']}")
    log(f"[zmq] 12a LEARN over ZMQ: READY with {path} after {learn_s:.2f} s; "
        f"{hist['images_trained']} images in {hist['seconds']:.2f} s on the card: "
        f"{hist['img_per_s']:.0f} img/s, reconstruction {hist['history'][0]['reconstruction']:.5f}")

    config = os.path.join(KEPT["root"], "srl_service.yaml")
    with open(config, "w") as fh:
        fh.write(f"MobileRobotGymEnv-v0:\n  log_folder: {os.path.dirname(path)}/\n"
                 f"  autoencoder: {os.path.basename(path)}\n")
    argv = SRL_SERVE_ARGS + ["--srl-config-file", config]
    with served_batch(SERVED_CALL) as kept:
        _, launches, _ = drive(torch, train, argv,
                               "12a the service's encoder (SRLEncodedEnv) 256 envs",
                               obs_shape=(3,))
    # The policy reads the encoder's 3-d states: no conv1.
    expected = {"render2d": 257, "render3d": 0, "conv1": 0, "conv1_wgrad": 0}
    if launches != expected:
        raise AssertionError(f"12a: launches {launches}, not {expected}")
    if kept["calls"] != {"render": 257, "observe": 257}:
        raise AssertionError(f"12a: the served run rendered and encoded {kept['calls']}")
    src, frames, obs = kept["env"], kept["frames"], kept["obs"]
    xs, ys, bg = render2d.static_tensors(src.dim, *src.render_shape, "cuda")
    plain = render2d.render_mobile_robot_plain(render2d.scene_params(src, kept["state"]),
                                               xs, ys, bg)
    if tuple(obs.shape) != (256, 3) or not torch.isfinite(obs).all():
        raise AssertionError(f"12a: observations {tuple(obs.shape)}")
    if not torch.equal(frames, plain):
        raise AssertionError("12a: a served frame disagrees with the twin")

    cli.data_folder = os.path.join(KEPT["root"], "no such dataset")
    cli.sendLearnSignal("autoencoder", state_dim=3, epochs=1)
    answer = cli.waitForSRLModel(timeout_s=SERVICE_TIMEOUT)
    if answer != (False, None):
        raise AssertionError(f"12a: a LEARN on a missing folder answered {answer}")
    within(SERVICE_TIMEOUT, cli.waitReady)
    cli.close()
    stopped(thread, "12a")
    log(f"[zmq] 12a: observations {tuple(obs.shape)}; the {frames.shape[0]} frames "
        f"{tuple(frames.shape[1:])} of the served run's render {SERVED_CALL} equal the "
        f"twin's bit for bit; a LEARN on a missing "
        f"folder answered ERROR, then HELLO answered READY; EXIT stopped the server; "
        f"launches {launches}; 12a took {time.perf_counter() - t0:.1f} s")
    return launches["render2d"]


def sim_loopback(torch) -> None:
    """Step 12b: one Omnirobot episode over loopback against the env
    stepped in process."""
    from srl_tpu_torch.envs.omnirobot import OmniRobotEnv
    from srl_tpu_torch.real_robots import constants, remote_env, sim_server

    t0 = time.perf_counter()
    n_steps = constants.Omnirobot.MAX_STEPS + 1
    actions = np.random.default_rng(0).integers(0, 4, n_steps)
    port = free_port()
    srv = sim_server.OmniRobotSimServer(port, seed=0, device="cuda")
    thread = serving(srv.serve_forever)
    env = within(SERVICE_TIMEOUT, remote_env.OmniRobotRemoteEnv, port=port)

    def episode():
        got = [(env.reset(), 0.0, False, env.getGroundTruth(), env.getTargetPos())]
        t_steps = time.perf_counter()
        for a in actions:
            obs, reward, done, _ = env.step(int(a))
            got.append((obs, reward, done, env.getGroundTruth(), env.getTargetPos()))
        return got, time.perf_counter() - t_steps

    got, step_s = within(SERVICE_TIMEOUT, episode)
    within(SERVICE_TIMEOUT, env.close)
    stopped(thread, "12b")

    local = OmniRobotEnv(srl_model="raw_pixels")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, reward = local.reset(gen, 1), torch.zeros(1)
    local_s = 0.0  # what the server does for a step: step, render, frame to the host
    for t, (obs, r, done, pos, target) in enumerate(got):
        t_local = time.perf_counter()
        if t:
            state, reward, _ = local.step(
                state, torch.tensor([int(actions[t - 1])], dtype=torch.int32, device="cuda"), gen)
        frame = local.render_pixels(state)[0].cpu().numpy()
        local_s += (time.perf_counter() - t_local) if t else 0.0
        if not (np.array_equal(obs, frame) and r == float(reward[0])
                and np.array_equal(pos, state.robot_pos[0].cpu().numpy())
                and np.array_equal(target, state.target_pos[0].cpu().numpy())):
            raise AssertionError(f"12b: step {t} over the socket differs from the env")
        if done != (t == n_steps):
            raise AssertionError(f"12b: done {done} at step {t}")
    bumps = sum(r == -1.0 for _, r, _, _, _ in got)
    log(f"[zmq] 12b Omnirobot over loopback: reset and {n_steps} steps, done at step "
        f"{n_steps}; every frame {got[0][0].shape} {got[0][0].dtype} ({got[0][0].nbytes} bytes), "
        f"reward and position equals the in-process env on the card bit for bit ({bumps} wall "
        f"bumps); {n_steps / step_s:.0f} steps/s over loopback ({step_s * 1e3 / n_steps:.3f} ms "
        f"a round trip, of which the env's step, render and copy to the host take "
        f"{local_s * 1e3 / n_steps:.3f} ms in process; {got[0][0].nbytes * n_steps / step_s / 1e6:.1f} "
        f"MB/s of frames); 12b took {time.perf_counter() - t0:.1f} s")


# Step 13's runs, each PPO2 at the reference's widths (srl_tpu_torch.parallel.dp_ppo).
DP_KUKA_ARGS = ["--env", "KukaButtonGymEnv-v0", "--srl-model", "raw_pixels", "--render-scale",
                "2", "--coarse-obs", "--num-envs", "256", "--updates", "2"]
DP_MOBILE_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "raw_pixels",
                  "--num-envs", "256", "--updates", "2", "--fingerprint-steps", "260"]
DP_MIXED_ARGS = ["--env", "KukaButtonGymEnv-v0", "--mixed-envs", "KukaButtonGymEnv-v0",
                 "OmnirobotEnv-v0", "--srl-model", "raw_pixels", "--render-scale", "2",
                 "--num-envs", "256", "--updates", "1", "--fingerprint-steps", "64"]
DP_CHILD_TIMEOUT = 240.0  # seconds the ranks of 13b, 13c, 14a or 14b may take
# The reference's bar for a dp update against one process
# (tests/test_sharding.py:68-93): pg_loss rtol 1e-4 (atol 1e-5), parameters
# rtol 1e-3 (atol 1e-5). 13a's one rank runs the policy over the batch one
# process runs it over, and is held to it for every update. In 13b and 13c a
# rank runs the policy's bfloat16 convolutions over its own rows, which cuDNN
# rounds otherwise than the whole batch (measured on an H100: a 256-row
# forward and two 128-row ones 2.4e-4 apart in the logits and 0.014 in the
# values; one update over 2 ranks from the same data 1.2% apart in pg_loss,
# up to 8.3e-4 in a parameter), and Adam's per-element step turns that
# rounding into a parameter difference of about 4% of the step the
# parameters took. They are held to the reference's curve bar on pg_loss
# (:96-123: rtol 5e-3, atol 1e-4) and to the step: |p_dp - p_one| <=
# STEP_RTOL |p_one - p_0| over the whole vector. A dp update that leaves the
# gradients unreduced lands about 75% of the step away.
PG_RTOL, PG_ATOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5, 1e-3, 1e-5
CURVE_RTOL, CURVE_ATOL = 5e-3, 1e-4
STEP_RTOL = 0.1
# Step 15's bars (see DP_AGENT_RUNS): each first gradient the agent hands on
# (the optimizer's after the dp all-reduce, TRPO's surrogate gradient too)
# within GRAD_RTOL of one process's over the whole vector; ACER's first
# iteration, made before any step, on the one-update bar for FIRST_KEYS.
# Measured on an H100 (scripts/dp_bar_check.py; PERF.md, section 6):
# the sound runs 0.16-1.15% from one process, the same to the digit in
# every run; with rank 1's share left out of the gradient all-reduces 43-52%
# (4.6% in 15d, whose first minibatch draws its signal from rank 0's
# envs), with the sum dp times too large 100%.
GRAD_RTOL = 0.02
FIRST_KEYS = ("loss_policy", "loss_q")


def first_grads_off(got: dict, want: dict) -> dict:
    """For each gradient site the dp run and one process both kept
    (``dp_ppo``'s ``grads0``: the first gradient the agent handed on),
    |g_dp - g_one| / |g_one| over the whole vector."""
    if not got.get("grads0") or not want.get("grads0"):
        return {}
    return {k: ((got["grads0"][k].double() - g.double()).norm() / g.double().norm()).item()
            for k, g in want["grads0"].items()}


def leaf_reading(torch, got: dict, want: dict, top: int = 3) -> str:
    """The ``top`` leaves that hold most of |p_dp - p_one|^2: each one's
    share of it and its own |p_dp - p_one| / |p_one - p_0|."""
    names, sizes = zip(*want["leaves"])
    split = lambda x: dict(zip(names, torch.split(x.double(), list(sizes))))
    off = split(got["params"] - want["params"])
    step = split(want["params"] - want["params0"])
    total = sum(v.square().sum().item() for v in off.values()) or 1.0
    worst = sorted(names, key=lambda k: -off[k].square().sum().item())[:top]
    return ", ".join(f"{k} {off[k].square().sum().item() / total:.0%} of it "
                     f"({off[k].norm().item() / max(step[k].norm().item(), 1e-30):.1%} of its step)"
                     for k in worst)


def hold_dp(torch, got: dict, want: dict, what: str, own_rows: bool,
            held: tuple = ("curve", "step")) -> str:
    """The loss (pg_loss; TRPO's kl, ACER's loss_policy: ``loss_metric``),
    first gradients and parameters of a dp run against the one-process
    run's; returns the differences. Where a rank runs the policy over its own
    rows (``own_rows``; see above), the bars named in ``held``: "curve" (the
    loss of every update within the curve bar), "step" (|p_dp - p_one| <=
    STEP_RTOL of the step), "first" (the first update's FIRST_KEYS within the
    one-update bar), "grad" (each first gradient within GRAD_RTOL); else the
    one-update bar on the loss and every parameter."""
    name = want["loss_metric"]
    pg, pg_want = np.asarray(got[name]), np.asarray(want[name])
    params, params_want = got["params"].double(), want["params"].double()
    step = (params_want - want["params0"].double()).norm().item()
    off = (params - params_want).norm().item()
    grads_off = first_grads_off(got, want)
    close = lambda a, b, rtol, atol: bool(np.all(np.abs(np.asarray(a) - np.asarray(b))
                                                 <= atol + rtol * np.abs(np.asarray(b))))
    failed = []
    if not own_rows:
        if not close(pg, pg_want, PG_RTOL, PG_ATOL):
            failed.append(f"{name} rtol {PG_RTOL} atol {PG_ATOL}")
        if not bool(((params - params_want).abs()
                     <= PARAM_ATOL + PARAM_RTOL * params_want.abs()).all()):
            failed.append(f"parameters rtol {PARAM_RTOL} atol {PARAM_ATOL}")
    else:
        if "curve" in held and not close(pg, pg_want, CURVE_RTOL, CURVE_ATOL):
            failed.append(f"{name} rtol {CURVE_RTOL} atol {CURVE_ATOL}")
        if "step" in held and not off <= STEP_RTOL * step:
            failed.append(f"|p_dp - p_one| <= {STEP_RTOL} |p_one - p_0|")
        if "first" in held:
            failed += [f"the first {k} rtol {PG_RTOL} atol {PG_ATOL}" for k in FIRST_KEYS
                       if not close(got["metrics"][k][0], want["metrics"][k][0], PG_RTOL,
                                    PG_ATOL)]
        if "grad" in held:
            if not grads_off:
                failed.append("first gradients kept")
            failed += [f"the first {k} gradient |g_dp - g_one| <= {GRAD_RTOL} |g_one|"
                       for k, v in grads_off.items() if not v <= GRAD_RTOL]
    diff = (f"{name} {pg.tolist()} vs {pg_want.tolist()} (|diff| "
            f"{np.abs(pg - pg_want).tolist()}); parameters max |diff| "
            f"{(params - params_want).abs().max().item():.3g}, |p_dp - p_one| {off:.4g} of "
            f"the step |p_one - p_0| {step:.4g} ({off / step:.3%})")
    if off > 0 and "leaves" in want:
        diff += f", most in {leaf_reading(torch, got, want)}"
    if grads_off:
        diff += "; the first gradients' |g_dp - g_one| / |g_one|: " + ", ".join(
            f"{k} {v:.3%}" for k, v in grads_off.items())
    if "metrics" in want:
        moved = {k: max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["metrics"][k], v))
                 for k, v in want["metrics"].items()}
        diff += "; every metric's largest relative |diff|: " + ", ".join(
            f"{k} {v:.2g}" for k, v in moved.items())
        if "first" in held:
            diff += "; the first update's " + ", ".join(
                f"{k} {got['metrics'][k][0]} vs {want['metrics'][k][0]}" for k in FIRST_KEYS)
    if failed:
        raise AssertionError(f"{what}: not within {'; '.join(failed)}: {diff}")
    return diff


def dp_rates(results: list, card: str) -> str:
    rates = ", ".join(f"rank {r['rank']} {r['rank_env_steps_per_s']:.0f}" for r in results)
    coll = "; ".join(f"rank {r['rank']} " + "/".join(f"{c:.3f}" for c in r["collective_s"])
                     for r in results)
    line = (f"{results[0]['env_steps_per_s']:.0f} env-steps/s global ({rates}); collectives "
            f"s an update: {coll}")
    if results[0]["tp"] > 1:
        line += "; of the tp groups (weight gathers, norm sums): " + "; ".join(
            f"rank {r['rank']} " + "/".join(f"{c:.3f}" for c in r["tp_collective_s"])
            for r in results)
    mem = ", ".join(f"rank {r['rank']} {r['peak_mem_gb']:.2f} GB" for r in results)
    state = ", ".join(f"rank {r['rank']} {r['state_mb']:.2f}" for r in results)
    return f"{line}; peak memory {mem}; state_mb {state}; {card}"


def nccl_one_rank(torch, card: str) -> dict:
    """Step 13a: the Kuka pixel run on a one-rank NCCL world against the same
    run without a mesh; returns the meshed run's result."""
    import torch.distributed as tdist

    from srl_tpu_torch.parallel import distributed, dp_ppo

    t0 = time.perf_counter()
    args, env_argv = dp_ppo.build_parser().parse_known_args(DP_KUKA_ARGS)
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0")
    try:
        if not distributed.initialize(device="cuda"):
            raise AssertionError("13a: initialize() set up no process group")
        mesh = distributed.make_global_mesh()
        distributed.warmup_collectives(mesh)
        if (tdist.get_backend(), mesh.shape) != ("nccl", {"dp": 1, "tp": 1}):
            raise AssertionError(f"13a: {tdist.get_backend()} mesh {mesh.shape}")
        meshed = dp_ppo.run(args, env_argv, mesh)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    plain = dp_ppo.run(args, env_argv)
    diff = hold_dp(torch, meshed, plain, "13a", own_rows=False)
    launches = [r["init_launches"]["render3d"] + r["launches"]["render3d"]
                for r in (meshed, plain)]
    if launches != [257, 257] or meshed["launches"]["render2d"]:
        raise AssertionError(f"13a: render3d launched {launches} times (meshed, plain), not 257")
    log(f"[dp] 13a Kuka pixels, one NCCL rank: {diff}; render3d {launches[0]} launches as "
        f"without the mesh ({plain['env_steps_per_s']:.0f} env-steps/s there); "
        + dp_rates([meshed], card) + f"; 13a took {time.perf_counter() - t0:.1f} s")
    return meshed


def gloo_ranks(torch, argv: list, what: str, card: str, kernel: str, expected: list,
               one: dict = None, held: tuple = ("curve", "step"),
               launch: tuple = ("-m", "srl_tpu_torch.parallel.dp_ppo")) -> tuple:
    """Steps 13b, 13c and 14: ``dp_ppo`` in ``len(expected)`` processes on
    the one card, joined by gloo over 127.0.0.1, ``--tp`` of them to a tp
    group, against one process stepping the whole batch: ``one``, that
    run's result when a step made it already (same arguments and seed),
    else it runs while the processes start, which wait, once in their
    world, for it to end. The processes are killed on failure.
    ``expected`` is each rank's launches of ``kernel`` while training;
    ``held`` names ``hold_dp``'s bars; ``launch`` is what each rank's
    python runs, ``dp_ppo``'s ``main`` on the arguments that follow it.
    Returns (the one-process result, the ranks' results)."""
    from srl_tpu_torch.parallel import dp_ppo

    t0 = time.perf_counter()
    args, env_argv = dp_ppo.build_parser().parse_known_args(argv)
    n, tp = len(expected), args.tp
    dp = n // tp
    with tempfile.TemporaryDirectory() as out:
        gate = os.path.join(out, "start")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(n), GLOO_SOCKET_IFNAME="lo")
        cmd = [sys.executable, *launch, *argv, "--backend",
               "gloo", "--timeout", str(int(DP_CHILD_TIMEOUT)), "--out", out,
               "--start-after", gate]
        procs = []
        try:
            for rank in range(n):
                procs.append(subprocess.Popen(cmd, cwd=REPO, env={**env, "RANK": str(rank)},
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
            if one is None:
                one = dp_ppo.run(args, env_argv)
                torch.cuda.empty_cache()
            t_ranks = time.perf_counter()
            open(gate, "w").close()
            deadline = time.monotonic() + DP_CHILD_TIMEOUT
            outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                    for p in procs]
            ranks_s = time.perf_counter() - t_ranks
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (stdout, stderr) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"{what}: a rank exited {p.returncode}:\n{stdout[-3000:]}"
                                     f"\n{stderr[-3000:]}")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(n)]
    rows = args.num_envs // dp
    got = [(r["rank"], r["dp"], r["tp"], r["rows"], r["backend"]) for r in ranks]
    if got != [(r, dp, tp, rows, "gloo") for r in range(n)]:
        raise AssertionError(f"{what}: ranks {got}")
    loss = one["loss_metric"]
    if any(r[loss] != ranks[0][loss] or not torch.equal(r["params"], ranks[0]["params"])
           for r in ranks):
        raise AssertionError(f"{what}: the ranks disagree on {loss} or the parameters")
    if not np.isfinite(ranks[0][loss] + one[loss]).all():
        raise AssertionError(f"{what}: {loss} {ranks[0][loss]}, one process {one[loss]}")
    for name, want in one["fingerprints"].items():
        # The ranks of a tp group step the same rows.
        if not all(torch.equal(r["fingerprints"][name], ranks[r["rank"] - r["rank"] % tp]
                               ["fingerprints"][name]) for r in ranks):
            raise AssertionError(f"{what}: the ranks of a tp group differ in their {name}")
        got = torch.cat([r["fingerprints"][name] for r in ranks[::tp]], 1)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the ranks' {name} differ from one process's")
    steps, resets = one["fingerprints"]["done"].shape[0], int(one["fingerprints"]["done"].sum())
    diff = hold_dp(torch, ranks[0], one, what, own_rows=dp > 1, held=held)
    launches = [r["launches"][kernel] for r in ranks]
    if launches != expected:
        raise AssertionError(f"{what}: {kernel} launched {launches} times, not {expected}")
    if tp > 1 and not all(r["state_mb"] < 0.51 * one["state_mb"] for r in ranks):
        raise AssertionError(f"{what}: a rank holds {[r['state_mb'] for r in ranks]} MB of "
                             f"parameters and Adam moments, one process {one['state_mb']}")
    log(f"[dp] {what}: rewards, dones and frame fingerprints of {steps} steps ({resets} "
        f"auto-resets) equal one process stepping all {args.num_envs} envs bit for bit; "
        f"{diff}; {kernel} {launches} launches while training (N={rows} a rank; the reset "
        f"before, {[r['init_launches'][kernel] for r in ranks]}, at the global batch); "
        f"families {ranks[0]['family_counts']}; one process {one['env_steps_per_s']:.0f} "
        f"env-steps/s, state_mb {one['state_mb']:.2f}; the ranks' collectives are gloo's "
        f"allreduce and allgather on card tensors, which gloo stages through host memory "
        f"itself; " + dp_rates(ranks, card)
        + f"; the ranks ran {ranks_s:.1f} s after the gate, {what} "
        f"{time.perf_counter() - t0:.1f} s")
    return one, ranks


# Step 15's runs: every other agent whose state shard_ppo_state lays out, at
# the reference's widths and 256 global envs over two gloo ranks, each
# agent's default config cut in depth only (n_steps and updates): (run,
# what, dp_ppo arguments, kernel, the bars hold_dp holds it to). Each rank
# launches its kernel n_steps x updates times at N=128. ACER's store at 8
# steps is 50 x 9 x 256 Kuka frames (4.3 GB; 2.2 GB a rank),
# RecurrentACER's at 4 steps 50 x 5 x 256 MobileRobot frames (9.6 GB; 4.8
# GB a rank); both replay from their 4th iteration (replay_start 4).
#
# A rank's convolutions round its rows otherwise than one process's, and
# each summation order rounds its own way: the first gradients differ by
# 0.2-1.2% (1e-5 with the CNN in float32). Adam steps each entry by about lr
# whatever its size, so an entry's step follows its own relative
# difference, large for the many small entries, and every later minibatch
# runs on weights that moved apart: |p_dp - p_one| grows to 5-44% of the
# update's step with depth, spread over every leaf (15% in float32; PERF.md,
# section 6). An optimizer that is blind to the gradient's scale
# cannot see a gradient twice too large either, and 13b's bars let
# both planted faults through on A2C. So every run holds its first
# gradients to GRAD_RTOL; the RMSProp agents (A2C, ACER), whose distances
# stay small, keep 13b's step bar, A2C its curve bar, ACER its first,
# pre-replay iteration's losses (FIRST_KEYS, the one-update bar; the
# replayed ones follow Retrace targets that swing by orders of magnitude
# between iterations).
DP_KUKA = DP_KUKA_ARGS[:-2] + ["--fingerprint-steps", "16"]
DP_MOBILE = DP_MOBILE_ARGS[:6] + ["--fingerprint-steps", "16"]
ADAM_BARS, A2C_BARS, ACER_BARS = ("grad",), ("curve", "step", "grad"), ("first", "step", "grad")
DP_AGENT_RUNS = [
    ("15a", "PPO1, Kuka pixels", DP_KUKA + ["--algo", "ppo1", "--n-steps", "16", "--updates",
                                           "2"], "render3d", ADAM_BARS),
    ("15b", "A2C, Kuka pixels", DP_KUKA + ["--algo", "a2c", "--n-steps", "5", "--updates",
                                          "2"], "render3d", A2C_BARS),
    ("15c", "TRPO, Kuka pixels", DP_KUKA + ["--algo", "trpo", "--n-steps", "16", "--updates",
                                           "2"], "render3d", ADAM_BARS),
    ("15d", "PPO2 cnnlstm, MobileRobot 224x224",
     DP_MOBILE + ["--algo", "ppo2", "--policy", "cnnlstm", "--n-steps", "16", "--updates",
                  "1"], "render2d", ADAM_BARS),
    ("15e", "A2C cnnlstm, MobileRobot 224x224",
     DP_MOBILE + ["--algo", "a2c", "--policy", "cnnlstm", "--n-steps", "5", "--updates", "2"],
     "render2d", A2C_BARS),
    ("15f", "ACER, Kuka pixels", DP_KUKA + ["--algo", "acer", "--n-steps", "8", "--updates",
                                           "5"], "render3d", ACER_BARS),
    ("15g", "RecurrentACER cnnlstm, MobileRobot 224x224",
     DP_MOBILE + ["--algo", "acer", "--policy", "cnnlstm", "--n-steps", "4", "--updates", "5"],
     "render2d", ACER_BARS),
]


def dp_launches(argv: list) -> list:
    """Each of two ranks' kernel launches while training: n_steps x updates."""
    return [flag(argv, "--n-steps") * flag(argv, "--updates")] * 2


def agent_ranks(torch, card: str) -> dict:
    """Step 15: each of ``DP_AGENT_RUNS`` on two gloo ranks against one
    process, then 15h (TRPO, dp1 x tp2) against 15c's one process; returns
    each run's ranks' results."""
    out, ones = {}, {}
    for run, what, argv, kernel, held in DP_AGENT_RUNS:
        torch.cuda.empty_cache()
        ones[run], out[run] = gloo_ranks(torch, argv, f"{run} {what}, 2 gloo ranks", card,
                                         kernel, dp_launches(argv), held=held)
        if run == "15c":
            trpo_argv = argv + ["--tp", "2"]
    torch.cuda.empty_cache()
    _, out["15h"] = gloo_ranks(torch, trpo_argv, "15h TRPO, Kuka pixels, dp1 x tp2", card,
                               "render3d", dp_launches(trpo_argv), one=ones["15c"])
    n_steps = flag(trpo_argv, "--n-steps")
    out["conv1"] = {
        run: [hold_conv1(f"{run} rank {r['rank']}", r["launches"],
                         trpo_conv1(r["metrics"]["line_search_accepted"], n_steps))
              for r in ([ones["15c"]] if run == "15c one" else out[run.split()[0]])]
        for run in ("15c one", "15c", "15h")}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "srl_tpu_torch")):
        print("chip_smoke: srl_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from srl_tpu_torch.envs import kuka, mobile_robot
    from srl_tpu_torch.experiments import train
    from srl_tpu_torch.ops import cuda_build, render2d, render3d

    dev = torch.device("cuda")
    kept = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    KEPT["root"] = kept.name
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}; allow_tf32: "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()

    # 1. Build.
    build_kernels(cuda_build)

    # 2. Kernels against their twins.
    r3_err, (cfg, scene, cam) = compare_render3d(torch, dev, kuka, render3d)
    r2_err, (env2d, inputs2d) = compare_render2d(torch, dev, mobile_robot, render2d)

    # 3. Times at the main paths' shapes.
    out3 = render3d.render_kuka_cuda(cfg, scene, cam)
    outs3 = rotating(torch, out3.shape, dev)
    r3_ms = time_ms(lambda: render3d.render_kuka_cuda(cfg, scene, cam, out=next(outs3)), 200)
    r3_one_ms = time_ms(lambda: render3d.render_kuka_cuda(cfg, scene, cam, out=out3), 200)
    r3_unculled_ms = time_ms(
        lambda: render3d.render_kuka_cuda(cfg, scene, cam, out=next(outs3), cull=False), 50)
    # Every primitive far below the floor: what the kernel costs with nothing
    # to trace. And a plain fill of the same outputs: what writing them costs.
    far = torch.full_like(scene, -50.0)
    r3_empty_ms = time_ms(lambda: render3d.render_kuka_cuda(cfg, far, cam, out=next(outs3)), 200)
    r3_fill_ms = time_ms(lambda: next(outs3).fill_(0), 200)
    r3_plain_ms = time_ms(
        lambda: render3d.render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg), 5, 1)
    r3_bound = render_bound_ms(render3d, cfg, scene)
    log(f"[bound] render3d N={scene.shape[0]} trace {cfg.trace_h}x{cfg.trace_w}: culling "
        f"keeps {r3_bound['kept_per_pixel']:.4f} primitives per pixel of "
        f"{r3_bound['n_prims']}; bound_ms {r3_bound['bound_ms']:.5f} "
        f"({r3_bound['bound_by']}); bound_unculled_ms {r3_bound['bound_unculled_ms']:.5f} "
        f"({r3_bound['bound_unculled_by']}; {render_flops_per_pixel(render3d, cfg)} "
        f"flop/pixel); {r3_bound['busy_subtiles']:.1f} of {r3_bound['subtiles']} "
        f"{SUBTILE_W}x{SUBTILE_H} sub-tiles per env and view hold a primitive, "
        f"{r3_bound['pairs_per_busy']:.2f} primitives each")
    log(f"[time] render3d: kernel {r3_ms:.4f} ms over rotating outputs "
        f"({r3_bound['bound_ms'] / r3_ms:.1%} of the bound), {r3_one_ms:.4f} ms into one "
        f"output, {r3_unculled_ms:.4f} ms unculled, {r3_empty_ms:.4f} ms with nothing to "
        f"trace; fill_ of the same outputs {r3_fill_ms:.4f} ms; twin {r3_plain_ms:.3f} ms; "
        f"no single PyTorch call computes this function, so library_ms is null")
    n2d = inputs2d[0].shape[0]
    h2d, w2d = env2d.render_shape
    out2 = render2d.render_mobile_robot_cuda(*inputs2d)
    outs2 = rotating(torch, out2.shape, dev)
    r2_ms = time_ms(lambda: render2d.render_mobile_robot_cuda(*inputs2d, out=next(outs2)), 500)
    r2_one_ms = time_ms(lambda: render2d.render_mobile_robot_cuda(*inputs2d, out=out2), 500)
    r2_fill_ms = time_ms(lambda: next(outs2).fill_(0), 500)
    scene2d = inputs2d[0]
    twin2d = render2d.static_tensors(env2d.dim, h2d, w2d, dev)
    r2_plain_ms = time_ms(lambda: render2d.render_mobile_robot_plain(scene2d, *twin2d), 20, 2)
    r2_bound, r2_by = render2d_bound_ms(env2d, n2d)
    log(f"[time] render2d N={n2d} {h2d}x{w2d}: kernel {r2_ms:.4f} ms over rotating outputs "
        f"({r2_bound / r2_ms:.1%} of the bound, {n2d * h2d * w2d * 3 / r2_ms / 1e9:.3f} TB/s "
        f"written), {r2_one_ms:.4f} ms into one output; fill_ of the same outputs "
        f"{r2_fill_ms:.4f} ms; twin {r2_plain_ms:.3f} ms, bound "
        f"{r2_bound:.4f} ms ({r2_by}; {render2d_flops_per_pixel(env2d)} flop/pixel, "
        f"{n2d * h2d * w2d * 3} bytes out); no single PyTorch call computes this function, "
        f"so library_ms is null")

    conv1_report = conv1_kernels(torch, dev, train)

    # 4. The main paths, each with the counts set to 0 just before it.
    kuka_seconds, kuka_launches, entries = drive(torch, train, KUKA_ARGS,
                                                 "KukaButtonGymEnv-v0 raw_pixels 256 envs",
                                                 keep="kuka")
    if kuka_launches["render3d"] <= 0:
        raise AssertionError("the Kuka pixel path never launched the render3d kernel")
    conv1_main = {"kuka": hold_conv1("4 Kuka pixel PPO2", kuka_launches,
                                     ppo2_conv1(len(entries)))}
    _, mobile_launches, entries = drive(torch, train, MOBILE_ARGS,
                                        "MobileRobotGymEnv-v0 raw_pixels 224x224 256 envs",
                                        keep="mobile")
    if mobile_launches["render2d"] <= 0:
        raise AssertionError("the MobileRobot pixel path never launched the render2d kernel")
    conv1_main["mobile"] = hold_conv1("4 MobileRobot pixel PPO2", mobile_launches,
                                      ppo2_conv1(len(entries)))
    _, _, entries = drive(torch, train, QUICKSTART_ARGS,
                          "MobileRobotGymEnv-v0 ground_truth 4096 envs")
    log("[main] quickstart mean reward per env step, by update: "
        + ", ".join(f"{e['mean_reward_per_step']:.5f}" for e in entries))

    # 5. The SRL workflow.
    srl_launches = srl_workflow(torch, train)
    log(f"[srl] launches: {json.dumps(srl_launches)}")

    # 6. The mixed batch, CarRacing, Omnirobot and the IK debugger.
    new_launches = new_envs(torch, train)
    log(f"[main] launches: {json.dumps(new_launches)}")

    # 7. PPO2's full surface and the other agents on the Kuka pixel path.
    mb = recompute_minibatch(torch, train, render3d, dev)
    surface_launches = full_surface(torch, train, kuka_launches["render3d"],
                                    kuka_seconds)
    log(f"[main] render3d launches: {json.dumps(surface_launches)}")
    t_step8 = time.perf_counter()

    # 8. The recurrent agents and ACKTR.
    lstm_launches = recurrent_agents(torch, train)
    log(f"[lstm] launches: {json.dumps(lstm_launches)}; step 8 took "
        f"{time.perf_counter() - t_step8:.1f} s")
    t_step9 = time.perf_counter()

    # 9. ACER, RecurrentACER and DQN.
    replay_launches = replay_agents(torch, train)
    log(f"[replay] launches: {json.dumps(replay_launches)}; step 9 took "
        f"{time.perf_counter() - t_step9:.1f} s")
    t_step10 = time.perf_counter()

    # 10. SAC, DDPG, ARS, CMA-ES and the random agent.
    last_launches = last_agents(torch, train)
    log(f"[last] launches: {json.dumps(last_launches)}; step 10 took "
        f"{time.perf_counter() - t_step10:.1f} s")
    t_step11 = time.perf_counter()

    # 11. Replays of the kept runs, and the host-side tools.
    found = {}
    for module in ("matplotlib", "zmq"):
        try:
            found[module] = __import__(module).__version__
        except ImportError:
            found[module] = None
    log(f"[replay] matplotlib {found['matplotlib'] or 'is not installed'}; pyzmq "
        f"{found['zmq'] or 'is not installed'}"
        + ("" if found["matplotlib"] else ": the figures are left out, every replay and "
           "kernel still runs"))
    enjoy_launches = replays(torch, render2d, render3d)
    host_tools(torch, found["matplotlib"] is not None)
    log(f"[replay] launches: {json.dumps(enjoy_launches)}; step 11 took "
        f"{time.perf_counter() - t_step11:.1f} s")
    t_step12 = time.perf_counter()

    # 12. The ZMQ layer: the SRL service and the Omnirobot simulator server.
    import zmq

    log(f"[zmq] pyzmq {zmq.__version__}, libzmq {zmq.zmq_version()}")
    srl_server_launches = srl_service(torch, train, render2d)
    sim_loopback(torch)
    log(f"[zmq] step 12 took {time.perf_counter() - t_step12:.1f} s")
    t_step13 = time.perf_counter()

    # 13. The data-parallel layer.
    torch.cuda.empty_cache()
    dp_kuka = nccl_one_rank(torch, card)
    mobile_one, dp_mobile = gloo_ranks(
        torch, DP_MOBILE_ARGS, "13b MobileRobot 224x224 pixels, 2 gloo ranks", card,
        "render2d", [256, 256])
    mixed_one, dp_mixed = gloo_ranks(
        torch, DP_MIXED_ARGS, "13c mixed Kuka + Omnirobot pixels, 2 gloo ranks", card,
        "render3d", [128, 0])
    log(f"[dp] step 13 took {time.perf_counter() - t_step13:.1f} s")
    t_step14 = time.perf_counter()

    # 14. Tensor parallelism: each rank holds its 1/tp of the weights.
    torch.cuda.empty_cache()
    _, tp_mobile = gloo_ranks(
        torch, DP_MOBILE_ARGS + ["--tp", "2"], "14a MobileRobot 224x224 pixels, dp1 x tp2",
        card, "render2d", [256, 256], one=mobile_one)
    _, tp_mixed = gloo_ranks(
        torch, DP_MIXED_ARGS + ["--tp", "2"], "14b mixed Kuka + Omnirobot pixels, dp2 x tp2",
        card, "render3d", [128, 128, 0, 0], one=mixed_one)
    diff = hold_dp(torch, tp_mixed[0], dp_mixed[0], "14b against 13c's dp2 x tp1 ranks",
                   own_rows=False)
    log(f"[tp] 14b against 13c's dp2 x tp1 ranks (the same rows a rank, the weights "
        f"whole there): {diff}; step 14 took {time.perf_counter() - t_step14:.1f} s")
    t_step15 = time.perf_counter()

    # 15. The other agents on the mesh: PPO1, A2C, TRPO, ACER and the
    # recurrent PPO2, A2C and ACER.
    dp_agents = agent_ranks(torch, card)
    log(f"[dp] step 15 took {time.perf_counter() - t_step15:.1f} s")
    kept.cleanup()
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start-up")

    print(json.dumps({"kernels": [{
        "name": "render3d",
        "route": "cuda",
        "source": "srl_tpu_torch/csrc/render3d.cu",
        "replaces": "srl_tpu/ops/pallas_render3d.py:480",
        "launches": kuka_launches["render3d"],
        "recompute_obs_launches": surface_launches["recompute_obs"],
        "lstm_ppo_launches": lstm_launches["lstm_ppo"],
        "acer_launches": replay_launches["9a"],
        "sac_launches": last_launches["10a"],
        "ars_launches": last_launches["10c"],
        "random_agent_launches": last_launches["10e"],
        "enjoy_launches": enjoy_launches["11a"],
        "dp_nccl_launches": dp_kuka["init_launches"]["render3d"] + dp_kuka["launches"]["render3d"],
        "dp_mixed_rank0_launches": dp_mixed[0]["launches"]["render3d"],
        "tp_mixed_rank0_launches": tp_mixed[0]["launches"]["render3d"],
        "dp_ppo1_launches": [r["launches"]["render3d"] for r in dp_agents["15a"]],
        "dp_a2c_launches": [r["launches"]["render3d"] for r in dp_agents["15b"]],
        "dp_trpo_launches": [r["launches"]["render3d"] for r in dp_agents["15c"]],
        "dp_acer_launches": [r["launches"]["render3d"] for r in dp_agents["15f"]],
        "tp_trpo_launches": [r["launches"]["render3d"] for r in dp_agents["15h"]],
        "max_abs_err": max(r3_err, mb["max_abs_err"]),
        "ms": r3_ms,
        "plain_ms": r3_plain_ms,
        "bound_ms": r3_bound["bound_ms"],
        "bound_by": r3_bound["bound_by"],
        "library_ms": None,
    }, {
        "name": "render2d",
        "route": "cuda",
        "source": "srl_tpu_torch/csrc/render2d.cu",
        "replaces": "srl_tpu/ops/pallas_render.py:111",
        "launches": mobile_launches["render2d"],
        "acktr_launches": lstm_launches["8c"],
        "dqn_launches": replay_launches["9c"],
        "ddpg_launches": last_launches["10b"],
        "cmaes_launches": last_launches["10d"],
        "enjoy_launches": enjoy_launches["11b"],
        "srl_server_launches": srl_server_launches,
        "dp_rank0_launches": dp_mobile[0]["launches"]["render2d"],
        "tp_rank0_launches": tp_mobile[0]["launches"]["render2d"],
        "dp_lstm_ppo_launches": [r["launches"]["render2d"] for r in dp_agents["15d"]],
        "dp_lstm_a2c_launches": [r["launches"]["render2d"] for r in dp_agents["15e"]],
        "dp_lstm_acer_launches": [r["launches"]["render2d"] for r in dp_agents["15g"]],
        "max_abs_err": r2_err,
        "ms": r2_ms,
        "plain_ms": r2_plain_ms,
        "bound_ms": r2_bound,
        "bound_by": r2_by,
        "library_ms": None,
    }, {
        "name": "conv1",
        "route": "cuda",
        "source": "srl_tpu_torch/csrc/conv1.cu",
        "replaces": None,
        "launches_per_update": conv1_report["launches"],
        "kuka_launches": conv1_main["kuka"],
        "mobile_launches": conv1_main["mobile"],
        "acer_launches": replay_launches["9a_conv1"],
        "dqn_launches": replay_launches["9c_conv1"],
        "dp_trpo_one_launches": dp_agents["conv1"]["15c one"],
        "dp_trpo_launches": dp_agents["conv1"]["15c"],
        "tp_trpo_launches": dp_agents["conv1"]["15h"],
        "max_err": conv1_report["worst"],
        "times": conv1_report["times"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

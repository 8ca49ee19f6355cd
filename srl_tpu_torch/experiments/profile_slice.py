"""Where the time of one update goes on the card, for a main path of the
port: by default PPO2 on KukaButtonGymEnv-v0 from raw pixels (render scale
2, coarse observations, the Nature CNN); ``--env MobileRobotGymEnv-v0``
gives the MobileRobot pixel run (224x224 frames from the sprite
compositor); a learned ``--srl-model`` with ``--srl-model-path`` profiles
PPO2 on that encoder's states (``SRLEncodedEnv``: render, then encode);
``--mixed-envs KukaButtonGymEnv-v0 OmnirobotEnv-v0`` the mixed pixel batch
(Kuka traced at render scale 2 and upsampled to 224x224, Omnirobot
rasterised at 224x224), with the rollout's env and render time split by
family. ``--algo`` and ``--policy`` pick another agent (``--algo ppo2
--policy cnnlstm``: the recurrent PPO2 at its tuned 609 steps; ``--algo
a2c --policy cnnlnlstm``; ``--algo acktr [--policy cnnlstm]``; ``--algo
acer [--policy cnnlstm]``, profiled once its buffer holds ``replay_start``
segments, so the iteration replays; ``--algo deepq``, whose "update" is
``train_freq`` vector steps, one TD update among them, once past
``learning_starts``; ``--algo sac|ddpg``, continuous actions, a window of 8
vector steps past ``learning_starts``, each with its update, split into
acting, env dynamics, render and insert, and the update into its parts;
``--algo ars|cma-es``, a generation of their 20-member populations, its
rollout split into the population's policy, env dynamics and render, its
update (CMA-ES: ``eigh``, ``ask``, ``tell``); ``--algo random_agent``, the
env and render rate with no policy), the agent's own defaults otherwise.

    python -m srl_tpu_torch.experiments.profile_slice [--env ENV_ID]
        [--srl-model NAME [--srl-model-path CHECKPOINT]] [--num-envs 256]
        [--mixed-envs ENV_ID ...] [--policy KIND] [--algo
        ppo2|a2c|acktr|acer|deepq|sac|ddpg|ars|cma-es|random_agent]

After one warm-up update it reports, on the host clock with the device
synchronised around each part:

* the wall time of an update and of its two halves, the rollout and the
  rest (the epochs, or the agent's update);
* a rollout step split into its parts (env dynamics, render (with the
  encoder, for an SRL model), policy, action sampling; env dynamics and
  render per family of a mixed batch), each timed over the rollout's steps
  with a synchronise between parts (auto-resets left out);
* the update split into its parts, each forward with its backward: for a
  recurrent policy the batched torso, the cell's loop over T, and the
  heads, loss and optimizer step, for one minibatch (PPO2; times
  nminibatches x noptepochs for an update) or the whole segment (A2C); for
  ACKTR the loss backward, the Fisher G backward, the factor EMAs, the
  inverses (the preconditioning) and the trust-region momentum step; for
  ACER the on-policy update (the forward with grad, the average policy's
  forward, the logit-space gradients, the backward, the optimizer), the
  ``replay_ratio`` replay updates and the average policy's EMA; for DQN,
  per vector step, acting, the env step, the insert, and per TD update the
  batch draw, the loss forward and backward with Adam, and a target copy;
* under ``torch.profiler``, one more update: device time by kernel (top 12),
  kernel launches per update and per env step, and the device's busy and
  idle share of the update's wall time (the recurrent PPO2's update is too
  long to trace whole: its first 128 rollout steps and one minibatch are
  traced and scaled to the update's 609 steps and 32 minibatches); and the
  peak device memory.

The last line is one JSON object with the same numbers. Needs a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from srl_tpu_torch.agents.acer import ACER, acer_logit_grads
from srl_tpu_torch.agents.acktr import ACKTR
from srl_tpu_torch.agents.ars import ARS
from srl_tpu_torch.agents.base import RecurrentActing
from srl_tpu_torch.agents.cma_es import CMAES, cma_constants
from srl_tpu_torch.agents.common import (collect_recurrent_rollout, collect_rollout,
                                         compute_gae, population_returns)
from srl_tpu_torch.agents.dqn import DQN
from srl_tpu_torch.agents.off_policy import OffPolicyAgent
from srl_tpu_torch.agents.random_agent import RandomAgent
from srl_tpu_torch.agents.recurrent_ppo import RecurrentPolicyMixin, RecurrentPPO2
from srl_tpu_torch.agents.registry import resolve_policy_class
from srl_tpu_torch.agents.sac import SAC
from srl_tpu_torch.core.mixed_env import MixedEnv, MixedVecEnv
from srl_tpu_torch.envs.registry import registered_env
from srl_tpu_torch.experiments.train import make_with_options
from srl_tpu_torch.models.recurrent import mask_carry
from srl_tpu_torch.srl.registry import registered_srl


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# The longest rollout traced whole (the Kuka step launches 700-950
# kernels, so 128 steps of it is about 100k launches).
PROFILE_STEPS = 128


def profiled(fn) -> tuple:
    """(seconds, device busy microseconds, kernel launches, {kernel: device
    microseconds}) of ``fn`` under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = _sync_time(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    return (seconds, sum(dev_us(e) for e in kernels), sum(e.count for e in kernels),
            {e.key: dev_us(e) for e in kernels})


def minibatch_step(agent, state, minibatch):
    """One RecurrentPPO2 minibatch: the loss, its backward and the
    optimizer step (on copies)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    loss, _ = agent._loss(leaves, minibatch, agent.config.cliprange)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    params = {k: v.detach().clone() for k, v in state.params.items()}
    with torch.no_grad():
        agent.optimizer_step_(params, grads, agent.opt_init(params))


def acting(agent, state):
    """obs -> the distribution the agent acts from, an lstm policy's carry
    carried from call to call."""
    if not isinstance(agent, RecurrentActing):
        return lambda obs: agent.apply(state.params, obs)[0]
    context = [state.lstm_state]

    def act(obs):
        dist, _, context[0] = agent._policy_step(state.params, obs, context[0], state.done)
        return dist

    return act


def segment(agent, state, gen):
    """The agent's rollout of ``n_steps`` from ``state``."""
    if hasattr(agent, "rollout"):
        return agent.rollout(state, gen)
    return collect_rollout(agent.vec_env, lambda obs: agent.apply(state.params, obs),
                           state.vstate, state.obs, state.obs_norm, gen, agent.config.n_steps)


def recurrent_segment(agent, state, gen):
    """A recurrent agent's segment as its update takes it: (data, per
    update): RecurrentPPO2's epochs' data and its minibatches per update,
    or RecurrentA2C's whole-segment batch and 1."""
    _, _, _, _, _, batch, last_value = agent.rollout(state, gen)
    cfg = agent.config
    if isinstance(agent, RecurrentPPO2):
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, cfg.lam)
        return ((batch.obs, batch.done_in, batch.carry0, batch.actions, batch.log_probs,
                 batch.values, advantages, returns), cfg.nminibatches * cfg.noptepochs)
    advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones, last_value,
                                      cfg.gamma, 1.0)
    return ((batch.obs, batch.done_in, batch.carry0), batch.actions, advantages, returns), 1


def first_minibatch(agent, data):
    """RecurrentPPO2's first minibatch of ``data`` (whole env columns)."""
    size = agent.num_envs // agent.config.nminibatches
    return agent._minibatch(data, torch.arange(size, device=data[0].device))


def recurrent_update_split(agent, state, gen) -> dict:
    """Seconds of each part of a recurrent policy's loss, each forward with
    its backward (the graph cut between parts): the batched torso, the cell
    over T, the heads and loss, and the optimizer step. RecurrentPPO2: its
    first minibatch (whole env columns), and the same times the number of
    minibatches an update; RecurrentA2C: the whole segment."""
    data, per_update = recurrent_segment(agent, state, gen)
    ppo = isinstance(agent, RecurrentPPO2)
    (obs, done, carry), *rest = first_minibatch(agent, data) if ppo else data
    if ppo:
        rest.append(agent.config.cliprange)
    net = agent.policy
    net.load_state_dict(state.params)
    t, b = done.shape
    parts = {}
    x, parts["torso_fwd"] = _sync_time(lambda: net.torso(obs.reshape((t * b,) + obs.shape[2:])))
    x_in = x.detach().requires_grad_(True)

    def cell_loop():
        proj, c, hs = net.cell.project_input(x_in).reshape(t, b, -1), carry, []
        for k in range(t):
            c = net.cell.step(proj[k], mask_carry(c, done[k]))
            hs.append(c[1])
        return torch.stack(hs)

    hs, parts["cell_fwd"] = _sync_time(cell_loop)
    h_in = hs.detach().requires_grad_(True)
    (loss, _), parts["heads_loss_fwd"] = _sync_time(lambda: agent._objective(*net._heads(h_in),
                                                                             *rest))
    _, parts["heads_loss_bwd"] = _sync_time(lambda: loss.backward())
    _, parts["cell_bwd"] = _sync_time(lambda: hs.backward(h_in.grad))
    _, parts["torso_bwd"] = _sync_time(lambda: x.backward(x_in.grad))
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    grads = {k: v.grad for k, v in net.named_parameters()}
    opt_state = agent.opt_init(params)
    _, parts["optimizer"] = _sync_time(lambda: agent.optimizer_step_(params, grads, opt_state))
    split = {"torso": parts["torso_fwd"] + parts["torso_bwd"],
             "cell_loop": parts["cell_fwd"] + parts["cell_bwd"],
             "heads_loss_optimizer": (parts["heads_loss_fwd"] + parts["heads_loss_bwd"]
                                      + parts["optimizer"])}
    return {"per": "minibatch" if ppo else "update", "minibatches_per_update": per_update,
            "T": t, "frames": t * b, **split,
            **({f"{k}_per_update": v * per_update for k, v in split.items()} if ppo else {}),
            "parts": parts}


def acktr_update_split(agent, state, gen) -> dict:
    """Seconds of each part of a K-FAC update: the loss forward and backward
    (and the factors' input rows), the Fisher G's forward and backward, the
    factor EMAs, the inverses (the preconditioning) and the trust-region
    momentum step."""
    _, data, _ = agent.rollout(state, gen)
    (loss, grads, acts, samples), t_loss = _sync_time(
        lambda: agent.loss_and_grads(state.params, data))
    fisher, t_fisher = _sync_time(lambda: agent.fisher_G(state.params, samples, gen))
    (kfac_A, kfac_G), t_ema = _sync_time(
        lambda: agent.update_factors(state.kfac_A, state.kfac_G, acts, fisher))
    precond, t_inv = _sync_time(
        lambda: agent.precondition(grads, kfac_A, kfac_G, state.update_idx))
    (_, _, eta), t_step = _sync_time(lambda: agent.kfac_step(
        state.params, state.momentum, grads, precond, agent.learning_rate(state.update_idx)))
    return {"per": "update", "loss_backward": t_loss, "fisher_G_backward": t_fisher,
            "factor_ema": t_ema, "inverses": t_inv, "momentum_step": t_step,
            "eta": float(eta),
            "factor_sizes": {w: list(a.shape) for w, a in kfac_A.items()}}


def acer_update_split(agent, state, gen) -> dict:
    """Seconds of each part of an ACER iteration after its rollout: the
    on-policy update (forward with grad, the average policy's forward, the
    logit-space gradients, the backward, the optimizer step), the
    ``replay_ratio`` replays from the stored segments, and the EMA (on
    copies: ``state`` is left as it is but for nothing)."""
    cfg = agent.config
    seg = agent.rollout(state, gen)[5]
    params = {k: v.detach().clone() for k, v in state.params.items()}
    opt_state = {"count": 0, "nu": {k: v.clone() for k, v in state.opt_state["nu"].items()}}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    (logits, q), t_fwd = _sync_time(lambda: agent.segment_outputs(leaves, seg))
    with torch.no_grad():
        (avg_logits, _), t_avg = _sync_time(
            lambda: agent.segment_outputs(state.avg_params, seg))
    (g_logits, g_q), t_grads = _sync_time(lambda: acer_logit_grads(
        logits.detach(), q.detach(), avg_logits, seg["actions"], seg["rewards"],
        seg["dones"], seg["mus"], cfg))
    grads, t_bwd = _sync_time(lambda: torch.autograd.grad(
        (logits, q), list(leaves.values()), (g_logits, g_q * cfg.q_coef)))
    _, t_opt = _sync_time(lambda: agent.optimizer_step_(params, dict(zip(leaves, grads)),
                                                        opt_state))
    idx = torch.randint(0, state.buffer.size, (cfg.replay_ratio,), generator=gen,
                        device=gen.device)
    _, t_replays = _sync_time(lambda: [
        agent.update_(params, opt_state, state.avg_params, state.buffer.segment(idx[i:i + 1]))
        for i in range(cfg.replay_ratio)])
    with torch.no_grad():
        _, t_ema = _sync_time(lambda: {k: cfg.alpha * a + (1 - cfg.alpha) * params[k]
                                       for k, a in state.avg_params.items()})
    return {"per": "iteration", "frames_per_segment": int(seg["obs"].shape[0]
                                                          * seg["obs"].shape[1]),
            "on_policy_forward": t_fwd, "average_policy_forward": t_avg,
            "logit_grads": t_grads, "backward": t_bwd, "optimizer": t_opt,
            "on_policy_total": t_fwd + t_avg + t_grads + t_bwd + t_opt,
            "replays": t_replays, "replay_ratio": cfg.replay_ratio, "ema": t_ema,
            "buffer_gb": sum(getattr(state.buffer, n).nbytes
                             for n in state.buffer.tensor_names()) / 2**30}


def dqn_profile(agent, state, gen, args, smi) -> dict:
    """DQN past ``learning_starts``: the seconds of ``train_freq`` vector
    steps (one TD update among them), each part synchronised (acting, env
    step, insert per step; batch draw and gather, loss forward and backward
    with Adam, and a target copy per update), then one such window under
    ``torch.profiler``."""
    cfg, n = agent.config, agent.num_envs
    while state.global_step < max(cfg.learning_starts, 2 * n * cfg.train_freq):
        state = agent.train_step(state, gen)[0]
    window = cfg.train_freq

    def steps():
        for _ in range(window):
            agent.train_step(state, gen)

    _, t_window = _sync_time(steps)
    parts = dict(act=0.0, env_step=0.0, insert=0.0)
    for _ in range(window):
        norm = state.obs_norm.normalize(state.obs) if state.obs_norm is not None else state.obs
        with torch.no_grad():
            actions, t = _sync_time(lambda: torch.argmax(
                agent.q_values(state.params, norm), 1).to(torch.int32))
        parts["act"] += t
        (vstate, tr), t = _sync_time(lambda: agent.vec_env.step(state.vstate, actions, gen))
        parts["env_step"] += t
        _, t = _sync_time(lambda: state.buffer.add_batch(norm, actions, tr.reward, tr.obs,
                                                         tr.done))
        parts["insert"] += t
        state.vstate, state.obs = vstate, tr.obs
    idx, t_draw = _sync_time(lambda: state.buffer.draw_prioritized(
        gen, cfg.batch_size, cfg.prioritized_replay_alpha))
    _, t_td = _sync_time(lambda: agent.td_update_(state, idx, gen))
    _, t_copy = _sync_time(lambda: {k: v.clone() for k, v in state.params.items()})
    seconds, busy_us, launches, by_kernel = profiled(steps)
    env_steps = window * n
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:12]
    result = {
        "card": smi, "algo": "deepq", "env": args.env, "srl_model": args.srl_model,
        "num_envs": n, "window_vector_steps": window, "window_s": t_window,
        "env_steps_per_s": env_steps / t_window,
        "per_vector_step_s": {k: v / window for k, v in parts.items()},
        "per_td_update_s": {"draw": t_draw, "loss_backward_adam": t_td},
        "target_copy_s": t_copy,
        "profiled_window_s": seconds, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / seconds,
        "kernel_launches_per_window": launches,
        "kernel_launches_per_env_step": launches / window,
        "buffer_gb": sum(getattr(state.buffer, name).nbytes
                         for name in state.buffer.tensor_names()) / 2**30,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
    }
    print(f"card: {smi}; deepq on {args.env} {args.srl_model}, {n} envs")
    print(f"{window} vector steps (one TD update) {t_window:.4f} s, "
          f"{result['env_steps_per_s']:.0f} env-steps/s; per vector step: "
          + ", ".join(f"{k} {v:.4f}" for k, v in result["per_vector_step_s"].items())
          + f"; per TD update: draw {t_draw:.4f}, loss+backward+Adam {t_td:.4f}; "
          f"target copy {t_copy:.4f}")
    print(f"profiled window {seconds:.3f} s: device busy {busy_us / 1e6:.3f} s, idle share "
          f"{result['device_idle_share']:.3f}, {launches} launches ({launches / window:.1f} "
          f"per vector step); buffer {result['buffer_gb']:.3f} GiB; peak device memory "
          f"{result['peak_memory_gb']:.1f} GiB")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name}")
    print(json.dumps(result))
    return result


def _report(result: dict, lines: list) -> dict:
    for line in lines:
        print(line)
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name}")
    print(json.dumps(result))
    return result


def _device_fields(windows) -> dict:
    """Busy and idle share, launches and top kernels of profiled windows
    [((seconds, busy us, launches, {kernel: us}), times in the unit)]."""
    seconds = sum(w[0] * k for w, k in windows)
    busy_us = sum(w[1] * k for w, k in windows)
    by_kernel = {}
    for (_, _, _, kernels), k in windows:
        for name, us in kernels.items():
            by_kernel[name] = by_kernel.get(name, 0.0) + us * k
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:12]
    return {"profiled_s": seconds, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / seconds,
            "kernel_launches": sum(w[2] * k for w, k in windows),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top}}


def off_policy_profile(agent, state, gen, args, smi) -> dict:
    """SAC or DDPG past ``learning_starts``: the seconds of a window of
    vector steps (each with its update), a vector step's parts (acting, env
    dynamics, render, insert; auto-resets left out) and an update's parts
    (the batch's draw and gather, then ``update_parts``: the target's
    forward, the critic's forward and backward, its Adam step, the actor's
    forward and backward, its Adam step, SAC's temperature, Polyak), each
    synchronised, then the window under ``torch.profiler``."""
    cfg, n, env = agent.config, agent.num_envs, agent.env
    while state.global_step < cfg.learning_starts + 2 * n:
        state = agent.train_step(state, gen)[0]
    window = 8

    def steps():
        for _ in range(window):
            agent.train_step(state, gen)

    _, t_window = _sync_time(steps)
    parts = dict(act=0.0, env_step=0.0, render=0.0, insert=0.0)
    for _ in range(window):
        norm_obs, t_norm = _sync_time(lambda: agent.observe_(state))
        actions, t = _sync_time(lambda: agent.act(state, norm_obs, gen))
        parts["act"] += t_norm + t
        noise = env.draw_step_noise(gen, n)
        (env_state, reward, done), t = _sync_time(
            lambda: env.apply_step(state.vstate.env_state, actions, noise))
        parts["env_step"] += t
        obs, t = _sync_time(lambda: env.observe(env_state))
        parts["render"] += t
        next_norm = state.obs_norm.normalize(obs) if state.obs_norm is not None else obs
        _, t = _sync_time(lambda: state.buffer.add_batch(norm_obs, actions, reward, next_norm,
                                                         done))
        parts["insert"] += t
        state.vstate.env_state, state.obs = env_state, obs
    batch, t_batch = _sync_time(lambda: agent.batch(state, None, gen))
    noise = ((tuple(torch.randn((cfg.batch_size, agent.act_dim), generator=gen, device="cuda")
                    for _ in range(2)),) if isinstance(agent, SAC) else ())
    update_parts, _ = agent.update_parts(state, batch, *noise)
    update = {"draw_gather": t_batch}
    for name, part in update_parts:
        update[name] = _sync_time(part)[1]
    dev = _device_fields([(profiled(steps), 1.0)])
    result = {
        "card": smi, "algo": agent.name, "env": args.env, "srl_model": args.srl_model,
        "num_envs": n, "window_vector_steps": window, "window_s": t_window,
        "env_steps_per_s": window * n / t_window,
        "per_vector_step_s": {k: v / window for k, v in parts.items()},
        "per_update_s": update, "update_s": sum(update.values()),
        **dev, "kernel_launches_per_vector_step": dev["kernel_launches"] / window,
        "buffer_gb": (state.buffer.obs.nbytes + state.buffer.next_obs.nbytes) / 2**30,
    }
    return _report(result, [
        f"card: {smi}; {agent.name} ({agent.torso}) on {args.env} {args.srl_model}, {n} envs",
        f"{window} vector steps, each with an update: {t_window:.4f} s, "
        f"{result['env_steps_per_s']:.0f} env-steps/s; per vector step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in result["per_vector_step_s"].items()),
        "per update (s, synchronised): " + ", ".join(f"{k} {v:.4f}" for k, v in update.items())
        + f"; total {result['update_s']:.4f}",
        f"profiled window {dev['profiled_s']:.3f} s: device busy {dev['device_busy_s']:.3f} s, "
        f"idle share {dev['device_idle_share']:.3f}, {dev['kernel_launches']} launches "
        f"({result['kernel_launches_per_vector_step']:.1f} per vector step); store "
        f"{result['buffer_gb']:.2f} GiB; peak device memory {dev['peak_memory_gb']:.1f} GiB"])


def es_profile(agent, gen, args, smi) -> dict:
    """ARS or CMA-ES: the seconds of a generation (after one warm-up), its
    rollout's parts over the ``max_episode_steps`` steps (the population's
    policy, env dynamics, render; synchronised, auto-resets left out), and
    its update's parts (ARS: the step of ``M``; CMA-ES: ``eigh``, ``ask``
    and ``tell``, the covariance update); then under ``torch.profiler`` the
    first ``PROFILE_STEPS`` rollout steps, scaled to the generation's."""
    cfg, env, n = agent.config, agent.env, agent.num_envs
    T = cfg.max_episode_steps
    if isinstance(agent, ARS):
        M, norm = agent.M, agent.obs_norm
        delta = torch.randn((cfg.num_population,) + tuple(M.shape), generator=gen,
                            device="cuda")
        act = agent.population_policy(M, delta, norm, gen)[0]
        run = lambda: agent.generation(M, norm, gen)
        r = run()[2]
        update = {"update_M": lambda: agent.update(M, delta, r)}
    else:
        k = cma_constants(cfg.num_population, agent.dim)
        s = agent.initial_cma(np.full(agent.dim, cfg.mu))
        z = torch.as_tensor(np.random.RandomState(args.seed).randn(cfg.num_population, agent.dim),
                            device="cuda")

        def run():
            s.B, s.D = agent.eigen(s.C)
            y, pop = agent.ask(s, z)
            return agent.tell(s, y, pop, agent.eval_population(pop.float(), gen).cpu().numpy(),
                              k)

        s = run()
        y, pop = agent.ask(s, z)
        act = agent.population_policy(pop.float(), gen)
        r = np.zeros(cfg.num_population, np.float32)
        update = {"eigh": lambda: agent.eigen(s.C), "ask": lambda: agent.ask(s, z),
                  "tell": lambda: agent.tell(s, y, pop, r, k)}
    _, t_gen = _sync_time(run)
    parts = dict(policy=0.0, env_step=0.0, render=0.0)
    vstate, obs = agent.vec_env.reset(gen)
    env_state = vstate.env_state
    with torch.no_grad():
        for t in range(T):
            actions, dt = _sync_time(lambda: act(obs, t))
            parts["policy"] += dt
            noise = env.draw_step_noise(gen, n)
            (env_state, _, _), dt = _sync_time(lambda: env.apply_step(env_state, actions, noise))
            parts["env_step"] += dt
            obs, dt = _sync_time(lambda: env.observe(env_state))
            parts["render"] += dt
    update_s = {name: _sync_time(fn)[1] for name, fn in update.items()}
    # The rollout alone under the profiler: traced, cuSOLVER's eigh of the
    # 7,572-dim covariance did not finish in 15 minutes on the H100.
    steps = min(T, PROFILE_STEPS)
    dev = _device_fields([
        (profiled(lambda: population_returns(agent.vec_env, act, gen, steps)), T / steps)])
    result = {
        "card": smi, "algo": agent.name, "env": args.env, "srl_model": args.srl_model,
        "num_envs": n, "steps_per_generation": T, "generation_s": t_gen,
        "env_steps_per_s": T * n / t_gen, "rollout_split_s": parts, "update_split_s": update_s,
        **dev, "kernel_launches_per_env_step": dev["kernel_launches"] / T,
        "parameters": int(agent.M.numel()) if isinstance(agent, ARS) else agent.dim,
    }
    return _report(result, [
        f"card: {smi}; {agent.name} on {args.env} {args.srl_model}, {n} envs, "
        f"{result['parameters']} parameters",
        f"generation {t_gen:.3f} s ({T} steps), {result['env_steps_per_s']:.0f} env-steps/s; "
        f"rollout split (s over {T} steps, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
        "update split (s, synchronised): " + ", ".join(f"{k} {v:.4f}"
                                                       for k, v in update_s.items()),
        f"profiled rollout (scaled to {T} steps) {dev['profiled_s']:.3f} s: device busy "
        f"{dev['device_busy_s']:.3f} s, idle share {dev['device_idle_share']:.3f}, "
        f"{dev['kernel_launches']:.0f} launches ({result['kernel_launches_per_env_step']:.1f} per "
        f"env step); peak device memory {dev['peak_memory_gb']:.1f} GiB"])


def random_agent_profile(agent, gen, args, smi) -> dict:
    """The random agent: the env and render rate with no policy in the loop,
    over ``PROFILE_STEPS`` steps (after a warm-up chunk), split into the
    draw, env dynamics and render, then under ``torch.profiler``."""
    env, n = agent.env, agent.num_envs
    vstate, _ = agent.vec_env.reset(gen)

    def steps(k):
        vs = vstate
        for _ in range(k):
            vs = agent.vec_env.step(vs, agent.actions(gen), gen)[0]

    steps(8)
    _, t_window = _sync_time(lambda: steps(PROFILE_STEPS))
    parts = dict(draw=0.0, env_step=0.0, render=0.0)
    env_state = vstate.env_state
    for _ in range(PROFILE_STEPS):
        actions, dt = _sync_time(lambda: agent.actions(gen))
        parts["draw"] += dt
        noise = env.draw_step_noise(gen, n)
        (env_state, _, _), dt = _sync_time(lambda: env.apply_step(env_state, actions, noise))
        parts["env_step"] += dt
        _, dt = _sync_time(lambda: env.observe(env_state))
        parts["render"] += dt
    dev = _device_fields([(profiled(lambda: steps(PROFILE_STEPS)), 1.0)])
    result = {"card": smi, "algo": agent.name, "env": args.env, "srl_model": args.srl_model,
              "num_envs": n, "window_steps": PROFILE_STEPS, "window_s": t_window,
              "env_steps_per_s": PROFILE_STEPS * n / t_window, "split_s": parts, **dev,
              "kernel_launches_per_env_step": dev["kernel_launches"] / PROFILE_STEPS}
    return _report(result, [
        f"card: {smi}; random_agent on {args.env} {args.srl_model}, {n} envs",
        f"{PROFILE_STEPS} steps {t_window:.3f} s, {result['env_steps_per_s']:.0f} env-steps/s; "
        "split (s, synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
        f"profiled window {dev['profiled_s']:.3f} s: device busy {dev['device_busy_s']:.3f} s, "
        f"idle share {dev['device_idle_share']:.3f}, {result['kernel_launches_per_env_step']:.1f} "
        f"launches per env step; peak device memory {dev['peak_memory_gb']:.1f} GiB"])


def rollout_split(agent, state, gen, n_steps: int) -> dict:
    """Seconds per part over ``n_steps`` steps, synchronising between parts;
    env dynamics and render per family of a mixed batch."""
    vec = agent.vec_env
    # (label suffix, env, its slots [lo, hi) of the batch, action table).
    if isinstance(vec, MixedVecEnv):
        families = [(f" {v.env.name}", v.env, vec._offsets[i], vec._offsets[i + 1],
                     vec._table(i, state.obs.device)) for i, v in enumerate(vec.vecs)]
        env_states = [vs.env_state for vs in state.vstate]
    else:
        families = [("", agent.env, 0, vec.num_envs, None)]
        env_states = [state.vstate.env_state]
    parts = dict(policy=0.0, sample=0.0)
    obs = state.obs
    act = acting(agent, state)
    with torch.no_grad():
        for _ in range(n_steps):
            dist, t = _sync_time(lambda: act(obs))
            parts["policy"] += t
            action, t = _sync_time(lambda: dist.sample(gen))
            parts["sample"] += t
            frames = []
            for k, (name, env, lo, hi, table) in enumerate(families):
                a = action[lo:hi] if table is None else table[action[lo:hi].long()]
                noise = env.draw_step_noise(gen, hi - lo)
                (env_states[k], _, _), t = _sync_time(
                    lambda: env.apply_step(env_states[k], a, noise))
                parts["env_step" + name] = parts.get("env_step" + name, 0.0) + t
                frame, t = _sync_time(lambda: env.observe(env_states[k]))
                parts["render" + name] = parts.get("render" + name, 0.0) + t
                frames.append(frame)
            obs = torch.cat(frames)
    return parts


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", default="KukaButtonGymEnv-v0",
                        choices=list(registered_env.keys()))
    parser.add_argument("--srl-model", default="raw_pixels",
                        choices=list(registered_srl.keys()))
    parser.add_argument("--srl-model-path", default=None,
                        help="checkpoint of a learned --srl-model")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mixed-envs", nargs="+", default=None, metavar="ENV_ID",
                        choices=list(registered_env.keys()),
                        help="profile one learner on a batch of these env families")
    parser.add_argument("--algo", default="ppo2",
                        choices=["ppo2", "a2c", "acktr", "acer", "deepq", "sac", "ddpg", "ars",
                                 "cma-es", "random_agent"])
    parser.add_argument("--policy", default="auto",
                        choices=["auto", "mlp", "cnn", "lstm", "lnlstm", "cnnlstm",
                                 "cnnlnlstm"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_slice measures the card and needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Kuka's pixel run traces at render scale 2 with coarse observations,
    # an encoder reads the upsampled 224x224 frames; the MobileRobot envs
    # take neither option.
    # A mixed batch shares 224x224 frames, so Kuka traces at render scale 2
    # and upsamples there too.
    options = dict(srl_model=args.srl_model, render_scale=2,
                   coarse_obs=args.srl_model == "raw_pixels" and not args.mixed_envs,
                   is_discrete=args.algo not in ("sac", "ddpg"))
    wrap = lambda e: e
    if args.srl_model_path is not None:
        from srl_tpu_torch.srl.models import SRLEncodedEnv, loadSRLModel

        model = loadSRLModel(args.srl_model_path, device="cuda")
        wrap = lambda e: SRLEncodedEnv(e, model)
    if args.mixed_envs:
        env = MixedEnv([wrap(make_with_options(e, options)) for e in args.mixed_envs],
                       oob_action="modulo")
    else:
        env = wrap(make_with_options(args.env, options))
    cls = resolve_policy_class(args.algo, args.policy)
    kwargs = {} if args.policy == "auto" else {"policy": args.policy}
    if "num_envs" in inspect.signature(cls.__init__).parameters:  # not ARS's, CMA-ES's
        kwargs["num_envs"] = args.num_envs
    agent = cls(env=env, device="cuda", **kwargs)
    agent.n_updates = 3
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if isinstance(agent, (ARS, CMAES)):
        return es_profile(agent, gen, args, smi)
    if isinstance(agent, RandomAgent):
        return random_agent_profile(agent, gen, args, smi)
    state = agent.init_state(gen, args.seed)
    if isinstance(agent, OffPolicyAgent):
        return off_policy_profile(agent, state, gen, args, smi)
    if isinstance(agent, DQN):
        agent._total_timesteps = 100 * agent.config.learning_starts
        return dqn_profile(agent, state, gen, args, smi)
    state, _ = agent.train_iteration(state, gen)  # warm-up: cuDNN plans, allocator
    if isinstance(agent, ACER):  # until the timed iteration replays
        while state.buffer.size + 1 < agent.config.replay_start:
            state, _ = agent.train_iteration(state, gen)

    (state, _), t_update = _sync_time(lambda: agent.train_iteration(state, gen))
    n_steps = agent.config.n_steps
    _, t_rollout = _sync_time(lambda: segment(agent, state, gen))
    split = rollout_split(agent, state, gen, n_steps)
    update_split = None
    if isinstance(agent, ACKTR):
        update_split = acktr_update_split(agent, state, gen)
    elif isinstance(agent, ACER):
        update_split = acer_update_split(agent, state, gen)
    elif isinstance(agent, RecurrentPolicyMixin):
        # The first call's backward from an explicit gradient imports
        # modules (seconds): report the second.
        recurrent_update_split(agent, state, gen)
        update_split = recurrent_update_split(agent, state, gen)

    if isinstance(agent, RecurrentPPO2):
        # Its update (32 minibatches, each a 609-step cell loop) and its
        # 609-step rollout launch too many kernels to trace whole: trace the
        # first PROFILE_STEPS rollout steps and one minibatch, and scale
        # each window to the update.
        data, per_update = recurrent_segment(agent, state, gen)
        steps = min(n_steps, PROFILE_STEPS)
        windows = [
            (profiled(lambda: collect_recurrent_rollout(
                agent.vec_env, lambda o, c, d: agent.apply(state.params, o, c, d),
                state.vstate, state.obs, state.done, state.lstm_state, state.obs_norm, gen,
                steps)), n_steps / steps),
            (profiled(lambda: minibatch_step(agent, state, first_minibatch(agent, data))),
             per_update)]
    else:
        windows = [(profiled(lambda: agent.train_iteration(state, gen)), 1.0)]
    t_prof = sum(w[0] * k for w, k in windows)
    busy_us = sum(w[1] * k for w, k in windows)
    launches = sum(w[2] * k for w, k in windows)
    by_kernel = {}
    for (_, _, _, kernels), k in windows:
        for name, us in kernels.items():
            by_kernel[name] = by_kernel.get(name, 0.0) + us * k
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:12]

    result = {
        "card": smi,
        "algo": args.algo,
        "policy": getattr(agent, "policy_kind", args.policy),
        "n_steps": n_steps,
        "env": args.mixed_envs or args.env,
        "srl_model": args.srl_model,
        "num_envs": args.num_envs,
        "update_s": t_update,
        "rollout_s": t_rollout,
        "epochs_s": t_update - t_rollout,
        "update_split_s": update_split,
        "env_steps_per_s": n_steps * args.num_envs / t_update,
        "rollout_split_s": split,
        "profiled_update_s": t_prof,
        "profiled_windows": [{"seconds": w[0], "busy_s": w[1] / 1e6, "launches": w[2],
                              "times": k} for w, k in windows],
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / t_prof,
        "kernel_launches_per_update": launches,
        "kernel_launches_per_env_step": launches / n_steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
    }
    print(f"card: {result['card']}; {args.algo} {result['policy']} on {result['env']} "
          f"{args.srl_model}, {args.num_envs} envs, {n_steps} steps")
    print(f"update {t_update:.3f} s = rollout {t_rollout:.3f} s + update "
          f"{t_update - t_rollout:.3f} s; {result['env_steps_per_s']:.0f} env-steps/s")
    print(f"rollout split (s over {n_steps} steps, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    if update_split is not None:
        print("update split (s, synchronised): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else
            f"{k} " + (", ".join(f"{a} {b:.4f}" for a, b in v.items())
                       if k == "parts" else f"{v}")
            for k, v in update_split.items()))
    if len(windows) > 1:
        print("profiled windows (s, busy s, launches, times in an update): " + "; ".join(
            f"{w[0]:.3f}, {w[1] / 1e6:.3f}, {w[2]}, x{k:g}" for w, k in windows))
    print(f"profiled update {t_prof:.3f} s: device busy {busy_us / 1e6:.3f} s, idle "
          f"share {result['device_idle_share']:.3f}, {launches} kernel launches "
          f"({launches / n_steps:.1f} per env step); peak device memory "
          f"{result['peak_memory_gb']:.1f} GiB")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""ACER, port against reference on the CPU.

* ``acer_logit_grads`` on random logits, Q values and behaviour
  probabilities [T+1 = 7, 4 envs, 3 actions], dones inside the segment and
  at its end (the bootstrap cut), the trust region off and on at a radius
  of 1e-3 (at the default 1 it does not bind on these inputs): both
  gradients within rtol 1e-5 of the reference's ``_acer_logit_grads``
  (float32 sums in another order), the bootstrap row's logit gradient zero.
* ``segment_grads`` (the one forward, the average policy's logits, the
  distribution-space gradients and the pull-back) against the reference's
  ``_segment_loss_grads`` (its VJP): the MLP on normalized MobileRobot
  ground truth within 1e-5 of each tensor's scale (max |reference|); the
  Nature CNN on 36x36 pixels within 1e-2 of each tensor's scale, the
  torso's biases within 5e-2, since its convolutions and fc512 run in
  bfloat16 on both sides and round their sums differently, a bias's
  gradient being a bfloat16 sum over every frame and output position
  (conv1's: 4% of scale off here; the kernels' 0.3%).
* One whole ``train_iteration`` with replays (MobileRobot ground truth, 4
  envs, T = 4, a buffer of 3 segments, ``replay_start`` 1, 4 replays): the
  reference runs three iterations; the port starts from the reference's
  state after the second and is fed the Gumbel noise, the replay indices and
  the auto-reset draws the reference's third drew from its keys (the env's
  step noise off, ``noise_std=0``; ``max_steps`` 4, so an episode ends
  inside the segment). The buffer (actions, rewards, dones, its cursor
  wrapping to 0) and the env batch equal the reference's, the behaviour
  probabilities and the normalized observations within rtol 1e-6 (the
  reference's normalizer, fused inside its scan, rounds an element here
  and there 1 ulp apart); the
  parameters, the average policy and RMSProp's ``nu`` within 1e-4 of each
  tensor's scale after five RMSProp steps (RMSProp divides by
  ``sqrt(nu)``, which amplifies the gradients' float32 rounding where
  ``nu`` is small).
* The ``"acer"`` pickle read both ways, and a checkpoint (the whole state,
  the segment buffer too) written by either package and read by the other
  through ``bridge``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.acer import ACER as JACER
from srl_tpu.agents.acer import ACERConfig as JACERConfig
from srl_tpu.agents.acer import ACERNet as JACERNet
from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.acer import (ACER, ACERConfig, ACERState, SegmentBuffer,
                                       acer_logit_grads)
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.core.env import VecEnvState
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.spaces import Box, Discrete
from srl_tpu_torch.envs import mobile_robot as tm

torch.set_num_threads(1)

N, T = 4, 4
t = lambda x: torch.as_tensor(np.array(x))


def assert_close_to_scale(got, ref, frac, what=""):
    """|got - ref| within ``frac`` of max |ref|, tensor by tensor."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= frac * scale, f"{what}: {err} > {frac} x {scale}"


def assert_trees_close(port_tree, ref_tree, frac):
    """Two Flax-layout trees, leaf by leaf within ``frac`` of scale
    (``frac(path)`` when callable)."""
    paths = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    flat_port = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    assert len(flat_port) == len(paths)
    for path, ref in paths:
        name = jax.tree_util.keystr(path)
        assert_close_to_scale(flat_port[path], ref, frac(name) if callable(frac) else frac,
                              name)


def bf16_cnn_frac(name):
    """A Nature CNN gradient's tolerance: 5e-2 of scale for the torso's
    biases, whose gradients are bfloat16 sums over every frame and output
    position (conv1: 4% off here), 1e-2 for the rest (0.3% at most)."""
    return 5e-2 if "Torso" in name and "bias" in name else 1e-2


# ---- reference draws -------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reset_draws(env):
    def one(key):
        _, k_robot, k_targets = jax.random.split(key, 3)
        out = {"robot_u": jax.random.uniform(k_robot, (2,), minval=-jm.MAX_X / 3,
                                             maxval=jm.MAX_X / 3)}
        if env.random_target:
            margin = 0.1 * jm.MAX_X
            out["target_u"] = jax.random.uniform(
                k_targets, (env.n_targets, 2), minval=jm.MIN_X + margin,
                maxval=jm.MAX_X - margin)
        return out

    return jax.jit(jax.vmap(one))


def reset_noise_of(jenv, vkey, n_steps):
    """The auto-reset draws of the reference's VecEnv over ``n_steps`` steps
    from its key ``vkey`` (srl_tpu/core/env.py:185-186)."""
    out = []
    for _ in range(n_steps):
        vkey, sub = jax.random.split(vkey)
        keys = jax.random.split(sub, N)
        out.append({k: t(v) for k, v in _reset_draws(jenv)(keys).items()})
    return out


def feed_resets(agent, noises):
    """The port's VecEnv steps with the given auto-reset draws, in order
    (on a mesh: the whole batch's)."""
    step, it = agent.vec_env.step, iter(noises)
    agent.vec_env.step = lambda vs, a, gen, **kw: step(vs, a, gen, reset_noise=next(it), **kw)


def gumbel_draws(k_roll, n_act, recurrent=False):
    """The Gumbel noise of the rollout's categorical draws: a key split off
    per step (srl_tpu/agents/acer.py:284), or one key a step (l.672)."""
    if recurrent:
        keys = jax.random.split(k_roll, T)
    else:
        keys, k = [], k_roll
        for _ in range(T):
            k, ka = jax.random.split(k)
            keys.append(ka)
    return t(np.stack([np.asarray(jax.random.gumbel(k, (N, n_act))) for k in keys]))


def replay_draws(k_replay, ratio, size):
    """The replays' segment indices (srl_tpu/agents/acer.py:317-320)."""
    idx, k = [], k_replay
    for _ in range(ratio):
        k, ks = jax.random.split(k)
        idx.append(int(jax.random.randint(ks, (), 0, max(size, 1))))
    return idx


# ---- reference state -> port state -------------------------------------------
def port_vstate(jv):
    env = jv.env_state
    arrays = {f.name: np.asarray(getattr(env, f.name)) for f in dataclasses.fields(env)}
    return VecEnvState(env_state=bridge.state_from_numpy(tm.MobileRobotState, arrays),
                       ep_return=t(jv.ep_return), ep_length=t(jv.ep_length))


def port_norm(jn):
    return RunningNorm(mean=t(jn.mean), var=t(jn.var), count=t(jn.count))


def port_params(agent, tree):
    return agent._state_dict(jax.tree.map(np.asarray, tree))


def perturbed_pair(agent, params, scale=0.05, seed=3):
    """(params, params plus Gaussian noise) in the reference's tree: a
    parameter set and an average policy apart from it."""
    gen = torch.Generator().manual_seed(seed)
    noisy = {k: v + scale * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    return agent._flax(params), agent._flax(noisy)


def port_opt_state(agent, jopt):
    return {"count": 0, "nu": port_params(agent, jopt[1][0].nu)}


# ---- acer_logit_grads ----------------------------------------------------------
def random_segment(rng, n_act=3):
    logits = rng.normal(0, 1.0, (T + 3, N, n_act)).astype(np.float32)
    q = rng.normal(0, 1.0, (T + 3, N, n_act)).astype(np.float32)
    avg = (logits + rng.normal(0, 0.5, logits.shape)).astype(np.float32)
    mus = np.asarray(jax.nn.softmax(rng.normal(0, 1.0, (T + 2, N, n_act)).astype(np.float32)))
    actions = rng.integers(0, n_act, (T + 2, N)).astype(np.int32)
    rewards = rng.normal(0, 1.0, (T + 2, N)).astype(np.float32)
    dones = np.zeros((T + 2, N), bool)
    dones[2, 0] = dones[4, 1] = True  # inside the segment
    dones[-1, 2] = True  # at its end: the bootstrap is cut
    return logits, q, avg, actions, rewards, dones, mus


@pytest.mark.parametrize("trust_region, delta", [(False, 1.0), (True, 1e-3)])
def test_logit_grads_match_reference(trust_region, delta):
    rng = np.random.default_rng(0)
    seg = random_segment(rng)
    steps = seg[3].shape[0]
    jagent = JACER(config=JACERConfig(trust_region=trust_region, delta=delta))
    jg_logits, jg_q = jax.jit(lambda *a: jagent._acer_logit_grads(*a, steps))(
        *map(jnp.asarray, seg))
    cfg = ACERConfig(trust_region=trust_region, delta=delta)
    losses = {}
    g_logits, g_q = acer_logit_grads(*map(t, seg), cfg, losses)
    np.testing.assert_allclose(g_logits.numpy(), np.asarray(jg_logits), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(g_q.numpy(), np.asarray(jg_q), rtol=1e-5, atol=1e-8)
    assert not g_logits[steps].any() and not g_q[steps].any()
    plain, _ = acer_logit_grads(*map(t, seg), ACERConfig(trust_region=False))
    default, _ = acer_logit_grads(*map(t, seg), ACERConfig())
    # The radius binds at delta 1e-3 (the projection moves the gradient),
    # not at the default 1 on these inputs.
    assert torch.equal(plain, g_logits) != trust_region and torch.equal(plain, default)
    assert set(losses) == {"loss_policy", "loss_q", "entropy"}


# ---- one iteration with replays ---------------------------------------------------
CFG = dict(n_steps=T, buffer_segments=3, replay_start=1)


def make_pair():
    jagent = JACER(env=jm.MobileRobotEnv(noise_std=0.0, max_steps=4), num_envs=N,
                   policy="mlp", config=JACERConfig(**CFG))
    agent = ACER(env=tm.MobileRobotEnv(noise_std=0.0, max_steps=4), num_envs=N,
                 policy="mlp", config=ACERConfig(**CFG), device="cpu")
    return jagent, agent


def reference_iterations(jagent, n=3):
    """The reference's first ``n`` jitted iterations: [(state, metrics)]."""
    step = jax.jit(jagent.train_iteration)
    out, js = [], jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    for _ in range(n):
        js, metrics = step(js)
        out.append((js, metrics))
    return out


@pytest.fixture(scope="module")
def reference_run():
    jagent, agent = make_pair()
    return jagent, agent, reference_iterations(jagent)


# ---- segment_grads -------------------------------------------------------------
def stub_env(shape, dtype, n_act):
    space = Box(0, 255, shape, dtype) if dtype == np.uint8 else Box(-1, 1, shape, dtype)
    env = type("Stub", (), {})()
    env.observation_space, env.action_space = space, Discrete(n_act)
    env.srl_model = "raw_pixels" if dtype == np.uint8 else "ground_truth"
    return env


@pytest.mark.parametrize("torso", ["mlp", "cnn"])
def test_segment_grads_match_reference(torso, reference_run):
    rng = np.random.default_rng(1)
    n_act = 4
    jagent = JACER(config=JACERConfig())
    jagent.net, jagent.n_act = JACERNet(n_act, torso), n_act
    if torso == "mlp":  # the reference's parameters and average policy after 2 iterations
        shape, frac = (2,), 1e-5
        obs = rng.normal(0, 1, (T + 1, N) + shape).astype(np.float32)
        params, avg = reference_run[2][1][0].params, reference_run[2][1][0].avg_params
    else:
        shape, frac = (36, 36, 3), bf16_cnn_frac
        obs = rng.integers(0, 256, (T + 1, N) + shape).astype(np.uint8)
    agent = ACER(env=stub_env(shape, obs.dtype.type, n_act), num_envs=N, policy=torso,
                 device="cpu")
    assert agent.policy.torso_kind == torso
    if torso == "cnn":  # the port's fresh parameters, in the reference's tree
        params, avg = perturbed_pair(agent, agent.init_params(2))
    _, _, _, actions, rewards, dones, mus = random_segment(rng, n_act)
    seg = (obs, actions[:T], rewards[:T], dones[:T], mus[:T])
    jgrads = jax.jit(jagent._segment_loss_grads)(params, avg, tuple(map(jnp.asarray, seg)))

    names = ("obs", "actions", "rewards", "dones", "mus")
    grads = agent.segment_grads(port_params(agent, params), port_params(agent, avg),
                                dict(zip(names, map(t, seg))))
    assert_trees_close(agent._flax(grads), jax.tree.map(np.asarray, jgrads), frac)


def port_acer_state(agent, js):
    return ACERState(params=port_params(agent, js.params),
                     avg_params=port_params(agent, js.avg_params),
                     opt_state=port_opt_state(agent, js.opt_state),
                     buffer=SegmentBuffer.from_reference(js.buffer),
                     vstate=port_vstate(js.vstate), obs=t(js.obs),
                     obs_norm=port_norm(js.obs_norm), update_idx=int(js.update_idx))


def assert_iteration_matches(agent, state, js, metrics):
    """The port's state after an iteration against the reference's ``js``."""
    buf, jbuf = state.buffer, js.buffer
    assert (buf.cursor, buf.size) == (int(jbuf.cursor), int(jbuf.size))
    for name in buf.tensor_names():
        ref, ours = np.asarray(getattr(jbuf, name)), getattr(buf, name).numpy()
        if name == "mus" or (name == "obs" and ours.dtype == np.float32):
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=name)
    for f in ("robot_pos", "step_count"):
        np.testing.assert_array_equal(getattr(state.vstate.env_state, f).numpy(),
                                      np.asarray(getattr(js.vstate.env_state, f)))
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(js.obs))
    assert_trees_close(agent._flax(state.params), jax.tree.map(np.asarray, js.params), 1e-4)
    assert_trees_close(agent._flax(state.avg_params),
                       jax.tree.map(np.asarray, js.avg_params), 1e-4)
    assert_trees_close(agent._flax(state.opt_state["nu"]),
                       jax.tree.map(np.asarray, js.opt_state[1][0].nu), 1e-4)
    assert float(metrics["replays"]) == agent.config.replay_ratio


def test_iteration_with_replays_matches_reference(reference_run):
    jagent, agent, run = reference_run
    # Two segments stored, an episode ended in the second.
    (js, _), (js3, jmetrics) = run[1], run[2]
    state = port_acer_state(agent, js)
    _, k_roll, k_replay = jax.random.split(js.key, 3)
    feed_resets(agent, reset_noise_of(jagent.env, js.vstate.key, T))
    idx = replay_draws(k_replay, agent.config.replay_ratio, 3)
    state, metrics = agent.train_iteration(state, torch.Generator().manual_seed(0),
                                           gumbel=gumbel_draws(k_roll, 4), replay_idx=idx)
    assert state.buffer.cursor == 0 and state.buffer.dones[2].any()  # wrapped; a done stored
    assert_iteration_matches(agent, state, js3, metrics)
    np.testing.assert_allclose(float(metrics["mean_reward_per_step"]),
                               float(jmetrics["mean_reward_per_step"]), rtol=1e-6)


def test_learn_runs_replays_from_replay_start():
    agent = ACER(env=tm.MobileRobotEnv(max_steps=30), num_envs=N, policy="mlp",
                 config=ACERConfig(n_steps=T, buffer_segments=2, replay_start=2,
                                   replay_ratio=1), device="cpu")
    replays = []
    agent.learn(3 * N * T, seed=0,
                callback=lambda lc, _: replays.append(lc["metrics"]["replays"]))
    assert replays == [0.0, 1.0, 1.0] and agent.state.buffer.size == 2
    assert all(torch.isfinite(v).all() for v in agent.state.params.values())


# ---- pickles and checkpoints -------------------------------------------------------
def test_acer_pickle_crosses_both_ways(reference_run, tmp_path):
    jagent, _, run = reference_run
    jagent.state = run[1][0]
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = ACER.load(path, tm.MobileRobotEnv(), None, device="cpu")
    assert type(agent) is ACER and agent.config == ACERConfig(**CFG)
    obs = np.random.default_rng(1).normal(size=(5, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  jagent.getAction(obs, deterministic=True))
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-6, atol=1e-7)
    for k, v in agent.state.avg_params.items():
        assert v is agent.state.params[k]

    agent.state = agent.init_state(torch.Generator().manual_seed(0), seed=3)
    path = str(tmp_path / "port.pkl")
    agent.save(path)
    assert agent._load_pickle(path)["name"] == "acer"
    back = JACER.load(path, env=jm.MobileRobotEnv())
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 agent._flax(agent.state.params))
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  back.getAction(obs, deterministic=True))


def test_checkpoint_crosses_both_ways(reference_run, tmp_path):
    agent = ACER(env=tm.MobileRobotEnv(max_steps=30), num_envs=N, policy="mlp",
                 config=ACERConfig(n_steps=T, buffer_segments=3), device="cpu")
    agent.learn(2 * N * T, seed=1)
    path = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(path, meta={"num_timesteps": 2 * N * T})
    jstate, meta = JBase.load_checkpoint(path)
    s = agent.state
    assert type(jstate).__name__ == "ACERState" and int(jstate.update_idx) == 2
    assert type(jstate.buffer).__name__ == "SegmentBuffer" and meta["num_timesteps"] == 32
    assert (int(jstate.buffer.cursor), int(jstate.buffer.size)) == (2, 2)
    np.testing.assert_array_equal(np.asarray(jstate.buffer.obs), s.buffer.obs.numpy())
    assert np.asarray(jstate.buffer.actions).dtype == np.int32
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.avg_params),
                 agent._flax(s.avg_params))
    nu = jstate.opt_state[1][0].nu
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, nu),
                 agent._flax(s.opt_state["nu"]))

    # The reference's checkpoint, read by the port.
    jagent, _, run = reference_run
    jagent.state = run[0][0]
    ref_path = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(ref_path, meta={"num_timesteps": N * T})
    state, meta = BaseRLAgent.load_checkpoint(ref_path)
    assert state.ref_name == "srl_tpu.agents.acer.ACERState" and meta["num_timesteps"] == N * T
    buffer = SegmentBuffer.from_reference(state.buffer)
    assert (buffer.cursor, buffer.size) == (1, 1)
    for name in buffer.tensor_names():
        np.testing.assert_array_equal(getattr(buffer, name).numpy(),
                                      np.asarray(getattr(jagent.state.buffer, name)))
    for k, v in agent._state_dict(state.avg_params).items():
        np.testing.assert_array_equal(
            v.numpy(), port_params(agent, jagent.state.avg_params)[k].numpy())

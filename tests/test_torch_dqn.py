"""DQN and its replay buffer, port against reference on the CPU.

* ``ReplayBuffer``: inserts of 3 rows into 8 that wrap the cursor, new rows
  at ``max(max(p), 1)``, priority updates with a repeated index (which
  carries the same TD error), the prioritized weights and the uniform batch
  given the reference's indices: every field equal, the weights within
  rtol 1e-6; the port's own prioritized draws never leave the valid rows.
* ``td_loss`` and its gradients (double-DQN target, weighted Huber loss),
  dueling and not, on normalized MobileRobot ground truth: the loss and the
  TD errors within rtol 1e-5 (float32 sums in another order), the gradients
  within 1e-5 of each tensor's scale (max |reference|).
* 8 vector steps of 4 envs (``learning_starts`` 8, ``train_freq`` 2, a
  target copy every 12 env steps, batches of 8 from 64 rows): the
  reference's ``train_chunk`` one step at a time, the port's
  ``train_step`` fed each step's draws from the reference's keys (the
  explore uniforms, the random actions and the prioritized indices, drawn
  from the buffer as it stands after the step's insert; the env's step
  noise off, ``noise_std=0``). After every step: the buffer's rows equal
  (observations and priorities within rtol 1e-5: normalized states, and
  ``|td| + 1e-6``), the global step, the TD updates (at env steps 8, 16, 24
  and 32) and the target copies (at 12 and 24) as the reference's, and the
  parameters, the target network and Adam's moments within 1e-4 of each
  tensor's scale (Adam's step, ``m / (sqrt(v) + eps)``, amplifies the
  rounding of gradients near zero).
* The epsilon and beta schedules in float32, equal to the reference's.
* The ``"deepq"`` pickle (``getAction`` greedy by default) and a checkpoint
  (``DQNState`` with its ``ReplayBuffer``) read both ways.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.buffers import ReplayBuffer as JReplayBuffer
from srl_tpu.agents.dqn import DQN as JDQN
from srl_tpu.agents.dqn import DQNConfig as JDQNConfig
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.buffers import ReplayBuffer
from srl_tpu_torch.agents.dqn import DQN, DQNConfig, DQNState
from srl_tpu_torch.envs import mobile_robot as tm
from tests.test_torch_acer import (assert_trees_close, perturbed_pair, port_norm, port_params,
                                   port_vstate, t)

torch.set_num_threads(1)

N = 4
FIELDS = ("obs", "actions", "rewards", "next_obs", "dones", "priorities")


def assert_buffers_equal(buf, jbuf, rtol=0.0):
    assert (buf.cursor, buf.size) == (int(jbuf.cursor), int(jbuf.size))
    for name in FIELDS:
        ours, ref = getattr(buf, name).numpy(), np.asarray(getattr(jbuf, name))
        if rtol and ours.dtype == np.float32 and name != "rewards":
            np.testing.assert_allclose(ours, ref, rtol=rtol, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_replay_buffer_matches_reference():
    rng = np.random.default_rng(0)
    jbuf = JReplayBuffer.create(8, (2,), jnp.float32, (), jnp.int32)
    buf = ReplayBuffer.create(8, (2,), np.float32)
    add = jax.jit(JReplayBuffer.add_batch)
    for i in range(4):  # 12 rows into 8: the cursor wraps
        rows = (rng.normal(size=(3, 2)).astype(np.float32), rng.integers(0, 4, 3).astype(np.int32),
                rng.normal(size=3).astype(np.float32), rng.normal(size=(3, 2)).astype(np.float32),
                rng.random(3) < 0.5)
        jbuf = add(jbuf, *map(jnp.asarray, rows))
        buf.add_batch(*map(t, rows))
        if i == 1:  # priorities above 1, so new rows take their max
            idx = np.array([1, 4, 1], np.int32)  # a repeated index, the same TD error
            td = np.array([2.5, -0.3, 2.5], np.float32)
            jbuf = jax.jit(JReplayBuffer.update_priorities)(jbuf, jnp.asarray(idx),
                                                            jnp.asarray(td))
            buf.update_priorities(t(idx).long(), t(td))
        assert_buffers_equal(buf, jbuf)
    assert buf.cursor == 4 and buf.size == 8
    assert buf.priorities.max() == np.float32(2.5) + np.float32(1e-6)

    jidx, jbatch, jweights = jax.jit(lambda b, k: b.sample_prioritized(k, 16, 0.6, 0.4))(
        jbuf, jax.random.PRNGKey(1))
    batch, weights = buf.sample_prioritized(t(jidx).long(), 0.6, np.float32(0.4))
    for ours, ref in zip(batch, jbatch):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights), rtol=1e-6)
    jidx, jbatch, _ = jax.jit(lambda b, k: b.sample_uniform(k, 5))(jbuf, jax.random.PRNGKey(2))
    batch, weights = buf.sample_uniform(t(jidx).long())
    for ours, ref in zip(batch, jbatch):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert torch.equal(weights, torch.ones(5))

    part = ReplayBuffer.create(8, (2,), np.float32).add_batch(*map(t, rows))
    gen = torch.Generator().manual_seed(0)
    assert int(part.draw_prioritized(gen, 256, 0.6).max()) < 3
    assert int(part.draw_uniform(gen, 256).max()) < 3


@pytest.mark.parametrize("dueling", [True, False])
def test_td_loss_and_grads_match_reference(dueling):
    rng = np.random.default_rng(1)
    jagent = JDQN(env=jm.MobileRobotEnv(), num_envs=N, config=JDQNConfig(dueling=dueling))
    agent = DQN(env=tm.MobileRobotEnv(), num_envs=N, config=DQNConfig(dueling=dueling),
                device="cpu")
    obs = rng.normal(size=(16, 2)).astype(np.float32)
    params, target = perturbed_pair(agent, agent.init_params(0), scale=0.1)
    batch = (obs, rng.integers(0, 4, 16).astype(np.int32), rng.normal(size=16).astype(np.float32),
             rng.normal(size=(16, 2)).astype(np.float32), rng.random(16) < 0.3)
    weights = rng.uniform(0.2, 1.0, 16).astype(np.float32)
    (jloss, jtd), jgrads = jax.jit(jax.value_and_grad(jagent._td_loss, has_aux=True))(
        params, target, tuple(map(jnp.asarray, batch)), jnp.asarray(weights))

    leaves = {k: v.requires_grad_(True) for k, v in port_params(agent, params).items()}
    loss, td = agent.td_loss(leaves, port_params(agent, target), tuple(map(t, batch)),
                             t(weights))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jtd), rtol=1e-5, atol=1e-6)
    assert_trees_close(agent._flax(grads), jax.tree.map(np.asarray, jgrads), 1e-5)
    assert ("adv" in str(agent._flax(grads))) == dueling


# ---- 8 vector steps --------------------------------------------------------------
CFG = dict(buffer_size=64, learning_starts=8, train_freq=2, target_network_update_freq=12,
           batch_size=8)
TOTAL = 32


def reference_draws(jagent, js):
    """The draws of the reference's next step (srl_tpu/agents/dqn.py:163-199):
    the explore uniforms, the random actions, and the prioritized indices
    from the buffer as it stands after the step's insert."""
    return tuple(map(t, jax.jit(functools.partial(_draws, jagent))(js)))


def _draws(jagent, js):
    cfg, buf = jagent.config, js.buffer
    _, k_eps, k_act, k_sample = jax.random.split(js.key, 4)
    random_actions = jax.random.randint(k_eps, (N,), 0, jagent.env.action_space.n)
    uniforms = jax.random.uniform(k_act, (N,))
    rows = (buf.cursor + jnp.arange(N)) % buf.capacity
    after = buf.replace(
        priorities=buf.priorities.at[rows].set(jnp.maximum(jnp.max(buf.priorities), 1.0)),
        size=jnp.minimum(buf.size + N, buf.capacity))
    idx, _, _ = after.sample_prioritized(k_sample, cfg.batch_size,
                                         cfg.prioritized_replay_alpha, 0.5)
    return uniforms, random_actions, idx


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's 8 steps: [(state before, draws, state after)]."""
    jagent = JDQN(env=jm.MobileRobotEnv(noise_std=0.0), num_envs=N, config=JDQNConfig(**CFG))
    step = jax.jit(jagent.train_chunk, static_argnums=1)
    js = jax.jit(jagent.init_state, static_argnums=1)(jax.random.PRNGKey(0), TOTAL)
    out = []
    for _ in range(TOTAL // N):
        draws = reference_draws(jagent, js)
        after, _ = step(js, 1)
        out.append((js, draws, after))
        js = after
    return jagent, out


def port_dqn_state(agent, js):
    adam = js.opt_state[0]
    return DQNState(params=port_params(agent, js.params),
                    target_params=port_params(agent, js.target_params),
                    opt_state={"count": int(adam.count), "mu": port_params(agent, adam.mu),
                               "nu": port_params(agent, adam.nu)},
                    buffer=ReplayBuffer.from_reference(js.buffer), vstate=port_vstate(js.vstate),
                    obs=t(js.obs), obs_norm=port_norm(js.obs_norm),
                    global_step=int(js.global_step))


def test_eight_steps_match_reference(reference_steps):
    jagent, steps = reference_steps
    agent = DQN(env=tm.MobileRobotEnv(noise_std=0.0), num_envs=N, config=DQNConfig(**CFG),
                device="cpu")
    agent._total_timesteps = TOTAL
    state = port_dqn_state(agent, steps[0][0])
    gen = torch.Generator().manual_seed(0)
    updates, copies = [], []
    for before, draws, after in steps:
        state, _, loss, copied = agent.train_step(state, gen, draws)
        if loss is not None:
            updates.append(state.global_step)
        if copied:
            copies.append(state.global_step)
        assert state.global_step == int(after.global_step)
        assert_buffers_equal(state.buffer, after.buffer, rtol=1e-5)
        flax = agent._flax
        assert_trees_close(flax(state.params), jax.tree.map(np.asarray, after.params), 1e-4)
        assert_trees_close(flax(state.target_params),
                           jax.tree.map(np.asarray, after.target_params), 1e-4)
        adam = after.opt_state[0]
        assert state.opt_state["count"] == int(adam.count)
        assert_trees_close(flax(state.opt_state["mu"]), jax.tree.map(np.asarray, adam.mu), 1e-4)
        assert_trees_close(flax(state.opt_state["nu"]), jax.tree.map(np.asarray, adam.nu), 1e-4)
    assert updates == [8, 16, 24, 32] and copies == [12, 24]
    for k, v in state.params.items():  # copied at 24, updated at 32 since
        assert not torch.equal(v, state.target_params[k]), k


def test_schedules_match_reference():
    jagent, agent = JDQN(), DQN(device="cpu")
    for total in (1, 7, 1000, 22000):
        jagent._total_timesteps = agent._total_timesteps = total
        for step in sorted({0, 1, 3, total // 20, total // 10, total // 10 + 1, total // 2,
                            total, 3 * total}):
            eps, beta = agent.epsilon(step), agent.beta(step)
            assert eps.dtype == beta.dtype == np.float32
            assert eps == np.asarray(jagent._epsilon(jnp.int32(step))), (total, step)
            assert beta == np.asarray(jagent._beta(jnp.int32(step))), (total, step)
    assert agent.epsilon(0) == 1.0 and agent.beta(3 * total) == 1.0


def test_deepq_pickle_and_checkpoint_cross_both_ways(reference_steps, tmp_path):
    jagent, steps = reference_steps
    jagent.state = steps[-1][2]
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = DQN.load(path, tm.MobileRobotEnv(), None, device="cpu")
    assert type(agent) is DQN and agent.config == DQNConfig(**CFG)
    obs = np.random.default_rng(2).normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs), jagent.getAction(obs))
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-6, atol=1e-7)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    assert agent._load_pickle(port_path)["name"] == "deepq"
    back = JDQN.load(port_path, env=jm.MobileRobotEnv())
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 jax.tree.map(np.asarray, jagent.state.params))

    # The reference's checkpoint read by the port, and the port's by the
    # reference.
    ref_ckpt = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(ref_ckpt, meta={"num_timesteps": TOTAL})
    state, meta = BaseRLAgent.load_checkpoint(ref_ckpt)
    assert state.ref_name == "srl_tpu.agents.dqn.DQNState" and meta["num_timesteps"] == TOTAL
    assert int(np.asarray(state.global_step)) == TOTAL
    assert_buffers_equal(ReplayBuffer.from_reference(state.buffer), jagent.state.buffer)

    agent = DQN(env=tm.MobileRobotEnv(), num_envs=N, config=DQNConfig(**CFG), device="cpu")
    agent.learn(TOTAL, seed=0, chunk=4)
    ckpt = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(ckpt, meta={"num_timesteps": TOTAL})
    jstate, _ = JBase.load_checkpoint(ckpt)
    s = agent.state
    assert type(jstate).__name__ == "DQNState" and int(jstate.global_step) == TOTAL
    assert type(jstate.buffer).__name__ == "ReplayBuffer"
    assert_buffers_equal(s.buffer, jstate.buffer)
    adam = jstate.opt_state[0]
    assert type(adam).__name__ == "ScaleByAdamState" and int(adam.count) == s.opt_state["count"]
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.target_params),
                 agent._flax(s.target_params))
    assert dataclasses.is_dataclass(jstate.vstate)

"""DDPG, port against reference on the CPU.

* One update (srl_tpu/agents/ddpg.py:148-184, the ``train_chunk``
  closure) from the same parameters, targets and Adam states (count 3,
  nonzero moments), given the batch: the target from the target actor and
  target critic, the critic's step with the weight decay added to the
  gradient of every critic parameter, the biases too (optax's
  ``add_decayed_weights`` before Adam), the actor's step against the
  updated critic, Polyak on both targets. On normalized MobileRobot ground
  truth (the MLP), from the port's fresh parameters perturbed, the
  parameters, the targets and Adam's moments within 1e-5 of each tensor's
  scale (max |reference|); on 36x36 pixels (the Nature CNN in bfloat16 on
  both sides), from the port's fresh parameters, within 2e-2 of scale, the
  torsos' biases within 5e-2 (``tests/test_torch_sac.py``).
* 8 vector steps of 4 continuous MobileRobot envs with OU action noise and
  ``--noise-param`` (``learning_starts`` 8, batches of 8 from 64 rows,
  ``max_steps`` 4 so episodes end, the step noise off): the reference's
  ``train_chunk`` one step at a time; the port's ``train_step`` fed each
  step's draws from the reference's keys (the action noise, the parameter
  noise leaf by leaf in ``jax.tree.flatten`` order, the batch indices) and
  the auto-reset draws. After every step the buffer equals the reference's
  (the normalized observations within rtol 1e-5, the actions within 1e-5),
  the OU state runs on across the episodes' ends within rtol 1e-6, and the
  parameters and both targets are within 1e-4 of scale.
* The ``"ddpg"`` pickle and a checkpoint (``DDPGState`` with its replay
  buffer and the critic's ``(EmptyState, (ScaleByAdamState, EmptyState))``)
  read both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.ddpg import DDPG as JDDPG
from srl_tpu.agents.ddpg import DDPGConfig as JDDPGConfig
from srl_tpu.agents.ddpg import DDPGState as JDDPGState
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.buffers import ReplayBuffer
from srl_tpu_torch.agents.ddpg import DDPG, DDPGConfig, DDPGState
from srl_tpu_torch.envs import mobile_robot as tm
from tests.test_torch_acer import (assert_trees_close, feed_resets, port_norm, port_vstate,
                                   reset_noise_of, t)
from tests.test_torch_sac import (adam_state, assert_buffers_equal, bf16_moments, perturbed,
                                  port_adam, random_batch, reference_closure, reference_start,
                                  stub_env)

torch.set_num_threads(1)

N, BATCH = 4, 8
ref = lambda tree: jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("torso", ["mlp", "cnn"])
def test_update_matches_reference(torso):
    rng = np.random.default_rng(1)
    shape, dtype, act_dim = ((2,), np.float32, 2) if torso == "mlp" else (
        (36, 36, 3), np.uint8, 3)
    env = stub_env(shape, dtype, act_dim)
    jagent = JDDPG(env=env, num_envs=N, config=JDDPGConfig(buffer_size=64))
    agent = DDPG(env=env, num_envs=N, config=DDPGConfig(buffer_size=64), device="cpu")
    assert agent.torso == torso
    actor, critic = agent.init_params(0)
    actor, critic = agent._flax_actor(actor), agent._flax_critic(critic)
    if torso == "mlp":  # trained-looking parameters: the fresh biases are zeros
        actor, critic = perturbed(actor, rng, 0.05), perturbed(critic, rng, 0.05)
    targets = perturbed(actor, rng, 0.05), perturbed(critic, rng, 0.05)
    actor_opt, critic_adam = adam_state(actor, rng), adam_state(critic, rng)
    jstate = JDDPGState(actor_params=actor, critic_params=critic, target_actor=targets[0],
                        target_critic=targets[1], actor_opt=actor_opt,
                        critic_opt=(optax.EmptyState(), critic_adam), buffer=None, vstate=None,
                        obs=None, obs_norm=None, ou_state=None, param_noise_sigma=None,
                        key=None, global_step=jnp.int32(0))
    batch = random_batch(rng, shape, act_dim)
    jafter = jax.jit(reference_closure(jagent, "update"))(
        jstate, tuple(map(jnp.asarray, batch)), jax.random.PRNGKey(0))

    def port_state():
        return DDPGState(actor_params=agent._port(actor, agent.actor),
                         critic_params=agent._port(critic, agent.critic), buffer=None,
                         vstate=None, obs=None, obs_norm=None,
                         target_actor=agent._port(targets[0], agent.actor),
                         target_critic=agent._port(targets[1], agent.critic),
                         actor_opt=port_adam(agent, actor_opt, agent.actor),
                         critic_opt=port_adam(agent, critic_adam, agent.critic))

    state = port_state()
    losses = agent.update_(state, tuple(map(t, batch)))
    assert all(np.isfinite(float(v)) for v in losses.values())

    frac = 1e-5 if torso == "mlp" else bf16_moments
    assert_trees_close(agent._flax_actor(state.actor_params), ref(jafter.actor_params), frac)
    assert_trees_close(agent._flax_critic(state.critic_params), ref(jafter.critic_params), frac)
    assert_trees_close(agent._flax_actor(state.target_actor), ref(jafter.target_actor), frac)
    assert_trees_close(agent._flax_critic(state.target_critic), ref(jafter.target_critic), frac)
    for ours, theirs, flax in ((state.actor_opt, jafter.actor_opt[0], agent._flax_actor),
                               (state.critic_opt, jafter.critic_opt[1][0], agent._flax_critic)):
        assert ours["count"] == int(theirs.count) == 4
        assert_trees_close(flax(ours["mu"]), ref(theirs.mu), frac)
        assert_trees_close(flax(ours["nu"]), ref(theirs.nu), frac)
    if torso == "mlp":  # the decay reached the critic's (nonzero) biases
        no_decay = DDPG(env=env, num_envs=N,
                        config=DDPGConfig(buffer_size=64, critic_l2_reg=0.0), device="cpu")
        bare = port_state()
        no_decay.update_(bare, tuple(map(t, batch)))
        mu = lambda s: s.critic_opt["mu"]["out.bias"]
        assert not torch.allclose(mu(bare), mu(state), rtol=1e-4, atol=0)


# ---- 8 vector steps ------------------------------------------------------------------
CFG = dict(buffer_size=64, learning_starts=8, batch_size=BATCH, noise_param=True)
ENV = dict(is_discrete=False, noise_std=0.0, max_steps=4)


def _draws(jagent, js):
    """The draws of the reference's next step (srl_tpu/agents/ddpg.py:186-236):
    the action noise, the parameter noise (a key per leaf of the actor's
    tree in ``jax.tree.flatten`` order), and the uniform batch indices from
    the buffer as it stands after the step's insert."""
    _, k_noise, k_sample, _, k_pn = jax.random.split(js.key, 5)
    leaves, treedef = jax.tree.flatten(js.actor_params)
    keys = jax.random.split(k_pn, len(leaves))
    param_noise = jax.tree.unflatten(treedef, [jax.random.normal(k, x.shape)
                                               for x, k in zip(leaves, keys)])
    size = jnp.minimum(js.buffer.size + N, js.buffer.capacity)
    idx = jax.random.randint(k_sample, (BATCH,), 0, jnp.maximum(size, 1))
    return jax.random.normal(k_noise, (N, jagent.act_dim)), param_noise, idx


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's 8 steps: [(state before, draws, state after)]."""
    jagent = JDDPG(env=jm.MobileRobotEnv(**ENV), num_envs=N, config=JDDPGConfig(**CFG))
    agent = DDPG(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=DDPGConfig(**CFG),
                 device="cpu")
    # The step and the draws it makes, compiled together.
    step = jax.jit(lambda js: (jagent.train_chunk(js, 1)[0], _draws(jagent, js)))
    actor, critic = (f(p) for f, p in zip((agent._flax_actor, agent._flax_critic),
                                          agent.init_params(0)))
    js = reference_start(
        jagent, JDDPGState, actor_params=actor, critic_params=critic,
        target_actor=actor, target_critic=critic, actor_opt=jagent._actor_tx.init(actor),
        critic_opt=jagent._critic_tx.init(critic), ou_state=jnp.zeros((N, jagent.act_dim)),
        param_noise_sigma=jnp.asarray(0.2))
    out = []
    for _ in range(8):
        after, draws = step(js)
        out.append((js, draws, after))
        js = after
    return jagent, out


def test_eight_steps_match_reference(reference_steps):
    jagent, steps = reference_steps
    agent = DDPG(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=DDPGConfig(**CFG),
                 device="cpu")
    js = steps[0][0]
    state = agent.init_state(torch.Generator().manual_seed(0))
    state = dataclasses.replace(
        state, actor_params=agent._port(js.actor_params, agent.actor),
        critic_params=agent._port(js.critic_params, agent.critic),
        target_actor=agent._port(js.target_actor, agent.actor),
        target_critic=agent._port(js.target_critic, agent.critic),
        vstate=port_vstate(js.vstate), obs=t(js.obs), obs_norm=port_norm(js.obs_norm))
    feed_resets(agent, [noise for before, _, _ in steps
                        for noise in reset_noise_of(jagent.env, before.vstate.key, 1)])
    gen = torch.Generator().manual_seed(0)
    updates = []
    for before, (act_noise, param_noise, idx), after in steps:
        draws = (t(act_noise), agent._port(ref(param_noise), agent.actor), t(idx))
        state, tr, losses = agent.train_step(state, gen, draws)
        if losses is not None:
            updates.append(state.global_step)
        assert state.global_step == int(after.global_step)
        assert_buffers_equal(state.buffer, after.buffer)
        np.testing.assert_allclose(state.ou_state.numpy(), np.asarray(after.ou_state),
                                   rtol=1e-6, atol=1e-7)
        assert_trees_close(agent._flax_actor(state.actor_params), ref(after.actor_params), 1e-4)
        assert_trees_close(agent._flax_critic(state.critic_params), ref(after.critic_params),
                           1e-4)
        assert_trees_close(agent._flax_actor(state.target_actor), ref(after.target_actor), 1e-4)
        assert_trees_close(agent._flax_critic(state.target_critic), ref(after.target_critic),
                           1e-4)
    assert updates == [8, 12, 16, 20, 24, 28, 32]
    assert state.buffer.dones.any() and state.ou_state.abs().min() > 0  # never reset


def test_ddpg_pickle_and_checkpoint_cross_both_ways(reference_steps, tmp_path):
    jagent, steps = reference_steps
    jagent.state = steps[-1][2]
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = DDPG.load(path, tm.MobileRobotEnv(is_discrete=False), None, device="cpu")
    assert type(agent) is DDPG and agent.config == DDPGConfig(**CFG)
    obs = np.random.default_rng(2).normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_allclose(agent.getAction(obs), jagent.getAction(obs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-5, atol=1e-6)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    assert agent._load_pickle(port_path)["name"] == "ddpg"
    back = JDDPG.load(port_path, env=jm.MobileRobotEnv(is_discrete=False))
    jax.tree.map(np.testing.assert_array_equal, ref(back.state.actor_params),
                 ref(jagent.state.actor_params))

    ref_ckpt = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(ref_ckpt, meta={"num_timesteps": 32})
    state, meta = BaseRLAgent.load_checkpoint(ref_ckpt)
    assert state.ref_name == "srl_tpu.agents.ddpg.DDPGState" and meta["num_timesteps"] == 32
    empty, (adam, lr) = state.critic_opt
    assert empty.ref_name.endswith("EmptyState") and lr.ref_name.endswith("EmptyState")
    assert int(np.asarray(adam.count)) == 7
    buf = ReplayBuffer.from_reference(state.buffer)
    np.testing.assert_array_equal(buf.actions.numpy(), np.asarray(jagent.state.buffer.actions))

    agent = DDPG(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=DDPGConfig(**CFG),
                 device="cpu")
    agent.learn(32, seed=0, chunk=8)
    ckpt = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(ckpt, meta={"num_timesteps": 32})
    jstate, _ = JBase.load_checkpoint(ckpt)
    s = agent.state
    assert type(jstate).__name__ == "DDPGState" and int(jstate.global_step) == 32
    assert type(jstate.buffer).__name__ == "ReplayBuffer"
    np.testing.assert_array_equal(np.asarray(jstate.buffer.obs), s.buffer.obs.numpy())
    empty, (adam, lr) = jstate.critic_opt
    assert [type(x).__name__ for x in (empty, adam, lr)] == [
        "EmptyState", "ScaleByAdamState", "EmptyState"]
    assert int(adam.count) == s.critic_opt["count"] == 7
    jax.tree.map(np.testing.assert_array_equal, ref(jstate.target_actor),
                 agent._flax_actor(s.target_actor))
    np.testing.assert_array_equal(np.asarray(jstate.ou_state), s.ou_state.numpy())
    assert float(jstate.param_noise_sigma) == np.float32(0.2)

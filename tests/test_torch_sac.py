"""SAC, port against reference on the CPU.

* ``sample_action`` (``tanh(mean + std eps)`` and its log-probability, the
  ``1e-6`` inside the log) given the reference's normal draws: the action
  within rtol 1e-6; the log-probability within rtol 1e-5 where every
  |action| is below 0.99, and elsewhere within twice the derivative of
  ``log(1 - a^2 + 1e-6)`` times the actions' difference (XLA's tanh and
  PyTorch's round an ulp or two apart, which the log amplifies as |a|
  nears 1).
* One update (srl_tpu/agents/sac.py:166-228, the ``train_chunk`` closure)
  from the same parameters, target critics, temperature and Adam states
  (count 3, nonzero moments, so the step follows the gradients' size),
  given the batch and the update's two normal draws: on normalized
  MobileRobot ground truth (the MLP) with a float ``ent_coef`` of 0.1
  (the 8 steps below cover "auto" there), from the port's fresh parameters
  perturbed (trained-looking: no
  zero biases), the parameters, the target critics, Adam's moments and
  ``log_alpha`` within 1e-5 of each tensor's scale (max |reference|); on
  36x36 pixels (the Nature CNN, whose convolutions and fc512 run in
  bfloat16 on both sides and round their sums differently), from the
  port's fresh parameters, the parameters and the moments within 2e-2 of
  scale, the torsos' biases within 5e-2 (a bias's gradient is a bfloat16
  sum over every frame and output position; the fresh biases are zeros,
  so after the step they are Adam's step itself). The CNN starts
  unperturbed: on random frames a perturbed actor's ``log_std`` reaches
  its clip, the actions saturate in float32, and ``log(1 - a^2 + 1e-6)``
  and its gradient then follow the tanh's last ulp (see the first test),
  which moves the moments by 2% even with both CNNs in float32.
* 8 vector steps of 4 continuous MobileRobot envs (``learning_starts`` 8,
  batches of 8 from 64 rows, ``max_steps`` 4 so episodes end, the step
  noise off): the reference's ``train_chunk`` one step at a time; the
  port's ``train_step`` fed each step's draws from the reference's keys
  (the warm-up uniforms and the actor's normals both from ``k_act``, the
  batch indices, the update's normals) and the auto-reset draws. After
  every step the buffer equals the reference's (the normalized
  observations within rtol 1e-5, the actions, acted from parameters the
  updates have moved apart, within 1e-5), and the parameters, the
  target critics and ``log_alpha`` are within 1e-4 of scale (Adam's step
  amplifies the rounding of gradients near zero).
* The ``"sac"`` pickle and a checkpoint (``SACState`` with its replay
  buffer and the optax states) read both ways.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.buffers import ReplayBuffer as JReplayBuffer
from srl_tpu.agents.sac import SAC as JSAC
from srl_tpu.agents.sac import SACConfig as JSACConfig
from srl_tpu.agents.sac import SACState as JSACState
from srl_tpu.agents.sac import _sample_action as j_sample_action
from srl_tpu.core.normalize import RunningNorm as JRunningNorm
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.buffers import ReplayBuffer
from srl_tpu_torch.agents.sac import SAC, SACConfig, SACState, sample_action
from srl_tpu_torch.core.spaces import Box
from srl_tpu_torch.envs import mobile_robot as tm
from tests.test_torch_acer import (assert_trees_close, bf16_cnn_frac, feed_resets, port_norm,
                                   port_vstate, reset_noise_of, t)

torch.set_num_threads(1)

N, BATCH = 4, 8


def reference_closure(jagent, name):
    """A closure of the reference's ``train_chunk`` (its ``update``): the
    chunk is built with ``jax.lax.scan`` stubbed, and the scanned body's
    cell read."""
    captured = {}

    def scan(body, init, xs, length):
        captured["body"] = body
        return init, None

    with mock.patch.object(jax.lax, "scan", scan):
        jagent.train_chunk(None, 1)
    body = captured["body"]
    return body.__closure__[body.__code__.co_freevars.index(name)].cell_contents


def stub_env(obs_shape, dtype, act_dim):
    """An env for the agents' constructors: spaces and ``srl_model``."""
    env = type("Stub", (), {})()
    env.observation_space = (Box(0, 255, obs_shape, np.uint8) if dtype == np.uint8
                             else Box(-1, 1, obs_shape, np.float32))
    env.action_space = Box(-1, 1, (act_dim,), np.float32)
    env.srl_model = "raw_pixels" if dtype == np.uint8 else "ground_truth"
    return env


def perturbed(tree, rng, scale):
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(size=np.shape(x)))
                        .astype(np.float32), tree)


def adam_state(tree, rng, count=3):
    """An optax Adam state with nonzero moments."""
    mu = jax.tree.map(lambda x: (0.01 * rng.normal(size=np.shape(x))).astype(np.float32), tree)
    nu = jax.tree.map(lambda x: (1e-4 * (0.1 + rng.random(np.shape(x)))).astype(np.float32),
                      tree)
    return (optax.ScaleByAdamState(count=jnp.int32(count), mu=mu, nu=nu), optax.EmptyState())


def port_adam(agent, ref, net=None):
    adam = ref[0]
    port = ((lambda x: {"log_alpha": t(x)}) if net is None
            else (lambda x: agent._port(x, net)))
    return {"count": int(adam.count), "mu": port(adam.mu), "nu": port(adam.nu)}


def random_batch(rng, obs_shape, act_dim, n=16):
    if len(obs_shape) == 3:
        obs = lambda: rng.integers(0, 256, (n,) + obs_shape).astype(np.uint8)
    else:
        obs = lambda: rng.normal(size=(n,) + obs_shape).astype(np.float32)
    return (obs(), rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
            rng.normal(size=n).astype(np.float32), obs(), rng.random(n) < 0.3)


def bf16_moments(name):
    """An Adam moment's tolerance on the Nature CNN: 5e-2 of scale for the
    torsos' biases (``bf16_cnn_frac``), 2e-2 for the rest, whose gradients
    also carry the target's bfloat16 forwards (the target critics and the
    actor's sample on ``next_obs``: 1.1% off here at most)."""
    return max(bf16_cnn_frac(name), 2e-2)


def test_sample_action_matches_reference():
    rng = np.random.default_rng(0)
    mean = rng.normal(0, 1, (64, 3)).astype(np.float32)
    log_std = rng.uniform(-3, 1, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jact, jlogp = jax.jit(j_sample_action)(jnp.asarray(mean), jnp.asarray(log_std), key)
    eps = jax.random.normal(key, mean.shape)
    act, logp = sample_action(t(mean), t(log_std), t(eps))
    act, jact, logp, jlogp = act.numpy(), np.asarray(jact), logp.numpy(), np.asarray(jlogp)
    np.testing.assert_allclose(act, jact, rtol=1e-6, atol=1e-7)
    # XLA's tanh and PyTorch's round apart by an ulp or two, and
    # log(1 - a^2 + 1e-6) amplifies that where |a| nears 1: allow its
    # derivative times the actions' difference, twice over.
    amplified = np.sum(4 * np.abs(jact) * np.abs(act - jact) / (1 - jact**2 + 1e-6), -1)
    assert (np.abs(logp - jlogp) <= 1e-5 * np.abs(jlogp) + 1e-5 + amplified).all()
    calm = (np.abs(jact) < 0.99).all(-1)
    np.testing.assert_allclose(logp[calm], jlogp[calm], rtol=1e-5, atol=1e-5)
    assert np.isfinite(logp).all() and calm.sum() > 16


@pytest.mark.parametrize("torso, ent_coef", [("mlp", 0.1), ("cnn", "auto")])
def test_update_matches_reference(torso, ent_coef):
    rng = np.random.default_rng(1)
    shape, dtype, act_dim = ((2,), np.float32, 2) if torso == "mlp" else (
        (36, 36, 3), np.uint8, 3)
    cfg = dict(buffer_size=64, ent_coef=ent_coef)
    env = stub_env(shape, dtype, act_dim)
    jagent = JSAC(env=env, num_envs=N, config=JSACConfig(**cfg))
    agent = SAC(env=env, num_envs=N, config=SACConfig(**cfg), device="cpu")
    assert agent.torso == torso
    actor, critic = agent.init_params(0)
    actor, critic = agent._flax_actor(actor), agent._flax_critic(critic)
    if torso == "mlp":  # trained-looking parameters: the fresh biases are zeros
        actor, critic = perturbed(actor, rng, 0.05), perturbed(critic, rng, 0.05)
    target = perturbed(critic, rng, 0.05)
    log_alpha = np.float32(-0.3 if ent_coef == "auto" else np.log(0.1))
    opts = [adam_state(tree, rng) for tree in (actor, critic, np.float32(0))]
    jstate = JSACState(actor_params=actor, critic_params=critic, target_critic_params=target,
                       log_alpha=jnp.asarray(log_alpha), actor_opt=opts[0], critic_opt=opts[1],
                       alpha_opt=opts[2], buffer=None, vstate=None, obs=None, obs_norm=None,
                       key=None, global_step=jnp.int32(0))
    batch = random_batch(rng, shape, act_dim)
    key = jax.random.PRNGKey(7)
    jafter = jax.jit(reference_closure(jagent, "update"))(
        jstate, tuple(map(jnp.asarray, batch)), key)
    noise = tuple(t(jax.random.normal(k, (16, act_dim))) for k in jax.random.split(key))

    state = SACState(actor_params=agent._port(actor, agent.actor),
                     critic_params=agent._port(critic, agent.critic),
                     target_critic_params=agent._port(target, agent.critic), buffer=None,
                     vstate=None, obs=None, obs_norm=None, log_alpha=t(log_alpha),
                     actor_opt=port_adam(agent, opts[0], agent.actor),
                     critic_opt=port_adam(agent, opts[1], agent.critic),
                     alpha_opt=port_adam(agent, opts[2]))
    losses = agent.update_(state, tuple(map(t, batch)), noise)
    assert all(np.isfinite(float(v)) for v in losses.values())

    frac = moments = 1e-5 if torso == "mlp" else bf16_moments
    ref = lambda tree: jax.tree.map(np.asarray, tree)
    assert_trees_close(agent._flax_actor(state.actor_params), ref(jafter.actor_params), frac)
    assert_trees_close(agent._flax_critic(state.critic_params), ref(jafter.critic_params), frac)
    assert_trees_close(agent._flax_critic(state.target_critic_params),
                       ref(jafter.target_critic_params), frac)
    for ours, theirs, flax in ((state.actor_opt, jafter.actor_opt, agent._flax_actor),
                               (state.critic_opt, jafter.critic_opt, agent._flax_critic)):
        assert ours["count"] == int(theirs[0].count) == 4
        assert_trees_close(flax(ours["mu"]), ref(theirs[0].mu), moments)
        assert_trees_close(flax(ours["nu"]), ref(theirs[0].nu), moments)
    np.testing.assert_allclose(float(state.log_alpha), float(jafter.log_alpha), rtol=1e-6)
    assert (float(state.log_alpha) != log_alpha) == (ent_coef == "auto")
    assert state.alpha_opt["count"] == int(jafter.alpha_opt[0].count)
    np.testing.assert_allclose(float(state.alpha_opt["mu"]["log_alpha"]),
                               float(jafter.alpha_opt[0].mu), rtol=1e-5)


# ---- 8 vector steps ------------------------------------------------------------------
CFG = dict(buffer_size=64, learning_starts=8, batch_size=BATCH)
ENV = dict(is_discrete=False, noise_std=0.0, max_steps=4)


def _draws(jagent, js):
    """The draws of the reference's next step (srl_tpu/agents/sac.py:231-263):
    the warm-up uniforms and the actor's normals both from ``k_act``, the
    uniform batch indices from the buffer as it stands after the step's
    insert, and the update's two normals."""
    _, k_act, k_sample, k_upd = jax.random.split(js.key, 4)
    shape = (N, jagent.act_dim)
    size = jnp.minimum(js.buffer.size + N, js.buffer.capacity)
    idx = jax.random.randint(k_sample, (BATCH,), 0, jnp.maximum(size, 1))
    k_next, k_pi = jax.random.split(k_upd)
    return (jax.random.uniform(k_act, shape, minval=-1.0, maxval=1.0),
            jax.random.normal(k_act, shape), idx,
            jax.random.normal(k_next, (BATCH, jagent.act_dim)),
            jax.random.normal(k_pi, (BATCH, jagent.act_dim)))


def reference_start(jagent, state_cls, **fields):
    """The reference's first state as its ``init_state`` builds it (a reset
    of its vector env from ``PRNGKey(0)``'s split, an empty buffer and
    normalizer, fresh optax states), its parameters the port's fresh ones:
    cheaper than compiling ``init_state`` (its own parameter draws)."""
    key, k_env = jax.random.split(jax.random.PRNGKey(0), 4)[:2]
    vstate, obs = jax.jit(jagent.vec_env.reset)(k_env)
    space = jagent.env.observation_space
    buffer = JReplayBuffer.create(jagent.config.buffer_size, space.shape, space.dtype,
                                  (jagent.act_dim,), jnp.float32)
    return state_cls(**fields, buffer=buffer, vstate=vstate, obs=obs,
                     obs_norm=JRunningNorm.create(space.shape), key=key,
                     global_step=jnp.int32(0))


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's 8 steps: [(state before, draws, state after)]."""
    jagent = JSAC(env=jm.MobileRobotEnv(**ENV), num_envs=N, config=JSACConfig(**CFG))
    agent = SAC(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=SACConfig(**CFG),
                device="cpu")
    # The step and the draws it makes, compiled together.
    step = jax.jit(lambda js: (jagent.train_chunk(js, 1)[0], _draws(jagent, js)))
    actor, critic = (f(p) for f, p in zip((agent._flax_actor, agent._flax_critic),
                                          agent.init_params(0)))
    js = reference_start(
        jagent, JSACState, actor_params=actor, critic_params=critic,
        target_critic_params=critic, log_alpha=jnp.zeros(()),
        actor_opt=jagent._actor_tx.init(actor), critic_opt=jagent._critic_tx.init(critic),
        alpha_opt=jagent._alpha_tx.init(jnp.zeros(())))
    out = []
    for _ in range(8):
        after, draws = step(js)
        out.append((js, tuple(map(t, draws)), after))
        js = after
    return jagent, out


def assert_buffers_equal(buf, jbuf):
    assert (buf.cursor, buf.size) == (int(jbuf.cursor), int(jbuf.size))
    for name in ("obs", "actions", "next_obs", "rewards", "dones"):
        ours, ref = getattr(buf, name).numpy(), np.asarray(getattr(jbuf, name))
        if name in ("obs", "next_obs"):
            np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7, err_msg=name)
        elif name == "actions":  # in [-1, 1], from the updated parameters
            np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_eight_steps_match_reference(reference_steps):
    jagent, steps = reference_steps
    agent = SAC(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=SACConfig(**CFG),
                device="cpu")
    js = steps[0][0]
    state = agent.init_state(torch.Generator().manual_seed(0))
    state = dataclasses.replace(
        state, actor_params=agent._port(js.actor_params, agent.actor),
        critic_params=agent._port(js.critic_params, agent.critic),
        target_critic_params=agent._port(js.target_critic_params, agent.critic),
        vstate=port_vstate(js.vstate), obs=t(js.obs), obs_norm=port_norm(js.obs_norm))
    feed_resets(agent, [noise for before, _, _ in steps
                        for noise in reset_noise_of(jagent.env, before.vstate.key, 1)])
    gen = torch.Generator().manual_seed(0)
    updates = []
    for before, draws, after in steps:
        state, tr, losses = agent.train_step(state, gen, draws)
        if losses is not None:
            updates.append(state.global_step)
        assert state.global_step == int(after.global_step)
        assert_buffers_equal(state.buffer, after.buffer)
        ref = lambda tree: jax.tree.map(np.asarray, tree)
        assert_trees_close(agent._flax_actor(state.actor_params), ref(after.actor_params), 1e-4)
        assert_trees_close(agent._flax_critic(state.critic_params), ref(after.critic_params),
                           1e-4)
        assert_trees_close(agent._flax_critic(state.target_critic_params),
                           ref(after.target_critic_params), 1e-4)
        np.testing.assert_allclose(float(state.log_alpha), float(after.log_alpha), rtol=1e-5,
                                   atol=1e-7)
    assert updates == [8, 12, 16, 20, 24, 28, 32]
    assert state.buffer.dones.any()  # episodes ended inside the chunk
    # The first insert holds the warm-up uniforms, a later one the actor's sample.
    np.testing.assert_array_equal(state.buffer.actions[:N].numpy(), steps[0][1][0].numpy())


def test_sac_pickle_and_checkpoint_cross_both_ways(reference_steps, tmp_path):
    jagent, steps = reference_steps
    jagent.state = steps[-1][2]
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = SAC.load(path, tm.MobileRobotEnv(is_discrete=False), None, device="cpu")
    assert type(agent) is SAC and agent.config == SACConfig(**CFG)
    obs = np.random.default_rng(2).normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_allclose(agent.getAction(obs), jagent.getAction(obs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-5, atol=1e-6)
    assert float(agent.state.log_alpha) == float(jagent.state.log_alpha)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    assert agent._load_pickle(port_path)["name"] == "sac"
    back = JSAC.load(port_path, env=jm.MobileRobotEnv(is_discrete=False))
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.critic_params),
                 jax.tree.map(np.asarray, jagent.state.critic_params))

    # The reference's checkpoint read by the port, and the port's by the
    # reference.
    ref_ckpt = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(ref_ckpt, meta={"num_timesteps": 32})
    state, meta = BaseRLAgent.load_checkpoint(ref_ckpt)
    assert state.ref_name == "srl_tpu.agents.sac.SACState" and meta["num_timesteps"] == 32
    assert state.critic_opt[0].ref_name.endswith("ScaleByAdamState")
    assert int(np.asarray(state.critic_opt[0].count)) == 7
    buf = ReplayBuffer.from_reference(state.buffer)
    np.testing.assert_array_equal(buf.actions.numpy(), np.asarray(jagent.state.buffer.actions))

    agent = SAC(env=tm.MobileRobotEnv(**ENV), num_envs=N, config=SACConfig(**CFG),
                device="cpu")
    agent.learn(32, seed=0, chunk=8)
    ckpt = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(ckpt, meta={"num_timesteps": 32})
    jstate, _ = JBase.load_checkpoint(ckpt)
    s = agent.state
    assert type(jstate).__name__ == "SACState" and int(jstate.global_step) == 32
    assert type(jstate.buffer).__name__ == "ReplayBuffer"
    np.testing.assert_array_equal(np.asarray(jstate.buffer.actions), s.buffer.actions.numpy())
    for opt, count in ((jstate.actor_opt, 7), (jstate.alpha_opt, 7)):
        assert type(opt[0]).__name__ == "ScaleByAdamState" and int(opt[0].count) == count
        assert type(opt[1]).__name__ == "EmptyState"
    np.testing.assert_array_equal(np.asarray(jstate.alpha_opt[0].mu),
                                  s.alpha_opt["mu"]["log_alpha"].numpy())
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jstate.target_critic_params),
                 agent._flax_critic(s.target_critic_params))
    np.testing.assert_array_equal(np.asarray(jstate.log_alpha), s.log_alpha.numpy())
    assert bridge.read_reference_pickle(ckpt)["state"].ref_name == "srl_tpu.agents.sac.SACState"

"""RecurrentPPO2, port against reference on the CPU (MobileRobot ground
truth, 4 envs, the reference's tuned ``lstm_ppo_config`` at n_steps 8).

* ``update_epochs``: the reference runs two of its ``train_iteration``s;
  the port's epochs are fed the reference's second segment (rebuilt under
  the same key splits: observations, the pre-step ``done`` mask, actions,
  log-probabilities, values, GAE), the carry the segment started from, the
  parameters and Adam state after the first update, and the reference's
  per-epoch permutations of the envs. 8 epochs x 4 minibatches of one env
  column each, at the tuned lr 4.9e-3. Parameters and Adam's moments agree
  within 1e-4 of each tensor's scale (max |reference|; 3e-5 at most here):
  32 Adam steps compound the float32 rounding of the LSTM's sums. The
  one-element value bias is held within 1e-3 (its first moment is 4.3e-4
  off here): with rewards this sparse its gradient is a sum that nearly
  cancels, so its rounding is large against itself. The mean loss within
  1e-4.
* The divisibility assert, with the reference's message.
* Stateful acting: ``getAction`` advances the carry (``dones`` zeroes it),
  ``getActionProba`` reads the context the last ``getAction`` acted from;
  both packages from the same parameters, 3 calls in a row: actions equal,
  probabilities within rtol 1e-5.
* The ``"ppo2_lstm"`` pickle, written by either package and read by the
  other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.common import compute_gae as jgae
from srl_tpu.agents.recurrent_ppo import RecurrentPPO2 as JRecurrentPPO2
from srl_tpu.agents.recurrent_ppo import lstm_ppo_config as jlstm_ppo_config
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.recurrent_ppo import RecurrentPPO2, lstm_ppo_config
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)

N, T = 4, 8
t = lambda x: torch.as_tensor(np.array(x))


def config(module_config):
    cfg = module_config()
    cfg.n_steps = T
    return cfg


def reference_segment(jagent, state):
    """The reference's rollout, GAE and epoch permutations of ``state``'s
    ``train_iteration`` (srl_tpu/agents/recurrent_ppo.py:113-211)."""
    cfg = jagent.config
    _, k_roll, k_perm = jax.random.split(state.key, 3)

    def body(carry, k_step):
        vstate, obs, done, lstm, obs_norm = carry
        obs_norm = obs_norm.update(obs)
        norm_obs = obs_norm.normalize(obs)
        dist, value, lstm = jagent.policy.apply(state.params, norm_obs, lstm, done)
        action = dist.sample(k_step)
        vstate, tr = jagent.vec_env.step(vstate, action)
        return ((vstate, tr.obs, tr.done, lstm, obs_norm),
                (norm_obs, done, action, dist.log_prob(action), value, tr.reward, tr.done))

    (_, obs, done, lstm, obs_norm), (b_obs, b_done_in, b_act, b_logp, b_val, b_rew, b_done) = \
        jax.lax.scan(body, (state.vstate, state.obs, state.done, state.lstm_state,
                            state.obs_norm), jax.random.split(k_roll, cfg.n_steps))
    _, last_value, _ = jagent.policy.apply(state.params, obs_norm.normalize(obs), lstm, done)
    adv, ret = jgae(b_rew, b_val, b_done, last_value, cfg.gamma, cfg.lam)
    perms = jnp.stack([jax.random.permutation(k, N)
                       for k in jax.random.split(k_perm, cfg.noptepochs)])
    return (b_obs, b_done_in, b_act, b_logp, b_val, adv, ret), perms


def test_update_epochs_match_reference():
    jagent = JRecurrentPPO2(env=JMobile(max_steps=30), num_envs=N, policy="lstm",
                            config=config(jlstm_ppo_config))
    state0 = jagent.init_state(jax.random.PRNGKey(0), 2)
    step = jax.jit(jagent.train_iteration)
    state1, _ = step(state0)
    state2, jmetrics = step(state1)
    (obs, done_in, act, logp, val, adv, ret), perms = jax.jit(
        lambda s: reference_segment(jagent, s))(state1)

    agent = RecurrentPPO2(env=MobileRobotEnv(max_steps=30), num_envs=N, policy="lstm",
                          config=config(lstm_ppo_config), device="cpu")
    params = agent._state_dict(jax.tree.map(np.asarray, state1.params))
    adam = state1.opt_state[1][0]
    opt = {"count": int(adam.count), "mu": agent._state_dict(adam.mu),
           "nu": agent._state_dict(adam.nu)}
    data = (t(obs), t(done_in), tuple(t(x) for x in state1.lstm_state), t(act), t(logp),
            t(val), t(adv), t(ret))
    before = {k: v.clone() for k, v in params.items()}
    out, out_opt, metrics = agent.update_epochs(params, opt, data, t(perms))
    for k, v in params.items():  # the inputs are left as they are
        assert torch.equal(v, before[k]), k
    jadam = state2.opt_state[1][0]
    assert out_opt["count"] == int(jadam.count) == 64
    for ours, ref in ((out, state2.params), (out_opt["mu"], jadam.mu),
                      (out_opt["nu"], jadam.nu)):
        ref = agent._state_dict(jax.tree.map(np.asarray, ref))
        assert set(ours) == set(ref)
        for k, v in ours.items():
            scale = np.abs(ref[k].numpy()).max()
            tol = 1e-3 if k == "vf.bias" else 1e-4
            assert np.abs(v.numpy() - ref[k].numpy()).max() <= tol * scale, k
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)


def test_num_envs_must_divide_into_minibatches():
    with pytest.raises(AssertionError) as ref_err:
        JRecurrentPPO2(num_envs=6)
    with pytest.raises(AssertionError) as err:
        RecurrentPPO2(num_envs=6, device="cpu")
    assert str(err.value) == str(ref_err.value)


def agents_with_the_same_params(tmp_path):
    jagent = JRecurrentPPO2(env=JMobile(), num_envs=N, policy="lnlstm")
    jagent.state = jagent.init_state(jax.random.PRNGKey(0), 2)
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    return jagent, RecurrentPPO2.load(path, env=MobileRobotEnv(), device="cpu"), path


def test_stateful_acting_matches_reference(tmp_path):
    jagent, agent, _ = agents_with_the_same_params(tmp_path)
    rng = np.random.default_rng(0)
    # Before any getAction: probabilities from a zero carry.
    obs = rng.normal(size=(3, 2)).astype(np.float32)
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-5, atol=1e-7)
    for dones in (None, np.array([False, True, False]), np.array([True, False, False])):
        obs = rng.normal(size=(3, 2)).astype(np.float32)
        np.testing.assert_array_equal(agent.getAction(obs, dones, deterministic=True),
                                      jagent.getAction(obs, dones, deterministic=True))
        proba = agent.getActionProba(obs)
        np.testing.assert_allclose(proba, jagent.getActionProba(obs), rtol=1e-5, atol=1e-7)
        # Read, not advanced: the same context again.
        np.testing.assert_array_equal(agent.getActionProba(obs), proba)
    # A new batch size starts from zeros.
    obs = rng.normal(size=(2, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  jagent.getAction(obs, deterministic=True))


def test_ppo2_lstm_pickle_crosses_both_ways(tmp_path):
    jagent, agent, _ = agents_with_the_same_params(tmp_path)
    assert type(agent) is RecurrentPPO2 and agent.policy_kind == "lnlstm"
    assert agent.config == lstm_ppo_config()
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jagent.state.params),
                 agent._flax(agent.state.params))
    agent.state = agent.init_state(torch.Generator().manual_seed(0), seed=3)
    path = str(tmp_path / "port.pkl")
    agent.save(path)
    payload = agent._load_pickle(path)
    assert payload["name"] == "ppo2_lstm" and payload["obs_norm"] is not None
    back = JRecurrentPPO2.load(path, env=JMobile())
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 bridge.recurrent_state_dict_to_flax(agent.state.params))
    obs = np.random.default_rng(1).normal(size=(3, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  back.getAction(obs, deterministic=True))


def test_checkpoint_reads_in_the_reference(tmp_path):
    """The port's ``checkpoint.pkl`` is the reference's
    ``RecurrentPPOState``, the carry in Flax's (c, h) order; and back."""
    from srl_tpu.agents.base import BaseRLAgent as JBase
    from srl_tpu_torch.agents.base import BaseRLAgent

    agent = RecurrentPPO2(env=MobileRobotEnv(max_steps=30), num_envs=N,
                          config=config(lstm_ppo_config), device="cpu")
    agent.learn(2 * N * T, seed=1)
    path = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(path, meta={"num_timesteps": 2 * N * T})
    jstate, meta = JBase.load_checkpoint(path)
    s = agent.state
    assert type(jstate).__name__ == "RecurrentPPOState" and int(jstate.update_idx) == 2
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.params),
                 agent._flax(s.params))
    for ref, ours in zip(jstate.lstm_state, s.lstm_state):
        np.testing.assert_array_equal(np.asarray(ref), ours.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.done), s.done.numpy())
    assert int(jstate.opt_state[1][0].count) == s.opt_state["count"] == 64

    state, meta = BaseRLAgent.load_checkpoint(path)
    assert state.ref_name == "srl_tpu.agents.recurrent_ppo.RecurrentPPOState"
    for k, v in agent._state_dict(state.params).items():
        assert torch.equal(v, s.params[k]), k

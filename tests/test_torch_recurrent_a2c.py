"""RecurrentA2C, port against reference on the CPU (MobileRobot ground truth,
4 envs, the reference's n_steps 5, ``lnlstm``: the cell and the LayerNorm;
the plain ``lstm`` cell's update is held in tests/test_torch_recurrent_ppo.py,
and one reference compile per case is what this file costs).

The reference runs two of its ``train_iteration``s; the port's ``update``
is fed the reference's second segment (rebuilt under the same ``k_roll``
split, srl_tpu/agents/a2c.py:323-362: observations, the pre-step ``done``
mask, actions, discounted returns), the carry the segment started from, and
the parameters and RMSProp state after the first update. One full-batch
step with backpropagation through time over the [5, 4] segment: parameters
within rtol 1e-6 and RMSProp's ``nu`` within rtol 2e-6, as
tests/test_torch_a2c.py holds the feed-forward A2C (float32 sums in another
order); the parameters' atol is 1e-8, under 1e-5 of a step of the lr 7e-4
(``lnlstm`` puts one torso bias 2.6e-9 off: the LayerNorm's backward sums
over the cell's 64 outputs); the losses within 1e-5. Then the
``"a2c_lstm"`` pickle, written by either package and read by the other.
"""
import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.a2c import RecurrentA2C as JRecurrentA2C
from srl_tpu.agents.common import compute_gae as jgae
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch.agents.a2c import A2CConfig, RecurrentA2C
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)

N = 4
t = lambda x: torch.as_tensor(np.array(x))


def reference_segment(jagent, state):
    cfg = jagent.config
    _, k_roll = jax.random.split(state.key)

    def body(carry, k_step):
        vstate, obs, done, lstm, obs_norm = carry
        obs_norm = obs_norm.update(obs)
        norm_obs = obs_norm.normalize(obs)
        dist, value, lstm = jagent.policy.apply(state.params, norm_obs, lstm, done)
        action = dist.sample(k_step)
        vstate, tr = jagent.vec_env.step(vstate, action)
        return ((vstate, tr.obs, tr.done, lstm, obs_norm),
                (norm_obs, done, action, value, tr.reward, tr.done))

    (_, obs, done, lstm, obs_norm), (b_obs, b_done_in, b_act, b_val, b_rew, b_done) = \
        jax.lax.scan(body, (state.vstate, state.obs, state.done, state.lstm_state,
                            state.obs_norm), jax.random.split(k_roll, cfg.n_steps))
    _, last_value, _ = jagent.policy.apply(state.params, obs_norm.normalize(obs), lstm, done)
    adv, ret = jgae(b_rew, b_val, b_done, last_value, cfg.gamma, 1.0)
    return b_obs, b_done_in, b_act, adv, ret


@pytest.mark.parametrize("policy", ["lnlstm"])
def test_update_matches_reference(policy):
    jagent = JRecurrentA2C(env=JMobile(max_steps=30), num_envs=N, policy=policy)
    state0 = jagent.init_state(jax.random.PRNGKey(0), 3)
    step = jax.jit(jagent.train_iteration)
    state1, _ = step(state0)
    state2, jmetrics = step(state1)
    obs, done_in, act, adv, ret = jax.jit(lambda s: reference_segment(jagent, s))(state1)

    agent = RecurrentA2C(env=MobileRobotEnv(max_steps=30), num_envs=N, policy=policy,
                         device="cpu")
    params = agent._state_dict(jax.tree.map(np.asarray, state1.params))
    before = {k: v.clone() for k, v in params.items()}
    opt = {"count": 1, "nu": agent._state_dict(state1.opt_state[1][0].nu)}
    carry0 = tuple(t(x) for x in state1.lstm_state)
    out, out_opt, losses = agent.update(
        params, opt, ((t(obs), t(done_in), carry0), t(act), t(adv), t(ret)))
    assert out_opt["count"] == 2 and opt["count"] == 1
    for k, v in params.items():  # the inputs are left as they are
        assert torch.equal(v, before[k]), k
    expect = agent._state_dict(jax.tree.map(np.asarray, state2.params))
    expect_nu = agent._state_dict(state2.opt_state[1][0].nu)
    assert set(out) == set(expect)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
        np.testing.assert_allclose(out_opt["nu"][k].numpy(), expect_nu[k].numpy(),
                                   rtol=2e-6, atol=1e-12, err_msg=k)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def test_a2c_lstm_pickle_crosses_both_ways(tmp_path):
    jagent = JRecurrentA2C(env=JMobile(), num_envs=N, policy="lstm")
    jagent.state = jagent.init_state(jax.random.PRNGKey(1))
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = RecurrentA2C.load(path, env=MobileRobotEnv(), device="cpu")
    assert type(agent) is RecurrentA2C and agent.config == A2CConfig()
    obs = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
    for dones in (None, np.array([True, False, False])):
        np.testing.assert_array_equal(agent.getAction(obs, dones, deterministic=True),
                                      jagent.getAction(obs, dones, deterministic=True))
        np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                                   rtol=1e-5, atol=1e-7)

    agent.state = agent.init_state(torch.Generator().manual_seed(0), seed=2)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    assert agent._load_pickle(port_path)["name"] == "a2c_lstm"
    back = JRecurrentA2C.load(port_path, env=JMobile())
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 agent._flax(agent.state.params))

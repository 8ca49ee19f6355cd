"""A2C, port against reference on the CPU (MobileRobot ground truth, MLP, 4
envs, the reference's n_steps 5).

The reference runs two of its ``train_iteration``s; the port's ``update`` is
fed the reference's second rollout batch (rebuilt with ``collect_rollout``
under the same ``k_roll`` split, srl_tpu/agents/a2c.py:96-105) from the
reference's parameters and RMSProp state after the first, so the second
moment is not trivial. Parameters agree within 1e-6 relative (float32 sums
in another order); RMSProp's ``nu``, a square of the gradient, within
2e-6, twice the gradient's; the losses within 1e-5; for the constant and
the linear lr schedule."""
import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.a2c import A2C as JA2C
from srl_tpu.agents.a2c import A2CConfig as JA2CConfig
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.a2c import A2C, A2CConfig
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)

N_UPDATES = 3


def to_port(tree):
    return bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), "mlp")


@pytest.mark.parametrize("lr_schedule", ["constant", "linear"])
def test_a2c_update_matches_reference(lr_schedule):
    jagent = JA2C(env=JMobile(max_steps=30), num_envs=4,
                  config=JA2CConfig(lr_schedule=lr_schedule))
    state0 = jagent.init_state(jax.random.PRNGKey(0), N_UPDATES)
    step = jax.jit(jagent.train_iteration)
    state1, _ = step(state0)
    state2, jmetrics = step(state1)

    @jax.jit
    def batch_of(state):
        cfg = jagent.config
        _, k_roll = jax.random.split(state.key)
        _, _, _, last_obs, batch = jcommon.collect_rollout(
            jagent.vec_env, jagent.policy.apply, state.params, state.vstate, state.obs,
            state.obs_norm, k_roll, cfg.n_steps)
        _, last_value = jagent.policy.apply(state.params, last_obs)
        adv, ret = jcommon.compute_gae(batch.rewards, batch.values, batch.dones,
                                       last_value, cfg.gamma, 1.0)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        return flat(batch.obs), flat(batch.actions), flat(adv), flat(ret)

    data = tuple(torch.as_tensor(np.array(x)) for x in batch_of(state1))
    agent = A2C(env=MobileRobotEnv(max_steps=30), num_envs=4,
                config=A2CConfig(lr_schedule=lr_schedule), device="cpu")
    agent.n_updates = N_UPDATES
    params = to_port(state1.params)
    before = {k: v.clone() for k, v in params.items()}
    opt = {"count": 1, "nu": to_port(state1.opt_state[1][0].nu)}
    out, out_opt, losses = agent.update(params, opt, data)
    assert out_opt["count"] == 2 and opt["count"] == 1
    for k, v in params.items():  # the inputs are left as they are
        assert torch.equal(v, before[k]), k
    expect = to_port(state2.params)
    expect_nu = to_port(state2.opt_state[1][0].nu)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
        np.testing.assert_allclose(out_opt["nu"][k].numpy(), expect_nu[k].numpy(),
                                   rtol=2e-6, atol=1e-12, err_msg=k)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def test_a2c_lr_schedules():
    agent = A2C(env=MobileRobotEnv(), num_envs=4, device="cpu")
    agent.n_updates = 4
    assert agent.learning_rate(3) == 7e-4
    for name in ("double_linear_con", "middle_drop", "double_middle_drop"):
        agent.config.lr_schedule = name  # the reference's fallback: constant
        assert agent.learning_rate(3) == 7e-4
    agent.config.lr_schedule = "linear"
    assert agent.learning_rate(0) == 7e-4
    assert agent.learning_rate(3) == pytest.approx(7e-4 / 4)
    assert agent.learning_rate(9) == 0.0

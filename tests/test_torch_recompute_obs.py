"""PPO2's ``recompute_obs`` and ``remat_policy`` in the port, on the CPU.

* Storing env states and re-rendering each minibatch changes the memory
  schedule, not the math: one update gives bit-identical parameters to the
  stored-frame path, on MobileRobot pixels (as tests/test_ppo.py:132-157)
  and on Kuka pixels (render scale 7, the Nature CNN).
* Against the reference: its ``train_iteration`` with ``recompute_obs``
  on Kuka pixels, its frames from the Pallas kernel in interpret mode
  (``force_pallas_render``), and the port's ``update_epochs`` fed the
  reference's rollout (rebuilt with ``collect_rollout(store_states=True)``
  under the same ``k_roll`` split, srl_tpu/agents/ppo.py:225-236): the
  port re-renders the reference's stored states through the render3d twin
  (bit-equal to the Pallas frames here), and the parameters agree within
  tests/test_torch_ppo.py's update tolerance (rtol 1e-4, atol 1e-6). The
  policy is the MLP on the 32x32 frames that render scale 7 traces (coarse
  observations), float32 throughout: on 224x224 frames the MLP's 150,528-term
  sums round differently in the two packages by more than that tolerance.
* ``remat_policy`` recomputes the activations in the backward pass:
  parameters within rtol 1e-5 / atol 1e-6.
* The guards: normalized observations, mixed families and FrameStack raise
  AssertionErrors that name ``recompute_obs``.
"""
import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.agents.ppo import PPOConfig as JPPOConfig
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.core.mixed_env import MixedEnv
from srl_tpu_torch.envs.kuka import KukaButtonEnv
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from tests.test_torch_kuka_env import jit_reset

torch.set_num_threads(1)

CFG = dict(n_steps=4, nminibatches=2, noptepochs=1)


def one_update(env, recompute, remat=False):
    agent = PPO2(env=env, num_envs=4, config=PPOConfig(**CFG),
                 recompute_obs=recompute, remat_policy=remat, device="cpu")
    agent.n_updates = 2
    gen = torch.Generator().manual_seed(0)
    state, metrics = agent.train_iteration(agent.init_state(gen), gen)
    return state.params, float(metrics["pg_loss"])


@pytest.mark.parametrize("make_env", [
    lambda: MobileRobotEnv(srl_model="raw_pixels", max_steps=8),
    lambda: KukaButtonEnv(srl_model="raw_pixels", render_scale=7),
], ids=["mobile_robot", "kuka"])
def test_recompute_obs_bit_identical_update(make_env):
    ref_params, ref_loss = one_update(make_env(), False)
    rec_params, rec_loss = one_update(make_env(), True)
    for k, v in ref_params.items():
        assert torch.equal(v, rec_params[k]), k
    assert ref_loss == rec_loss


def test_remat_policy_within_tolerance():
    env = lambda: MobileRobotEnv(srl_model="raw_pixels", max_steps=8)
    ref_params, _ = one_update(env(), True)
    rem_params, _ = one_update(env(), True, remat=True)
    for k, v in ref_params.items():
        np.testing.assert_allclose(rem_params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("make_env", [
    lambda: MobileRobotEnv(srl_model="ground_truth"),
    lambda: MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=7),
                      KukaButtonEnv(srl_model="raw_pixels", render_scale=7)]),
    lambda: FrameStack(MobileRobotEnv(srl_model="raw_pixels"), 2),
], ids=["normalized", "mixed", "frame_stack"])
def test_recompute_obs_guards(make_env):
    with pytest.raises(AssertionError, match="recompute_obs"):
        PPO2(env=make_env(), num_envs=4, recompute_obs=True, device="cpu")


def test_kuka_recompute_update_matches_reference():
    n, t = 2, 4
    jenv = JKuka(srl_model="raw_pixels", render_scale=7, coarse_obs=True)
    jenv.force_pallas_render = True
    jagent = JPPO2(env=jenv, num_envs=n, policy="mlp", config=JPPOConfig(**CFG),
                   recompute_obs=True)
    jit_reset(lambda: None)  # the settled arm pose, outside any trace
    state = jagent.init_state(jax.random.PRNGKey(0), 1)
    new_state, _ = jax.jit(jagent.train_iteration)(state)

    @jax.jit
    def rollout(state):
        """The reference's batch, as its train_iteration builds it."""
        _, k_roll, k_perm = jax.random.split(state.key, 3)
        _, _, _, last_obs, batch = jcommon.collect_rollout(
            jagent.vec_env, jagent.policy.apply, state.params, state.vstate, state.obs,
            None, k_roll, t, store_states=True)
        _, last_value = jagent.policy.apply(state.params, last_obs)
        adv, ret = jcommon.compute_gae(batch.rewards, batch.values, batch.dones,
                                       last_value, 0.99, 0.95)
        flat = lambda x: x.reshape((t * n,) + x.shape[2:])
        perm = jax.random.permutation(jax.random.split(k_perm, 1)[0], t * n)
        data = (jax.tree.map(flat, batch.obs), flat(batch.actions), flat(batch.log_probs),
                flat(batch.values), flat(adv), flat(ret))
        return data, perm[None], jagent.vec_env._observe(data[0])

    jdata, perms, jframes = jax.device_get(rollout(state))
    tagent = PPO2(env=KukaButtonEnv(srl_model="raw_pixels", render_scale=7, coarse_obs=True),
                  num_envs=n, policy="mlp", config=PPOConfig(**CFG), recompute_obs=True, device="cpu")
    tagent.n_updates = 1
    states = bridge.kuka_state_from_numpy(
        {k: v for k, v in vars(jdata[0]).items() if k != "key"})
    frames = tagent.vec_env.env.observe(states)
    np.testing.assert_array_equal(frames.numpy(), jframes)

    params = bridge.flax_to_state_dict(jax.tree.map(np.asarray, state.params), "mlp")
    data = (states,) + tuple(torch.as_tensor(np.array(x)) for x in jdata[1:])
    out, opt, _ = tagent.update_epochs(params, tagent.opt_init(params), data,
                                       torch.as_tensor(np.asarray(perms)).long())
    assert opt["count"] == int(new_state.opt_state[1][0].count) == 2
    expect = bridge.flax_to_state_dict(jax.tree.map(np.asarray, new_state.params), "mlp")
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)

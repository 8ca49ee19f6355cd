"""Full training-state checkpoints on the CPU: the port's resume and the
checkpoint format both packages share.

* A port resume is exact: 4 updates in one run equal 2 updates, a
  checkpoint and 2 resumed updates, bit for bit (parameters, Adam state,
  env batch, observations, normalizer, update counter), the generator's
  state carried in the checkpoint.
* A reference ``checkpoint.pkl`` resumes in the port with every state leaf
  carried exactly (parameters, Adam ``mu``/``nu``/``count``, the schedule
  count, env state, episode accumulators, observations, normalizer,
  ``update_idx``); its random stream starts fresh from the seed, and the
  port says so.
* A port checkpoint goes through the reference's
  ``BaseRLAgent.load_checkpoint`` and ``learn(initial_state=...)``, its
  leaves equal to the port's.
* Nested and pixel env states (FrameStack over Kuka) cross both ways.
All on MobileRobot ground truth (4 envs, 8 steps an update) unless named.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.agents.ppo import PPOConfig as JPPOConfig
from srl_tpu.core.frame_stack import FrameStackState as JFrameStackState
from srl_tpu.envs.kuka import KukaState as JKukaState
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.envs.kuka import KukaButtonEnv
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)

N, T = 4, 8
STEPS = N * T


def port_agent():
    return PPO2(env=MobileRobotEnv(max_steps=30), num_envs=N, config=PPOConfig(n_steps=T),
                device="cpu")


def assert_states_equal(a, b):
    """Two port PPOStates, leaf by leaf."""
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    assert a.opt_state["count"] == b.opt_state["count"]
    for part in ("mu", "nu"):
        for k, v in a.opt_state[part].items():
            assert torch.equal(v, b.opt_state[part][k]), (part, k)
    for f in dataclasses.fields(a.vstate.env_state):
        assert torch.equal(getattr(a.vstate.env_state, f.name),
                           getattr(b.vstate.env_state, f.name)), f.name
    assert torch.equal(a.vstate.ep_return, b.vstate.ep_return)
    assert torch.equal(a.vstate.ep_length, b.vstate.ep_length)
    assert torch.equal(a.obs, b.obs)
    for k in ("mean", "var", "count"):
        assert torch.equal(getattr(a.obs_norm, k), getattr(b.obs_norm, k)), k
    assert a.update_idx == b.update_idx


def test_port_resume_is_bit_exact(tmp_path):
    path = str(tmp_path / "checkpoint.pkl")

    def save_at_two(_locals, _globals):
        if _locals["update"] == 1:
            _locals["self"].save_checkpoint(path, meta={"update": 1})

    whole = port_agent()
    whole.learn(4 * STEPS, seed=5, callback=save_at_two)
    state, meta = BaseRLAgent.load_checkpoint(path)
    assert meta == {"update": 1} and state.torch_generator["device_type"] == "cpu"
    resumed = port_agent()
    resumed.learn(2 * STEPS, seed=5, initial_state=state)
    assert resumed.n_updates == whole.n_updates == 4
    assert_states_equal(resumed.state, whole.state)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "checkpoint.pkl")
    jagent = JPPO2(env=JMobile(max_steps=30), num_envs=N, config=JPPOConfig(n_steps=T))
    jagent.learn(2 * STEPS, seed=0)
    jagent.save_checkpoint(path, meta={"num_timesteps": 2 * STEPS})
    return path


def test_reference_checkpoint_resumes_in_port(reference_checkpoint, capsys):
    jstate, jmeta = JBase.load_checkpoint(reference_checkpoint)
    ckpt, meta = BaseRLAgent.load_checkpoint(reference_checkpoint)
    assert meta == jmeta and ckpt.torch_generator is None
    agent = port_agent()
    state = agent.restore(ckpt, seed=7)
    assert "starts fresh from seed 7" in capsys.readouterr().out

    to_port = lambda tree: bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), "mlp")
    for k, v in to_port(jstate.params).items():
        assert torch.equal(state.params[k], v), k
    adam, sched = jstate.opt_state[1]
    assert state.opt_state["count"] == int(adam.count) == int(sched.count) == 32
    for part in ("mu", "nu"):
        for k, v in to_port(getattr(adam, part)).items():
            assert torch.equal(state.opt_state[part][k], v), (part, k)
    for f in dataclasses.fields(state.vstate.env_state):
        np.testing.assert_array_equal(getattr(state.vstate.env_state, f.name).numpy(),
                                      np.asarray(getattr(jstate.vstate.env_state, f.name)))
    np.testing.assert_array_equal(state.vstate.ep_return.numpy(), jstate.vstate.ep_return)
    np.testing.assert_array_equal(state.vstate.ep_length.numpy(), jstate.vstate.ep_length)
    np.testing.assert_array_equal(state.obs.numpy(), jstate.obs)
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(state.obs_norm, k).numpy(),
                                      np.asarray(getattr(jstate.obs_norm, k)))
    assert state.update_idx == int(jstate.update_idx) == 2

    out = agent.learn(STEPS, seed=7, initial_state=ckpt)
    assert out.update_idx == 3 and agent.n_updates == 3
    assert out.opt_state["count"] == 48


def test_port_checkpoint_resumes_in_reference(tmp_path):
    path = str(tmp_path / "checkpoint.pkl")
    agent = port_agent()
    agent.learn(2 * STEPS, seed=1)
    agent.save_checkpoint(path, meta={"num_timesteps": 2 * STEPS})
    jstate, meta = JBase.load_checkpoint(path)
    assert meta == {"num_timesteps": 2 * STEPS} and type(jstate).__name__ == "PPOState"
    s = agent.state
    flax = lambda tree: bridge.state_dict_to_flax(tree, "mlp")
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.params),
                 flax(s.params))
    adam, sched = jstate.opt_state[1]
    assert int(adam.count) == int(sched.count) == s.opt_state["count"] == 32
    jax.tree.map(np.testing.assert_array_equal, adam.mu, flax(s.opt_state["mu"]))
    jax.tree.map(np.testing.assert_array_equal, adam.nu, flax(s.opt_state["nu"]))
    for f in dataclasses.fields(s.vstate.env_state):
        np.testing.assert_array_equal(np.asarray(getattr(jstate.vstate.env_state, f.name)),
                                      getattr(s.vstate.env_state, f.name).numpy())
    np.testing.assert_array_equal(jstate.obs_norm.mean, s.obs_norm.mean.numpy())
    assert int(jstate.update_idx) == 2

    jagent = JPPO2(env=JMobile(max_steps=30), num_envs=N, config=JPPOConfig(n_steps=T))
    out = jagent.learn(STEPS, seed=1, initial_state=jstate)
    assert int(out.update_idx) == 3 and int(out.opt_state[1][0].count) == 48


def test_nested_pixel_states_cross_both_ways(tmp_path):
    env = FrameStack(KukaButtonEnv(srl_model="raw_pixels", render_scale=7), 2)
    vstate, _ = VecEnv(env, 2).reset(torch.Generator().manual_seed(0))
    path = str(tmp_path / "state.pkl")
    bridge.write_reference_pickle({"vstate": bridge.to_reference(vstate, seed=3)}, path)

    import pickle

    with open(path, "rb") as f:
        ref = pickle.load(f)["vstate"]  # the reference's own classes
    assert isinstance(ref.env_state, JFrameStackState)
    assert isinstance(ref.env_state.inner, JKukaState)
    assert ref.env_state.inner.key.shape == (2, 2) and ref.key.shape == (2,)
    np.testing.assert_array_equal(ref.env_state.frames, vstate.env_state.frames.numpy())
    np.testing.assert_array_equal(ref.env_state.inner.q, vstate.env_state.inner.q.numpy())

    back = bridge.to_port(bridge.read_reference_pickle(path)["vstate"])
    assert type(back.env_state.inner) is type(vstate.env_state.inner)
    for f in dataclasses.fields(vstate.env_state.inner):
        assert torch.equal(getattr(back.env_state.inner, f.name),
                           getattr(vstate.env_state.inner, f.name)), f.name
    assert torch.equal(back.env_state.frames, vstate.env_state.frames)


def test_reader_refuses_other_classes(tmp_path):
    import collections
    import pickle

    path = str(tmp_path / "other.pkl")
    with open(path, "wb") as f:
        pickle.dump({"state": collections.OrderedDict(a=1)}, f)
    with pytest.raises(pickle.UnpicklingError, match="not a class of a training checkpoint"):
        bridge.read_reference_pickle(path)

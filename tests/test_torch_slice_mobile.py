"""Slice 2 as a whole, port against reference on the CPU: PPO2 on
MobileRobotGymEnv-v0 from raw pixels (rendered at 48x48 to keep the CPU
budget; the main path renders 224x224), the Nature CNN, 4 envs, 8 steps;
the ground-truth quickstart through the CLI; and reference checkpoints of
the pixel policies (224x224 with 3, 6 and, stacked, 12 channels) loading
into the port.

Both sides start from the reference's reset and the same parameters, and
step with the actions the reference sampled and the env noise it drew.
Frames, rewards and dones are bit-equal (the compositor is exact). The
policy runs in bfloat16 on both sides: values and log-probs agree within
2e-2 of their scale, and one update of the reference's batch gives finite
losses within the same tolerance of the reference's (as slice 1 states for
the bf16 CNN, tests/test_torch_slice.py).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.core.frame_stack import FrameStack as JFrameStack
from srl_tpu.envs.mobile_robot import MobileRobot1DEnv as JMobile1D
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents import ppo as tppo
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv as TMobile
from srl_tpu_torch.experiments import train
from tests.test_torch_mobile_robot import jax_reset_noise, jax_step_noise
from tests.test_torch_ppo import jax_update_epochs
from tests.test_torch_slice import BF16_TOL, assert_close_to_scale

torch.set_num_threads(1)

N, T = 4, 8


def test_pixel_slice_matches_reference():
    kwargs = dict(srl_model="raw_pixels", render_shape=(48, 48), random_target=True)
    jenv, tenv = JMobile(**kwargs), TMobile(**kwargs)
    jagent = JPPO2(env=jenv, num_envs=N)
    jagent._tx = jagent._make_optimizer(1)
    tagent = tppo.PPO2(env=tenv, num_envs=N, device="cpu")
    tagent.n_updates = 1
    jvec, tvec = JaxVecEnv(jenv, N), tagent.vec_env

    key = jax.random.PRNGKey(0)
    jv, jobs = jax.jit(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, N)))
    assert tobs.shape == (N, 48, 48, 3) and tobs.dtype == torch.uint8
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))

    params = jax.jit(jagent.policy.init)(jax.random.PRNGKey(1), jobs)
    tparams = bridge.flax_to_state_dict(jax.tree.map(np.asarray, params), "cnn")
    apply = jax.jit(jagent.policy.apply)
    step = jax.jit(jvec.step)
    steps = []
    for t in range(T):
        jd, jval = apply(params, jobs)
        action = jd.sample(jax.random.PRNGKey(100 + t))
        jlogp = jd.log_prob(action)
        with torch.no_grad():
            td, tval = tagent.apply(tparams, tobs)
        taction = torch.from_numpy(np.array(action))
        assert_close_to_scale(tval, jval)
        assert_close_to_scale(td.log_prob(taction), jlogp)
        steps.append((jobs, action, jlogp, jval))

        step_noise = jax_step_noise(jenv, jv.env_state.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, action)
        tv, ttr = tvec.step(tv, taction, step_noise=step_noise, reset_noise=reset_noise)
        for name in ("obs", "reward", "done"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)))
        steps[-1] += (jtr.reward, jtr.done)
        jobs, tobs = jtr.obs, ttr.obs

    obs, actions, logps, values, rewards, dones = (jnp.stack(x) for x in zip(*steps))
    _, last_value = apply(params, jobs)
    adv, ret = jcommon.compute_gae(rewards, values, dones, last_value, 0.99, 0.95)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    jdata = tuple(flat(x) for x in (obs, actions, logps, values, adv, ret))
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))
                      for k in jax.random.split(jax.random.PRNGKey(2), 4)])
    _, _, jmetrics = jax_update_epochs(jagent, params, jagent._tx.init(params), jdata,
                                       perms)
    tdata = tuple(torch.tensor(np.asarray(x)) for x in jdata)
    _, _, metrics = tagent.update_epochs(tparams, tppo.adam_init(tparams), tdata,
                                         torch.from_numpy(perms).long())
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert abs(float(metrics["pg_loss"]) - float(jmetrics["pg_loss"])) <= BF16_TOL
    for k in ("vf_loss", "entropy"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= BF16_TOL * abs(
            float(jmetrics[k])), k


@pytest.mark.parametrize("case", ["3ch", "fpv_6ch", "stack4_12ch"])
def test_reference_pixel_checkpoint_loads_into_port(case, tmp_path):
    """The Nature CNN at 224x224 with the reference's weights and layout."""
    fpv = case == "fpv_6ch"
    jenv = JMobile(srl_model="raw_pixels", fpv=fpv)
    tenv = TMobile(srl_model="raw_pixels", fpv=fpv)
    if case == "stack4_12ch":
        jenv, tenv = JFrameStack(jenv, 4), FrameStack(tenv, 4)
    jagent = JPPO2(env=jenv, num_envs=2)
    jagent.state = jagent.init_state(jax.random.PRNGKey(0), 1)
    path = str(tmp_path / "ppo2_model.pkl")
    jagent.save(path)
    agent = tppo.PPO2.load(path, env=tenv, device="cpu")
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jagent.state.params), "cnn")
    assert set(agent.state.params) == set(agent.policy.state_dict()) == set(ref)
    for k, v in agent.state.params.items():
        assert v.shape == agent.policy.state_dict()[k].shape, k
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    channels = {"3ch": 3, "fpv_6ch": 6, "stack4_12ch": 12}[case]
    assert agent.state.params["torso.c1.weight"].shape == (32, channels, 8, 8)


@pytest.fixture(scope="module")
def quickstart_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("logs")
    # 4 envs x 128 steps: one PPO update of the MLP on ground-truth states.
    log_dir = train.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                          "--device", "cpu", "--num-envs", "4", "--num-timesteps", "500",
                          "--log-dir", str(root), "--no-vis"])
    return root, log_dir


def test_quickstart_cli_writes_the_reference_run_dir(quickstart_run):
    root, log_dir = quickstart_run
    rel = os.path.relpath(log_dir, root).split(os.sep)
    assert rel[:3] == ["MobileRobotGymEnv-v0", "ground_truth", "ppo2"] and len(rel) == 4
    assert {"args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
            "ppo2_final_model.pkl"} <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "env_globals.json")) as f:
        globals_ = json.load(f)
    assert globals_["srl_model"] == "ground_truth" and "render_scale" not in globals_
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 1 and lines[0]["num_timesteps"] == 512
    assert all(np.isfinite(lines[0][k]) for k in ("pg_loss", "vf_loss", "entropy"))


def test_reference_loads_the_quickstart_checkpoint(quickstart_run):
    _, log_dir = quickstart_run
    path = os.path.join(log_dir, "ppo2_final_model.pkl")
    jagent = JPPO2.load(path, env=JMobile())
    agent = tppo.PPO2.load(path, env=TMobile(), device="cpu")
    back = bridge.state_dict_to_flax(agent.state.params, "mlp")
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jagent.state.params), back)
    np.testing.assert_array_equal(agent.state.obs_norm.mean.numpy(),
                                  np.asarray(jagent.state.obs_norm.mean))
    obs = np.array([[0.5, -1.0], [-2.0, 0.3]], np.float32)
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  jagent.getAction(obs, deterministic=True))


def test_cli_passes_each_env_the_options_it_takes():
    """-r, --shape-reward and --num-stack reach the MobileRobot variants
    (whose constructors pass ``**kwargs`` on); Kuka-only options do not."""
    args = train.parse_args(["--env", "MobileRobot1DGymEnv-v0", "--srl-model",
                             "raw_pixels", "-r", "--shape-reward", "--num-stack", "2",
                             "--render-scale", "2", "--device", "cpu"])
    env = train.build_env(args)
    assert isinstance(env, FrameStack) and env.num_stack == 2
    inner = env.env
    assert (inner.dim, inner.srl_model, inner.random_target, inner.shape_reward) == (
        1, "raw_pixels", True, True)
    assert not hasattr(inner, "render_scale")
    assert env.observation_space.shape == (224, 224, 6)
    kuka = train.build_env(train.parse_args(["--render-scale", "2", "-r",
                                             "--device", "cpu"]))
    assert kuka.render_scale == 2 and kuka.random_target
    # The reference's CLI gives the same 1D env no options at all; the port's
    # filter follows the constructor up to MobileRobotEnv's signature.
    assert "srl_model" in train.accepted_kwargs(type(inner), {"srl_model": 1})
    assert JMobile1D().srl_model == "ground_truth"

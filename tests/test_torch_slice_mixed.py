"""The mixed-batch slice as a whole, port against reference on the CPU.

* One PPO2 update on a mixed ground-truth batch (MobileRobot + Omnirobot,
  both 2-D relative positions, 4 envs each, 8 steps). Both sides start from
  the same state and parameters (through the bridge) and step with the
  actions the reference sampled and the env noise it drew. Observations,
  rewards and dones are equal; the normalized observations and the MLP's
  values and log-probs agree at rtol 1e-5; one update of the reference's
  batch with the same permutations gives the reference's metrics at rtol
  1e-4 (float32, as tests/test_torch_ppo.py holds PPO2's update).
* ``--mixed-envs KukaButtonGymEnv-v0 OmnirobotEnv-v0`` from raw pixels
  through the training CLI (2 envs per family, Kuka at render scale 2, one
  update of 128 steps): the reference's run directory, and the
  reference's ``PPO2.load`` reads the port's mixed checkpoint.
* ``envs.debug.track`` against the reference's ``track``: 200 servo steps,
  q and tip within 2e-4 (each control step agrees at rtol 1e-4,
  tests/test_torch_kinematics.py).
* Recording Omnirobot and CarRacing datasets that the reference's loader
  reads; the toward-target expert refuses a state without targets.
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
from srl_tpu.core import mixed_env as jmixed
from srl_tpu.core.normalize import RunningNorm as JRunningNorm
from srl_tpu.envs import debug as jdebug
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.envs.omnirobot import OmniRobotEnv as JOmni
from srl_tpu.srl import episode_saver as jsaver
from srl_tpu_torch import bridge
from srl_tpu_torch.agents import ppo as tppo
from srl_tpu_torch.core.mixed_env import MixedEnv, MixedVecEnv
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.data import dataset_generator
from srl_tpu_torch.envs import MobileRobotEnv, OmniRobotEnv, debug
from srl_tpu_torch.envs.kuka import KukaButtonEnv
from srl_tpu_torch.experiments import train
from srl_tpu_torch.ops import kinematics as kin
from tests import test_torch_mobile_robot as mobile_noise
from tests import test_torch_omnirobot as omni_noise
from tests.test_torch_ppo import jax_update_epochs

torch.set_num_threads(1)

N, T = 8, 8


def test_one_update_on_mixed_ground_truth_matches_reference():
    jfams = [JMobile(srl_model="ground_truth"), JOmni(srl_model="ground_truth")]
    jenv = jmixed.MixedEnv(jfams)
    jagent = JPPO2(env=jenv, num_envs=N)
    jagent._tx = jagent._make_optimizer(1)
    tenv = MixedEnv([MobileRobotEnv(srl_model="ground_truth"),
                     OmniRobotEnv(srl_model="ground_truth")])
    tagent = tppo.PPO2(env=tenv, num_envs=N, device="cpu")
    tagent.n_updates = 1
    jvec, tvec = jagent.vec_env, tagent.vec_env
    assert isinstance(tvec, MixedVecEnv) and tvec.counts == jvec.counts == [4, 4]

    key = jax.random.PRNGKey(0)
    jv, jobs = jax.jit(jvec.reset)(key)
    subs = [jax.random.split(jax.random.split(k)[1], 4) for k in jax.random.split(key, 2)]
    tv, tobs = tvec.reset(None, noise=[mobile_noise.jax_reset_noise(jfams[0], subs[0]),
                                       omni_noise.jax_reset_noise(jfams[1], subs[1])])
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))

    params = jax.jit(jagent.policy.init)(jax.random.PRNGKey(1), jobs)
    tparams = bridge.flax_to_state_dict(jax.tree.map(np.asarray, params), "mlp")
    apply = jax.jit(jagent.policy.apply)
    step = jax.jit(jvec.step)
    jnorm, tnorm = JRunningNorm.create((2,)), RunningNorm.create((2,))
    steps = []
    for t in range(T):
        jnorm, tnorm = jnorm.update(jobs), tnorm.update(tobs)
        jn_obs, tn_obs = jnorm.normalize(jobs), tnorm.normalize(tobs)
        np.testing.assert_allclose(tn_obs.numpy(), np.asarray(jn_obs), rtol=1e-5, atol=1e-6)
        jd, jval = apply(params, jn_obs)
        action = jd.sample(jax.random.PRNGKey(100 + t))
        jlogp = jd.log_prob(action)
        with torch.no_grad():
            td, tval = tagent.apply(tparams, torch.tensor(np.asarray(jn_obs)))
        taction = torch.from_numpy(np.array(action))
        np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(td.log_prob(taction).numpy(), np.asarray(jlogp),
                                   rtol=1e-5, atol=1e-6)
        steps.append((jn_obs, action, jlogp, jval))

        step_noise = [mobile_noise.jax_step_noise(jfams[0], jv[0].env_state.key),
                      omni_noise.jax_step_noise(jfams[1], jv[1].env_state)]
        reset_noise = [mobile_noise.jax_reset_noise(
                           jfams[0], jax.random.split(jax.random.split(jv[0].key)[1], 4)),
                       omni_noise.jax_reset_noise(
                           jfams[1], jax.random.split(jax.random.split(jv[1].key)[1], 4))]
        jv, jtr = step(jv, action)
        tv, ttr = tvec.step(tv, taction, step_noise=step_noise, reset_noise=reset_noise)
        for name in ("obs", "reward", "done"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)), err_msg=name)
        steps[-1] += (jtr.reward, jtr.done)
        jobs, tobs = jtr.obs, ttr.obs

    obs, actions, logps, values, rewards, dones = (jnp.stack(x) for x in zip(*steps))
    _, last_value = apply(params, jnorm.normalize(jobs))
    adv, ret = jcommon.compute_gae(rewards, values, dones, last_value, 0.99, 0.95)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    jdata = tuple(flat(x) for x in (obs, actions, logps, values, adv, ret))
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))
                      for k in jax.random.split(jax.random.PRNGKey(2), 4)])
    jparams, _, jmetrics = jax_update_epochs(jagent, params, jagent._tx.init(params), jdata,
                                             perms)
    tdata = tuple(torch.tensor(np.asarray(x)) for x in jdata)
    tparams, _, metrics = tagent.update_epochs(tparams, tppo.adam_init(tparams), tdata,
                                               torch.from_numpy(perms).long())
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    back = bridge.state_dict_to_flax(tparams, "mlp")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6),
                 jax.tree.map(np.asarray, jparams), back)

    # The port's own update on this mixed env: rollout through MixedVecEnv.
    gen = torch.Generator().manual_seed(0)
    state, metrics = tagent.train_iteration(tagent.init_state(gen), gen)
    assert isinstance(state.vstate, tuple) and len(state.vstate) == 2
    assert all(np.isfinite(float(v)) for k, v in metrics.items() if v.dim() == 0)


@pytest.fixture(scope="module")
def mixed_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("logs")
    log_dir = train.main(["--env", "KukaButtonGymEnv-v0", "--mixed-envs",
                          "KukaButtonGymEnv-v0", "OmnirobotEnv-v0", "--srl-model",
                          "raw_pixels", "--render-scale", "2", "--num-envs", "4",
                          "--num-timesteps", "200", "--log-dir", str(root), "--device",
                          "cpu", "--no-vis"])
    return root, log_dir


def test_mixed_cli_writes_the_reference_run_dir(mixed_run):
    root, log_dir = mixed_run
    rel = os.path.relpath(log_dir, root).split(os.sep)
    assert rel[:3] == ["KukaButtonGymEnv-v0", "raw_pixels", "ppo2"] and len(rel) == 4
    assert {"args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
            "ppo2_final_model.pkl"} <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "args.json")) as f:
        args = json.load(f)
    assert args["mixed_envs"] == ["KukaButtonGymEnv-v0", "OmnirobotEnv-v0"]
    with open(os.path.join(log_dir, "env_globals.json")) as f:
        globals_ = json.load(f)
    assert globals_["fractions"] == [0.5, 0.5] and len(globals_["families"]) == 2
    assert globals_["_tables"][0] is None and "0 1 2 3 0 1" in globals_["_tables"][1]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 1 and lines[0]["num_timesteps"] == 512
    assert all(np.isfinite(lines[0][k]) for k in ("pg_loss", "vf_loss", "entropy"))


def test_reference_loads_the_port_mixed_checkpoint(mixed_run):
    _, log_dir = mixed_run
    path = os.path.join(log_dir, "ppo2_final_model.pkl")
    jenv = jmixed.MixedEnv([JKuka(srl_model="raw_pixels", render_scale=2),
                            JOmni(srl_model="raw_pixels")], oob_action="modulo")
    jagent = JPPO2.load(path, env=jenv)
    assert isinstance(jagent.vec_env, jmixed.MixedVecEnv) and jagent.policy.torso == "cnn"
    tenv = MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=2),
                     OmniRobotEnv(srl_model="raw_pixels")], oob_action="modulo")
    agent = tppo.PPO2.load(path, env=tenv, device="cpu")
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jagent.state.params),
                 bridge.state_dict_to_flax(agent.state.params, "cnn"))
    obs = np.zeros((2, 224, 224, 3), np.uint8)
    for act in (agent.getAction(obs, deterministic=True),
                np.asarray(jagent.getAction(obs, deterministic=True))):
        assert act.shape == (2,) and int(act.max()) < 6


def test_debug_track_matches_reference(tmp_path):
    q0 = kin.settled_rest_q()
    target = np.array([0.4, 0.1, 0.35], np.float32)
    q, tip, err = debug.track(q0, target, steps=200)
    jq, jtip, jerr = jdebug.track(q0, target, steps=200)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tip.numpy(), np.asarray(jtip), atol=2e-4, rtol=0)
    assert abs(err - jerr) < 2e-4 and err < 0.15
    path = debug.render_frame(q, str(tmp_path / "frame.png"), device="cpu")
    assert os.path.isfile(path)
    errors = debug.main(["--target", "0.5", "0.0", "0.3", "--steps", "20", "--device", "cpu"])
    assert len(errors) == 1 and np.isfinite(errors[0])


@pytest.mark.parametrize("env_id,max_steps,gt_dim", [("OmnirobotEnv-v0", 20, 2),
                                                     ("CarRacingGymEnv-v0", 16, 5)])
def test_record_a_dataset(tmp_path, env_id, max_steps, gt_dim):
    folder = dataset_generator.main([
        "--env", env_id, "--num-episode", "3", "--num-envs", "2", "--max-steps",
        str(max_steps), "--save-path", str(tmp_path), "--device", "cpu"])
    data = jsaver.load_dataset(folder)
    n = len(data["rewards"])
    assert data["observations"].shape == (n, 224, 224, 3)
    assert data["observations"].dtype == np.uint8 and data["observations"].any()
    assert int(data["episode_starts"].sum()) == 3
    assert data["ground_truth_states"].shape[1] == gt_dim
    with pytest.raises(ValueError, match="toward-target"):
        dataset_generator.main([
            "--env", "OmnirobotEnv-v0", "--num-episode", "1", "--num-envs", "2",
            "--toward-target-timesteps-proportion", "0.5", "--save-path",
            str(tmp_path / "expert"), "--device", "cpu"])

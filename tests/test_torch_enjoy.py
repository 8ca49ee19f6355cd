"""srl_tpu_torch.replay.enjoy against srl_tpu.replay.enjoy on the CPU.

Run directories are read by both packages: the port's training CLI writes
four (MobileRobot ground truth, 4 envs, one PPO2 update), which the
reference reads through the reference-format pickles; the reference
writes one (its CLI's parser for ``args.json``, its PPO2's jitted
``init_state`` and ``save`` for the model: its training would compile for
10 s), which the port reads.

* ``load_config_and_setup`` rebuilds the same env and agent classes (a
  plain run, ``--policy lstm`` -> RecurrentPPO2, a ``--mixed-envs`` pod).
* Replays with deterministic actions, for 260 steps (every episode lasts
  251): the port is fed the random numbers the reference's VecEnv drew
  (``env_draws``; the key splits of srl_tpu/core/env.py:156-189 and
  srl_tpu/envs/mobile_robot.py). Episode returns and lengths are equal. The
  ``--plot`` numbers (read from the reference's own figure calls) agree:
  the trajectory within 1e-5 and up to the sign of each principal axis (the
  port's positions follow the reference's within 1e-6,
  tests/test_torch_mobile_robot.py), the mean action probabilities within
  1e-5. The reference's policy is applied under ``jax.jit`` (the same
  function, compiled once): applied op by op, 260 steps take 10 s.
* A recurrent agent's ``getActionProba`` reads the context of its last
  ``getAction`` in both packages, and the two agree within 1e-5.
* A Kuka pixel run at render scale 7 with ``--render``: each frame equals
  the twin's render of the state it came from, bit for bit, and the strip is
  drawn.
* Where the packages differ on purpose (ROADMAP Queue C): the port lets a
  render error propagate where the reference drops the frame, and it
  resolves a ``--latest`` run's encoder as the training CLI does, where the
  reference reads ``--srl-config-file``.
"""
import json
import os
import time

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
from matplotlib.axes import Axes  # noqa: E402

from srl_tpu.agents.ppo import PPO2 as JPPO2  # noqa: E402
from srl_tpu.core.env import VecEnv as JaxVecEnv  # noqa: E402
from srl_tpu.envs import mobile_robot as jm  # noqa: E402
from srl_tpu.experiments import train as jtrain  # noqa: E402
from srl_tpu.replay import enjoy as jenjoy  # noqa: E402
from srl_tpu_torch.agents.ppo import PPO2  # noqa: E402
from srl_tpu_torch.envs import mobile_robot as tm  # noqa: E402
from srl_tpu_torch.experiments import train  # noqa: E402
from srl_tpu_torch.ops import render3d  # noqa: E402
from srl_tpu_torch.replay import enjoy  # noqa: E402

from .test_torch_mobile_robot import jax_reset_noise, jax_step_noise  # noqa: E402

torch.set_num_threads(1)

N, STEPS = 4, 260  # every env ends its first episode at step 251
GT = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth", "--num-envs", "4",
      "--num-timesteps", "600", "--no-vis"]
RUNS = {
    "plain": [],
    "stack2": ["--num-stack", "2"],
    "lstm": ["--policy", "lstm", "--hyperparam", "n_steps:16", "--num-timesteps", "64"],
    "mixed": ["--mixed-envs", "MobileRobotGymEnv-v0", "OmnirobotEnv-v0"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run dirs of the port's CLI (RUNS) and, as "reference", one the
    reference writes for the plain run."""
    out = {name: train.main(GT + argv + ["--device", "cpu", "--log-dir",
                                         str(tmp_path_factory.mktemp(name))])
           for name, argv in RUNS.items()}
    ref = str(tmp_path_factory.mktemp("ref"))
    with open(os.path.join(ref, "args.json"), "w") as f:
        json.dump(vars(jtrain.parse_args(GT)[0]), f)
    agent = JPPO2(env=jm.MobileRobotEnv(), num_envs=N)
    agent.state = jax.jit(agent.init_state)(jax.random.PRNGKey(3))
    agent.save(os.path.join(ref, "ppo2_final_model.pkl"))
    out["reference"] = ref
    return out


def class_names(env, agent):
    envs = env.families if getattr(env, "is_mixed_family", False) else [env]
    return [type(e).__name__ for e in envs], type(env).__name__, type(agent).__name__


@pytest.mark.parametrize("name, agent_class", [("plain", "PPO2"), ("lstm", "RecurrentPPO2"),
                                               ("mixed", "PPO2"), ("stack2", "PPO2")])
def test_load_config_and_setup_rebuilds_the_reference_classes(runs, name, agent_class):
    _, jenv, jagent = jenjoy.load_config_and_setup(runs[name])
    train_args, env, agent = enjoy.load_config_and_setup(runs[name], device="cpu")
    assert class_names(env, agent) == class_names(jenv, jagent)
    assert type(agent).__name__ == agent_class
    assert train_args["algo"] == "ppo2" and agent.device.type == "cpu"
    if name == "mixed":
        assert [type(f).__name__ for f in env.families] == ["MobileRobotEnv", "OmniRobotEnv"]


def reference_replay(log_dir, n_envs, n_steps, seed=0):
    """The reference's replay loop (srl_tpu/replay/enjoy.py:103-124) with
    deterministic actions, recording the random numbers its VecEnv draws
    and each finished episode's return and length."""
    _, jenv, jagent = jenjoy.load_config_and_setup(log_dir)
    inner = getattr(jenv, "env", jenv)  # the MobileRobot env inside a frame stack
    key_of = (lambda s: s.inner.key) if inner is not jenv else (lambda s: s.key)
    vec = JaxVecEnv(jenv, n_envs)
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    vstate, obs = vec.reset(sub)
    draws = [{"noise": jax_reset_noise(inner, jax.random.split(jax.random.split(sub)[1],
                                                               n_envs))}]
    step = jax.jit(vec.step)
    returns, lengths, dones = [], [], np.zeros(n_envs, bool)
    for _ in range(n_steps):
        actions = jagent.getAction(np.asarray(obs), dones=dones, deterministic=True)
        draws.append({"step_noise": jax_step_noise(inner, key_of(vstate.env_state)),
                      "reset_noise": jax_reset_noise(inner, jax.random.split(
                          jax.random.split(vstate.key)[1], n_envs))})
        vstate, tr = step(vstate, jax.numpy.asarray(actions))
        obs, dones = tr.obs, np.asarray(tr.done)
        returns += np.asarray(tr.episode_return)[dones].tolist()
        lengths += np.asarray(tr.episode_length)[dones].tolist()
    return draws, returns, lengths


class JittedPolicy:
    """A reference policy whose ``apply`` runs under ``jax.jit``."""

    def __init__(self, policy):
        self._policy = policy
        self.apply = jax.jit(policy.apply)

    def __getattr__(self, name):
        return getattr(self._policy, name)


@pytest.fixture
def jitted_reference(monkeypatch):
    load = jenjoy.load_config_and_setup

    def load_jitted(log_dir):
        train_args, env, agent = load(log_dir)
        agent.policy = JittedPolicy(agent.policy)
        return train_args, env, agent

    monkeypatch.setattr(jenjoy, "load_config_and_setup", load_jitted)


@pytest.fixture
def figure_calls(monkeypatch):
    """The data of every ``Axes.plot`` and ``Axes.bar`` call, by name."""
    calls = {"plot": [], "bar": []}
    for name in calls:
        original = getattr(Axes, name)

        def record(self, *args, _name=name, _original=original, **kwargs):
            calls[_name].append([np.asarray(a) for a in args if not isinstance(a, str)])
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(Axes, name, record)
    return calls


@pytest.mark.parametrize("name", ["stack2", "reference"])
def test_replay_matches_the_reference(runs, name, jitted_reference, figure_calls):
    log_dir = runs[name]
    draws, returns, lengths = reference_replay(log_dir, N, STEPS)
    assert len(returns) == N
    out = enjoy.enjoy(log_dir, num_timesteps=N * STEPS, num_envs=N, plot=True, device="cpu",
                      env_draws=draws)
    assert out["episode_returns"] == returns
    assert out["episode_lengths"] == lengths == [251] * N
    assert os.path.isfile(out["plot_path"])
    if name != "stack2":
        return
    # The reference's own enjoy on the port's run: the same replay, and the
    # numbers its --plot draws (4-d stacked observations: PCA).
    for calls in figure_calls.values():
        calls.clear()  # the port's own figure
    ref = jenjoy.enjoy(log_dir, num_timesteps=N * STEPS, num_envs=N, plot=True)
    assert len(figure_calls["plot"]) == len(figure_calls["bar"]) == 1
    assert ref["episode_returns"] == returns and out["mean_return"] == ref["mean_return"]
    ref_traj = np.stack(figure_calls["plot"][0], 1)
    traj = out["trajectory"]
    assert traj.shape == ref_traj.shape == (STEPS, 2)
    traj = traj * np.sign(np.sum(traj * ref_traj, 0))  # each axis up to its sign
    np.testing.assert_allclose(traj, ref_traj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["mean_proba"], figure_calls["bar"][0][1], rtol=0, atol=1e-5)


def test_recurrent_proba_reads_the_last_action_context(runs):
    """``getActionProba`` of a recurrent agent reads the context its last
    ``getAction`` acted from, without advancing it, as the reference's
    (srl_tpu/agents/recurrent_ppo.py:287-301)."""
    _, _, jagent = jenjoy.load_config_and_setup(runs["lstm"])
    _, _, agent = enjoy.load_config_and_setup(runs["lstm"], device="cpu")
    obs = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
    dones = [np.zeros(3, bool), np.array([False, True, False])]
    probas = []
    for a in (jagent, agent):
        fresh = a.getActionProba(obs)
        for d in dones:
            a.getAction(obs, dones=d, deterministic=True)
        after = a.getActionProba(obs[:1])
        assert not np.allclose(after[0], fresh[0], rtol=0, atol=1e-7)
        np.testing.assert_array_equal(after, a.getActionProba(obs[:1]))
        probas.append(np.asarray(after))
    np.testing.assert_allclose(probas[1], probas[0], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def kuka_run(tmp_path_factory):
    """A Kuka pixel run dir at render scale 7 (32x32 traces upsampled to
    224x224), its model an initialised PPO2 policy (an MLP over the pixels:
    the Nature CNN costs 8 s more on the CPU and renders nothing)."""
    log_dir = str(tmp_path_factory.mktemp("kuka"))
    args = train.parse_args(["--render-scale", "7", "--num-envs", "2", "--policy", "mlp",
                             "--device", "cpu"])
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump(vars(args), f)
    agent = PPO2(env=train.build_env(args, "cpu"), num_envs=2, policy="mlp", device="cpu")
    agent.state = agent.init_state(torch.Generator().manual_seed(0))
    agent.save(os.path.join(log_dir, "ppo2_final_model.pkl"))
    return log_dir


def test_kuka_render_frames_are_the_twins_render(kuka_run):
    out = enjoy.enjoy(kuka_run, num_timesteps=2 * 11, num_envs=2, render=True, device="cpu")
    assert len(out["frames"]) == 2  # steps 0 and 10
    env = enjoy.load_config_and_setup(kuka_run, device="cpu")[1]
    for frame, state in zip(out["frames"], out["frame_states"]):
        cfg, scene = render3d._scene_table(env, state)
        cam = render3d.camera_tensors(cfg, "cpu")
        twin = render3d.render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)
        assert frame.shape == (224, 224, 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, twin[0].numpy())
    assert not np.array_equal(out["frames"][0], out["frames"][1])
    assert os.path.isfile(out["frames_path"])


def test_render_errors_propagate_where_the_reference_drops_the_frame(runs, monkeypatch):
    def broken(self, state):
        raise NotImplementedError("no renderer")

    monkeypatch.setattr(jm.MobileRobotEnv, "render_pixels", broken)
    monkeypatch.setattr(tm.MobileRobotEnv, "render_pixels", broken)
    ref = jenjoy.enjoy(runs["plain"], num_timesteps=8, num_envs=4, render=True)
    assert "frames_path" not in ref
    with pytest.raises(NotImplementedError, match="no renderer"):
        enjoy.enjoy(runs["plain"], num_timesteps=8, num_envs=4, render=True, device="cpu")


def test_latest_log_dir_picks_the_newest_run(tmp_path):
    for name in ("run_a", "run_b"):
        (tmp_path / name).mkdir()
        time.sleep(0.05)
    (tmp_path / "note.txt").write_text("")
    assert enjoy.latest_log_dir(str(tmp_path)) == str(tmp_path / "run_b")
    assert jenjoy.latest_log_dir(str(tmp_path)) == str(tmp_path / "run_b")


def test_latest_srl_run_resolves_as_the_training_cli(tmp_path, monkeypatch):
    """A run trained with ``--latest``: the port takes the newest
    srl_logs/{env}/**/srl_model.pkl, as its training CLI did; the
    reference's enjoy ignores ``latest`` and reads the config file's entry
    (srl_tpu/replay/enjoy.py:66-74; ROADMAP Queue C)."""
    monkeypatch.chdir(tmp_path)
    for d in ("old", "new"):
        os.makedirs(f"srl_logs/MobileRobotGymEnv-v0/{d}")
        open(f"srl_logs/MobileRobotGymEnv-v0/{d}/srl_model.pkl", "w").close()
        time.sleep(0.05)
    with open("srl.yaml", "w") as f:
        f.write("MobileRobotGymEnv-v0:\n  log_folder: srl_logs/MobileRobotGymEnv-v0/\n"
                "  autoencoder: old/srl_model.pkl\n")
    args = vars(train.parse_args(["--env", "MobileRobotGymEnv-v0", "--srl-model", "autoencoder",
                                  "--latest", "--srl-config-file", "srl.yaml"]))
    with open("args.json", "w") as f:
        json.dump(args, f)

    class Resolved(Exception):
        pass

    def port_build_env(args, device):
        raise Resolved(train.srl_model_path(args))

    def reference_build_env(ns, env_kwargs):
        raise Resolved(env_kwargs["srl_model_path"])

    monkeypatch.setattr(train, "build_env", port_build_env)
    monkeypatch.setattr(jtrain, "build_env", reference_build_env)
    with pytest.raises(Resolved) as port:
        enjoy.load_config_and_setup(".", device="cpu")
    with pytest.raises(Resolved) as ref:
        jenjoy.load_config_and_setup(".")
    assert str(port.value) == "srl_logs/MobileRobotGymEnv-v0/new/srl_model.pkl"
    assert str(ref.value) == "srl_logs/MobileRobotGymEnv-v0/old/srl_model.pkl"

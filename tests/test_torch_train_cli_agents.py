"""The port's training CLI beyond PPO2 on the CPU (MobileRobot ground
truth, 4 envs): the other agents (ACKTR, ACER, DQN and the recurrent
policies too; ACER, DQN and the random agent on MobileRobot1DGymEnv-v0 as
the reference's test_train_cli_other_algos; SAC with ``-c`` on 2 envs as
its test_train_cli_continuous_sac; DDPG, ARS and CMA-ES), DQN's and DDPG's
flags (``--prioritized`` and ``--memory-limit`` reach no config field, as
in the reference), SAC and DDPG refused without ``-c`` as in the
reference, ``--hyperparam``, checkpoint and resume (a mirror of
tests/test_train_cli.py::test_checkpoint_resume) and its refusal for the
agents whose ``learn`` takes no state, and fine-tuning with
``--load-rl-model-path``.

Fine-tuning at ``learning_rate:0`` keeps the loaded parameters bit for bit
in the port, which starts ``learn`` from them. The reference's run does not
keep them: it puts the loaded policy into ``agent.state``, and ``learn``
then draws fresh parameters (srl_tpu/experiments/train.py:468-472,
srl_tpu/agents/ppo.py:341-353; ROADMAP Queue C).
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from srl_tpu.agents.a2c import A2C as JA2C
from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.dqn import DQNConfig as JDQNConfig
from srl_tpu.agents.registry import registered_rl as jregistry
from srl_tpu.agents.registry import resolve_policy_class as jresolve_policy_class
from srl_tpu.envs.mobile_robot import MobileRobot1DEnv as JMobile1D
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.experiments import train as jtrain
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.experiments import train

torch.set_num_threads(1)

GT = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth", "--num-envs", "4",
      "--no-vis"]


def run(tmp_path, *argv):
    return train.main(GT + ["--device", "cpu", "--log-dir", str(tmp_path)] + list(argv))


def final_model(log_dir, algo="ppo2"):
    with open(os.path.join(log_dir, f"{algo}_final_model.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("algo, metric", [("a2c", "pg_loss"), ("ppo1", "pg_loss"),
                                          ("trpo", "kl")])
def test_cli_trains_the_other_agents(algo, metric, tmp_path):
    log_dir = run(tmp_path, "--algo", algo, "--num-timesteps", "1500")
    assert os.path.relpath(log_dir, tmp_path).split(os.sep)[2] == algo
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert lines and all(np.isfinite(e[metric]) for e in lines)
    payload = final_model(log_dir, algo)
    assert payload["name"] == algo
    if algo == "a2c":  # the reference reads the port's model
        JA2C.load(os.path.join(log_dir, "a2c_final_model.pkl"), env=JMobile())


def test_cli_hyperparam_override(tmp_path):
    log_dir = run(tmp_path, "--num-timesteps", "2000", "--hyperparam", "gamma:0.9",
                  "n_steps:16")
    config = final_model(log_dir)["config"]
    assert config["gamma"] == 0.9 and config["n_steps"] == 16
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["num_timesteps"] == 16 * 4


def test_cli_lr_schedule_flag_reaches_the_config(tmp_path):
    log_dir = run(tmp_path, "--algo", "a2c", "--lr-schedule", "linear",
                  "--num-timesteps", "100")
    assert final_model(log_dir, "a2c")["config"]["lr_schedule"] == "linear"


def test_checkpoint_resume(tmp_path):
    log_dir = run(tmp_path, "--num-timesteps", "2000", "--seed", "3",
                  "--checkpoint-interval", "2")
    ckpt = os.path.join(log_dir, "checkpoint.pkl")
    _, meta = BaseRLAgent.load_checkpoint(ckpt)
    steps_before = meta["num_timesteps"]
    assert steps_before > 0 and meta["update"] >= 1

    args_path = os.path.join(log_dir, "args.json")
    with open(args_path) as f:
        stored = json.load(f)
    stored["num_timesteps"] = 8000
    with open(args_path, "w") as f:
        json.dump(stored, f)

    log_dir2 = train.main(["--resume", log_dir, "--checkpoint-interval", "2",
                           "--device", "cpu"])
    assert log_dir2 == log_dir
    _, meta2 = BaseRLAgent.load_checkpoint(ckpt)
    assert meta2["num_timesteps"] > steps_before
    assert os.path.exists(os.path.join(log_dir, "ppo2_final_model.pkl"))
    with open(os.path.join(log_dir, "0.monitor.csv")) as f:
        text = f.read()
    assert text.count("#{") == 1 and text.count("r,l,t") == 1
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        steps = [json.loads(x)["num_timesteps"] for x in f]
    assert steps == sorted(steps) and steps[-1] > steps_before


def test_load_rl_model_path_at_lr_zero_keeps_the_weights(tmp_path):
    pretrained = os.path.join(run(tmp_path / "a", "--num-timesteps", "1000"),
                              "ppo2_final_model.pkl")
    loaded = final_model(os.path.dirname(pretrained))
    fine = ["--load-rl-model-path", pretrained, "--hyperparam", "learning_rate:0",
            "--num-timesteps", "1000", "--seed", "4"]
    port = final_model(run(tmp_path / "b", *fine))
    ref = final_model(jtrain.main(GT + ["--log-dir", str(tmp_path / "c")] + fine))
    leaves = lambda d: [np.asarray(x) for x in _leaves(d["params"])]
    for a, b in zip(leaves(port), leaves(loaded)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port["obs_norm"]["mean"].shape, loaded["obs_norm"]["mean"].shape)
    assert not all(np.array_equal(a, b) for a, b in zip(leaves(ref), leaves(loaded)))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_cli_profile_writes_a_trace(tmp_path):
    log_dir = run(tmp_path, "--num-timesteps", "100", "--profile")
    with open(os.path.join(log_dir, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_cli_run_flags_reach_the_env_and_agent(tmp_path):
    args = train.parse_args(["--device", "cpu", "--action-repeat", "2", "-joints",
                             "--render-scale", "7", "--policy", "mlp"])
    env = train.build_env(args, "cpu")
    assert env.action_repeat == 2 and env.action_joints
    log_dir = run(tmp_path, "--num-timesteps", "100", "--policy", "mlp",
                  "--min-episodes-save", "1", "--episode-window", "5")
    payload = final_model(log_dir)
    assert payload["policy_kind"] == "mlp"
    with open(os.path.join(log_dir, "args.json")) as f:
        stored = json.load(f)
    assert stored["min_episodes_save"] == 1 and stored["episode_window"] == 5


@pytest.mark.parametrize("algo, policy, metric, name", [
    ("ppo2", "lstm", "loss", "ppo2_lstm"), ("a2c", "lnlstm", "pg_loss", "a2c_lstm"),
    ("acktr", "lstm", "eta", "acktr_lstm"), ("acktr", "auto", "eta", "acktr")])
def test_cli_trains_acktr_and_the_recurrent_policies(algo, policy, metric, name, tmp_path):
    # The recurrent PPO2's --hyperparam parses against PPO2's table, as in
    # the reference, over its own default config (lstm_ppo_config).
    extra = ["--hyperparam", "n_steps:16"] if algo == "ppo2" else []
    log_dir = run(tmp_path, "--algo", algo, "--policy", policy, "--num-timesteps", "200",
                  *extra)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) >= 2 and all(np.isfinite(e[metric]) for e in lines)
    payload = final_model(log_dir, algo)
    assert payload["name"] == name
    if algo == "ppo2":
        assert payload["config"]["n_steps"] == 16 and payload["config"]["noptepochs"] == 8
    # The reference reads the port's model as the class it trains.
    jcls = jresolve_policy_class(algo, policy)
    jagent = jcls.load(os.path.join(log_dir, f"{algo}_final_model.pkl"), env=JMobile())
    assert type(jagent).__name__ == jcls.__name__


@pytest.mark.parametrize("algo, policy", [("ppo2", "lstm"), ("acktr", "auto"), ("acer", "auto"),
                                          ("acer", "lstm"), ("deepq", "auto"), ("sac", "auto"),
                                          ("ddpg", "auto"), ("ars", "auto"), ("cma-es", "auto"),
                                          ("random_agent", "auto")])
def test_cli_refuses_resume_where_learn_takes_no_state(algo, policy, tmp_path):
    extra = {"ppo2": ["--hyperparam", "n_steps:16"], "sac": ["-c"], "ddpg": ["-c"]}.get(algo, [])
    log_dir = run(tmp_path, "--algo", algo, "--policy", policy, "--num-timesteps", "100",
                  "--checkpoint-interval", "1", *extra)
    with open(os.path.join(log_dir, "args.json")) as f:
        stored = f.read()
    with pytest.raises(ValueError, match=f"--resume is not supported for algo '{algo}' yet"):
        train.main(["--resume", log_dir, "--device", "cpu"])
    with open(os.path.join(log_dir, "args.json")) as f:
        assert f.read() == stored


@pytest.mark.parametrize("algo, hyper", [("ppo2", ["n_steps:16"]), ("acktr", []), ("acer", [])])
def test_recurrent_fine_tune_at_lr_zero_keeps_the_weights(algo, hyper, tmp_path):
    common = ["--algo", algo, "--policy", "lstm", "--num-timesteps", "100"]
    first = run(tmp_path / "a", *common, *(["--hyperparam", *hyper] if hyper else []))
    path = os.path.join(first, f"{algo}_final_model.pkl")
    tuned = run(tmp_path / "b", *common, "--load-rl-model-path", path, "--seed", "4",
                "--hyperparam", *hyper, "learning_rate:0")
    leaves = lambda d: [np.asarray(x) for x in _leaves(d["params"])]
    for a, b in zip(leaves(final_model(tuned, algo)), leaves(final_model(first, algo))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo, policy, metric, name", [
    ("acer", "auto", "loss_q", "acer"), ("acer", "lstm", "loss_q", "acer_lstm"),
    ("deepq", "auto", "td_loss", "deepq")])
def test_cli_trains_acer_and_deepq(algo, policy, metric, name, tmp_path):
    """As the reference's tests/test_train_cli.py::test_train_cli_other_algos
    runs them: MobileRobot1DGymEnv-v0 ground truth, 4 envs, 1500 steps."""
    log_dir = train.main(["--algo", algo, "--policy", policy, "--env",
                          "MobileRobot1DGymEnv-v0", "--srl-model", "ground_truth",
                          "--num-timesteps", "1500", "--log-dir", str(tmp_path),
                          "--num-envs", "4", "--no-vis", "--device", "cpu"])
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    if algo == "acer":  # 20 iterations of 20 x 4 steps, replays from the 4th on
        assert [e["replays"] for e in lines] == [0.0] * 3 + [4.0] * 17
    else:  # 7 chunks of 64 x 4 steps; a TD update every 4th vector step from step 500
        assert [e["td_updates"] for e in lines] == [0, 1, 16, 16, 16, 16, 16]
    trained = [e for e in lines if algo == "acer" or e["td_updates"]]
    assert trained and all(np.isfinite(e[metric]) for e in trained)
    payload = final_model(log_dir, algo)
    assert payload["name"] == name
    jcls = jresolve_policy_class(algo, policy)
    jagent = jcls.load(os.path.join(log_dir, f"{algo}_final_model.pkl"), env=JMobile1D())
    assert type(jagent).__name__ == jcls.__name__


def test_cli_deepq_flags_reach_the_config_as_in_the_reference(tmp_path):
    """``--buffer-size`` and ``--dueling`` name DQNConfig fields and reach the
    config; ``--prioritized`` names none (the field is
    ``prioritized_replay``), so ``--prioritized 0`` changes nothing, in the
    reference's CLI as in the port's (ROADMAP Queue C)."""
    fields = {f.name for f in dataclasses.fields(JDQNConfig)}
    assert "prioritized" not in fields and {"prioritized_replay", "buffer_size",
                                           "dueling"} <= fields
    log_dir = run(tmp_path, "--algo", "deepq", "--num-timesteps", "100", "--prioritized", "0",
                  "--buffer-size", "300", "--dueling", "0")
    config = final_model(log_dir, "deepq")["config"]
    assert config["prioritized_replay"] is True
    assert config["buffer_size"] == 300 and not config["dueling"]
    with open(os.path.join(log_dir, "args.json")) as f:
        assert json.load(f)["prioritized"] == 0


@pytest.mark.parametrize("algo, argv", [
    ("random_agent", ["--env", "MobileRobot1DGymEnv-v0", "--num-envs", "4",
                      "--num-timesteps", "1500"]),
    ("sac", ["-c", "--num-envs", "2", "--num-timesteps", "600", "--checkpoint-interval", "2"]),
    ("ddpg", ["-c", "--num-envs", "2", "--num-timesteps", "600", "--checkpoint-interval", "2",
              "--memory-limit", "1000"]),
    ("ars", ["--num-timesteps", "1500"]),
    ("cma-es", ["--num-timesteps", "1500"])])
def test_cli_trains_the_last_agents(algo, argv, tmp_path):
    """As the reference's tests/test_train_cli.py runs random_agent
    (test_train_cli_other_algos: MobileRobot1DGymEnv-v0 ground truth, 4
    envs, 1500 steps) and SAC (test_train_cli_continuous_sac: ``-c``, 2
    envs, 600 steps); DDPG as SAC, its ``--memory-limit`` reaching no config
    field (the field is ``buffer_size``); ARS and CMA-ES one generation of
    their populations (``--num-envs`` ignored). The reference reads each
    final model, and SAC's and DDPG's checkpoints."""
    base = ["--algo", algo, "--srl-model", "ground_truth", "--no-vis", "--device", "cpu",
            "--log-dir", str(tmp_path)]
    log_dir = train.main(base + (argv if "--env" in argv else ["--env", "MobileRobotGymEnv-v0"]
                                 + argv))
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    payload = final_model(log_dir, algo)
    assert payload["name"] == algo
    env = JMobile1D() if algo == "random_agent" else JMobile(is_discrete="-c" not in argv)
    jagent = jregistry[algo][0].load(os.path.join(log_dir, f"{algo}_final_model.pkl"), env=env)
    assert type(jagent).__name__ == jregistry[algo][0].__name__
    if algo in ("sac", "ddpg"):
        # 6 chunks of 64 x 2 steps (to 660 steps), an update a step from env
        # step 100 on; a checkpoint after every second chunk.
        assert [e["updates"] for e in lines] == [15, 64, 64, 64, 64, 64]
        assert all(np.isfinite(e[k]) for e in lines for k in ("critic_loss", "actor_loss"))
        state, meta = JBase.load_checkpoint(os.path.join(log_dir, "checkpoint.pkl"))
        assert type(state).__name__ == {"sac": "SACState", "ddpg": "DDPGState"}[algo]
        assert int(state.global_step) == meta["num_timesteps"] == 640
        assert type(state.buffer).__name__ == "ReplayBuffer"
    elif algo == "random_agent":  # 2 chunks of 256 x 4 steps
        assert [e["num_timesteps"] for e in lines] == [1024, 2048]
    else:  # one generation of 260 steps of the population
        assert len(lines) == 1 and np.isfinite(lines[0]["mean_return"])
        with open(os.path.join(log_dir, "0.monitor.csv")) as f:
            assert len(f.read().splitlines()) == 3  # the header lines and one return
    if algo == "ddpg":
        assert payload["config"]["buffer_size"] == 50000
        with open(os.path.join(log_dir, "args.json")) as f:
            assert json.load(f)["memory_limit"] == 1000


def test_cli_refuses_discrete_sac_and_ddpg_as_the_reference():
    """SAC and DDPG take continuous actions only: without ``-c`` both CLIs
    stop at their action-type check, before the continuous-only override
    behind it (srl_tpu/experiments/train.py:395-412)."""
    for algo in ("sac", "ddpg"):
        argv = GT + ["--algo", algo, "--num-timesteps", "100", "--log-dir", "unused"]
        with pytest.raises(AssertionError) as ref_err:
            jtrain.main(argv)
        with pytest.raises(AssertionError) as err:
            train.main(argv + ["--device", "cpu"])
        assert str(err.value) == str(ref_err.value) == (
            f"Error: {algo} does not support discrete actions")
    with pytest.raises(AssertionError, match="deepq does not support continuous"):
        train.main(GT + ["--algo", "deepq", "-c", "--device", "cpu", "--log-dir", "unused"])


@pytest.mark.parametrize("algo, argv", [("ars", ["--hyperparam", "step_size:0"]),
                                        ("sac", ["-c", "--hyperparam", "learning_rate:0"])])
def test_fine_tune_starts_from_the_loaded_policy(algo, argv, tmp_path):
    """``--load-rl-model-path`` starts ``learn`` from the loaded ``M`` (ARS)
    or parameters (SAC); at a zero step size they stay bit for bit. The
    reference's run discards them (ROADMAP Queue C)."""
    common = ["--algo", algo, "--num-timesteps", "200"] + argv[:1 if algo == "sac" else 0]
    first = run(tmp_path / "a", *common)
    path = os.path.join(first, f"{algo}_final_model.pkl")
    tuned = final_model(run(tmp_path / "b", *common, "--load-rl-model-path", path, "--seed", "4",
                            *argv[-2:]), algo)
    loaded = final_model(first, algo)
    if algo == "ars":
        np.testing.assert_array_equal(tuned["M"], loaded["M"])
        assert np.abs(loaded["M"]).max() > 0
    else:
        for key in ("actor_params", "critic_params"):
            for a, b in zip(_leaves(tuned[key]), _leaves(loaded[key])):
                np.testing.assert_array_equal(a, b)
        assert tuned["log_alpha"] == loaded["log_alpha"] != 0

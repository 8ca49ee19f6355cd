"""The SRL workflow through the port's three CLIs on the CPU, as README
gives it: record a MobileRobot dataset (dataset_generator), train an
autoencoder on it (train_srl), and run PPO2 on the encoded states (train
--srl-model autoencoder). The reference's loaders read what the port
wrote, and its encoder gives the port's states within 1e-2 of their scale
(bf16 convs, tests/test_torch_srl_nets.py).

Also: the port reads ``srl_models.yaml`` without PyYAML, and its reader
equals ``yaml.safe_load`` on both files under ``config/`` and on the
corner cases of the subset it accepts.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml

from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.srl import episode_saver as jsaver
from srl_tpu.srl import models as jmodels
from srl_tpu_torch.data import dataset_generator
from srl_tpu_torch.experiments import train, train_srl
from srl_tpu_torch.srl import models as tmodels
from srl_tpu_torch.utils.yaml_subset import parse_yaml_subset, read_yaml_subset

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = "MobileRobotGymEnv-v0"


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    root = tmp_path_factory.mktemp("workflow")
    folder = dataset_generator.main([
        "--env", ENV, "--num-episode", "4", "--num-envs", "4", "--max-steps", "15",
        "--save-path", str(root / "data"), "--device", "cpu"])
    srl_dir = root / "srl_logs" / ENV / "autoencoder"
    model_path = train_srl.main([
        "--data-folder", folder, "--srl-model", "autoencoder", "--state-dim", "3",
        "--epochs", "2", "--batch-size", "16", "--log-dir", str(srl_dir),
        "--device", "cpu"])
    config = root / "srl_models.yaml"
    config.write_text(f"{ENV}:\n  log_folder: {root / 'srl_logs' / ENV}/  # base\n"
                      "  autoencoder: autoencoder/srl_model.pkl\n")
    log_dir = train.main([
        "--env", ENV, "--srl-model", "autoencoder", "--srl-config-file", str(config),
        "--num-envs", "4", "--num-timesteps", "1000", "--log-dir", str(root / "logs"),
        "--device", "cpu", "--no-vis"])
    return root, folder, model_path, log_dir


def test_recorded_dataset(workflow):
    _, folder, _, _ = workflow
    assert os.path.basename(folder) == "mobilerobotgymenv"
    data = jsaver.load_dataset(folder)
    assert data["observations"].shape == (64, 224, 224, 3)
    assert data["episode_starts"].sum() == 4


def test_trained_encoder(workflow):
    _, folder, model_path, _ = workflow
    srl_dir = os.path.dirname(model_path)
    assert sorted(os.listdir(srl_dir)) == ["exp_config.json", "history.json",
                                           "srl_model.pkl"]
    with open(os.path.join(srl_dir, "history.json")) as f:
        hist = json.load(f)
    # 4 episodes of 16 frames: 60 pairs, 3 minibatches of 16 per epoch.
    assert hist["images_trained"] == 2 * 3 * 16 and len(hist["history"]) == 2
    assert all(np.isfinite(v) for h in hist["history"] for v in h.values())
    ref, port = jmodels.loadSRLModel(model_path), tmodels.loadSRLModel(model_path,
                                                                        device="cpu")
    assert tmodels.getSRLDim(model_path) == jmodels.getSRLDim(model_path) == 3
    obs = jsaver.load_dataset(folder)["observations"][:4]
    ref_states = np.asarray(ref.getState(obs))
    out = port.getState(obs).numpy()
    assert np.abs(out - ref_states).max() <= 1e-2 * np.abs(ref_states).max()


def test_rl_run_on_the_encoded_states(workflow):
    root, _, _, log_dir = workflow
    rel = os.path.relpath(log_dir, root / "logs").split(os.sep)
    assert rel[:3] == [ENV, "autoencoder", "ppo2"]
    assert {"args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
            "ppo2_final_model.pkl"} <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "args.json")) as f:
        args = json.load(f)
    assert args["srl_model"] == "autoencoder" and args["latest"] is False
    with open(os.path.join(log_dir, "env_globals.json")) as f:
        assert json.load(f)["render_shape"] == [224, 224]  # the wrapped env's
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 2
    assert all(np.isfinite(e[k]) for e in lines for k in ("pg_loss", "vf_loss", "entropy"))
    # PPO2 saw [N, 3] normalized states; the reference loads the agent.
    jagent = JPPO2.load(os.path.join(log_dir, "ppo2_final_model.pkl"),
                        env=JMobile(srl_model="ground_truth"))
    assert jagent.normalize_obs and np.asarray(jagent.state.obs_norm.mean).shape == (3,)


def test_latest_and_config_errors(workflow, monkeypatch):
    root, _, model_path, _ = workflow
    monkeypatch.chdir(root)
    args = train.parse_args(["--env", ENV, "--srl-model", "autoencoder", "--latest",
                             "--device", "cpu"])
    assert os.path.samefile(train.srl_model_path(args), model_path)
    args = train.parse_args(["--env", "KukaButtonGymEnv-v0", "--srl-model", "autoencoder",
                             "--latest", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="No trained SRL models"):
        train.srl_model_path(args)
    args = train.parse_args(["--env", ENV, "--srl-model", "vae", "--srl-config-file",
                             str(root / "srl_models.yaml"), "--device", "cpu"])
    with pytest.raises(KeyError, match="not in config"):
        train.srl_model_path(args)
    args = train.parse_args(["--env", ENV, "--srl-model", "ground_truth", "--device", "cpu"])
    assert train.srl_model_path(args) is None


@pytest.mark.parametrize("name", ["srl_models.yaml", "srl_models_test.yaml"])
def test_yaml_reader_equals_safe_load_on_the_config_files(name):
    path = REPO / "config" / name
    assert read_yaml_subset(str(path)) == yaml.safe_load(path.read_text())


YAML_CASES = [
    "A:\n  log_folder: 'srl logs/A/'  # quoted, with a comment\n  m: \"x#y\"\n",
    "# only a comment\n\nA:\n\n  k: v # c\nB:\n",
    "A:\n    four: p/q.pkl\n    spaces: 1\nB:\n  two: x\n",
    "top: 3\nA:\n  f: 1.5\n  t: true\n  n: null\n  s: 'true'\n  h: a#b\n",
    "A:\n  e: 1e5\n  f: 1.0e+5\n",  # YAML 1.1: the first is a string
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_equals_safe_load_on_its_subset(text):
    assert parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["A:\n  - x\n", "A: {b: 1}\n", "A:\n  b:\n    c: 1\n",
                                  "A:\n  b: &x 1\n", "A:\n    b: 1\n  c: 2\n",
                                  "A:\n  b: 017\n"])  # octal: safe_load reads 15
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml_subset(text)

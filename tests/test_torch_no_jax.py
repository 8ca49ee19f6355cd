"""The port stands alone: no module of srl_tpu_torch, and not chip_smoke.py,
imports JAX, Flax, Optax, PyYAML (the machine with the card has none) or the
reference package; and its entry points run on the card unless the caller
asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.data import dataset_generator
from srl_tpu_torch.envs import debug
from srl_tpu_torch.envs.kuka import KukaButtonEnv
from srl_tpu_torch.experiments import hyperparam_search, pipeline, train, train_srl
from srl_tpu_torch.replay import enjoy
from srl_tpu_torch.srl.trainer import SRLTrainer, fit_pca

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "srl_tpu", "yaml"}
SOURCES = sorted((REPO / "srl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_imports(path):
    assert not imported_roots(path) & FORBIDDEN


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--num-envs", "2", "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--num-envs", "2", "--log-dir", str(tmp_path), "--mixed-envs",
                    "KukaButtonGymEnv-v0", "OmnirobotEnv-v0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug.main(["--target", "0.4", "0.1", "0.35", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug.render_frame(np.zeros(7, np.float32), str(tmp_path / "frame.png"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataset_generator.main(["--env", "OmnirobotEnv-v0", "--num-episode", "1",
                                "--save-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPO2(env=KukaButtonEnv(), num_envs=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataset_generator.main(["--env", "MobileRobotGymEnv-v0", "--num-episode", "1",
                                "--save-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SRLTrainer(state_dim=2, losses=["autoencoder"], obs_shape=(8, 8, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_pca(np.zeros((2, 4), np.uint8), 1)
    assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_srl.main(["--data-folder", str(tmp_path), "--srl-model", "pca"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enjoy.main(["--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enjoy.enjoy(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                       "--num-iteration", "1", "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hyperparam_search.main(["--max-eval", "3", "--log-dir", str(tmp_path),
                                "--output", str(tmp_path / "results.csv")])
    assert not any(tmp_path.iterdir())

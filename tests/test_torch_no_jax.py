"""The port stands alone: no module of srl_tpu_torch, and not chip_smoke.py,
imports JAX, Flax, Optax, PyYAML (the machine with the card has none) or the
reference package; its entry points run on the card unless the caller asks
for the CPU; and its ROS ``camera_info`` reader gives what ``yaml.safe_load``
gives, or raises."""
import ast
import pathlib

import numpy as np
import pytest
import torch
import yaml

from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.data import dataset_generator
from srl_tpu_torch.envs import debug
from srl_tpu_torch.envs.kuka import KukaButtonEnv
from srl_tpu_torch.experiments import hyperparam_search, pipeline, train, train_srl
from srl_tpu_torch.real_robots import sim_server
from srl_tpu_torch.replay import enjoy
from srl_tpu_torch.srl import server
from srl_tpu_torch.srl.trainer import SRLTrainer, fit_pca
from srl_tpu_torch.utils.yaml_subset import parse_yaml_subset, read_yaml_subset

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


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_servers_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a card the two servers refuse before they bind; with
    ``--device cpu`` they bind and serve (EXIT stops them)."""
    import threading

    import zmq

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _free_port()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim_server.main(["--port", str(port)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--port", str(port)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim_server.OmniRobotSimServer(port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.serve(port)
    for main, exit_msg in ((sim_server.main, {"command": "exit"}),
                           (server.main, {"command": server.Command.EXIT.value})):
        port = _free_port()
        thread = threading.Thread(target=main, args=(["--port", str(port), "--device", "cpu"],),
                                  daemon=True)
        thread.start()
        ctx = zmq.Context()
        sock = ctx.socket(zmq.PAIR)
        sock.connect(f"tcp://127.0.0.1:{port}")
        sock.send_json(exit_msg)
        thread.join(10)
        assert not thread.is_alive(), f"{main.__module__} did not stop on EXIT"
        sock.close(linger=0)
        ctx.term()


CAMERA_INFO = """image_width: 640
image_height: 480
camera_name: head_camera  # a comment
camera_matrix:
  rows: 3
  cols: 3
  data: [517.3, 0, 318.6, 0, 516.5, 255.3, 0, 0, 1]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]
rectification_matrix:
  rows: 3
  cols: 3
  data: [1.0, 0.0, 0.0,
         0.0, 1.0, 0.0,
         0.0, 0.0, 1.0]
projection_matrix:
  rows: 3
  cols: 4
  data: [5.2e+02, 0., 3.2e+02, 0, 0., 516.5, 255.3, 0, 0, 0, 1., 0]
binning_x: 0
roi: ~
flags: [yes, Off, 1e5, .5, -.inf, 1_000, text]
note: 'it''s calibrated'
"""


def test_camera_info_reader_equals_safe_load(tmp_path):
    path = tmp_path / "camera.yaml"
    path.write_text(CAMERA_INFO)
    assert repr(read_yaml_subset(str(path))) == repr(yaml.safe_load(CAMERA_INFO))
    for text in ("", "a: 1\n", "a:\n", "a: []\n", "a:\n  b: null\n  c: 2001-x\n"):
        assert parse_yaml_subset(text) == yaml.safe_load(text), text


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",  # an anchor and its alias
    "a:\n  - 1\n  - 2\n",  # a nested block list
    "- 1\n- 2\n",  # a top-level block list
    "a: [1, [2, 3]]\n",  # a nested flow list
    "a: {b: 1}\n",  # a flow mapping
    "a:\n  b:\n    c: 1\n",  # a third level
    "a: !!str 1\n",  # a tag
    "a: |\n  text\n",  # a block scalar
    "a: 017\n",  # an octal integer
    "a: 2001-12-14\n",  # a timestamp
    "---\na: 1\n",  # a document marker
])
def test_camera_info_reader_raises_outside_its_subset(text):
    yaml.safe_load(text)  # valid YAML all the same
    with pytest.raises(ValueError):
        parse_yaml_subset(text)

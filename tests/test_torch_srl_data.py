"""Dataset recording in the port: srl_tpu_torch.data.dataset_generator and
srl_tpu_torch.srl.episode_saver against srl_tpu's on the CPU.

Exact throughout: the dataset layout of tests/test_srl.py:44-59, the
``.srlf`` frame store byte for byte against the reference's native writer
(srl_tpu/native/framestore.cpp), datasets read both ways, the saver's and
``LogRLStates``' files equal to the reference's on the same calls. The
toward-target mix is statistical, as in tests/test_srl.py:316-357: at
proportion p the expert-agreement fraction is about p + (1 - p) / 4.
"""
import json
import os

import numpy as np
import pytest

from srl_tpu.data.dataset_generator import generate_dataset as jgenerate
from srl_tpu.native import FrameStoreReader, FrameStoreWriter, available
from srl_tpu.srl import episode_saver as jsaver
from srl_tpu_torch.data import dataset_generator as tgen
from srl_tpu_torch.srl import episode_saver as tsaver


@pytest.fixture(scope="module")
def port_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    folder = tgen.generate_dataset("MobileRobotGymEnv-v0", num_episodes=6, save_path=path,
                                   name="mr_test", num_envs=4, max_steps=15, seed=0,
                                   device="cpu")
    return tsaver.load_dataset(folder), folder


def test_dataset_generation_layout(port_dataset):
    data, folder = port_dataset
    n = len(data["rewards"])
    assert data["observations"].shape == (n, 224, 224, 3)
    assert data["observations"].dtype == np.uint8
    assert data["episode_starts"].sum() == 6
    assert data["ground_truth_states"].shape == (n, 2)
    assert data["target_positions"].shape == (6, 2)
    assert len(data["images_path"]) == n
    assert data["actions"].dtype == np.int32
    for f in ("dataset_config.json", "env_globals.json", "frames.srlf"):
        assert os.path.exists(os.path.join(folder, f))
    # The reset frame + max_steps frames: the frame returned with done
    # belongs to the next episode.
    assert n == 6 * 16
    starts = np.nonzero(data["episode_starts"])[0]
    np.testing.assert_array_equal(starts, np.arange(6) * 16)
    assert str(data["images_path"][17]) == "mr_test/record_001/frame000001"
    # Within an episode, consecutive ground truths differ by one move (or
    # none, when the robot bumped a wall).
    steps = np.abs(np.diff(data["ground_truth_states"], axis=0)).sum(1)
    inside = ~data["episode_starts"][1:]
    assert np.all((np.abs(steps[inside] - 0.1) < 1e-5) | (steps[inside] < 1e-6))


def test_reference_reads_the_port_dataset(port_dataset):
    data, folder = port_dataset
    assert available(), "the reference's native frame store needs g++"
    ref = jsaver.load_dataset(folder)
    assert set(ref) == set(data)
    for k in data:
        np.testing.assert_array_equal(ref[k], data[k], err_msg=k)


def test_port_reads_a_reference_dataset(tmp_path):
    folder = jgenerate("MobileRobotGymEnv-v0", 2, save_path=str(tmp_path), name="ref",
                       num_envs=2, max_steps=10, seed=1)
    assert os.path.exists(os.path.join(folder, "frames.srlf"))
    ref, port = jsaver.load_dataset(folder), tsaver.load_dataset(folder)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (5, 6, 7, 3)), (np.float32, (4, 3)),
                                         (np.int32, (3, 2, 2, 2, 2, 2)),
                                         (np.uint8, (0, 8, 8, 3))])
def test_srlf_is_the_native_format_byte_for_byte(tmp_path, dtype, shape):
    frames = (np.arange(np.prod(shape)) % 251).astype(dtype).reshape(shape)
    native, port = str(tmp_path / "native.srlf"), str(tmp_path / "port.srlf")
    with FrameStoreWriter(native, shape[1:], dtype) as w:
        w.push(frames)
    tsaver.write_srlf(port, frames)
    with open(native, "rb") as a, open(port, "rb") as b:
        assert a.read() == b.read()
    out = tsaver.read_srlf(native)
    assert out.dtype == frames.dtype and out.shape == frames.shape
    np.testing.assert_array_equal(out, frames)
    with FrameStoreReader(port) as r:
        np.testing.assert_array_equal(r.frames, frames)


def test_non_uint8_frames_go_to_npz_both_ways(tmp_path):
    frames = np.random.RandomState(0).rand(3, 4, 4, 3).astype(np.float32)
    tsaver.save_frames(str(tmp_path), frames)
    assert os.listdir(tmp_path) == ["frames.npz"]
    np.testing.assert_array_equal(jsaver.load_frames(str(tmp_path)), frames)
    np.testing.assert_array_equal(tsaver.load_frames(str(tmp_path)), frames)
    with pytest.raises(ValueError, match="not a frame store"):
        (tmp_path / "frames.srlf").write_bytes(b"\0" * 64)
        tsaver.load_frames(str(tmp_path))


def _drive_saver(saver_cls, root):
    rng = np.random.RandomState(3)
    saver = saver_cls("ep", max_dist=0.5, state_dim=2, globals_={"a": 1, "skip": object()},
                      path=root)
    for _ in range(2):
        saver.reset(rng.randint(0, 256, (4, 4, 3)), rng.randn(2), rng.randn(2))
        for t in range(3):
            saver.step(rng.randint(0, 256, (4, 4, 3)), np.int32(t), float(t == 2), t == 2,
                       rng.randn(2))
    return saver.save()


def test_episode_saver_writes_the_reference_files(tmp_path):
    ref = _drive_saver(jsaver.EpisodeSaver, str(tmp_path / "ref"))
    port = _drive_saver(tsaver.EpisodeSaver, str(tmp_path / "port"))
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port))
    for name in ("dataset_config.json", "env_globals.json"):
        with open(os.path.join(ref, name)) as a, open(os.path.join(port, name)) as b:
            assert json.load(a) == json.load(b)
    for name in ("preprocessed_data.npz", "ground_truth.npz"):
        a, b = np.load(os.path.join(ref, name)), np.load(os.path.join(port, name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(jsaver.load_frames(port), tsaver.load_frames(ref))


def test_log_rl_states_writes_the_reference_files(tmp_path):
    for mod, root in ((jsaver, tmp_path / "ref"), (tsaver, tmp_path / "port")):
        log = mod.LogRLStates(str(root))
        state = np.array([0.1, 0.2])
        log.reset(state / 2, state)
        for t in range(4):
            log.step(state / 2 + t, state + t, action=1, reward=0.5, done=t == 3)
    for name in ("full_log.npz", "states_rewards.npz", "normalized_states_rewards.npz"):
        a = np.load(str(tmp_path / "ref" / "log_srl" / name))
        b = np.load(str(tmp_path / "port" / "log_srl" / name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    full = np.load(str(tmp_path / "port" / "log_srl" / "full_log.npz"))
    assert full["rewards"].shape == (4,) and full["states"].shape == (4, 2)


def expert_agreement(folder) -> float:
    """Share of steps whose action is the toward-target expert's (as
    tests/test_srl.py:323-351 counts it)."""
    d = tsaver.load_dataset(folder)
    gt, tgt, act = d["ground_truth_states"], d["target_positions"], d["actions"]
    starts = d["episode_starts"]
    episode_idx = np.cumsum(starts) - 1
    agree = total = 0
    for t in range(1, len(act)):
        if starts[t]:
            continue
        delta = tgt[episode_idx[t]] - gt[t - 1]
        if np.max(np.abs(delta)) < 1e-6:
            continue
        if np.argmax(np.abs(delta)) == 0:
            a = 1 if delta[0] > 0 else 0
        else:
            a = 3 if delta[1] > 0 else 2
        agree += int(act[t] == a)
        total += 1
    assert total > 100
    return agree / total


def test_toward_target_mixes_per_step(tmp_path):
    make = lambda p, seed: tgen.generate_dataset(
        "MobileRobotGymEnv-v0", num_episodes=10, save_path=str(tmp_path),
        name=f"mix_{int(p * 100)}", num_envs=4, max_steps=20, seed=seed,
        policy="toward_target", toward_target_proportion=p, device="cpu")
    assert 0.50 < expert_agreement(make(0.5, 1)) < 0.75
    assert expert_agreement(make(1.0, 2)) > 0.9


def test_cli_run_ppo2_and_refuses_an_existing_folder(tmp_path):
    argv = ["--env", "MobileRobot1DGymEnv-v0", "--num-episode", "2", "--num-envs", "4",
            "--max-steps", "10", "--save-path", str(tmp_path), "--name", "ppo",
            "--run-ppo2", "--device", "cpu"]
    folder = tgen.main(argv)
    data = tsaver.load_dataset(folder)
    assert data["episode_starts"].sum() == 2 and len(data["rewards"]) == 22
    assert set(np.unique(data["actions"])) <= {0, 1}
    with pytest.raises(ValueError, match="already exists"):
        tgen.main(argv)

"""The port's dataset tools and frame store against the reference's, on the
CPU.

* ``dataset_fusioner`` on two MobileRobot datasets recorded by the port's
  generator (random targets, 2 envs, 8 steps an episode) writes every file
  byte for byte as the reference's does from copies of the same sources,
  and removes the sources; ``change_to_relative_pos`` then rewrites
  ``ground_truth.npz`` to the reference's bytes.
* A ``.srlf`` written by the port's ``FrameStoreWriter`` is the reference's
  native writer's file byte for byte and reads in the reference's
  ``FrameStoreReader``, and the other way round, for each dtype.
* ``push`` returns before the frames are on disk: with the writer's thread
  held, pushes finish and the file holds only its header.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

from srl_tpu.data import change_to_relative_pos as jrelative
from srl_tpu.data import dataset_fusioner as jfusioner
from srl_tpu.native import FrameStoreReader as JReader
from srl_tpu.native import FrameStoreWriter as JWriter
from srl_tpu.native import available as jnative_available
from srl_tpu_torch import native
from srl_tpu_torch.data import change_to_relative_pos, dataset_fusioner
from srl_tpu_torch.data import dataset_generator
from srl_tpu_torch.native import framestore
from srl_tpu_torch.srl.episode_saver import load_dataset

DATASET_FILES = ["dataset_config.json", "env_globals.json", "frames.srlf", "ground_truth.npz",
                 "preprocessed_data.npz"]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Two MobileRobot datasets of the port's generator: 3 and 2 episodes."""
    root = tmp_path_factory.mktemp("data")
    for name, episodes, seed in (("first", 3, 0), ("second", 2, 1)):
        dataset_generator.main(["--env", "MobileRobotGymEnv-v0", "--num-episode", str(episodes),
                                "--num-envs", "2", "--max-steps", "8", "--random-target",
                                "--seed", str(seed), "--name", name, "--save-path", str(root),
                                "--device", "cpu"])
    return root


def test_fusioner_and_relative_pos_write_the_reference_files(recorded, tmp_path):
    for side in ("port", "ref"):
        for name in ("first", "second"):
            shutil.copytree(recorded / name, tmp_path / side / name)
    port, ref = tmp_path / "port", tmp_path / "ref"
    dataset_fusioner.main(["--merge", str(port / "first"), str(port / "second"),
                           str(port / "merged")])
    jfusioner.main(["--merge", str(ref / "first"), str(ref / "second"), str(ref / "merged")])
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == ["merged"]
    assert sorted(os.listdir(port / "merged")) == DATASET_FILES
    for name in DATASET_FILES:
        assert (port / "merged" / name).read_bytes() == (ref / "merged" / name).read_bytes(), name

    merged = load_dataset(str(port / "merged"))
    first = load_dataset(str(recorded / "first"))
    n1 = len(first["rewards"])
    assert merged["episode_starts"].sum() == 5 and len(merged["rewards"]) > n1
    np.testing.assert_array_equal(merged["observations"][:n1], first["observations"])
    assert merged["images_path"][n1] == "merged/record_003/frame000000"

    change_to_relative_pos.main(["--data-folder", str(port / "merged")])
    jrelative.main(["--data-folder", str(ref / "merged")])
    assert (port / "merged" / "ground_truth.npz").read_bytes() == (
        ref / "merged" / "ground_truth.npz").read_bytes()
    relative = load_dataset(str(port / "merged"))["ground_truth_states"]
    episode = np.cumsum(merged["episode_starts"]) - 1
    np.testing.assert_array_equal(
        relative, merged["ground_truth_states"] - merged["target_positions"][episode])


@pytest.mark.parametrize("dtype, shape", [(np.uint8, (37, 16, 24, 3)), (np.float32, (50, 7)),
                                          (np.int32, (9, 2, 3, 4, 5, 6))])
def test_srlf_written_by_either_store_reads_in_the_other(dtype, shape, tmp_path):
    assert jnative_available(), "the reference's native frame store needs g++"
    assert native.available()
    frames = (np.random.default_rng(0).uniform(0, 250, shape)).astype(dtype)
    port, ref = str(tmp_path / "port.srlf"), str(tmp_path / "ref.srlf")
    for writer, path in ((native.FrameStoreWriter, port), (JWriter, ref)):
        with writer(path, shape[1:], dtype) as w:
            w.push(frames[:5])
            w.push(frames[5:])
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with native.FrameStoreReader(ref) as r:
        assert not r.frames.flags.writeable
        np.testing.assert_array_equal(r.frames, frames)
    with JReader(port) as r:
        np.testing.assert_array_equal(np.array(r.frames), frames)


def test_push_returns_before_the_frames_are_on_disk(tmp_path, monkeypatch):
    release = threading.Event()
    drain = framestore.FrameStoreWriter._drain

    def held_drain(self):
        release.wait()
        drain(self)

    monkeypatch.setattr(framestore.FrameStoreWriter, "_drain", held_drain)
    path = str(tmp_path / "big.srlf")
    batch = np.zeros((64, 224, 224, 3), np.uint8)  # 9.6 MB a push
    w = native.FrameStoreWriter(path, (224, 224, 3))
    t0 = time.perf_counter()
    for i in range(8):
        w.push(batch + i)
    seconds = time.perf_counter() - t0
    batch[:] = 255  # the writer holds its own copies
    assert os.path.getsize(path) == 64 and seconds < 2.0
    release.set()
    assert w.close() == 8 * 64
    assert os.path.getsize(path) == 64 + 8 * 64 * 224 * 224 * 3
    with native.FrameStoreReader(path) as r:
        assert [int(r.frames[64 * i, 0, 0, 0]) for i in range(8)] == list(range(8))
    with pytest.raises(ValueError, match="closed"):
        w.push(batch)
    with native.FrameStoreWriter(str(tmp_path / "x.srlf"), (2, 2)) as w2:
        with pytest.raises(ValueError, match="2, 2"):
            w2.push(np.zeros((1, 3, 2), np.uint8))

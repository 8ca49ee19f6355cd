"""Episode recording for SRL datasets (counterpart of
srl_tpu/srl/episode_saver.py), in the same on-disk layout:

* ``preprocessed_data.npz``: rewards, actions, episode_starts;
* ``ground_truth.npz``: target_positions (one row per episode),
  ground_truth_states, images_path;
* ``dataset_config.json``, ``env_globals.json``;
* the frames: ``frames.srlf`` for uint8 frames, else ``frames.npz``.

``frames.srlf`` is the reference's native frame store
(srl_tpu/native/framestore.cpp): a 64-byte little-endian header ``{magic
'SRLF', version 1, dtype code (0 u8, 1 f32, 2 i32), ndim, dims[5],
nframes}`` followed by the packed frames. This module writes and reads it
with numpy alone (a memory map past the header).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

SRLF_MAGIC = 0x53524C46  # 'SRLF'
SRLF_VERSION = 1
SRLF_HEADER = np.dtype([("magic", "<u4"), ("version", "<u4"), ("dtype", "<u4"),
                        ("ndim", "<u4"), ("dims", "<u8", (5,)), ("nframes", "<u8")])
SRLF_DTYPES = {0: np.dtype(np.uint8), 1: np.dtype("<f4"), 2: np.dtype("<i4")}
assert SRLF_HEADER.itemsize == 64


class EpisodeSaver:
    def __init__(
        self,
        name: str,
        max_dist: float = 0.0,
        state_dim: int = -1,
        globals_: Optional[dict] = None,
        learn_every: int = 3,
        learn_states: bool = False,
        path: str = "data/",
        relative_pos: bool = False,
    ):
        self.name = name
        self.data_folder = os.path.join(path, name)
        os.makedirs(self.data_folder, exist_ok=True)

        self.actions: List = []
        self.rewards: List[float] = []
        self.images: List[np.ndarray] = []
        self.images_path: List[str] = []
        self.episode_starts: List[bool] = []
        self.ground_truth_states: List[np.ndarray] = []
        self.target_positions: List[np.ndarray] = []
        self.episode_step = 0
        self.episode_idx = -1
        self.episode_success = False

        if globals_ is not None:
            serializable = {k: v for k, v in globals_.items()
                            if isinstance(v, (int, float, str, bool, list))}
            with open(os.path.join(self.data_folder, "env_globals.json"), "w") as f:
                json.dump(serializable, f, indent=2)
        with open(os.path.join(self.data_folder, "dataset_config.json"), "w") as f:
            json.dump({"max_dist": max_dist, "state_dim": state_dim,
                       "relative_pos": relative_pos}, f, indent=2)

    def _frame_path(self) -> str:
        return f"{self.name}/record_{self.episode_idx:03d}/frame{self.episode_step:06d}"

    def reset(self, observation, target_pos, ground_truth):
        self.episode_idx += 1
        self.episode_step = 0
        self.episode_success = False
        self.episode_starts.append(True)
        self.images.append(np.asarray(observation, np.uint8))
        self.images_path.append(self._frame_path())
        self.ground_truth_states.append(np.asarray(ground_truth, np.float32))
        self.target_positions.append(np.asarray(target_pos, np.float32))
        # The reset frame has no action: zeros of the action dtype at save.
        self.actions.append(None)
        self.rewards.append(0.0)

    def step(self, observation, action, reward, done, ground_truth_state):
        self.episode_step += 1
        self.episode_starts.append(False)
        self.rewards.append(float(reward))
        self.actions.append(action)
        if float(reward) > 0:
            self.episode_success = True
        self.images.append(np.asarray(observation, np.uint8))
        self.images_path.append(self._frame_path())
        self.ground_truth_states.append(np.asarray(ground_truth_state, np.float32))

    @property
    def n_episodes(self) -> int:
        return self.episode_idx + 1

    def save(self) -> str:
        if not len(self.actions) == len(self.rewards) == len(self.images):
            raise RuntimeError("actions, rewards and frames are out of step")
        proto = next((a for a in self.actions if a is not None), 0)
        zero = np.zeros_like(np.asarray(proto))
        actions = np.asarray([zero if a is None else np.asarray(a) for a in self.actions])
        np.savez(os.path.join(self.data_folder, "preprocessed_data.npz"),
                 rewards=np.asarray(self.rewards, np.float32), actions=actions,
                 episode_starts=np.asarray(self.episode_starts, bool))
        np.savez(os.path.join(self.data_folder, "ground_truth.npz"),
                 target_positions=np.asarray(self.target_positions, np.float32),
                 ground_truth_states=np.asarray(self.ground_truth_states, np.float32),
                 images_path=np.asarray(self.images_path))
        frames = np.stack(self.images) if self.images else np.zeros((0, 1), np.uint8)
        save_frames(self.data_folder, frames)
        return self.data_folder


def srlf_header(dtype, frame_shape, nframes: int) -> bytes:
    """The 64-byte header of a ``.srlf`` store of ``nframes`` frames of
    ``frame_shape`` (1 to 5 dims) and ``dtype`` (uint8, float32, int32)."""
    code = {v: k for k, v in SRLF_DTYPES.items()}[np.dtype(dtype)]
    if not 1 <= len(frame_shape) <= 5:
        raise ValueError(f"a frame store holds 1 to 5 frame dims, got {tuple(frame_shape)}")
    header = np.zeros((), SRLF_HEADER)
    header["magic"], header["version"], header["dtype"] = SRLF_MAGIC, SRLF_VERSION, code
    header["ndim"] = len(frame_shape)
    header["dims"][: len(frame_shape)] = frame_shape
    header["nframes"] = nframes
    return header.tobytes()


def write_srlf(path: str, frames: np.ndarray) -> None:
    """Frames [N, ...] (1 to 5 frame dims, uint8/float32/int32) -> a
    ``.srlf`` frame store."""
    header = srlf_header(frames.dtype, frames.shape[1:], frames.shape[0])
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(frames).tobytes())


def open_srlf(path: str) -> np.ndarray:
    """A ``.srlf`` frame store -> a read-only memory map of its frames
    [nframes, *dims] (an empty array for a store of no frame)."""
    header = np.fromfile(path, SRLF_HEADER, count=1)
    if len(header) != 1 or int(header["magic"][0]) != SRLF_MAGIC:
        raise ValueError(f"{path} is not a frame store")
    h = header[0]
    shape = (int(h["nframes"]),) + tuple(int(d) for d in h["dims"][: int(h["ndim"])])
    dtype = SRLF_DTYPES[int(h["dtype"])]
    if shape[0] == 0:
        return np.zeros(shape, dtype)
    return np.memmap(path, dtype, "r", offset=SRLF_HEADER.itemsize, shape=shape)


def read_srlf(path: str) -> np.ndarray:
    """A ``.srlf`` frame store -> frames [nframes, *dims] (a copy)."""
    return np.array(open_srlf(path))


def save_frames(data_folder: str, frames: np.ndarray) -> None:
    """uint8 frames -> ``frames.srlf``; anything else -> ``frames.npz``."""
    if frames.ndim >= 2 and frames.dtype == np.uint8:
        write_srlf(os.path.join(data_folder, "frames.srlf"), frames)
        return
    np.savez_compressed(os.path.join(data_folder, "frames.npz"), frames=frames)


def load_frames(data_folder: str) -> np.ndarray:
    srlf = os.path.join(data_folder, "frames.srlf")
    if os.path.exists(srlf):
        return read_srlf(srlf)
    return np.load(os.path.join(data_folder, "frames.npz"))["frames"]


def load_dataset(data_folder: str) -> Dict[str, np.ndarray]:
    """A recorded dataset in the trainer's dict format."""
    pre = np.load(os.path.join(data_folder, "preprocessed_data.npz"))
    gt = np.load(os.path.join(data_folder, "ground_truth.npz"))
    return {
        "observations": load_frames(data_folder),
        "actions": pre["actions"],
        "rewards": pre["rewards"],
        "episode_starts": pre["episode_starts"],
        "ground_truth_states": gt["ground_truth_states"],
        "target_positions": gt["target_positions"],
        "images_path": gt["images_path"],
    }


class LogRLStates:
    """Logs (state, normalized state, action, reward) during RL training
    into ``{log_folder}/log_srl/``: ``full_log.npz``, ``states_rewards.npz``
    and ``normalized_states_rewards.npz``. Calls may pass batches [N, d];
    rows stack along the leading time axis. ``step`` saves when the episode
    ends (``done`` truthy, or true for every env of a batch)."""

    def __init__(self, log_folder: str):
        self.log_folder = os.path.join(log_folder, "log_srl")
        os.makedirs(self.log_folder, exist_ok=True)
        self.actions: List = []
        self.rewards: List = []
        self.states: List = []
        self.normalized_states: List = []

    def reset(self, normalized_state, state):
        self.normalized_states.append(np.asarray(normalized_state))
        self.states.append(np.squeeze(np.asarray(state)))

    def step(self, normalized_state, state, action, reward, done):
        self.rewards.append(np.asarray(reward))
        self.actions.append(np.asarray(action))
        if np.asarray(done).all():
            self.save()
        else:
            self.normalized_states.append(np.asarray(normalized_state))
            self.states.append(np.squeeze(np.asarray(state)))

    def save(self):
        if not (len(self.actions) == len(self.rewards) == len(self.normalized_states)
                == len(self.states)):
            raise RuntimeError("the logged states, actions and rewards are out of step")
        data = {
            "rewards": np.array(self.rewards),
            "actions": np.array(self.actions),
            "states": np.array(self.states),
            "normalized_states": np.array(self.normalized_states),
        }
        np.savez(os.path.join(self.log_folder, "full_log.npz"), **data)
        np.savez(os.path.join(self.log_folder, "states_rewards.npz"),
                 states=data["states"], rewards=data["rewards"])
        np.savez(os.path.join(self.log_folder, "normalized_states_rewards.npz"),
                 states=data["normalized_states"], rewards=data["rewards"])

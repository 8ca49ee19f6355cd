"""Client envs of real and simulated robots over ZMQ (counterpart of
srl_tpu/real_robots/remote_env.py).

Baxter, Robobo and the real Omnirobot (environments/gym_baxter/baxter_env.py,
robobo_gym/robobo_env.py, omnirobot_gym real mode): thin host loops speaking
the PAIR-socket JSON protocol ({"command": "action"/"reset"/"exit"}, then
the frame through the matrix transport). They run at robot speed (about
0.1-0.6 frames/s) on the host, one env each, and hand numpy observations to
the caller, who moves them to the card; they are not batched envs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from srl_tpu_torch.core.spaces import Box, Discrete
from srl_tpu_torch.real_robots import constants as C
from srl_tpu_torch.real_robots.transport import connect_pair, getActions, recvMatrix
from srl_tpu_torch.utils.logging import printGreen, printYellow

RENDER_WIDTH = 224
RENDER_HEIGHT = 224


class RemoteRobotEnv:
    """Common ZMQ client machinery."""

    def __init__(self, port: int = C.SERVER_PORT, hostname: str = C.HOSTNAME,
                 env_rank: int = 0):
        # Per-rank ports like omnirobot_env.py:83.
        self.port = port + env_rank
        self.context, self.socket = connect_pair(self.port, hostname=hostname)
        printGreen(f"Connected to robot server tcp://{hostname}:{self.port}")
        self.np_random = np.random.RandomState(0)

    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def _recv_image(self) -> np.ndarray:
        return recvMatrix(self.socket)

    def close(self):
        try:
            self.socket.send_json({"command": "exit"})
            self.socket.close()
        except Exception:
            pass


class BaxterEnv(RemoteRobotEnv):
    """Baxter arm via Gazebo or the real robot
    (environments/gym_baxter/baxter_env.py). 5 discrete (dx, dy, dz) actions;
    reward/termination computed client-side from the server state
    (baxter_env.py:168-202)."""

    name = "Baxter-v0"

    def __init__(self, srl_model: str = "raw_pixels", shape_reward: bool = False,
                 real: bool = None, **kwargs):
        super().__init__(**kwargs)
        cfg = C.RealBaxter if (real if real is not None else C.USING_REAL_BAXTER) \
            else C.BaxterGazebo
        self.cfg = cfg
        self.srl_model = srl_model
        self.shape_reward = shape_reward
        self.action_space = Discrete(5)
        # Discrete action table: single-axis +-DELTA_POS moves + down.
        self.actions = np.vstack(
            [getActions(cfg.DELTA_POS, 6)[:5]]
        )
        self.observation_space = (
            Box(0, 255, (RENDER_HEIGHT, RENDER_WIDTH, 3), np.uint8)
            if srl_model == "raw_pixels" else Box(-np.inf, np.inf, (3,))
        )
        self.button_pos = np.zeros(3)
        self.arm_pos = np.zeros(3)
        self.reward = 0.0
        self.n_contacts = 0
        self._step_counter = 0

    @staticmethod
    def getGroundTruthDim():
        return 3

    def getGroundTruth(self):
        return np.asarray(self.arm_pos)

    def getTargetPos(self):
        return np.asarray(self.button_pos)

    def _update_state(self):
        state_data = self.socket.recv_json()
        self.reward = state_data["reward"]
        self.button_pos = np.array(state_data["button_pos"])
        self.arm_pos = np.array(state_data["position"])
        self.observation = self._recv_image()
        return state_data

    def reset(self):
        self._step_counter = 0
        self.n_contacts = 0
        self.socket.send_json({"command": "reset"})
        self._update_state()
        return self._obs()

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        delta = self.actions[int(action)].tolist()
        self.socket.send_json({"command": "action", "action": delta})
        self._update_state()
        self._step_counter += 1
        self.n_contacts += max(int(self.reward), 0)
        distance = np.linalg.norm(self.button_pos - self.arm_pos)
        reward = self.reward
        if distance > self.cfg.MAX_DISTANCE:
            reward = -1
        done = self._step_counter >= self.cfg.MAX_STEPS or self.n_contacts >= 5
        if self.shape_reward:
            reward = -distance
        return self._obs(), float(reward), bool(done), {}

    def _obs(self):
        if self.srl_model == "ground_truth":
            return self.getGroundTruth() - self.getTargetPos()
        return self.observation


class RoboboEnv(RemoteRobotEnv):
    """Robobo wheeled robot (environments/robobo_gym/robobo_env.py):
    4 discrete moves; the server computes the reward (robobo_env.py:155-166)."""

    name = "RoboboGymEnv-v0"

    def __init__(self, srl_model: str = "raw_pixels", **kwargs):
        super().__init__(**kwargs)
        self.srl_model = srl_model
        self.action_space = Discrete(4)
        self.observation_space = (
            Box(0, 255, (RENDER_HEIGHT, RENDER_WIDTH, 3), np.uint8)
            if srl_model == "raw_pixels" else Box(-np.inf, np.inf, (2,))
        )
        self.robobo_pos = np.zeros(2)
        self.target_pos = np.zeros(2)
        self.reward = 0.0
        self._step_counter = 0

    @staticmethod
    def getGroundTruthDim():
        return 2

    def getGroundTruth(self):
        return np.asarray(self.robobo_pos)

    def getTargetPos(self):
        return np.asarray(self.target_pos)

    def _update_state(self):
        state_data = self.socket.recv_json()
        self.reward = state_data["reward"]
        self.robobo_pos = np.array(state_data.get("position", [0, 0])[:2])
        if "target_pos" in state_data:
            self.target_pos = np.array(state_data["target_pos"][:2])
        self.observation = self._recv_image()

    def reset(self):
        self._step_counter = 0
        self.socket.send_json({"command": "reset"})
        self._update_state()
        return self._obs()

    def step(self, action):
        self.socket.send_json(
            {"command": "action", "action": int(action)}
        )
        self._update_state()
        self._step_counter += 1
        done = self._step_counter >= C.Robobo.MAX_STEPS
        return self._obs(), float(self.reward), bool(done), {}

    def _obs(self):
        if self.srl_model == "ground_truth":
            return self.getGroundTruth() - self.getTargetPos()
        return self.observation


class OmniRobotRemoteEnv(RemoteRobotEnv):
    """Real Omnirobot via its ROS server (omnirobot_gym real mode,
    omnirobot_env.py:133-147): same protocol the in-repo simulator server
    speaks, so it is testable end-to-end without hardware."""

    name = "OmnirobotRemoteEnv-v0"

    def __init__(self, srl_model: str = "raw_pixels", is_discrete: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.srl_model = srl_model
        self.is_discrete = is_discrete
        self.action_space = Discrete(4) if is_discrete else Box(-0.1, 0.1, (2,))
        self.observation_space = (
            Box(0, 255, (RENDER_HEIGHT, RENDER_WIDTH, 3), np.uint8)
            if srl_model == "raw_pixels" else Box(-np.inf, np.inf, (2,))
        )
        self.robot_pos = np.zeros(2)
        self.target_pos = np.zeros(2)
        self.reward = 0.0
        self._step_counter = 0

    @staticmethod
    def getGroundTruthDim():
        return 2

    def getGroundTruth(self):
        return np.asarray(self.robot_pos)

    def getTargetPos(self):
        return np.asarray(self.target_pos)

    def _update_state(self):
        state_data = self.socket.recv_json()
        self.reward = state_data["reward"]
        self.robot_pos = np.array(state_data["position"][:2])
        self.target_pos = np.array(state_data["target_pos"][:2])
        self.observation = self._recv_image()

    def reset(self):
        self._step_counter = 0
        self.socket.send_json({"command": "reset"})
        self._update_state()
        return self._obs()

    def step(self, action):
        if self.is_discrete:
            payload = int(action)
        else:
            payload = np.asarray(action).tolist()
        self.socket.send_json(
            {"command": "action", "action": payload,
             "is_discrete": self.is_discrete}
        )
        self._update_state()
        self._step_counter += 1
        done = self._step_counter > C.Omnirobot.MAX_STEPS
        return self._obs(), float(self.reward), bool(done), {}

    def _obs(self):
        if self.srl_model == "ground_truth":
            return self.getGroundTruth() - self.getTargetPos()
        return self.observation

"""Real-robot configuration constants (counterpart of
srl_tpu/real_robots/constants.py, values identical).

The robot is chosen by the environment variable ``SRL_TPU_ROBOT`` (default
``omnirobot_simulator``); each robot's constants are a class of its own.
"""
from __future__ import annotations

import os
from enum import Enum

import numpy as np

SERVER_PORT = 7777
HOSTNAME = "localhost"

ROBOT = os.environ.get("SRL_TPU_ROBOT", "omnirobot_simulator")
assert ROBOT in (
    "none", "baxter_gazebo", "real_baxter", "robobo", "omnirobot",
    "omnirobot_simulator",
), f"Unknown SRL_TPU_ROBOT={ROBOT}"

USING_REAL_BAXTER = ROBOT == "real_baxter"
USING_ROBOBO = ROBOT == "robobo"
USING_OMNIROBOT = ROBOT == "omnirobot"
USING_OMNIROBOT_SIMULATOR = ROBOT == "omnirobot_simulator"


# ==== Real Baxter (constants.py:24-46) ====
class RealBaxter:
    LEFT_ARM_INIT_POS = [0.69850099, 0.14505832, 0.08032852]
    LEFT_ARM_ORIENTATION = [0.99893116, -0.04207143, -0.00574656, -0.01826233]
    BUTTON_POS = [0.7090276, 0.13833109, -0.11170768]
    DIST_TO_TARGET_THRESHOLD = 0.035
    MAX_DISTANCE = 0.18
    IK_SEED_POSITIONS = None
    DELTA_POS = 0.02
    Z_TABLE = -0.10
    MAX_STEPS = 100
    IMAGE_TOPIC = "/kinect2/qhd/image_color"


# ==== Baxter Gazebo (constants.py else-branch) ====
class BaxterGazebo:
    LEFT_ARM_INIT_POS = [0.6, 0.30, 0.20]
    IK_SEED_POSITIONS = [-1.535, 1.491, -0.038, 0.194, 1.546, 1.497, -0.520]
    DELTA_POS = 0.05
    Z_TABLE = -0.14
    MAX_STEPS = 100
    MAX_DISTANCE = 0.35
    IMAGE_TOPIC = "/cameras/head_camera_2/image"


# ==== Robobo (reference constants.py:48-77) ====
class Robobo:
    MAX_STEPS = 20
    # Grid boundaries (integer cells)
    MIN_X, MAX_X = -3, 3
    MIN_Y, MAX_Y = -4, 3
    IMAGE_TOPIC = "/camera/rgb/image_raw"
    SECOND_CAM_TOPIC = None
    DATA_FOLDER_SECOND_CAM = "real_robobo_second_cam"
    # Calibrated area (px) of the target when fully visible; the reward
    # fires when the detected area shrinks by MIN_DELTA_AREA (the robot
    # covering the target).
    TARGET_INITIAL_AREA = 3700
    MIN_DELTA_AREA = 0.2
    # HSV threshold calibration (OpenCV convention: H in [0,180))
    LOWER_RED = np.array([120, 130, 0])
    UPPER_RED = np.array([135, 255, 255])
    REWARD_TARGET_REACH = 1
    REWARD_NOTHING = 0
    REWARD_BUMP_WALL = -1


# ==== Omnirobot (constants.py:78-138) ====
class Omnirobot:
    REWARD_TARGET_REACH = 1
    REWARD_NOTHING = 0
    REWARD_BUMP_WALL = -1
    IMAGE_TOPIC = "/camera/image_raw"
    SECOND_CAM_TOPIC = None
    MAX_STEPS = 250
    MIN_X, MAX_X = -0.85, 0.85
    MIN_Y, MAX_Y = -0.85, 0.85
    INIT_MIN_X, INIT_MAX_X = -0.7, 0.7
    INIT_MIN_Y, INIT_MAX_Y = -0.7, 0.7
    TARGET_MIN_X, TARGET_MAX_X = -0.7, 0.7
    TARGET_MIN_Y, TARGET_MAX_Y = -0.7, 0.7
    RL_CONTROL_FREQ = 20.0
    OMNIROBOT_L = 0.120
    DIST_TO_TARGET_THRESHOLD = 0.2
    STEP_DISTANCE = 0.1
    ACTION_POSITIVE_LOW = 0.0
    ACTION_POSITIVE_HIGH = 0.1
    ACTION_NEGATIVE_LOW = -0.1
    ACTION_NEGATIVE_HIGH = 0.0
    CAMERA_POS_COORD_GROUND = [0, 0, 2.9]
    CAMERA_ROT_EULER_COORD_GROUND = [0, 180, 0]
    ORIGIN_SIZE = [640, 480]
    CROPPED_SIZE = [480, 480]

    class Move(Enum):
        FORWARD = 0
        BACKWARD = 1
        LEFT = 2
        RIGHT = 3
        STOP = 4


# Teleoperation keycodes (constants.py:150-160).
UP_KEY = 82
DOWN_KEY = 84
RIGHT_KEY = 83
LEFT_KEY = 81
ENTER_KEY = 10
SPACE_KEY = 32
EXIT_KEYS = [113, 27]  # q and Escape
D_KEY = 100
U_KEY = 117
R_KEY = 114

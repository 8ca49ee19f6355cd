"""ROS-side robot servers (counterpart of
srl_tpu/real_robots/ros_servers.py), with the behaviour of the upstream
toolbox's four servers: real_robots/gazebo_server.py (Baxter in Gazebo),
real_baxter_server.py, real_robobo_server.py and omnirobot_server.py.

Design: each server splits into
  * a **pure decision core** (grid motion state machine, timed open-loop
    motion model, HSV target detection, reward rules) that is ROS-free and
    unit-tested over a loopback ZMQ socket, and
  * a **rig** — the thin actuation/sensing backend. The default rig talks
    ROS (rospy publishers / Robobo command service / Baxter IK); tests
    inject fakes. Importing this module never touches ROS.

Run (on the robot workstation):
  python -m srl_tpu_torch.real_robots.ros_servers --robot robobo [--port 7777]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from srl_tpu_torch.real_robots import constants as C
from srl_tpu_torch.real_robots.transport import connect_pair, sendMatrix
from srl_tpu_torch.utils.logging import printGreen, printRed


def _require_ros():
    try:
        import rospy  # noqa: F401
        from cv_bridge import CvBridge  # noqa: F401

        return True
    except ImportError:
        printRed(
            "Error: rospy/cv_bridge not available — ROS servers must run in "
            "a ROS environment on the robot workstation."
        )
        return False


# ---------------------------------------------------------------------------
# Pure image processing (real_robobo_server.py:223-278 findTarget, without
# OpenCV: numpy HSV conversion + morphological open + largest component)
# ---------------------------------------------------------------------------

def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """Uint8 [H,W,3] -> OpenCV-convention HSV: H in [0,180), S,V in
    [0,255]. This is a *correct* channel-order-respecting conversion;
    note that ``find_target`` deliberately feeds it a channel-swapped
    frame to reproduce the reference's calibration quirk (see there)."""
    rgb = rgb.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    # Hue in degrees [0, 360)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.maximum(delta, 1e-12)
        h = np.where(
            maxc == r, (g - b) / d % 6.0,
            np.where(maxc == g, (b - r) / d + 2.0, (r - g) / d + 4.0),
        )
    h = np.where(delta == 0, 0.0, h) * 60.0
    return np.stack(
        [h / 2.0, s * 255.0, v * 255.0], axis=-1
    ).astype(np.uint8)


def _binary_erode(mask: np.ndarray, k: int) -> np.ndarray:
    """Erosion with a k x k all-ones structuring element (cv2.erode
    semantics): output is 1 where every pixel under the kernel is 1."""
    h, w = mask.shape
    pl = k // 2
    pr = k - 1 - pl
    padded = np.pad(mask.astype(np.uint8), ((pl, pr), (pl, pr)))
    out = np.ones_like(mask, np.uint8)
    for dy in range(k):
        for dx in range(k):
            out &= padded[dy:dy + h, dx:dx + w]
    return out


def _binary_dilate(mask: np.ndarray, k: int) -> np.ndarray:
    h, w = mask.shape
    pl = k // 2
    pr = k - 1 - pl
    padded = np.pad(mask.astype(np.uint8), ((pl, pr), (pl, pr)))
    out = np.zeros_like(mask, np.uint8)
    for dy in range(k):
        for dx in range(k):
            out |= padded[dy:dy + h, dx:dx + w]
    return out


def find_target(image: np.ndarray, lower=None, upper=None):
    """Locate the colour-calibrated target: HSV threshold, 2x erode(4),
    2x dilate(6), largest 4-connected component's centroid + area
    (real_robobo_server.py:223-278). Returns (cx, cy, area, error).

    Calibration quirk, reproduced deliberately: the reference calls
    ``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on a frame that is actually
    RGB (real_robobo_server.py:289 decodes "rgb8"), i.e. R and B are
    swapped before the HSV conversion. The calibrated LOWER_RED/UPPER_RED
    window H in [120,135] (constants.py:62-63) therefore selects *red*
    targets only under that swap (pure red -> treated as blue -> H=120).
    We feed the HSV conversion the channel-swapped frame so the carried-
    over constants keep their calibrated meaning.

    Area metric: the reference uses ``cv2.contourArea`` of the largest
    contour, which for a filled region is close to
    ``pixel_count - boundary_pixels/2`` (Green's-theorem polygon area vs
    pixel count). We apply that correction so TARGET_INITIAL_AREA=3700
    (calibrated against contourArea) keeps firing at the same physical
    coverage."""
    from srl_tpu_torch.real_robots.marker_finder import label_components

    lower = np.asarray(C.Robobo.LOWER_RED if lower is None else lower)
    upper = np.asarray(C.Robobo.UPPER_RED if upper is None else upper)
    hsv = rgb_to_hsv_u8(image[..., ::-1])  # reference's BGR2HSV-on-RGB quirk
    mask = np.all((hsv >= lower) & (hsv <= upper), axis=-1).astype(np.uint8)
    for _ in range(2):
        mask = _binary_erode(mask, 4)
    for _ in range(2):
        mask = _binary_dilate(mask, 6)
    labels, n = label_components(mask)
    if n == 0:
        return 0, 0, 0.0, True
    areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    best = int(np.argmax(areas)) + 1
    region = (labels == best).astype(np.uint8)
    ys, xs = np.nonzero(region)
    pixel_count = float(areas[best - 1])
    boundary = pixel_count - float(_binary_erode(region, 3).sum())
    area = max(pixel_count - boundary / 2.0, 0.0)  # ~cv2.contourArea
    return int(xs.mean()), int(ys.mean()), area, False


# ---------------------------------------------------------------------------
# Robobo timed open-loop motion model (real_robobo_server.py:35-220)
# ---------------------------------------------------------------------------

def normalize_angle(angle: float) -> float:
    """Wrap degrees into [-180, 180]."""
    while angle > 180:
        angle -= 360
    while angle < -180:
        angle += 360
    return angle


class RoboboMotion:
    """Grid motion state machine over a timed actuation rig. The robot
    always ends a move facing 'north'; LEFT/RIGHT are executed as
    turn + forward + turn-back so x changes while the heading is restored
    (real_robobo_server.py:369-399). The rig provides
    ``move(t, speed)`` (translation), ``turn(t, speed)`` (rotation),
    ``stop()``, ``yaw()`` and ``sleep(seconds)``."""

    TIME_FORWARD = 1.7  # seconds per grid cell (real_robobo_server.py:42-44)
    SPEED = 10
    ANGLE_OFFSET = 38  # degrees reached in the 1st second at SPEED
    ANGLE_COEFF = 50   # degrees/s after the 1st second (calibration)
    DIRECTIONS = {"left": 90, "right": -90}
    FACES = ("west", "north", "east")

    def __init__(self, rig):
        self.rig = rig
        self.position = [0, 0]
        self.current_face_idx = 1  # start facing north
        self.yaw_error = 0.0
        self.yaw_target = 0.0
        self.yaw_north = 0.0
        self.angles = {}

    def init_yaw_north(self):
        """Record the gyroscope yaw that means 'north' and derive the
        east/west targets from it."""
        self.yaw_north = self.rig.yaw()
        self.angles = {
            "north": self.yaw_north,
            "east": normalize_angle(self.yaw_north - 90),
            "west": normalize_angle(self.yaw_north + 90),
        }
        self.current_face_idx = 1
        self.yaw_target = self.yaw_north
        self.yaw_error = 0.0

    def compute_time(self, direction: str) -> float:
        """Seconds of rotation needed to face `direction`: the calibrated
        piecewise-linear model t = (|angle| - offset)/coeff + 1."""
        self.yaw_error = 0.0  # cancelling the error drifts less in practice
        return (
            abs(self.DIRECTIONS[direction]) - self.ANGLE_OFFSET
        ) / self.ANGLE_COEFF + 1.0

    def _update_error(self):
        self.yaw_error = normalize_angle(self.yaw_target - self.rig.yaw())

    def forward(self):
        self.rig.move(self.TIME_FORWARD, self.SPEED)
        self.rig.sleep(1.1 * self.TIME_FORWARD)

    def backward(self):
        self.rig.move(self.TIME_FORWARD, -self.SPEED)
        self.rig.sleep(1.1 * self.TIME_FORWARD)

    def turn_left(self):
        t = self.compute_time("left")
        assert self.current_face_idx > 0
        self.current_face_idx -= 1
        self.yaw_target = self.angles.get(
            self.FACES[self.current_face_idx], self.yaw_target
        )
        self.rig.turn(t, -self.SPEED)
        self.rig.sleep(1.1 * t + 2)
        self._update_error()

    def turn_right(self):
        t = self.compute_time("right")
        assert self.current_face_idx < len(self.FACES) - 1
        self.current_face_idx += 1
        self.yaw_target = self.angles.get(
            self.FACES[self.current_face_idx], self.yaw_target
        )
        self.rig.turn(t, self.SPEED)
        self.rig.sleep(1.1 * t + 2)
        self._update_error()

    def apply_move(self, move: int) -> bool:
        """Execute one discrete grid move with boundary checks
        (real_robobo_server.py:369-399). Returns has_bumped."""
        cfg = C.Robobo
        Move = C.Omnirobot.Move  # FORWARD/BACKWARD/LEFT/RIGHT/STOP ids match
        if move == Move.FORWARD.value:
            if self.position[1] < cfg.MAX_Y:
                self.forward()
                self.position[1] += 1
            else:
                return True
        elif move == Move.STOP.value:
            self.rig.stop()
        elif move == Move.RIGHT.value:
            if self.position[0] < cfg.MAX_X:
                self.turn_right()
                self.forward()
                self.turn_left()
                self.position[0] += 1
            else:
                return True
        elif move == Move.LEFT.value:
            if self.position[0] > cfg.MIN_X:
                self.turn_left()
                self.forward()
                self.turn_right()
                self.position[0] -= 1
            else:
                return True
        elif move == Move.BACKWARD.value:
            if self.position[1] > cfg.MIN_Y:
                self.backward()
                self.position[1] -= 1
            else:
                return True
        return False


class RosRoboboRig:
    """Actuation via the Robobo ROS command service (MOVE with
    lspeed/rspeed/time key-values) + gyroscope yaw from /status."""

    def __init__(self):
        import rospy
        from com_mytechia_robobo_ros_msgs.msg import Status
        from com_mytechia_robobo_ros_msgs.srv import Command

        self._command = rospy.ServiceProxy("/command", Command)
        self._yaw = 0.0
        rospy.Subscriber("/status", Status, self._status_cb)

    def _status_cb(self, status):
        if status.name == "ORIENTATION":
            for kv in status.value:
                if kv.key == "yaw":
                    self._yaw = float(kv.value)

    def _move_cmd(self, lspeed, rspeed, t):
        from com_mytechia_robobo_ros_msgs.msg import KeyValue

        self._command("MOVE", 0, [
            KeyValue("lspeed", str(lspeed)), KeyValue("rspeed", str(rspeed)),
            KeyValue("time", str(t)),
        ])

    def move(self, t, speed):
        self._move_cmd(speed, speed, t)

    def turn(self, t, speed):
        self._move_cmd(speed, -speed, t)

    def stop(self):
        from com_mytechia_robobo_ros_msgs.msg import KeyValue

        self._command("MOVE-FOREVER", 0, [
            KeyValue("lspeed", "forward"), KeyValue("rspeed", "forward"),
            KeyValue("speed", "0"),
        ])

    def yaw(self):
        return self._yaw

    def sleep(self, seconds):
        time.sleep(seconds)


class _RosImageFeed:
    """cv_bridge Image-topic subscriber holding the latest RGB frame
    (the reference's ImageCallback pattern, real_robobo_server.py:283-317,
    gazebo_server.py:25-63). ``get()`` blocks briefly until the first
    frame arrives so episode 0 never observes an all-black image."""

    def __init__(self, topic: str, timeout: float = 5.0):
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image

        self._bridge = CvBridge()
        self._img = None
        self._timeout = timeout
        self._sub = rospy.Subscriber(topic, Image, self._cb, queue_size=1)

    def _cb(self, msg):
        try:
            self._img = self._bridge.imgmsg_to_cv2(msg, "rgb8")
        except Exception as exc:  # CvBridgeError
            printRed(f"CvBridgeError: {exc}")

    def get(self) -> np.ndarray:
        deadline = time.time() + self._timeout
        while self._img is None and time.time() < deadline:
            time.sleep(0.05)
        if self._img is None:
            printRed("No camera frame received yet; returning zeros")
            return np.zeros((224, 224, 3), np.uint8)
        return self._img


# ---------------------------------------------------------------------------
# Server base: ZMQ PAIR loop speaking the reference protocol
# ---------------------------------------------------------------------------

class RobotServerBase:
    """Shared ZMQ loop. Subclasses implement ``handle(msg) -> (state, image)``
    where state is the JSON reply dict and image the uint8 camera frame."""

    def __init__(self, port: int):
        self.context, self.socket = connect_pair(port, server=True)
        printGreen(f"{type(self).__name__} listening on port {port}")

    def serve_forever(self):
        while True:
            msg = self.socket.recv_json()
            if msg.get("command") == "exit":
                printGreen("Received exit signal, quitting...")
                self.socket.close()
                return
            state, image = self.handle(msg)
            self.socket.send_json(state)
            sendMatrix(self.socket, np.ascontiguousarray(image, np.uint8))

    def handle(self, msg):
        raise NotImplementedError


class RoboboServer(RobotServerBase):
    """Full-fidelity Robobo server (real_robobo_server.py): timed open-loop
    grid motion + colour-area target detection. The reward is +1 when the
    target's detected area has shrunk by more than MIN_DELTA_AREA relative
    to the calibrated TARGET_INITIAL_AREA (the robot covering the target),
    −1 on a grid-boundary bump (real_robobo_server.py:404-432)."""

    def __init__(self, port: int, rig=None, get_image=None,
                 second_cam=None, data_folder="robobo_2nd_cam"):
        super().__init__(port)
        if rig is None:
            rig = RosRoboboRig()
        self.motion = RoboboMotion(rig)
        if get_image is None:
            # Real run: subscribe to the camera topic like the reference's
            # ImageCallback (real_robobo_server.py:311-317).
            feed = _RosImageFeed(C.Robobo.IMAGE_TOPIC)
            get_image = feed.get
            if second_cam is None and C.Robobo.SECOND_CAM_TOPIC is not None:
                second_cam = _RosImageFeed(C.Robobo.SECOND_CAM_TOPIC).get
        self._get_image = get_image
        self._second_cam = second_cam
        self._data_folder = data_folder
        self._episode_idx = -1
        self._episode_step = 0
        # Calibrate the yaw reference as the reference does: a left/right
        # wiggle then record north (real_robobo_server.py:336-340).
        if rig.__class__ is RosRoboboRig:
            rig.turn(self.motion.compute_time("left"), -self.motion.SPEED)
            rig.turn(self.motion.compute_time("right"), self.motion.SPEED)
        self.motion.init_yaw_north()

    def handle(self, msg):
        cfg = C.Robobo
        command = msg.get("command", "")
        has_bumped = False
        if command == "reset":
            # The server cannot teleport the physical robot, so the tracked
            # grid position deliberately survives resets — matching the
            # reference's action-is-None reset path
            # (real_robobo_server.py:346-350) where robobo.position is
            # never reinitialised. Only episode bookkeeping resets.
            self._episode_idx += 1
            self._episode_step = 0
        elif command == "action":
            has_bumped = self.motion.apply_move(int(msg["action"]))
        else:
            raise ValueError(f"Unknown command: {msg}")

        image = self._get_image()
        cx, cy, area, error = find_target(image)
        delta_area_rate = (
            cfg.TARGET_INITIAL_AREA - area
        ) / cfg.TARGET_INITIAL_AREA

        reward = 0
        if delta_area_rate > cfg.MIN_DELTA_AREA:
            reward = 1
        if has_bumped:
            reward = -1

        if self._second_cam is not None:
            folder = os.path.join(
                self._data_folder, f"record_{self._episode_idx:03d}"
            )
            os.makedirs(folder, exist_ok=True)
            np.save(
                os.path.join(folder, f"frame{self._episode_step:06d}.npy"),
                self._second_cam(),
            )
            self._episode_step += 1

        state = {
            "position": list(self.motion.position),
            "reward": int(reward),
            "target_pos": [int(cx), int(cy)],
        }
        return state, image


# ---------------------------------------------------------------------------
# Baxter servers
# ---------------------------------------------------------------------------

def change_coordinate_system(point, origin, quaternion):
    """Express `point` in the frame at `origin` with orientation
    `quaternion` (x, y, z, w): R(q)^T (point - origin) — the
    arm_scenario_experiments `change_CS` used to report the Gazebo button
    position relative to the Baxter base (gazebo_server.py:143-146)."""
    x, y, z, w = quaternion
    # Rotation matrix of q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return R.T @ (np.asarray(point, np.float64) - np.asarray(origin, np.float64))


class RosBaxterRig:
    """Baxter actuation through baxter_interface + IK. ``ik_move`` returns
    False when the IK service finds no solution — the server then keeps the
    previous end-effector position (gazebo_server.py:127-137).

    Sensing: subscribes to the robot camera (cfg.IMAGE_TOPIC) via
    cv_bridge like the reference (gazebo_server.py:63,
    real_baxter_server.py), and in Gazebo wires the simulated button
    (arm_scenario_experiments Button.is_pressed / get_state,
    gazebo_server.py:70-75) plus the Baxter base pose used to express the
    button position in the base frame."""

    def __init__(self, cfg):
        import baxter_interface

        self.cfg = cfg
        self.arm = baxter_interface.Limb("left")
        self._ee = np.array(cfg.LEFT_ARM_INIT_POS, np.float64)
        self._camera = _RosImageFeed(cfg.IMAGE_TOPIC)
        # Gazebo-only instrumented button + baxter model state. Wrapping
        # the robot model in Button matches the reference exactly
        # (gazebo_server.py:69-74 constructs arm_sim.Button('baxter') to
        # read the model pose). Each handle is guarded independently and
        # against ANY failure, not just ImportError — on a physical Baxter
        # (or Gazebo without the model) construction can raise ROS
        # topic/service errors, and the rig must degrade to its stubbed
        # sensing instead of crashing.
        self._button = None
        self._baxter_model = None
        try:
            from arm_scenario_experiments import Button
        except ImportError:
            Button = None
        if Button is not None:
            try:
                self._button = Button("button1")
            except Exception:
                pass
            try:
                self._baxter_model = Button("baxter")
            except Exception:
                pass

    def ee_position(self):
        return self._ee.copy()

    def ik_move(self, position) -> bool:
        from baxter_pykdl import baxter_kinematics

        kin = baxter_kinematics("left")
        joints = kin.inverse_kinematics(list(map(float, position)))
        if joints is None:
            return False
        names = self.arm.joint_names()
        self.arm.move_to_joint_positions(dict(zip(names, joints)), timeout=3)
        self._ee = np.asarray(position, np.float64)
        return True

    def init_pose(self):
        self.ik_move(self.cfg.LEFT_ARM_INIT_POS)

    def enable(self):
        import baxter_interface

        rs = baxter_interface.RobotEnable(baxter_interface.CHECK_VERSION)
        if not rs.state().enabled:
            rs.enable()

    def button_pressed(self) -> bool:
        """Simulated button state in Gazebo (gazebo_server.py:152);
        False on a physical Baxter, which has no instrumented button."""
        if self._button is not None:
            return bool(self._button.is_pressed())
        return False

    def button_position(self):
        if self._button is not None:
            p = self._button.get_state().pose.position
            return np.array([p.x, p.y, p.z], np.float64)
        return np.array(getattr(self.cfg, "BUTTON_POS", [0.7, 0.1, self.cfg.Z_TABLE]))

    def base_pose(self):
        """Baxter base (position, quaternion) from the Gazebo model state
        (gazebo_server.py:74-79); identity for a physical robot whose
        base frame IS the world frame of the calibration."""
        if self._baxter_model is not None:
            pose = self._baxter_model.get_state().pose
            pos = np.array([pose.position.x, pose.position.y, pose.position.z])
            quat = np.array([
                pose.orientation.x, pose.orientation.y,
                pose.orientation.z, pose.orientation.w,
            ])
            return pos, quat
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])

    def image(self):
        return self._camera.get()


class BaxterServerBase(RobotServerBase):
    """Shared Baxter loop: candidate = ee + (dx,dy,dz); reject the move if
    IK fails; subclasses define the reward + reported button position."""

    def __init__(self, port: int, rig=None, cfg=None):
        super().__init__(port)
        self.cfg = cfg
        self.rig = rig if rig is not None else RosBaxterRig(cfg)

    def handle(self, msg):
        command = msg.get("command", "")
        if command == "reset":
            self.reset_robot()
        elif command == "action":
            candidate = self.rig.ee_position() + np.asarray(msg["action"])
            if not self.rig.ik_move(candidate):
                printRed("IK found no solution, keeping previous position")
        else:
            raise ValueError(f"Unknown command: {msg}")
        reward, button_pos = self.reward_and_button()
        state = {
            "position": list(map(float, self.rig.ee_position())),
            "reward": int(reward),
            "button_pos": list(map(float, button_pos)),
        }
        return state, self.rig.image()

    def reset_robot(self):
        raise NotImplementedError

    def reward_and_button(self):
        raise NotImplementedError


class GazeboBaxterServer(BaxterServerBase):
    """Baxter in Gazebo (gazebo_server.py): reward is the *simulated button
    state* (pressed or not), and the button position is reported relative
    to the Baxter base frame."""

    def __init__(self, port: int, rig=None):
        super().__init__(port, rig=rig, cfg=C.BaxterGazebo)

    def reset_robot(self):
        self.rig.init_pose()

    def reward_and_button(self):
        origin, quat = self.rig.base_pose()
        button_rel = change_coordinate_system(
            self.rig.button_position(), origin, quat
        )
        return int(self.rig.button_pressed()), button_rel


class RealBaxterServer(BaxterServerBase):
    """Physical Baxter (real_baxter_server.py): there is no instrumented
    button, so the reward is distance-to-calibrated-button-position under
    DIST_TO_TARGET_THRESHOLD, and reset re-enables the robot first."""

    def __init__(self, port: int, rig=None):
        super().__init__(port, rig=rig, cfg=C.RealBaxter)

    def reset_robot(self):
        self.rig.enable()
        self.rig.init_pose()

    def reward_and_button(self):
        button = np.asarray(self.cfg.BUTTON_POS)
        dist = np.linalg.norm(button - self.rig.ee_position())
        return int(dist < self.cfg.DIST_TO_TARGET_THRESHOLD), button


# Backwards-compatible alias (pre-split API).
BaxterServer = GazeboBaxterServer


# ---------------------------------------------------------------------------
# Omnirobot server (real robot; simulator lives in sim_server.py)
# ---------------------------------------------------------------------------

class OmnirobotServer(RobotServerBase):
    """Real Omnirobot: position commands via ROS topics, marker pose
    feedback (omnirobot_server.py). Uses the same boundary-checked step
    logic as the simulator kernel."""

    def __init__(self, port: int):
        super().__init__(port)
        import rospy
        from cv_bridge import CvBridge
        from geometry_msgs.msg import Twist, Vector3
        from sensor_msgs.msg import Image

        self.rospy = rospy
        self.bridge = CvBridge()
        rospy.init_node("srl_tpu_torch_omnirobot_server", anonymous=True)
        self.cmd_pub = rospy.Publisher("/cmd_vel", Twist, queue_size=1)
        self.pos_cmd_pub = rospy.Publisher(
            "/position_commands", Vector3, queue_size=1
        )
        self.image = np.zeros((224, 224, 3), np.uint8)
        self.robot_pos = np.zeros(2)
        self.target_pos = np.zeros(2)
        self.reward = 0
        rospy.Subscriber(C.Omnirobot.IMAGE_TOPIC, Image, self._image_cb)

    def _image_cb(self, msg):
        self.image = self.bridge.imgmsg_to_cv2(msg, "rgb8")

    def _publish_position(self, pos):
        from geometry_msgs.msg import Vector3

        self.pos_cmd_pub.publish(Vector3(pos[0], pos[1], 0))
        time.sleep(1.0 / C.Omnirobot.RL_CONTROL_FREQ)

    def handle(self, msg):
        cfg = C.Omnirobot
        command = msg.get("command", "")
        if command == "reset":
            rng = np.random.RandomState()
            self.robot_pos = rng.uniform(cfg.INIT_MIN_X, cfg.INIT_MAX_X, 2)
            self._publish_position(self.robot_pos)
            self.reward = 0
        elif command == "action":
            if msg.get("is_discrete", True):
                deltas = {
                    0: (cfg.STEP_DISTANCE, 0), 1: (-cfg.STEP_DISTANCE, 0),
                    2: (0, cfg.STEP_DISTANCE), 3: (0, -cfg.STEP_DISTANCE),
                    4: (0, 0),
                }
                d = np.array(deltas[int(msg["action"])])
            else:
                d = np.asarray(msg["action"])
            new = self.robot_pos + d
            bumped = not (
                cfg.MIN_X < new[0] < cfg.MAX_X
                and cfg.MIN_Y < new[1] < cfg.MAX_Y
            )
            if not bumped:
                self.robot_pos = new
                self._publish_position(new)
            dist = np.linalg.norm(self.robot_pos - self.target_pos)
            if dist < cfg.DIST_TO_TARGET_THRESHOLD:
                self.reward = cfg.REWARD_TARGET_REACH
            elif bumped:
                self.reward = cfg.REWARD_BUMP_WALL
            else:
                self.reward = cfg.REWARD_NOTHING
        else:
            raise ValueError(f"Unknown command: {msg}")
        state = {
            "reward": int(self.reward),
            "position": self.robot_pos.tolist(),
            "target_pos": self.target_pos.tolist(),
        }
        return state, self.image


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--robot", type=str, required=True,
        choices=["omnirobot", "baxter", "real_baxter", "robobo"],
    )
    parser.add_argument("--port", type=int, default=C.SERVER_PORT)
    args = parser.parse_args(argv)
    if not _require_ros():
        raise SystemExit(1)
    import rospy

    rospy.init_node(f"srl_tpu_torch_{args.robot}_server", anonymous=True)
    if args.robot == "omnirobot":
        server = OmnirobotServer(args.port)
    elif args.robot == "baxter":
        server = GazeboBaxterServer(args.port)
    elif args.robot == "real_baxter":
        server = RealBaxterServer(args.port)
    else:
        server = RoboboServer(args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()

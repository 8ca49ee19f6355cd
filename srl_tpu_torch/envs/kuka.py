"""Kuka iiwa button-pushing envs, batched over N (counterpart of
srl_tpu/envs/kuka.py).

Same constants, formulas and variants as the reference: the arm is the
analytic FK / closed-form IK / servo chain of ``ops/kinematics.py``, contacts
are geometric predicates over the finger tip, and pixel observations come
from the ray tracer of ``ops/render3d.py`` (the CUDA kernel on a card).

Random numbers: a reset draws the random-target button offsets, the
distractor placements and the 5 random init actions; a step draws one normal
for the action-magnitude noise and, with distractors, two for the ball kick.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srl_tpu_torch.core.device import host_tensor
from srl_tpu_torch.core.env import BatchedEnv
from srl_tpu_torch.core.spaces import Box, Discrete, Space
from srl_tpu_torch.ops import kinematics as kin

MAX_STEPS = 1000
MAX_STEPS_LONG = 1500
N_CONTACTS_BEFORE_TERMINATION = 5
N_STEPS_OUTSIDE_SAFETY_SPHERE = 5000
RENDER_WIDTH = 224
RENDER_HEIGHT = 224
Z_TABLE = -0.2
N_DISCRETE_ACTIONS = 6
DELTA_V = 0.03
DELTA_V_CONTINUOUS = 0.0035
DELTA_THETA = 0.1
NOISE_STD = 0.01
NOISE_STD_CONTINUOUS = 0.0001
NOISE_STD_JOINTS = 0.002
N_RANDOM_ACTIONS_AT_INIT = 5
BUTTON_DISTANCE_HEIGHT = 0.28
BUTTON_BASE_RADIUS = 0.10
BUTTON_BASE_TOP = Z_TABLE + 0.030
BUTTON_CAP_RADIUS = 0.09
BUTTON_CAP_TOP = Z_TABLE + 0.045
BUTTON_CAP_PRESSED = BUTTON_CAP_TOP - 0.01
CONTACT_EPS = 0.01
BUTTON_SPEED = 0.001
BUTTON_YMIN = -0.3
BUTTON_YMAX = 0.3
N_DISTRACTORS = 10
BALL_FORCE_SPEED = 0.004
DISTRACTOR_RADIUS = 0.05
DISTRACTOR_TOP = Z_TABLE + 0.08
BALL_RADIUS = 0.03
TIP_RADIUS = 0.02

GRIPPER_JOINTS = np.array(
    [0.000048, -0.299912, 0.0, -0.000043, 0.29996, 0.0, -0.0002], np.float32
)


@dataclasses.dataclass
class KukaState:
    q: torch.Tensor  # [N, 7] arm joint angles
    tip: torch.Tensor  # [N, 3] finger tip (cached FK, after the contact block)
    gripper: torch.Tensor  # [N, 3] gripper link
    flange: torch.Tensor  # [N, 3] flange (cached FK, control_step input)
    ee_target: torch.Tensor  # [N, 3] integrated clipped effector target
    effector_angle: torch.Tensor  # [N]
    buttons: torch.Tensor  # [N, n_buttons, 3] button TOP positions
    button_speed: torch.Tensor  # [N]
    n_contacts: torch.Tensor  # [N, n_buttons] int32
    goal_id: torch.Tensor  # [N] int32
    n_steps_outside: torch.Tensor  # [N] int32
    step_count: torch.Tensor  # [N] int32
    terminated: torch.Tensor  # [N] bool
    distractors: torch.Tensor  # [N, n_distractors, 3]
    ball: torch.Tensor  # [N, 6] position + velocity


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, -1))


class KukaButtonEnv(BatchedEnv):
    """Kuka iiwa arm pushing a button on a table."""

    name = "KukaButtonGymEnv-v0"

    def __init__(
        self,
        n_buttons: int = 1,
        moving_button: bool = False,
        rand_objects: bool = False,
        is_discrete: bool = True,
        action_joints: bool = False,
        multi_view: bool = False,
        shape_reward: bool = False,
        random_target: bool = False,
        force_down: bool = True,
        max_distance: float = 0.8,
        action_repeat: int = 1,
        srl_model: str = "raw_pixels",
        state_dim: int = -1,
        max_steps: int = None,
        noise_std: float = NOISE_STD,
        null_space: bool = False,
        render_scale: int = 1,
        coarse_obs: bool = False,
    ):
        if RENDER_HEIGHT % render_scale:
            raise ValueError(f"render_scale {render_scale} does not divide {RENDER_HEIGHT}")
        if coarse_obs and render_scale == 1:
            raise ValueError("coarse_obs needs render_scale > 1")
        self.render_scale = int(render_scale)
        self.coarse_obs = bool(coarse_obs)
        self.obs_coarse_scale = self.render_scale if self.coarse_obs else 1
        self.null_space = null_space
        self.n_buttons = n_buttons
        self.moving_button = moving_button
        self.rand_objects = rand_objects
        self.is_discrete = is_discrete
        self.action_joints = action_joints
        self.multi_view = multi_view
        self.shape_reward = shape_reward
        self.random_target = random_target
        self.force_down = force_down
        self.max_distance = float(max_distance)
        self.action_repeat = int(action_repeat)
        self.srl_model = srl_model
        self.relative_pos = True
        self.state_dim = state_dim
        self.noise_std = float(noise_std)
        if max_steps is None:
            max_steps = MAX_STEPS_LONG if (n_buttons > 1 or moving_button) else MAX_STEPS
        self.max_steps = max_steps
        small = not random_target and n_buttons == 1
        if small:
            self._ws_lo = np.array([0.50, -0.17, 0.0], np.float32)
            self._ws_hi = np.array([0.65, 0.22, 0.5], np.float32)
        else:
            self._ws_lo = np.array([0.35, -0.30, 0.0], np.float32)
            self._ws_hi = np.array([0.65, 0.30, 0.5], np.float32)
        self._n_distract = N_DISTRACTORS if rand_objects else 0

    # ------------------------------------------------------------------
    @property
    def action_space(self) -> Space:
        if self.is_discrete:
            return Discrete(N_DISCRETE_ACTIONS)
        if self.action_joints:
            return Box(-1.0, 1.0, (7,))
        return Box(-1.0, 1.0, (3,))

    @property
    def observation_space(self) -> Space:
        if self.srl_model == "raw_pixels":
            channels = 6 if self.multi_view else 3
            s = self.obs_coarse_scale
            return Box(0, 255, (RENDER_HEIGHT // s, RENDER_WIDTH // s, channels),
                       np.uint8)
        dims = {"ground_truth": 3, "joints": 14, "joints_position": 17}
        return Box(-np.inf, np.inf, (dims.get(self.srl_model, 3),))

    def _clip_ws(self, x: torch.Tensor) -> torch.Tensor:
        lo = host_tensor(self._ws_lo, device=x.device)
        hi = host_tensor(self._ws_hi, device=x.device)
        return torch.clamp(x, lo, hi)

    # ------------------------------------------------------------------
    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        """``button_u``: with random_target, U[-1, 1) [n, 2] for one button,
        U[0, 1) [n, 2, 2] for two; ``object_u``: U[-1, 1) [n, 10, 2]
        distractor placements; ``init_u`` U[0, 1) and ``init_axis`` in
        {0, 1, 2}, [n, 5], the discrete init actions' sign and axis, or
        ``init_dir`` N(0, 1) [n, 5, 3] for continuous ones."""
        dev = gen.device
        rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        noise = {}
        if self.random_target:
            noise["button_u"] = (rand(n, 2) * 2 - 1 if self.n_buttons == 1
                                 else rand(n, 2, 2))
        if self._n_distract:
            noise["object_u"] = rand(n, self._n_distract, 2) * 2 - 1
        k = N_RANDOM_ACTIONS_AT_INIT
        if self.is_discrete:
            noise["init_u"] = rand(n, k)
            noise["init_axis"] = torch.randint(0, 3, (n, k), generator=gen,
                                               device=dev)
        else:
            noise["init_dir"] = torch.randn((n, k, 3), generator=gen, device=dev)
        return noise

    def _buttons(self, noise: dict, n: int, dev) -> torch.Tensor:
        f32 = dict(dtype=torch.float32, device=dev)
        z = torch.full((n, 1), Z_TABLE + BUTTON_DISTANCE_HEIGHT, **f32)
        if self.n_buttons == 1:
            base = host_tensor([0.5, 0.0], **f32).expand(n, 2)
            if self.random_target:
                base = base + host_tensor([0.15, 0.3], **f32) * noise["button_u"]
            return torch.cat([base, z], 1)[:, None]
        b1 = host_tensor([0.5, 0.125], **f32).expand(n, 2)
        b2 = host_tensor([0.5, -0.125], **f32).expand(n, 2)
        if self.random_target:
            u = noise["button_u"]
            scale = host_tensor([0.15, 0.175], **f32)
            b1 = b1 + scale * torch.stack([u[:, 0, 0] * 2 - 1, u[:, 0, 1]], -1)
            b2 = b2 + scale * torch.stack([u[:, 1, 0] * 2 - 1, -u[:, 1, 1]], -1)
        return torch.stack([torch.cat([b1, z], 1), torch.cat([b2, z], 1)], 1)

    def apply_reset(self, noise: dict) -> KukaState:
        init = noise["init_u"] if self.is_discrete else noise["init_dir"]
        n, dev = init.shape[0], init.device
        f32 = dict(dtype=torch.float32, device=dev)
        buttons = self._buttons(noise, n, dev)

        if self._n_distract:
            xy = (host_tensor([0.5, 0.0], **f32)
                  + host_tensor([0.15, 0.3], **f32) * noise["object_u"])
            inside = ((torch.abs(xy[..., 0] - buttons[:, :1, 0]) <= 0.1)
                      & (torch.abs(xy[..., 1] - buttons[:, :1, 1]) <= 0.1))
            z = torch.where(inside, -5.0, Z_TABLE + 0.03)
            distractors = torch.cat([xy, z[..., None]], -1)
        else:
            distractors = torch.zeros((n, 0, 3), **f32)
        ball = host_tensor([0.25, -0.2, Z_TABLE + 0.03, 0.0, 0.0, 0.0],
                           **f32).expand(n, 6).clone()

        # Settled arm plus 5 random init actions.
        q = host_tensor(kin.settled_rest_q(), device=dev).expand(n, 7)
        ee_target = host_tensor(kin.REST_EE_TARGET, device=dev).expand(n, 3)
        for i in range(N_RANDOM_ACTIONS_AT_INIT):
            if self.is_discrete:
                sign = torch.where(noise["init_u"][:, i] > 0.5, 1.0, -1.0)
                delta = torch.zeros((n, 3), **f32).scatter(
                    1, noise["init_axis"][:, i:i + 1].long(),
                    (sign * DELTA_V)[:, None])
            else:
                direction = noise["init_dir"][:, i]
                direction = direction / _norm(direction)[:, None]
                delta = DELTA_V_CONTINUOUS * direction
            ee_target = self._clip_ws(ee_target + delta)
            q = kin.control_step(q, ee_target, null_space=self.null_space)

        flange, gripper, tip = kin.fk_points(q)
        i32 = dict(dtype=torch.int32, device=dev)
        return KukaState(
            q=q, tip=tip, gripper=gripper, flange=flange, ee_target=ee_target,
            effector_angle=torch.zeros(n, **f32),
            buttons=buttons,
            button_speed=torch.full((n,), BUTTON_SPEED, **f32),
            n_contacts=torch.zeros((n, self.n_buttons), **i32),
            goal_id=torch.zeros(n, **i32),
            n_steps_outside=torch.zeros(n, **i32),
            step_count=torch.zeros(n, **i32),
            terminated=torch.zeros(n, dtype=torch.bool, device=dev),
            distractors=distractors,
            ball=ball,
        )

    # ------------------------------------------------------------------
    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        """``dv``: N(0, 1) [n], the action-magnitude noise; ``kick``:
        N(0, 1) [n, 2], the ball kick direction (distractor envs only)."""
        noise = {"dv": torch.randn((n,), generator=gen, device=gen.device)}
        if self.rand_objects:
            noise["kick"] = torch.randn((n, 2), generator=gen, device=gen.device)
        return noise

    def _action_to_delta(self, dv_noise, action):
        if self.is_discrete:
            dv = DELTA_V + dv_noise * self.noise_std
            zero = torch.zeros_like(dv)
            dxs = torch.stack([-dv, dv, zero, zero, zero, zero], -1)
            dys = torch.stack([zero, zero, -dv, dv, zero, zero], -1)
            if self.force_down:
                dzs = torch.stack([zero, zero, zero, zero, -dv, -dv], -1)
            else:
                dzs = torch.stack([zero, zero, zero, zero, -dv, dv], -1)
            a = action.long()[:, None]
            return torch.cat([dxs.gather(1, a), dys.gather(1, a), dzs.gather(1, a)], 1)
        dv = DELTA_V_CONTINUOUS + dv_noise * NOISE_STD_CONTINUOUS
        act = action.to(torch.float32)
        dz = act[:, 2] * dv
        if self.force_down:
            dz = -torch.abs(dz)
        return torch.stack([act[:, 0] * dv, act[:, 1] * dv, dz], -1)

    def _blocked(self, buttons, q_old, tip_old, grip_old, fl_old, q_new):
        """Roll a sub-step back where the tip would sink below its support."""
        fl_new, grip_new, tip_new = kin.fk_points(q_new)
        xy = _norm(buttons[:, :, :2] - tip_new[:, None, :2])
        floor = torch.where(
            torch.any(xy <= BUTTON_CAP_RADIUS, 1), BUTTON_CAP_PRESSED,
            torch.where(torch.any(xy <= BUTTON_BASE_RADIUS, 1), BUTTON_BASE_TOP,
                        Z_TABLE))
        penet = (tip_new[:, 2] < floor)[:, None]
        return (torch.where(penet, q_old, q_new), torch.where(penet, tip_old, tip_new),
                torch.where(penet, grip_old, grip_new), torch.where(penet, fl_old, fl_new))

    def apply_step(self, state: KukaState, action, noise: dict):
        n = state.q.shape[0]
        rows = torch.arange(n, device=state.q.device)
        buttons = state.buttons
        button_speed = state.button_speed
        if self.moving_button:
            y = buttons[:, 0, 1]
            button_speed = torch.where((y > BUTTON_YMAX) | (y < BUTTON_YMIN),
                                       -button_speed, button_speed)
            buttons = buttons.clone()
            buttons[:, 0, 1] = y + button_speed

        q, tip, gripper, flange = state.q, state.tip, state.gripper, state.flange
        if self.action_joints:
            d_theta = DELTA_THETA + noise["dv"] * NOISE_STD_JOINTS
            q_target = action.to(torch.float32) * d_theta[:, None] + state.q
            ee_target = state.ee_target
            for _ in range(self.action_repeat):
                q, tip, gripper, flange = self._blocked(
                    buttons, q, tip, gripper, flange, kin.servo_step(q, q_target))
        else:
            delta = self._action_to_delta(noise["dv"], action)
            ee_target = self._clip_ws(state.ee_target + delta)
            for _ in range(self.action_repeat):
                q, tip, gripper, flange = self._blocked(
                    buttons, q, tip, gripper, flange,
                    kin.control_step(q, ee_target, null_space=self.null_space,
                                     p_cur=flange))

        step_count = state.step_count + self.action_repeat

        ball, distractors = state.ball, state.distractors
        if self.rand_objects:
            # Kick when the step counter crosses 10.
            kick = ((state.step_count < 10) & (step_count >= 10))[:, None]
            direction = torch.abs(noise["kick"])
            direction = direction / (_norm(direction) + 1e-8)[:, None]
            vel = torch.where(kick, direction * BALL_FORCE_SPEED, ball[:, 3:5])
            rel_tb = ball[:, :2] - tip[:, :2]
            d_tb = _norm(rel_tb)
            tip_low_ball = tip[:, 2] <= Z_TABLE + 2 * BALL_RADIUS + CONTACT_EPS
            tip_hits_ball = ((d_tb <= BALL_RADIUS + TIP_RADIUS) & tip_low_ball)[:, None]
            vel = torch.where(
                tip_hits_ball,
                rel_tb / torch.clamp(d_tb, min=1e-6)[:, None] * BALL_FORCE_SPEED, vel)
            ball = torch.cat([ball[:, :2] + vel, ball[:, 2:3], vel, ball[:, 5:6]], 1)

            on_table = distractors[..., 2] > Z_TABLE

            def push_from(xy, center_xy, radius, active):
                rel = xy - center_xy[:, None]
                d = _norm(rel)
                overlap = (d < radius + DISTRACTOR_RADIUS) & on_table & active
                dirn = rel / torch.clamp(d, min=1e-6)[..., None]
                target = center_xy[:, None] + dirn * (radius + DISTRACTOR_RADIUS)
                return torch.where(overlap[..., None], target, xy), overlap

            tip_low = (tip[:, 2] <= DISTRACTOR_TOP + CONTACT_EPS)[:, None]
            d_xy, _ = push_from(distractors[..., :2], tip[:, :2], TIP_RADIUS, tip_low)
            d_xy, ball_hit = push_from(d_xy, ball[:, :2], BALL_RADIUS, True)
            distractors = torch.cat([d_xy, distractors[..., 2:]], -1)
            vel = torch.where(torch.any(ball_hit, 1)[:, None], 0.0, vel)
            ball = torch.cat([ball[:, :3], vel, ball[:, 5:6]], 1)

        # Contacts and reward.
        goal_id = state.goal_id
        gi = goal_id.long()
        distance = _norm(buttons[rows, gi] - gripper)
        xy_dist_all = _norm(buttons[:, :, :2] - tip[:, None, :2])
        contact_all = (xy_dist_all <= BUTTON_CAP_RADIUS) & (
            tip[:, 2:3] <= BUTTON_CAP_TOP + CONTACT_EPS)
        goal_contact = contact_all[rows, gi]
        table_contact = tip[:, 2] <= Z_TABLE + CONTACT_EPS
        n_contacts = state.n_contacts + torch.nn.functional.one_hot(
            gi, self.n_buttons).to(torch.int32) * goal_contact.to(torch.int32)[:, None]

        if self.n_buttons == 1:
            reward = goal_contact.to(torch.float32)
            pressed_out = n_contacts[:, 0] >= N_CONTACTS_BEFORE_TERMINATION
            outside_limit = N_STEPS_OUTSIDE_SAFETY_SPHERE
        else:
            # Sparse reward only for the last button; advance the goal once
            # the current button has its 5 contacts.
            reward = torch.where(goal_id == self.n_buttons - 1,
                                 goal_contact.to(torch.float32), 0.0)
            advance = ((n_contacts[rows, gi] >= N_CONTACTS_BEFORE_TERMINATION)
                       & (goal_id < self.n_buttons - 1))
            goal_id = torch.where(advance, goal_id + 1, goal_id)
            pressed_out = n_contacts[:, -1] >= N_CONTACTS_BEFORE_TERMINATION
            outside_limit = N_STEPS_OUTSIDE_SAFETY_SPHERE - 1

        outside = (distance > self.max_distance) | table_contact
        reward = torch.where(outside, -1.0, reward)
        n_steps_outside = torch.where(outside, state.n_steps_outside + 1, 0)
        terminated = (state.terminated | table_contact | pressed_out
                      | (n_steps_outside >= outside_limit))

        if self.shape_reward:
            if self.is_discrete and self.n_buttons == 1:
                reward = -distance
            elif self.n_buttons == 1:
                reward = torch.where(
                    terminated & (reward > 0), 50.0,
                    torch.where(terminated & (reward < 0), -250.0, -distance))
            else:
                reward = torch.where(
                    terminated & (reward > 0), 50.0,
                    torch.where(
                        (n_contacts[rows, goal_id.long()] < N_CONTACTS_BEFORE_TERMINATION)
                        & goal_contact, 25.0,
                        torch.where(table_contact, -250.0,
                                    torch.where(distance > self.max_distance,
                                                -20.0, -distance))))

        done = terminated | (step_count > self.max_steps)
        new_state = dataclasses.replace(
            state, q=q, tip=tip, gripper=gripper, flange=flange,
            ee_target=ee_target, buttons=buttons, button_speed=button_speed,
            n_contacts=n_contacts, goal_id=goal_id,
            n_steps_outside=n_steps_outside, step_count=step_count,
            terminated=terminated, distractors=distractors, ball=ball)
        return new_state, reward.to(torch.float32), done

    # ------------------------------------------------------------------
    @staticmethod
    def ground_truth_dim() -> int:
        return 3

    @staticmethod
    def joints_dim() -> int:
        return 14

    def ground_truth(self, state: KukaState) -> torch.Tensor:
        return state.gripper

    def target_pos(self, state: KukaState) -> torch.Tensor:
        rows = torch.arange(state.goal_id.shape[0], device=state.goal_id.device)
        return state.buttons[rows, state.goal_id.long()]

    def joints(self, state: KukaState) -> torch.Tensor:
        g = host_tensor(GRIPPER_JOINTS, device=state.q.device)
        return torch.cat([state.q, g.expand(state.q.shape[0], -1)], 1)

    def observe(self, state: KukaState) -> torch.Tensor:
        if self.srl_model == "ground_truth":
            return self.srl_state(state)
        if self.srl_model == "joints":
            return self.joints(state)
        if self.srl_model == "joints_position":
            return torch.cat([self.srl_state(state), self.joints(state)], 1)
        return self.render_pixels(state)

    def render_pixels(self, state: KukaState) -> torch.Tensor:
        from srl_tpu_torch.ops.render3d import render_kuka

        return render_kuka(self, state)


class KukaRandButtonEnv(KukaButtonEnv):
    name = "KukaRandButtonGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("rand_objects", True)
        super().__init__(**kwargs)


class Kuka2ButtonEnv(KukaButtonEnv):
    name = "Kuka2ButtonGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("n_buttons", 2)
        kwargs.setdefault("max_distance", 2.0)
        kwargs.setdefault("force_down", False)
        kwargs.setdefault("null_space", True)
        super().__init__(**kwargs)


class KukaMovingButtonEnv(KukaButtonEnv):
    name = "KukaMovingButtonGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("moving_button", True)
        super().__init__(**kwargs)

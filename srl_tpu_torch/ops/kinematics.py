"""Batched kinematics of the Kuka iiwa arm (counterpart of
srl_tpu/ops/kinematics.py).

Every function takes a leading batch dimension of N envs: ``q`` is [N, 7],
positions are [N, 3]. The chain is evaluated on the scalar columns of R,
exactly as the reference does, so each step is a short list of elementwise
ops over [N] tensors.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from srl_tpu_torch.core.device import host_tensor

IIWA_OFFSETS_Z = (0.1575, 0.2025, 0.2045, 0.2155, 0.1845, 0.2155, 0.081)
# Joint axis kind: +1 -> Rz(q), +2 -> Ry(q), -2 -> Ry(-q) (axes z, y, z, -y,
# z, y, z of the iiwa model).
IIWA_AXIS_KINDS = (1, 2, 1, -2, 1, 2, 1)
BASE_POS = np.array([-0.1, 0.0, -0.15], dtype=np.float32)
TIP_OFFSET = 0.28
GRIPPER_OFFSET = 0.03
MAX_VELOCITY = 0.35
POSITION_GAIN = 0.3
TIMESTEP = 1.0 / 240.0
DQ_MAX = MAX_VELOCITY * TIMESTEP
R_DOWN = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
REST_Q = np.array(
    [0.006418, 0.113184, -0.011401, -1.289317, 0.005379, 1.737684, -0.006539],
    dtype=np.float32,
)
REST_EE_TARGET = np.array([0.537, 0.0, 0.5], dtype=np.float32)

_SHOULDER = BASE_POS + np.array([0.0, 0.0, 0.36], np.float32)
_UPPER_ARM = 0.42
_FOREARM = 0.40
_FLANGE_D = 0.081

NULL_LL = np.array([-0.967, -2.0, -2.96, -2.29, -2.96, -2.09, -3.05], np.float32)
NULL_UL = np.array([0.967, 2.0, 2.96, -0.19, 2.96, 2.09, 3.05], np.float32)
NULL_RP = np.array(
    [0.0, 0.0, 0.0, -0.5 * np.pi, 0.0, np.pi * 0.5 * 0.66, 0.0], np.float32
)
TASK_STEP = 0.002


def _const(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return host_tensor(x, torch.float32, like.device)


def fk(q: torch.Tensor):
    """Forward kinematics of [N, 7] joint angles.

    Returns (joint_positions [N,7,3], joint_axes_world [N,7,3], R_ee [N,3,3],
    p_flange [N,3], p_tip [N,3])."""
    base = _const(BASE_POS, q)
    one = torch.ones_like(q[:, 0])
    zero = torch.zeros_like(q[:, 0])
    px, py, pz = base[0] + zero, base[1] + zero, base[2] + zero
    c0 = (one, zero, zero)
    c1 = (zero, one, zero)
    c2 = (zero, zero, one)
    joint_pos, joint_axis = [], []
    for i in range(7):
        d = IIWA_OFFSETS_Z[i]
        px = px + d * c2[0]
        py = py + d * c2[1]
        pz = pz + d * c2[2]
        joint_pos.append(torch.stack([px, py, pz], -1))
        s, c = torch.sin(q[:, i]), torch.cos(q[:, i])
        if IIWA_AXIS_KINDS[i] == 1:
            joint_axis.append(torch.stack(c2, -1))
            n0 = tuple(c * a + s * b for a, b in zip(c0, c1))
            n1 = tuple(-s * a + c * b for a, b in zip(c0, c1))
            c0, c1 = n0, n1
        else:
            sgn = 1.0 if IIWA_AXIS_KINDS[i] == 2 else -1.0
            joint_axis.append(torch.stack([sgn * c1[0], sgn * c1[1], sgn * c1[2]], -1))
            se = sgn * s
            n0 = tuple(c * a - se * b for a, b in zip(c0, c2))
            n2 = tuple(se * a + c * b for a, b in zip(c0, c2))
            c0, c2 = n0, n2
    p_flange = torch.stack([px, py, pz], -1)
    col2 = torch.stack(c2, -1)
    p_tip = p_flange + TIP_OFFSET * col2
    R = torch.stack([torch.stack(c0, -1), torch.stack(c1, -1), col2], -1)
    return torch.stack(joint_pos, 1), torch.stack(joint_axis, 1), R, p_flange, p_tip


def tip_position(q: torch.Tensor) -> torch.Tensor:
    """[N, 3] fingertip positions of [N, 7] joint angles."""
    return fk(q)[4]


def gripper_position(q: torch.Tensor) -> torch.Tensor:
    """[N, 3] gripper-link positions (the reference's getArmPos)."""
    _, _, R, p_flange, _ = fk(q)
    return p_flange + GRIPPER_OFFSET * R[:, :, 2]


def fk_points(q: torch.Tensor):
    """(p_flange, p_gripper, p_tip), each [N, 3], from one FK pass."""
    _, _, R, p_flange, p_tip = fk(q)
    return p_flange, p_flange + GRIPPER_OFFSET * R[:, :, 2], p_tip


def ik_down(target_pos: torch.Tensor) -> torch.Tensor:
    """Closed-form IK with the flange pointing straight down, [N,3] -> [N,7]."""
    shoulder = _const(_SHOULDER, target_pos)
    wx = target_pos[:, 0] - shoulder[0]
    wy = target_pos[:, 1] - shoulder[1]
    wz = target_pos[:, 2] + np.float32(_FLANGE_D) - shoulder[2]
    r = torch.sqrt(wx * wx + wy * wy + 1e-12)
    q1 = torch.atan2(wy, wx)
    l2 = r * r + wz * wz
    a, b = _UPPER_ARM, _FOREARM
    c4 = torch.clamp((l2 - a * a - b * b) / (2.0 * a * b), -1.0, 1.0)
    elbow = torch.arccos(c4)
    length = torch.sqrt(l2)
    alpha = torch.arccos(
        torch.clamp((l2 + a * a - b * b) / (2.0 * a * length), -1.0, 1.0)
    )
    phi = torch.atan2(r, wz)
    q2 = phi - alpha
    q4 = -elbow
    q6 = np.pi - q2 + q4
    zero = torch.zeros_like(q1)
    return torch.stack([q1, q2, zero, q4, zero, q6, -q1], -1)


def ik_down_limited(target_pos: torch.Tensor) -> torch.Tensor:
    """Null-space-mode IK: ``ik_down`` clamped to the reference joint limits."""
    q = ik_down(target_pos)
    return torch.clamp(q, _const(NULL_LL, q), _const(NULL_UL, q))


def _orientation_error(R: torch.Tensor, R_d: torch.Tensor) -> torch.Tensor:
    e = (torch.linalg.cross(R[..., 0], R_d[..., 0])
         + torch.linalg.cross(R[..., 1], R_d[..., 1])
         + torch.linalg.cross(R[..., 2], R_d[..., 2]))
    return 0.5 * e


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve of A x = b for small SPD ``A`` [..., n, n],
    ``b`` [..., n]; every entry is a tensor over the leading dims."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for i in range(n):
        s = A[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(s)
        inv_d[i] = 1.0 / L[i][i]
        for j in range(i + 1, n):
            t = A[..., j, i]
            for k in range(i):
                t = t - L[j][k] * L[i][k]
            L[j][i] = t * inv_d[i]
    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t * inv_d[i]
    return torch.stack(x, -1)


def dls_ik(q: torch.Tensor, target_pos: torch.Tensor, n_iters: int = 3,
           damping: float = 0.1, null_space: bool = False,
           null_gain: float = 0.1) -> torch.Tensor:
    """Damped-least-squares IK toward (target_pos, down orientation), warm
    started from ``q`` [N, 7]."""
    R_d = _const(R_DOWN, q).expand(q.shape[0], 3, 3)
    lam2 = damping * damping
    eye6 = torch.eye(6, dtype=torch.float32, device=q.device)
    for _ in range(n_iters):
        joint_pos, joint_axis, R, p_flange, _ = fk(q)
        e = torch.cat([target_pos - p_flange, _orientation_error(R, R_d)], -1)
        lever = p_flange[:, None, :] - joint_pos
        J_v = torch.linalg.cross(joint_axis, lever)
        J = torch.cat([J_v, joint_axis], -1).transpose(1, 2)  # [N, 6, 7]
        JJt = J @ J.transpose(1, 2) + lam2 * eye6
        dq = (J.transpose(1, 2) @ spd_solve(JJt, e)[..., None])[..., 0]
        if null_space:
            # (J+ J) column by column: solve JJt x = J[:, :, col] for all 7.
            cols = spd_solve(JJt[:, None].expand(-1, 7, -1, -1), J.transpose(1, 2))
            JpJ = J.transpose(1, 2) @ cols.transpose(1, 2)
            dq_rest = null_gain * (_const(NULL_RP, q) - q)
            dq = dq + dq_rest - (JpJ @ dq_rest[..., None])[..., 0]
        q = q + dq
        if null_space:
            q = torch.clamp(q, _const(NULL_LL, q), _const(NULL_UL, q))
    return q


def servo_step(q: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """Proportional joint approach capped at maxVelocity * dt."""
    dq = torch.clamp(POSITION_GAIN * (q_target - q), -DQ_MAX, DQ_MAX)
    return q + dq


def control_step(q: torch.Tensor, ee_target: torch.Tensor,
                 null_space: bool = False, p_cur: torch.Tensor = None) -> torch.Tensor:
    """IK toward a point TASK_STEP ahead of the flange, then one servo step."""
    if p_cur is None:
        p_cur = fk(q)[3]
    delta = ee_target - p_cur
    dist = torch.sqrt(torch.sum(delta * delta, -1, keepdim=True)) + 1e-9
    t_int = p_cur + delta * (torch.clamp(dist, max=TASK_STEP) / dist)
    q_ik = ik_down_limited(t_int) if null_space else ik_down(t_int)
    return servo_step(q, q_ik)


@lru_cache(maxsize=1)
def settled_rest_q(n_steps: int = 500) -> np.ndarray:
    """The arm after the reference's 500 settle steps toward the rest target;
    the same for every episode, so it is computed once on the CPU."""
    q = torch.as_tensor(REST_Q)[None]
    target = torch.as_tensor(REST_EE_TARGET)[None]
    for _ in range(n_steps):
        q = control_step(q, target)
    return q[0].numpy()

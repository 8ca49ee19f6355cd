"""Frozen copy of the plain PyTorch in srl_tpu_torch/ops/render3d.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

Ray-traced Kuka renderer, its plain form (the counterpart of
srl_tpu/ops/pallas_render3d.py): each env's scene packed into one row of
floats (FK points, button xy, distractors and ball), every pixel of the
camera traced against it as torch ops over [N, pixels]. Rounding follows
the reference: where it computes a constant in Python doubles (``radius *
radius``, ``z - eye_z``), so does this, and the result is rounded to
float32 once.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import kinematics as kin
from . import kuka as kuka_env
from . import renderer3d as r3

BIG = r3.BIG


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_buttons: int
    n_pts: int
    n_distract: int
    trace_h: int
    trace_w: int
    up: int  # nearest-upsample factor fused into the store (1 = none)
    views: Tuple[str, ...]  # ("main",) or ("main", "aux")


# ---------------------------------------------------------------------------
# Intersection helpers, shared by the background planes and the twin. ``eye``
# is a tuple of Python floats in the twin (as in the reference kernel) and a
# float32 tensor for the background (as in the reference's planes).
# ---------------------------------------------------------------------------
def _composite(state, t, nx, ny, nz, color):
    t_best, bnx, bny, bnz, r, g, b = state
    closer = t < t_best
    cr, cg, cb = (float(c) for c in color)
    return (
        torch.minimum(t, t_best),
        torch.where(closer, nx, bnx),
        torch.where(closer, ny, bny),
        torch.where(closer, nz, bnz),
        torch.where(closer, cr, r),
        torch.where(closer, cg, g),
        torch.where(closer, cb, b),
    )


def _hit_floor(eye, dx, dy, dz, z):
    # A tensor numerator: ``float / tensor`` would be reciprocal-then-multiply.
    num = torch.as_tensor(z - eye[2], dtype=torch.float32)
    t = num / r3._safe(dz)
    return torch.where(t > 1e-4, t, BIG)


def _hit_aabb(eye, dx, dy, dz, center, half):
    t_near = torch.full_like(dx, -BIG)
    t_far = torch.full_like(dx, BIG)
    nx, ny, nz = (torch.zeros_like(dx) for _ in range(3))
    for axis, d in enumerate((dx, dy, dz)):
        inv = 1.0 / r3._safe(d)
        lo = (center[axis] - half[axis] - eye[axis]) * inv
        hi = (center[axis] + half[axis] - eye[axis]) * inv
        a_min = torch.minimum(lo, hi)
        a_max = torch.maximum(lo, hi)
        take = a_min > t_near
        sgn = -torch.sign(d)
        zero = torch.zeros_like(d)
        nx = torch.where(take, sgn if axis == 0 else zero, nx)
        ny = torch.where(take, sgn if axis == 1 else zero, ny)
        nz = torch.where(take, sgn if axis == 2 else zero, nz)
        t_near = torch.maximum(t_near, a_min)
        t_far = torch.minimum(t_far, a_max)
    hit = (t_near <= t_far) & (t_far > 1e-4) & (t_near > 1e-4)
    return torch.where(hit, t_near, BIG), nx, ny, nz


def _hit_vcylinder(eye, dx, dy, dz, cx, cy, radius, z_lo, z_hi):
    ox = eye[0] - cx
    oy = eye[1] - cy
    a = dx * dx + dy * dy
    bq = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = bq * bq - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-bq - sq) / (2 * r3._safe(a))
    z_at = eye[2] + t_side * dz
    side_ok = (disc > 0) & (t_side > 1e-4) & (z_at >= z_lo) & (z_at <= z_hi)
    t_side = torch.where(side_ok, t_side, BIG)
    snx = (ox + t_side * dx) / radius
    sny = (oy + t_side * dy) / radius

    t_cap = _hit_floor(eye, dx, dy, dz, z_hi)
    px = eye[0] + t_cap * dx - cx
    py = eye[1] + t_cap * dy - cy
    t_cap = torch.where((px * px + py * py) <= radius * radius, t_cap, BIG)

    use_cap = t_cap < t_side
    t = torch.minimum(t_side, t_cap)
    zero = torch.zeros_like(t)
    return (t, torch.where(use_cap, zero, snx), torch.where(use_cap, zero, sny),
            torch.where(use_cap, 1.0, zero))


def _hit_sphere(eye, dx, dy, dz, sx, sy, sz, radius):
    inv_r = 1.0 / radius
    ocx, ocy, ocz = eye[0] - sx, eye[1] - sy, eye[2] - sz
    bq = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
    disc = bq * bq - 4 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-bq - sq) * 0.5
    t = torch.where((disc > 0) & (t > 1e-4), t, BIG)
    return (t, (eye[0] + t * dx - sx) * inv_r, (eye[1] + t * dy - sy) * inv_r,
            (eye[2] + t * dz - sz) * inv_r)


def _hit_capsule_body(eye, dx, dy, dz, a, b, radius):
    inv_r = 1.0 / radius
    ax, ay, az = a
    bax, bay, baz = b[0] - ax, b[1] - ay, b[2] - az
    inv_ba_len2 = 1.0 / (bax * bax + bay * bay + baz * baz + 1e-12)
    oax, oay, oaz = eye[0] - ax, eye[1] - ay, eye[2] - az
    d_dot_ba = dx * bax + dy * bay + dz * baz
    oa_dot_ba = oax * bax + oay * bay + oaz * baz
    aa = 1.0 - d_dot_ba * d_dot_ba * inv_ba_len2
    bbq = 2.0 * ((dx * oax + dy * oay + dz * oaz)
                 - d_dot_ba * oa_dot_ba * inv_ba_len2)
    cc = (oax * oax + oay * oay + oaz * oaz
          - oa_dot_ba * oa_dot_ba * inv_ba_len2 - radius * radius)
    disc = bbq * bbq - 4 * aa * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-bbq - sq) / (2 * r3._safe(aa))
    s = (oa_dot_ba + t * d_dot_ba) * inv_ba_len2
    t = torch.where((disc > 0) & (t > 1e-4) & (s >= 0.0) & (s <= 1.0), t, BIG)
    return (t, (eye[0] + t * dx - (ax + s * bax)) * inv_r,
            (eye[1] + t * dy - (ay + s * bay)) * inv_r,
            (eye[2] + t * dz - (az + s * baz)) * inv_r)


# ---------------------------------------------------------------------------
# Camera-static constants.
# ---------------------------------------------------------------------------
@lru_cache(maxsize=8)
def _background_planes(which: str, height: int, width: int) -> np.ndarray:
    """[7, H, W] float32 composite state (t, normal, albedo) of the sky, the
    floor and the table: the same for every env, so computed once."""
    eye_np, dirs_np = r3._kuka_camera(which, height, width)
    eye = torch.as_tensor(np.asarray(eye_np, np.float32))
    dirs = torch.as_tensor(np.asarray(dirs_np, np.float32))
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    light, sky = r3.LIGHT_DIR, r3.SKY_COLOR
    full = lambda v: torch.full(dx.shape, v, dtype=torch.float32)
    # Sky "normal" = 1.01 * light: the shade clips to 1, so the sky colour
    # passes through unshaded.
    st = (full(BIG), full(float(light[0]) * 1.01), full(float(light[1]) * 1.01),
          full(float(light[2]) * 1.01), full(float(sky[0])), full(float(sky[1])),
          full(float(sky[2])))
    t = _hit_floor(eye, dx, dy, dz, r3.FLOOR_Z)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    st = _composite(st, t, zero, zero, one, r3.FLOOR_COLOR)
    t, nx, ny, nz = _hit_aabb(eye, dx, dy, dz,
                              tuple(map(float, r3.TABLE_CENTER)),
                              tuple(map(float, r3.TABLE_HALF)))
    st = _composite(st, t, nx, ny, nz, r3.TABLE_COLOR)
    return torch.stack(st).numpy()


@lru_cache(maxsize=8)
def _camera_planes(which: str, height: int, width: int):
    """(eye as 3 Python floats, dx, dy, dz as [H, W] float32 numpy)."""
    eye, dirs = r3._kuka_camera(which, height, width)
    dirs = np.asarray(dirs, np.float32)
    return (tuple(float(v) for v in np.asarray(eye)),
            dirs[..., 0], dirs[..., 1], dirs[..., 2])


@lru_cache(maxsize=8)
def _background_rgb(which: str, height: int, width: int) -> np.ndarray:
    """uint8 [H * W, 3]: the background's colour, shaded as the twin shades
    it. The kernel stores it wherever no primitive wins."""
    _, nx, ny, nz, r, g, b = torch.as_tensor(_background_planes(which, height, width))
    lx, ly, lz = (float(v) for v in r3.LIGHT_DIR)
    sh = 0.45 + 0.55 * torch.clamp(nx * lx + ny * ly + nz * lz, 0.0, 1.0)
    to_u8 = lambda x: torch.clamp(x, 0, 255).to(torch.int32).to(torch.uint8)
    return torch.stack([to_u8(sh * ch * 255.0 + 0.5) for ch in (r, g, b)], -1) \
        .reshape(-1, 3).numpy()


@lru_cache(maxsize=8)
def _button_planes(which: str, height: int, width: int) -> np.ndarray:
    """[8, H * W] float32 per-pixel terms of every button cylinder, with the
    twin's roundings (``_hit_vcylinder``): a = dx^2 + dy^2, 2 safe(a), then
    for the base top and the cap top the ray's hit t with that plane and
    the xy point eye + t d."""
    eye, *dirs = _camera_planes(which, height, width)
    dx, dy, dz = (torch.as_tensor(d).reshape(-1) for d in dirs)
    a = dx * dx + dy * dy
    planes = [a, 2 * r3._safe(a)]
    for z_hi in (kuka_env.BUTTON_BASE_TOP, kuka_env.BUTTON_CAP_TOP):
        t = _hit_floor(eye, dx, dy, dz, z_hi)
        planes += [t, eye[0] + t * dx, eye[1] + t * dy]
    return torch.stack(planes).numpy()


class CameraTensors(NamedTuple):
    eyes: tuple  # per view, the eye as 3 Python floats
    rays: torch.Tensor  # [V, 3, P] float32 ray directions
    bg: torch.Tensor  # [V, 7, P] float32 background state (t, normal, albedo)
    bg_rgb: torch.Tensor  # [V, P, 3] uint8 background's shaded colour
    planes: torch.Tensor  # [V, 8, P] float32 per-pixel button terms


_DEVICE_CONSTS: dict = {}


def camera_tensors(cfg: RenderConfig, device) -> CameraTensors:
    """The camera-static inputs of every view on ``device``, cached."""
    key = (cfg.views, cfg.trace_h, cfg.trace_w, str(device))
    if key not in _DEVICE_CONSTS:
        eyes, per_view = [], []
        for which in cfg.views:
            eye, dx, dy, dz = _camera_planes(which, cfg.trace_h, cfg.trace_w)
            eyes.append(eye)
            per_view.append((
                np.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)]),
                _background_planes(which, cfg.trace_h, cfg.trace_w).reshape(7, -1),
                _background_rgb(which, cfg.trace_h, cfg.trace_w),
                _button_planes(which, cfg.trace_h, cfg.trace_w)))
        _DEVICE_CONSTS[key] = CameraTensors(tuple(eyes), *(
            torch.as_tensor(np.stack(arrays), device=device).contiguous()
            for arrays in zip(*per_view)))
    return _DEVICE_CONSTS[key]


def _scene_table(env, states) -> Tuple[RenderConfig, torch.Tensor]:
    """Per-env scene rows [N, S]: arm points (base, 7 joints, flange, tip),
    button xy, then distractors and ball when the env has them."""
    joint_pos, _, _, p_flange, p_tip = kin.fk(states.q)
    n = joint_pos.shape[0]
    base = torch.as_tensor(kin.BASE_POS, device=joint_pos.device).expand(n, 1, 3)
    pts = torch.cat([base, joint_pos, p_flange[:, None], p_tip[:, None]], 1)
    cols = [pts.reshape(n, -1),
            states.buttons[:, : env.n_buttons, :2].reshape(n, -1)]
    n_distract = 0
    if env.rand_objects:
        n_distract = states.distractors.shape[1]
        cols.append(states.distractors.reshape(n, -1))
        cols.append(states.ball[:, :3])
    scene = torch.cat(cols, 1).to(torch.float32).contiguous()
    scale = int(env.render_scale)
    cfg = RenderConfig(
        n_buttons=env.n_buttons, n_pts=pts.shape[1], n_distract=n_distract,
        trace_h=kuka_env.RENDER_HEIGHT // scale, trace_w=kuka_env.RENDER_WIDTH // scale,
        up=scale if env.obs_coarse_scale == 1 else 1,
        views=("main", "aux") if env.multi_view else ("main",),
    )
    return cfg, scene


# ---------------------------------------------------------------------------
# The plain twin.
# ---------------------------------------------------------------------------
def _trace_view_plain(cfg, scene, eye, dx, dy, dz, bg):
    """uint8 [N, 3, P] for one camera view."""
    z_table, base_top, cap_top = (kuka_env.Z_TABLE, kuka_env.BUTTON_BASE_TOP,
                                  kuka_env.BUTTON_CAP_TOP)
    base_r, cap_r = kuka_env.BUTTON_BASE_RADIUS, kuka_env.BUTTON_CAP_RADIUS
    n = scene.shape[0]
    col = lambda j: scene[:, j:j + 1]
    st = tuple(bg[i].expand(n, -1) for i in range(7))

    cap_colors = [r3.BUTTON_CAP_YELLOW, r3.BUTTON_CAP_TEAL]
    off = cfg.n_pts * 3
    for i in range(cfg.n_buttons):
        bx, by = col(off + 2 * i), col(off + 2 * i + 1)
        st = _composite(st, *_hit_vcylinder(eye, dx, dy, dz, bx, by, base_r,
                                            z_table, base_top), r3.BUTTON_GREEN)
        st = _composite(st, *_hit_vcylinder(eye, dx, dy, dz, bx, by, cap_r,
                                            base_top, cap_top),
                        cap_colors[min(i, 1)])

    n_seg = cfg.n_pts - 1
    seg_color = [r3.ARM_ORANGE if i % 2 == 0 else r3.ARM_SILVER
                 for i in range(n_seg)]
    pts = [(col(3 * i), col(3 * i + 1), col(3 * i + 2)) for i in range(cfg.n_pts)]
    for i in range(n_seg):
        radius = r3.ARM_LINK_RADIUS if i < n_seg - 1 else r3.ARM_LAST_RADIUS
        st = _composite(st, *_hit_capsule_body(eye, dx, dy, dz, pts[i],
                                               pts[i + 1], radius), seg_color[i])
    for i in range(cfg.n_pts):
        radius = r3.ARM_LINK_RADIUS if i < cfg.n_pts - 1 else r3.ARM_LAST_RADIUS
        st = _composite(st, *_hit_sphere(eye, dx, dy, dz, *pts[i], radius),
                        seg_color[max(i - 1, 0)])

    if cfg.n_distract:
        doff = off + 2 * cfg.n_buttons
        for i in range(cfg.n_distract + 1):
            k = doff + 3 * i
            is_ball = i == cfg.n_distract
            st = _composite(
                st, *_hit_sphere(eye, dx, dy, dz, col(k), col(k + 1), col(k + 2),
                                 r3.BALL_RADIUS if is_ball else r3.DISTRACTOR_RADIUS),
                r3.BALL_COLOR if is_ball else r3.DISTRACTOR_COLOR)

    _, nx, ny, nz, r, g, b = st
    lx, ly, lz = (float(v) for v in r3.LIGHT_DIR)
    sh = 0.45 + 0.55 * torch.clamp(nx * lx + ny * ly + nz * lz, 0.0, 1.0)
    to_u8 = lambda x: torch.clamp(x, 0, 255).to(torch.int32).to(torch.uint8)
    return torch.stack([to_u8(sh * ch * 255.0 + 0.5) for ch in (r, g, b)], 1)


def render_kuka_plain(cfg: RenderConfig, scene, eyes, rays, bg) -> torch.Tensor:
    """uint8 [N, H, W, 3 * views] with the same formulas as the kernel."""
    n = scene.shape[0]
    imgs = []
    for v, eye in enumerate(eyes):
        out = _trace_view_plain(cfg, scene, eye, rays[v, 0], rays[v, 1],
                                rays[v, 2], bg[v])
        img = out.reshape(n, 3, cfg.trace_h, cfg.trace_w).permute(0, 2, 3, 1)
        imgs.append(r3.upsample_nearest(img, cfg.up))
    return torch.cat(imgs, -1) if len(imgs) > 1 else imgs[0]


def render_kuka(env, states) -> torch.Tensor:
    """uint8 [N, H, W, 3 * views] frames of a batched KukaState, traced by
    the plain twin on the states' device."""
    cfg, scene = _scene_table(env, states)
    cam = camera_tensors(cfg, scene.device)
    return render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)

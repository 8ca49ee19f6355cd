"""Ray-traced Kuka renderer: the CUDA kernel and its plain PyTorch twin
(counterpart of srl_tpu/ops/pallas_render3d.py).

``render_kuka(env, states)`` packs each env's scene into one row of floats
(FK points, button xy, distractors and ball), then traces every pixel of the
camera against it. On a CUDA tensor it launches the hand-written kernel in
``csrc/render3d.cu`` (and raises if that fails); on a CPU tensor it runs
``render_kuka_plain``, the same formulas as torch ops over [N, pixels].

The kernel culls: each primitive gets a conservative pixel rectangle from
its bounding sphere (``cull_rects`` is the same computation in PyTorch), and
a warp traces only the primitives whose rectangle meets its pixels. Its
camera-static inputs (``camera_tensors``) add to the twin's rays and
background planes the background's shaded colour (``_background_rgb``) and
the per-pixel terms of the button cylinders (``_button_planes``).

Rounding follows the reference: where it computes a constant in Python
doubles (``radius * radius``, ``z - eye_z``), so do the twin and the host
side of the kernel, and the result is rounded to float32 once.
"""
from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from srl_tpu_torch.core.device import host_tensor
from srl_tpu_torch.envs import kuka as kuka_env
from srl_tpu_torch.ops import camera
from srl_tpu_torch.ops import kinematics as kin
from srl_tpu_torch.ops import renderer3d as r3
from srl_tpu_torch.utils import trace

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
    base = host_tensor(kin.BASE_POS, device=joint_pos.device).expand(n, 1, 3)
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


# ---------------------------------------------------------------------------
# The kernel's culling, in PyTorch: for tests and for counting its work.
# ---------------------------------------------------------------------------
def _f32(x: float) -> float:
    return float(np.float32(x))


def _bound(r: float, z_lo: float, z_hi: float) -> Tuple[float, float]:
    """(centre height, radius) of the sphere around a vertical cylinder."""
    return _f32((z_lo + z_hi) / 2), _f32(np.hypot(r, (z_hi - z_lo) / 2))


BASE_BOUND = _bound(kuka_env.BUTTON_BASE_RADIUS, kuka_env.Z_TABLE,
                    kuka_env.BUTTON_BASE_TOP)
CAP_BOUND = _bound(kuka_env.BUTTON_CAP_RADIUS, kuka_env.BUTTON_BASE_TOP,
                   kuka_env.BUTTON_CAP_TOP)


@lru_cache(maxsize=8)
def _view_consts(which: str, height: int, width: int) -> Tuple[float, ...]:
    """The kernel's ``View``: eye, forward, right and up axes, tan(fov / 2)
    and tan(fov / 2) * width / height, each rounded to float32."""
    eye, _ = r3._kuka_camera(which, height, width)
    _, _, yaw, pitch, roll, fov = r3.KUKA_CAMERAS["main" if which == "main" else "second"]
    fwd, right, up = camera.camera_basis(yaw, pitch, roll)
    tan_h = np.tan(np.radians(fov) / 2.0)
    return tuple(_f32(v) for v in (*np.asarray(eye), *fwd, *right, *up, tan_h,
                                   tan_h * width / height))


def primitive_kinds(cfg: RenderConfig) -> Tuple[str, ...]:
    """The kernel's primitives in composite order: per button its base and
    cap ("cylinder"), the capsule bodies, the joint spheres, the distractors
    and the ball."""
    n_spheres = cfg.n_pts + (cfg.n_distract + 1 if cfg.n_distract else 0)
    return (("cylinder",) * (2 * cfg.n_buttons) + ("capsule",) * (cfg.n_pts - 1)
            + ("sphere",) * n_spheres)


def _bounding_spheres(cfg: RenderConfig, scene):
    """Centre x, y, z and radius [N, n_prim, 2] of two spheres per primitive
    whose convex hull holds it, with the kernel's float32 values
    (``setup_prim``): a capsule body's two joint spheres (each at least as
    wide as the body), and twice the bounding sphere of a cylinder (around
    its z extent) or the sphere itself."""
    n = scene.shape[0]
    col = lambda j: scene[:, j]
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=scene.device)
    spheres = []
    off = 3 * cfg.n_pts
    for i in range(cfg.n_buttons):
        for zmid, rad in (BASE_BOUND, CAP_BOUND):
            spheres.append(2 * [(col(off + 2 * i), col(off + 2 * i + 1), full(zmid), full(rad))])
    # The last capsule body and the last joint sphere are the gripper's.
    n_seg = cfg.n_pts - 1
    radius = lambda last: full(_f32(r3.ARM_LAST_RADIUS if last else r3.ARM_LINK_RADIUS))
    point = lambda i: (col(3 * i), col(3 * i + 1), col(3 * i + 2))
    for i in range(n_seg):
        spheres.append([(*point(i), radius(False)), (*point(i + 1), radius(i + 1 == n_seg))])
    for i in range(cfg.n_pts):
        spheres.append(2 * [(*point(i), radius(i == cfg.n_pts - 1))])
    if cfg.n_distract:
        doff = off + 2 * cfg.n_buttons
        for i in range(cfg.n_distract + 1):
            rad = r3.BALL_RADIUS if i == cfg.n_distract else r3.DISTRACTOR_RADIUS
            spheres.append(2 * [(*(col(doff + 3 * i + k) for k in range(3)), full(_f32(rad)))])
    return tuple(torch.stack([torch.stack([a[k], b[k]], -1) for a, b in spheres], 1)
                 for k in range(4))


def _ratio_interval(a_lo, a_hi, w_lo, w_hi):
    """The exact interval of a / w over [a_lo, a_hi] x [w_lo, w_hi], w > 0:
    the least and largest of the four corner ratios."""
    return (a_lo / torch.where(a_lo >= 0, w_hi, w_lo),
            a_hi / torch.where(a_hi >= 0, w_lo, w_hi))


def cull_rects(cfg: RenderConfig, scene, view: int) -> torch.Tensor:
    """int32 [N, n_prim, 4]: per primitive, the first and last traced row
    and column (clamped to [-1, n]) whose pixels the kernel traces it at, as
    its ``cull_rect`` computes them. For a sphere: the rows whose pixel
    centres see the exact interval of u/w over the sphere's camera-space
    box, one row of slack each side, and the same for columns with x/w; the
    whole image when the sphere reaches within 0.05 of the eye plane. A
    primitive takes the union over its two spheres (``_bounding_spheres``):
    the camera maps their convex hull onto the hull of their images."""
    h, w = cfg.trace_h, cfg.trace_w
    vc = _view_consts(cfg.views[view], h, w)
    eye, fwd, right, up = (vc[3 * k:3 * k + 3] for k in range(4))
    tan_h, tan_w = vc[12:]
    cx, cy, cz, rad = _bounding_spheres(cfg, scene)
    wx, wy, wz = cx - eye[0], cy - eye[1], cz - eye[2]
    dot = lambda axis: wx * axis[0] + wy * axis[1] + wz * axis[2]
    depth, uc, xc = dot(fwd), dot(up), dot(right)
    w_lo, w_hi = depth - rad, depth + rad
    v0, v1 = _ratio_interval(uc - rad, uc + rad, w_lo * tan_h, w_hi * tan_h)
    u0, u1 = _ratio_interval(xc - rad, xc + rad, w_lo * tan_w, w_hi * tan_w)
    to_int = lambda x, n: torch.clamp(x, -1.0, float(n)).to(torch.int32)
    rect = torch.stack([to_int(torch.ceil((1.0 - v1) * (0.5 * h) - 1.5), h),
                        to_int(torch.floor((1.0 - v0) * (0.5 * h) + 0.5), h),
                        to_int(torch.ceil((u0 + 1.0) * (0.5 * w) - 1.5), w),
                        to_int(torch.floor((u1 + 1.0) * (0.5 * w) + 0.5), w)], -1)
    whole = torch.tensor([0, h - 1, 0, w - 1], dtype=torch.int32, device=scene.device)
    rect = torch.where((depth <= rad + 0.05)[..., None], whole, rect)
    return torch.stack([torch.minimum(rect[:, :, 0, 0], rect[:, :, 1, 0]),
                        torch.maximum(rect[:, :, 0, 1], rect[:, :, 1, 1]),
                        torch.minimum(rect[:, :, 0, 2], rect[:, :, 1, 2]),
                        torch.maximum(rect[:, :, 0, 3], rect[:, :, 1, 3])], -1)


def kept_pixels(cfg: RenderConfig, scene, view: int) -> torch.Tensor:
    """int64 [N, n_prim]: how many traced pixels of the image lie in each
    primitive's rectangle, i.e. at how many pixels the kernel can trace it."""
    r = cull_rects(cfg, scene, view).to(torch.int64)
    rows = (torch.clamp(r[..., 1], max=cfg.trace_h - 1)
            - torch.clamp(r[..., 0], min=0) + 1).clamp(min=0)
    cols = (torch.clamp(r[..., 3], max=cfg.trace_w - 1)
            - torch.clamp(r[..., 2], min=0) + 1).clamp(min=0)
    return rows * cols


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------
def _kernel_consts(cfg: RenderConfig) -> np.ndarray:
    """The kernel's ``Consts`` struct (csrc/render3d.cu), field by field."""
    z_table, base_top, cap_top = (kuka_env.Z_TABLE, kuka_env.BUTTON_BASE_TOP,
                                  kuka_env.BUTTON_CAP_TOP)
    base_r, cap_r = kuka_env.BUTTON_BASE_RADIUS, kuka_env.BUTTON_CAP_RADIUS
    vals = [*(float(v) for v in r3.LIGHT_DIR), z_table, base_top, cap_top,
            base_r, base_r * base_r, cap_r, cap_r * cap_r]
    for r in (r3.ARM_LINK_RADIUS, r3.ARM_LAST_RADIUS, r3.DISTRACTOR_RADIUS, r3.BALL_RADIUS):
        vals.extend([r, r * r, 1.0 / r])
    vals.extend([*BASE_BOUND, *CAP_BOUND])
    for color in (r3.BUTTON_GREEN, r3.BUTTON_CAP_YELLOW, r3.BUTTON_CAP_TEAL,
                  r3.ARM_ORANGE, r3.ARM_SILVER, r3.DISTRACTOR_COLOR,
                  r3.BALL_COLOR):
        vals.extend(float(c) for c in color)
    for v in range(2):
        which = cfg.views[min(v, len(cfg.views) - 1)]
        vals.extend(_view_consts(which, cfg.trace_h, cfg.trace_w))
    return np.asarray(vals, np.float32)


def _load_kernel():
    from srl_tpu_torch.ops import cuda_build

    lib = cuda_build.load("render3d")
    lib.render3d_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # scene, n, stride
        ctypes.c_void_p, ctypes.c_void_p,  # rays, bg
        ctypes.c_void_p, ctypes.c_void_p,  # bg_rgb, planes
        ctypes.c_void_p,  # consts (host)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # buttons, pts, distract
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, up, V
        ctypes.c_int,  # cull
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    lib.render3d_launch.restype = ctypes.c_int
    lib.render3d_consts_floats.argtypes = []
    lib.render3d_consts_floats.restype = ctypes.c_int
    return lib


def render_kuka_cuda(cfg: RenderConfig, scene, cam: CameraTensors, out=None,
                     cull: bool = True) -> torch.Tensor:
    """Launch ``csrc/render3d.cu``: uint8 [N, H, W, 3 * views], into ``out``
    when given (a contiguous tensor of that shape). ``cull=False`` traces
    every primitive at every pixel; it is there to check that culling
    changes no bit."""
    n_views = len(cfg.views)
    p = cfg.trace_h * cfg.trace_w
    n = scene.shape[0]
    for name, x, dtype, shape in (
        ("scene", scene, torch.float32, (n, scene.shape[1])),
        ("rays", cam.rays, torch.float32, (n_views, 3, p)),
        ("bg", cam.bg, torch.float32, (n_views, 7, p)),
        ("bg_rgb", cam.bg_rgb, torch.uint8, (n_views, p, 3)),
        ("planes", cam.planes, torch.float32, (n_views, 8, p)),
    ):
        if x.device.type != "cuda" or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"render3d: {name} must be a contiguous {dtype} CUDA tensor of "
                f"shape {shape}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if len({scene.device, cam.rays.device, cam.bg.device, cam.bg_rgb.device,
            cam.planes.device}) != 1:
        raise ValueError("render3d: scene and camera tensors must be on one device")
    n_prim = len(primitive_kinds(cfg))
    expect = 3 * cfg.n_pts + 2 * cfg.n_buttons + (
        3 * cfg.n_distract + 3 if cfg.n_distract else 0)
    if scene.shape[1] != expect or expect > 128 or n_prim > 64 or n_views > 2 \
            or n > 65535 or cfg.trace_w > 224:
        raise ValueError(f"render3d: scene row of {scene.shape[1]} floats, {n_prim} "
                         f"primitives, {n_views} views, {n} envs, width "
                         f"{cfg.trace_w} not supported")
    shape = (n, cfg.trace_h * cfg.up, cfg.trace_w * cfg.up, 3 * n_views)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=scene.device)
    if out.dtype != torch.uint8 or tuple(out.shape) != shape or not out.is_contiguous() \
            or out.device != scene.device:
        raise ValueError(f"render3d: out must be a contiguous uint8 {shape} tensor on "
                         f"{scene.device}")
    lib = _load_kernel()
    consts = _kernel_consts(cfg)
    if consts.size != lib.render3d_consts_floats():
        raise RuntimeError("render3d: host constants do not match the kernel")
    with torch.cuda.device(scene.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render3d_launch(
            scene.data_ptr(), n, scene.shape[1], cam.rays.data_ptr(), cam.bg.data_ptr(),
            cam.bg_rgb.data_ptr(), cam.planes.data_ptr(), consts.ctypes.data,
            cfg.n_buttons, cfg.n_pts, cfg.n_distract, cfg.trace_h, cfg.trace_w, cfg.up,
            n_views, int(cull), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"render3d kernel launch failed: CUDA error {err}")
    trace.count("render3d.launches")
    return out


def render_kuka(env, states) -> torch.Tensor:
    """uint8 [N, H, W, 3] (or 6 channels with multi_view) Kuka frames of a
    batched KukaState: the CUDA kernel on a card, the twin on the CPU."""
    cfg, scene = _scene_table(env, states)
    cam = camera_tensors(cfg, scene.device)
    if scene.device.type == "cuda":
        return render_kuka_cuda(cfg, scene, cam)
    if scene.device.type != "cpu":
        raise ValueError(f"render_kuka: no path for device {scene.device}")
    return render_kuka_plain(cfg, scene, cam.eyes, cam.rays, cam.bg)

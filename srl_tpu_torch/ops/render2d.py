"""MobileRobot sprite compositor: the CUDA kernel and its plain PyTorch twin
(counterpart of srl_tpu/ops/pallas_render.py).

``render_mobile_robot(env, states)`` packs each env's scene into one row of
8 floats (robot xy, target xy, second target xy, two-target flag, line
flag) and composites, per pixel, over the packed-u32 checker-and-walls
background of ``ops/renderer.py``: the yellow target disk (or the line
band), the red second target, the robot body box and its four wheel pads.
On a CUDA tensor it launches the hand-written kernel in ``csrc/render2d.cu``
(and raises if that fails), which reads the background as RGB bytes
(``background_rgb``); on a CPU tensor it runs ``render_mobile_robot_plain``. The compositor is integer selects over
pre-quantized colours and float compares, so kernel, twin and the
reference's XLA compositor agree bit for bit. The one place where rounding
decides a pixel is the disk test ``dy2 + dx2 <= r*r``: XLA rounds ``dy2``
and fuses ``dx * dx`` into the sum as one multiply-add, and so do the twin
and the kernel. With ``fpv``
the first-person view fills channels 3-5 and the top-down view is written
into channels 0-2 of the same tensor.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from srl_tpu_torch.core import numerics
from srl_tpu_torch.core.device import host_tensor
from srl_tpu_torch.ops import renderer as rr
from srl_tpu_torch.utils import trace

SCENE_FLOATS = 8


def _f32(x: float) -> float:
    """A constant rounded to float32, so that every path compares and
    subtracts the same value whatever precision it computes in."""
    return float(np.float32(x))


TARGET_R2 = _f32(rr.TARGET_RADIUS * rr.TARGET_RADIUS)
LINE_HALF_W = _f32(rr.LINE_TARGET_HALF_W)
LINE_CY = LINE_HALF_H = 2.0
HALF_L = _f32(rr.ROBOT_HALF_L)
HALF_W = _f32(rr.ROBOT_HALF_W)
WHEEL_DX = _f32(rr.WHEEL_DX)
WHEEL_HX = _f32(rr.WHEEL_HALF_X)
WHEEL_HY = _f32(rr.WHEEL_HALF_Y)
# Packed RGB (R in byte 0) of the sprites, quantized once on the host.
COLORS = tuple(int(rr._pack_color(c)) for c in (
    rr.TARGET_YELLOW, rr.TARGET_RED, rr.ROBOT_BODY, rr.ROBOT_WHEEL))


def scene_params(env, states) -> torch.Tensor:
    """[N, 8] float32 scene rows: robot xy, target 0 xy, target 1 xy (zeros
    with one target), two-target flag, line flag."""
    n = states.robot_pos.shape[0]
    t0 = states.targets[:, 0]
    t1 = states.targets[:, 1] if env.n_targets > 1 else torch.zeros_like(t0)
    flags = host_tensor([float(env.n_targets > 1), float(env.line_target)],
                        dtype=torch.float32, device=t0.device).expand(n, 2)
    return torch.cat([states.robot_pos, t0, t1, flags], 1).to(torch.float32).contiguous()


_DEVICE_CONSTS: dict = {}


def static_tensors(dim: int, height: int, width: int, device):
    """(xs_row f32 [W], ys_col f32 [H], background int32 [H, W] of packed
    RGB) on ``device``, cached."""
    key = (dim, height, width, str(device))
    if key not in _DEVICE_CONSTS:
        xs, ys, bg = rr._mobile_robot_static_packed(dim, height, width)
        _DEVICE_CONSTS[key] = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (xs, ys, bg.view(np.int32)))
    return _DEVICE_CONSTS[key]


def background_rgb(dim: int, height: int, width: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] on ``device``: the background of ``static_tensors`` as
    the bytes the kernel copies, cached."""
    key = ("rgb", dim, height, width, str(device))
    if key not in _DEVICE_CONSTS:
        bg = rr._mobile_robot_static_packed(dim, height, width)[2]
        rgb = np.ascontiguousarray(bg.view(np.uint8).reshape(height, width, 4)[..., :3])
        _DEVICE_CONSTS[key] = torch.as_tensor(rgb, device=device)
    return _DEVICE_CONSTS[key]


# ---------------------------------------------------------------------------
# The plain twin.
# ---------------------------------------------------------------------------
def render_mobile_robot_plain(scene, xs_row, ys_col, bg) -> torch.Tensor:
    """uint8 [N, H, W, 3]: the batched packed-u32 compositor, with the same
    formulas as the kernel. Box masks are outer products of 1-D interval
    masks, the disk is ``dy2[:, None] + dx2[None, :] <= r*r`` with the x
    square fused into the sum (``fma(dx, dx, dy2)``), and the four wheels
    are one folded mask ``| |x - rx| - 0.22 | <= 0.08``."""
    xr, yc = xs_row[None, :], ys_col[None, :]  # [1, W], [1, H]
    col = lambda j: scene[:, j:j + 1]  # [N, 1]
    rx, ry, t0x, t0y, t1x, t1y = (col(j) for j in range(6))
    two = (col(6) > 0.5)[:, :, None]
    line = (col(7) > 0.5)[:, :, None]

    def outer(my, mx):
        return my[:, :, None] & mx[:, None, :]

    def disk(cx, cy):
        dx = (xr - cx)[:, None, :]
        dy2 = torch.square(yc - cy)[:, :, None]
        return numerics.fma(dx, dx, dy2) <= TARGET_R2

    yellow, red, body, wheel = COLORS
    img = bg[None]
    band = outer(torch.abs(yc - LINE_CY) <= LINE_HALF_H, torch.abs(xr - t0x) <= LINE_HALF_W)
    img = torch.where(torch.where(line, band, disk(t0x, t0y)), yellow, img)
    img = torch.where(disk(t1x, t1y) & two & ~line, red, img)
    img = torch.where(outer(torch.abs(yc - ry) <= HALF_W, torch.abs(xr - rx) <= HALF_L),
                      body, img)
    wx = torch.abs(torch.abs(xr - rx) - WHEEL_DX) <= WHEEL_HX
    wy = torch.abs(torch.abs(yc - ry) - HALF_W) <= WHEEL_HY
    img = torch.where(outer(wy, wx), wheel, img)
    return torch.stack([(img >> s) & 255 for s in (0, 8, 16)], -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------
def _kernel_consts() -> np.ndarray:
    """The kernel's ``Consts`` struct (csrc/render2d.cu) as 32-bit words:
    the float32 constants, bit for bit, then the packed colours."""
    floats = np.array([TARGET_R2, LINE_HALF_W, LINE_CY, LINE_HALF_H, HALF_L, HALF_W,
                       WHEEL_DX, WHEEL_HX, WHEEL_HY], np.float32)
    return np.concatenate([floats.view(np.uint32), np.array(COLORS, np.uint32)])


def _load_kernel():
    from srl_tpu_torch.ops import cuda_build

    lib = cuda_build.load("render2d")
    lib.render2d_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # scene, n
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # xs_row, ys_col, bg_rgb
        ctypes.c_int, ctypes.c_int,  # height, width
        ctypes.c_void_p,  # consts (host)
        ctypes.c_void_p, ctypes.c_int,  # out, out channels
        ctypes.c_void_p,  # stream
    ]
    lib.render2d_launch.restype = ctypes.c_int
    lib.render2d_consts_words.argtypes = []
    lib.render2d_consts_words.restype = ctypes.c_int
    return lib


def render_mobile_robot_cuda(scene, xs_row, ys_col, bg_rgb, out=None) -> torch.Tensor:
    """Launch ``csrc/render2d.cu`` over the background ``bg_rgb`` (uint8
    [H, W, 3], ``background_rgb``). Writes channels 0-2 of ``out``, uint8
    [N, H, W, C] with C >= 3 (a new [N, H, W, 3] tensor when None), and
    returns it."""
    n, h, w = scene.shape[0], ys_col.shape[0], xs_row.shape[0]
    for name, x, dtype, shape in (
        ("scene", scene, torch.float32, (n, SCENE_FLOATS)),
        ("xs_row", xs_row, torch.float32, (w,)),
        ("ys_col", ys_col, torch.float32, (h,)),
        ("bg_rgb", bg_rgb, torch.uint8, (h, w, 3)),
    ):
        if x.device.type != "cuda" or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"render2d: {name} must be a contiguous {dtype} CUDA tensor of "
                f"shape {shape}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if out is None:
        out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=scene.device)
    if out.dtype != torch.uint8 or out.dim() != 4 or tuple(out.shape[:3]) != (n, h, w) \
            or out.shape[3] < 3 or not out.is_contiguous():
        raise ValueError(f"render2d: out must be a contiguous uint8 [{n}, {h}, {w}, C>=3] "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")
    if not (scene.device == xs_row.device == ys_col.device == bg_rgb.device == out.device):
        raise ValueError("render2d: every tensor must be on one device")
    if n > 65535:
        raise ValueError(f"render2d: {n} envs not supported")
    # The kernel reads a scene row and the background 16 bytes at a time.
    if bg_rgb.data_ptr() % 16 or scene.data_ptr() % 16:
        raise ValueError("render2d: scene and bg_rgb must be 16-byte aligned")
    lib = _load_kernel()
    consts = _kernel_consts()
    if consts.size != lib.render2d_consts_words():
        raise RuntimeError("render2d: host constants do not match the kernel")
    with torch.cuda.device(scene.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.render2d_launch(
            scene.data_ptr(), n, xs_row.data_ptr(), ys_col.data_ptr(), bg_rgb.data_ptr(),
            h, w, consts.ctypes.data, out.data_ptr(), out.shape[3], stream)
    if err != 0:
        raise RuntimeError(f"render2d kernel launch failed: CUDA error {err}")
    trace.count("render2d.launches")
    return out


def render_mobile_robot(env, states) -> torch.Tensor:
    """uint8 [N, H, W, 3] (6 channels with ``fpv``) frames of a batched
    MobileRobotState: the CUDA kernel on a card, the twin on the CPU."""
    scene = scene_params(env, states)
    h, w = env.render_shape
    xs, ys, bg = static_tensors(env.dim, h, w, scene.device)
    dev = scene.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"render_mobile_robot: no path for device {scene.device}")
    bg_rgb = background_rgb(env.dim, h, w, scene.device) if dev == "cuda" else None
    if not env.fpv:
        if dev == "cuda":
            return render_mobile_robot_cuda(scene, xs, ys, bg_rgb)
        return render_mobile_robot_plain(scene, xs, ys, bg)
    out = torch.empty((scene.shape[0], h, w, 6), dtype=torch.uint8, device=scene.device)
    if dev == "cuda":
        render_mobile_robot_cuda(scene, xs, ys, bg_rgb, out)
    else:
        out[..., :3] = render_mobile_robot_plain(scene, xs, ys, bg)
    out[..., 3:] = rr.render_mobile_robot_fpv(env, states)
    return out

"""conv1 of the Nature CNN, from camera frames: the CUDA kernels and their
plain PyTorch twins (no counterpart kernel in srl_tpu: the reference's conv1
is XLA's convolution in srl_tpu/models/policies.py).

``conv1_stem(frames, weight, bias, stride)`` is ``relu(conv(frames / 255,
weight) + bias)`` with the frames NHWC uint8 (or float32) as the env
produces them, the weight [32, C, k, k] and bias [32] float32 (8x8 stride 4,
or the 4x4 stride 2 of a 2x upsample folded into the weight), and the
output bf16 NHWC [N, Ho, Wo, 32]. Any number of channels (a frame stack's
too) and any H, W of at least k; frames of another real dtype are read as
float32, as ``frames.float()``. Each pixel is rounded to bf16 after the
division, the weight and bias are rounded to bf16, and the products are
summed in float32, as the policy did with ``F.conv2d``.

It is a chain of two autograd Functions. ``_Stem`` runs the forward; its
backward is ``_Wgrad``, the weight and bias gradients (the frames take
none), whose own backward is the forward again with the mask ``out > 0`` in
place of the ReLU: the two are each other's adjoints, so TRPO's
Hessian-vector products (``create_graph=True``) run through the kernels
too. Each op dispatches by device: on a CUDA tensor it launches
``csrc/conv1.cu`` and raises if that fails; on a CPU tensor it runs the
plain twin, which is the policy's former code (``F.conv2d`` in bf16, and
``aten.convolution_backward`` as autograd called it), so the CPU keeps that
arithmetic bit for bit. The kernel's weight gradient is float32; the twin's
is bf16 widened, as autograd gave it.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from srl_tpu_torch.utils import trace

OUT_CHANNELS = 32
# Kernel size -> stride: conv1, and conv1 of a 2x upsample folded into it.
GEOMETRY = {8: 4, 4: 2}
FRAME_DTYPES = (torch.uint8, torch.float32)


def out_hw(h: int, w: int, k: int, stride: int) -> tuple:
    return (h - k) // stride + 1, (w - k) // stride + 1


def check(frames, weight, stride: int) -> None:
    """Raise a ValueError for an input the kernel does not take (on every
    device, so that the CPU run refuses what the card would)."""
    if frames.dim() != 4 or frames.dtype not in FRAME_DTYPES:
        raise ValueError(f"conv1: frames must be NHWC uint8 or float32, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    n, h, w, c = frames.shape
    if weight.dim() != 4 or weight.shape[0] != OUT_CHANNELS or weight.shape[1] != c \
            or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"conv1: weight must be [{OUT_CHANNELS}, {c}, k, k], got "
                         f"{tuple(weight.shape)}")
    k = weight.shape[2]
    if GEOMETRY.get(k) != stride:
        raise ValueError(f"conv1: takes {' or '.join(f'{a}x{a} stride {b}' for a, b in GEOMETRY.items())}"
                         f", got {k}x{k} stride {stride}")
    if c < 1:
        raise ValueError("conv1: frames without channels")
    if h < k or w < k:
        raise ValueError(f"conv1: frames of {h}x{w} are smaller than the {k}x{k} kernel")
    if h * w * c * frames.element_size() >= 2 ** 31:
        raise ValueError(f"conv1: a frame of {h}x{w}x{c} is too large")


# ---------------------------------------------------------------------------
# The plain twins.
# ---------------------------------------------------------------------------
def _scaled(frames):
    """The frames as the convolution reads them: bf16 NCHW in channels_last
    memory."""
    x = (frames.to(torch.float32) / 255.0).to(torch.bfloat16)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def fprop_plain(frames, weight, bias, stride: int, mask=None) -> torch.Tensor:
    bf16 = torch.bfloat16
    b = None if bias is None else bias.to(bf16)
    y = F.conv2d(_scaled(frames), weight.to(bf16), b, stride=stride)
    if mask is None:
        y = F.relu(y)
    else:
        y = torch.where(mask.permute(0, 3, 1, 2) > 0, y, torch.zeros((), dtype=bf16))
    return y.permute(0, 2, 3, 1)


def wgrad_plain(frames, out, grad, k: int, stride: int) -> tuple:
    bf16 = torch.bfloat16
    g = torch.where(out > 0, grad, torch.zeros((), dtype=bf16)).permute(0, 3, 1, 2)
    like = torch.empty((OUT_CHANNELS, frames.shape[3], k, k), dtype=bf16, device=frames.device)
    _, dw, db = torch.ops.aten.convolution_backward(
        g, _scaled(frames), like, [OUT_CHANNELS], [stride, stride], [0, 0], [1, 1], False,
        [0, 0], 1, [False, True, True])
    return dw.float(), db.float()


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------
@functools.cache
def _load_kernel():
    from srl_tpu_torch.ops import cuda_build

    lib = cuda_build.load("conv1")
    shape = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 6  # x, x_float, n h w c k s
    lib.conv1_fprop_launch.argtypes = shape + [ctypes.c_void_p] * 5  # w, b, mask, out, stream
    lib.conv1_fprop_launch.restype = ctypes.c_int
    lib.conv1_wgrad_blocks.argtypes = shape
    lib.conv1_wgrad_blocks.restype = ctypes.c_int
    lib.conv1_wgrad_launch.argtypes = shape + [
        ctypes.c_void_p, ctypes.c_void_p,  # act, gout
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # part_w, part_b, blocks
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dw, db, stream
    ]
    lib.conv1_wgrad_launch.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shape_args(frames, k: int, stride: int) -> list:
    n, h, w, c = frames.shape
    return [frames.data_ptr(), int(frames.dtype == torch.float32), n, h, w, c, k, stride]


def _on_card(frames, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != frames.device:
            raise ValueError(f"conv1: every tensor must be on {frames.device}, got {t.device}")


def fprop_cuda(frames, weight, bias, stride: int, mask=None) -> torch.Tensor:
    """Launch ``conv1_fprop``: bf16 NHWC [N, Ho, Wo, 32]."""
    check(frames, weight, stride)
    _on_card(frames, weight, bias, mask)
    n, h, w, _ = frames.shape
    k = weight.shape[2]
    ho, wo = out_hw(h, w, k, stride)
    out = torch.empty((n, ho, wo, OUT_CHANNELS), dtype=torch.bfloat16, device=frames.device)
    if n == 0:
        return out
    frames = frames.contiguous()
    weight = weight.detach().to(torch.float32).contiguous()
    bias = None if bias is None else bias.detach().to(torch.float32).contiguous()
    if mask is not None:
        mask = _aligned(mask)
        if mask.dtype != torch.bfloat16 or mask.shape != out.shape:
            raise ValueError(f"conv1: mask must be bf16 {tuple(out.shape)}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
    lib = _load_kernel()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv1_fprop_launch(
            *_shape_args(frames, k, stride), weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv1 kernel launch failed: CUDA error {err}")
    trace.count("conv1.launches")
    return out


def wgrad_cuda(frames, out, grad, k: int, stride: int) -> tuple:
    """Launch ``conv1_wgrad``: (dW float32 [32, C, k, k], db float32 [32])."""
    c = frames.shape[3]
    dev = frames.device
    dw = torch.empty((OUT_CHANNELS, c, k, k), dtype=torch.float32, device=dev)
    db = torch.empty(OUT_CHANNELS, dtype=torch.float32, device=dev)
    if frames.shape[0] == 0:
        return dw.zero_(), db.zero_()
    _on_card(frames, out, grad)
    frames, out, grad = frames.contiguous(), _aligned(out), _aligned(grad)
    if grad.dtype != torch.bfloat16 or grad.shape != out.shape:
        raise ValueError(f"conv1: the gradient must be bf16 {tuple(out.shape)}, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    lib = _load_kernel()
    with torch.cuda.device(dev):
        args = _shape_args(frames, k, stride)
        blocks = lib.conv1_wgrad_blocks(*args)
        if blocks <= 0:
            raise RuntimeError(f"conv1_wgrad: CUDA error {-blocks} planning the launch")
        part_w = torch.empty((blocks, OUT_CHANNELS, k * k * c), dtype=torch.float32, device=dev)
        part_b = torch.empty((blocks, OUT_CHANNELS), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv1_wgrad_launch(*args, out.data_ptr(), grad.data_ptr(), part_w.data_ptr(),
                                     part_b.data_ptr(), blocks, dw.data_ptr(), db.data_ptr(),
                                     stream)
    if err != 0:
        raise RuntimeError(f"conv1_wgrad kernel launch failed: CUDA error {err}")
    trace.count("conv1_wgrad.launches")
    return dw, db


# ---------------------------------------------------------------------------
# Dispatch and autograd.
# ---------------------------------------------------------------------------
def _device(frames) -> str:
    dev = frames.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"conv1: no path for device {frames.device}")
    return dev


def fprop(frames, weight, bias, stride: int, mask=None) -> torch.Tensor:
    """bf16 NHWC: relu(conv(frames / 255, weight) + bias), or with ``mask``
    the sum where ``mask > 0`` and 0 elsewhere."""
    if _device(frames) == "cuda":
        return fprop_cuda(frames, weight, bias, stride, mask)
    check(frames, weight, stride)
    return fprop_plain(frames, weight, bias, stride, mask)


def wgrad(frames, out, grad, k: int, stride: int) -> tuple:
    """(dW [32, C, k, k], db [32]) float32 of ``grad`` at the output ``out``
    of ``fprop``."""
    if _device(frames) == "cuda":
        return wgrad_cuda(frames, out, grad, k, stride)
    return wgrad_plain(frames, out, grad, k, stride)


class _Wgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frames, out, grad, k: int, stride: int):
        ctx.save_for_backward(frames, out)
        ctx.stride = stride
        return wgrad(frames, out, grad, k, stride)

    @staticmethod
    def backward(ctx, g_dw, g_db):
        frames, out = ctx.saved_tensors
        return None, None, fprop(frames, g_dw, g_db, ctx.stride, mask=out), None, None


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frames, weight, bias, stride: int):
        out = fprop(frames, weight, bias, stride)
        ctx.save_for_backward(frames, out)
        ctx.k, ctx.stride = weight.shape[2], stride
        return out

    @staticmethod
    def backward(ctx, grad):
        frames, out = ctx.saved_tensors
        dw, db = _Wgrad.apply(frames, out, grad, ctx.k, ctx.stride)
        return None, dw, db, None


def conv1_stem(frames, weight, bias, stride: int) -> torch.Tensor:
    """bf16 NHWC [N, Ho, Wo, 32]: relu(conv(frames / 255, weight) + bias),
    differentiable twice in ``weight`` and ``bias``."""
    if frames.dtype not in FRAME_DTYPES and not frames.dtype.is_complex:
        frames = frames.to(torch.float32)
    return _Stem.apply(frames, weight, bias, stride)

"""conv1 of the Nature CNN from frames (``srl_tpu_torch/ops/conv1.py``).

On the CPU the op runs its plain twins through the same chain of autograd
Functions as the kernels: they must keep the policy's former arithmetic
(scale in float32, round to bf16, ``F.conv2d`` in bf16, ReLU) bit for bit,
forward and gradients, give TRPO's Hessian-vector products, and refuse what
the kernel refuses. The ``gpu`` tests hold ``csrc/conv1.cu`` to the twins on
the card:

    python -m pytest --noconftest -m gpu tests/test_torch_conv1.py

This file imports no JAX, so it also runs where JAX is not installed."""
from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from srl_tpu_torch.models import policies
from srl_tpu_torch.ops import conv1

BF16 = torch.bfloat16
# (N, H, W, C, k): 224x224x3 and the folded 112x112x3 of the benchmark's
# cells, odd sizes, the first-person view's 6 channels, a 4-frame stack, and
# deep stacks: RGB x 6 (18) and the first-person view x 4 (24, the most the
# card's forward takes in one pass at 224x224).
SHAPES = [
    (2, 224, 224, 3, 8),
    (3, 112, 112, 3, 4),
    (3, 37, 41, 3, 8),
    (2, 29, 35, 6, 4),
    (2, 30, 33, 6, 8),
    (2, 21, 19, 12, 4),
    (2, 40, 36, 12, 8),
    (2, 45, 38, 18, 8),
    (2, 224, 224, 24, 8),
    (2, 112, 112, 24, 4),
]


def _inputs(n, h, w, c, k, seed=0, dtype=torch.uint8, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (n, h, w, c), generator=gen, dtype=torch.uint8)
    if dtype == torch.float32:
        frames = frames.float() + torch.rand(frames.shape, generator=gen)
    weight = torch.randn((32, c, k, k), generator=gen) * (2.0 / (k * k * c)) ** 0.5
    bias = torch.randn(32, generator=gen) * 0.1
    return frames.to(device), weight.to(device), bias.to(device)


def _former(frames, weight, bias, stride):
    """The policy's conv1 before the op: NCHW in channels_last memory."""
    x = (frames.to(torch.float32) / 255.0).to(BF16)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return F.relu(F.conv2d(x, weight.to(BF16), bias.to(BF16), stride=stride))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_equals_former_arithmetic_bit_for_bit(shape):
    frames, weight, bias = _inputs(*shape)
    stride = conv1.GEOMETRY[shape[-1]]
    out = conv1.conv1_stem(frames, weight, bias, stride)
    assert out.dtype == BF16 and out.shape == (shape[0], *conv1.out_hw(
        shape[1], shape[2], shape[4], stride), 32)
    assert torch.equal(out.permute(0, 3, 1, 2), _former(frames, weight, bias, stride))


@pytest.mark.parametrize("input_scale,hw", [(1, 224), (2, 112)])
def test_torso_equals_former_torso_bit_for_bit(input_scale, hw):
    torch.manual_seed(3)
    torso = policies.NatureCnnTorso((hw, hw, 3), input_scale)
    frames = _inputs(2, hw, hw, 3, 8, seed=3)[0]

    def former(x):
        x = _former(x, torso.c1.folded_weight(), torso.c1.bias, torso.c1.stride)
        x = F.relu(policies._bf16_conv(torso.c2, x))
        x = F.relu(policies._bf16_conv(torso.c3, x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        fc = torso.fc
        return F.relu(F.linear(x, fc.weight.to(BF16), fc.bias.to(BF16))).to(torch.float32)

    with torch.no_grad():
        assert torch.equal(torso(frames), former(frames))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_equal_autograd_through_conv2d(shape):
    frames, weight, bias = _inputs(*shape, seed=1)
    stride = conv1.GEOMETRY[shape[-1]]
    ho, wo = conv1.out_hw(shape[1], shape[2], shape[4], stride)
    r = torch.randn((shape[0], ho, wo, 32), generator=torch.Generator().manual_seed(2))
    grads = []
    for run in (conv1.conv1_stem, lambda *a: _former(*a).permute(0, 2, 3, 1)):
        w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
        loss = (run(frames, w, b, stride).float() * r).sum()
        grads.append(torch.autograd.grad(loss, (w, b)))
    for got, want in zip(*grads):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_folded_weight_gradient_flows_through_the_fold():
    """Kuka's 2x input: the gradient of the full 8x8 parameter is the 4x4
    gradient spread over each 2x2 block, as autograd through the fold."""
    torch.manual_seed(5)
    layer = policies._Conv1(3, input_scale=2)
    frames = _inputs(2, 44, 40, 3, 4, seed=5)[0]
    grads = []
    for run in (layer, lambda x: _former(x, layer.folded_weight(), layer.bias, 2)):
        layer.zero_grad()
        run(frames).float().square().sum().backward()
        grads.append((layer.weight.grad.clone(), layer.bias.grad.clone()))
    assert grads[0][0].shape == (32, 3, 8, 8)
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _hvp(stem, frames, flat0, shapes, v, stride):
    """TRPO's use: the gradient of a loss with ``create_graph=True``, then
    the gradient of its dot with ``v``."""
    head = torch.linspace(-1.0, 1.0, 32, device=flat0.device)
    fp = flat0.clone().requires_grad_(True)
    w, b = fp[:-32].view(shapes), fp[-32:]
    out = stem(frames, w, b)
    loss = (out.float().mean((1, 2)) @ head).square().mean()
    g = torch.autograd.grad(loss, fp, create_graph=True)[0]
    return g.detach(), torch.autograd.grad(torch.dot(g, v), fp)[0]


@pytest.mark.parametrize("shape", [(4, 36, 36, 3, 8), (4, 22, 24, 6, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_hessian_vector_product_matches_the_plain_path(shape):
    frames, weight, bias = _inputs(*shape, seed=7)
    stride = conv1.GEOMETRY[shape[-1]]
    flat0 = torch.cat([weight.reshape(-1), bias])
    v = torch.randn(flat0.shape, generator=torch.Generator().manual_seed(8))
    g_op, hv_op = _hvp(lambda f, w, b: conv1.conv1_stem(f, w, b, stride), frames, flat0,
                       weight.shape, v, stride)
    g_pl, hv_pl = _hvp(lambda f, w, b: _former(f, w, b, stride).permute(0, 2, 3, 1), frames,
                       flat0, weight.shape, v, stride)
    assert torch.equal(g_op, g_pl)
    assert hv_op.norm() > 0
    torch.testing.assert_close(hv_op, hv_pl, rtol=0, atol=1e-2 * hv_pl.abs().max().item())


def test_double_backward_is_the_adjoint_of_the_weight_gradient():
    """<fprop(x, dW', db'; mask out), g> = <wgrad(x, out, g), (dW', db')>:
    the masked forward is the weight gradient's adjoint."""
    frames, weight, bias = _inputs(3, 30, 26, 3, 8, seed=9)
    gen = torch.Generator().manual_seed(10)
    out = conv1.fprop(frames, weight, bias, 4)
    g = torch.randn(out.shape, generator=gen).to(BF16)
    gw, gb = torch.randn(weight.shape, generator=gen), torch.randn(32, generator=gen)
    dw, db = conv1.wgrad(frames, out, g, 8, 4)
    left = (conv1.fprop(frames, gw, gb, 4, mask=out).double() * g.double()).sum()
    right = (dw.double() * gw.double()).sum() + (db.double() * gb.double()).sum()
    assert torch.isclose(left, right, rtol=2e-2)
    assert torch.equal(conv1.fprop(frames, gw, gb, 4, mask=out)[out <= 0],
                       torch.zeros(int((out <= 0).sum()), dtype=BF16))


@pytest.mark.parametrize("change,match", [
    (dict(k=6), "weight|takes"),
    (dict(stride=4, k=4), "takes"),
    (dict(h=7), "smaller"),
    (dict(w=6), "smaller"),
    (dict(weight_c=4), "weight"),
    (dict(dims=3), "NHWC"),
], ids=lambda v: str(v) if isinstance(v, str) else "-".join(map(str, v)))
def test_refuses_what_the_kernel_does_not_take(change, match):
    c, k = change.get("c", 3), change.get("k", 8)
    stride = change.get("stride", conv1.GEOMETRY.get(k, 4))
    frames = torch.zeros((2, change.get("h", 40), change.get("w", 40), c), dtype=torch.uint8)
    if change.get("dims") == 3:
        frames = frames[0]
    weight = torch.zeros((32, change.get("weight_c", c), k, k))
    with pytest.raises(ValueError, match=match):
        conv1.conv1_stem(frames, weight, torch.zeros(32), stride)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.float16, torch.bool],
                         ids=str)
def test_other_frame_dtypes_read_as_float32(dtype):
    """The former torso read any real frames as ``frames.float()``: so does
    the stem, and its result equals the former one bit for bit."""
    frames, weight, bias = _inputs(2, 40, 36, 3, 8, seed=4)
    frames = frames.to(dtype) if dtype != torch.bool else frames > 127
    out = conv1.conv1_stem(frames, weight, bias, 4)
    assert torch.equal(out.permute(0, 3, 1, 2), _former(frames, weight, bias, 4))


def test_no_device_path_outside_cpu_and_cuda():
    frames, weight, bias = _inputs(1, 16, 16, 3, 8)
    with pytest.raises(ValueError, match="no path"):
        conv1.fprop(frames.to("meta"), weight.to("meta"), bias.to("meta"), 4)


def test_empty_batch():
    frames, weight, bias = _inputs(1, 16, 16, 3, 8)
    out = conv1.conv1_stem(frames[:0], weight, bias, 4)
    assert out.shape == (0, 3, 3, 32) and out.dtype == BF16


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _ulp_close(got, want, ulps=1.0):
    """Within ``ulps`` bf16 units in the last place of the output's scale."""
    scale = want.float().abs().max().item()
    tol = ulps * 2.0 ** (math.floor(math.log2(scale)) - 7)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol, scale)


# Beyond SHAPES: the cells' shapes at more frames; 45 channels (RGB x 15) on
# odd sizes in one pass, and at 224x224 in two passes of 23 channels in both
# kernels, the last holding a zero channel; 96 (the first-person view x 16)
# at 224x224, in four passes (forward) and two (weight gradient); 99 at the
# folded 112x112, the forward in two passes of 50.
CARD_SHAPES = SHAPES + [(64, 224, 224, 3, 8), (256, 112, 112, 3, 4), (3, 50, 47, 45, 8),
                        (2, 224, 224, 45, 8), (2, 224, 224, 96, 8), (2, 112, 112, 99, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_twin_on_card(shape, dtype, cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    frames, weight, bias = _inputs(*shape, seed=11, dtype=dtype, device=cuda_device)
    stride = conv1.GEOMETRY[shape[-1]]
    out = conv1.fprop_cuda(frames, weight, bias, stride)
    want = conv1.fprop_plain(frames, weight, bias, stride)
    torch.cuda.synchronize()
    _ulp_close(out, want)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    g = torch.randn(out.shape, generator=gen, device=cuda_device).to(BF16)
    dw, db = conv1.wgrad_cuda(frames, out, g, shape[-1], stride)
    # The twin at the kernel's own activation, in float32 so that its
    # rounding does not count against the kernel.
    x = conv1._scaled(frames).float()
    gm = torch.where(out > 0, g, 0).permute(0, 3, 1, 2).float()
    _, dw_ref, db_ref = torch.ops.aten.convolution_backward(
        gm, x, weight, [32], [stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
        [False, True, True])
    # Sound runs read 1e-7 to 4.0e-5; losing one block's partial sum (a
    # planted fault in the reduction) fails every uint8 case.
    for got, ref in ((dw, dw_ref), (db, db_ref)):
        assert (got - ref).norm() <= 1e-4 * ref.norm(), ((got - ref).norm(), ref.norm())
    dw2, db2 = conv1.wgrad_cuda(frames, out, g, shape[-1], stride)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(out, conv1.fprop_cuda(frames, weight, bias, stride))
    masked = conv1.fprop_cuda(frames, weight, -bias, stride, mask=out)
    _ulp_close(masked, conv1.fprop_plain(frames, weight, -bias, stride, mask=out))


@pytest.mark.gpu
def test_hessian_vector_product_on_card(cuda_device):
    frames, weight, bias = _inputs(8, 60, 60, 3, 8, seed=13)
    flat0 = torch.cat([weight.reshape(-1), bias])
    v = torch.randn(flat0.shape, generator=torch.Generator().manual_seed(14))
    stem = lambda f, w, b: conv1.conv1_stem(f, w, b, 4)
    g_cpu, hv_cpu = _hvp(stem, frames, flat0, weight.shape, v, 4)
    dev = cuda_device
    g_card, hv_card = _hvp(stem, frames.to(dev), flat0.to(dev), weight.shape, v.to(dev), 4)
    assert (g_card.cpu() - g_cpu).norm() <= 2e-2 * g_cpu.norm()
    assert (hv_card.cpu() - hv_cpu).norm() <= 2e-2 * hv_cpu.norm()

"""Model FLOPs of the Nature CNN actor-critic (two per multiply-add of
each convolution and linear layer; biases and activations not counted).

A frame traced at half resolution (``input_scale`` 2) is counted as the
program folds it: conv1 as 4x4 stride 2 on the traced image, which is
exactly the 8x8 stride 4 convolution of its 2x upsample."""
from __future__ import annotations

CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
FC = 512


def layer_flops(frame, n_actions: int, input_scale: int = 1) -> list:
    """Forward FLOPs of one frame, layer by layer: conv1, conv2, conv3, fc,
    heads. ``frame`` is the traced (H, W, C)."""
    h, w, c = frame
    out = []
    for i, (n_out, k, s) in enumerate(CONVS):
        if i == 0 and input_scale > 1:
            k, s = k // input_scale, s // input_scale
        h, w = (h - k) // s + 1, (w - k) // s + 1
        out.append(2 * h * w * n_out * k * k * c)
        c = n_out
    out.append(2 * h * w * c * FC)
    out.append(2 * FC * (n_actions + 1))
    return out


def forward_flops(frame, n_actions: int, input_scale: int = 1) -> int:
    return sum(layer_flops(frame, n_actions, input_scale))


def update_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one PPO update of one card's envs (``num_envs`` over
    ``dp``) for the configuration's ``frame``, ``n_actions`` and
    ``input_scale``: the rollout's forward of every step's frames and of the
    last, then each epoch's forward and backward of the batch; the backward
    is twice the forward but for conv1, whose input needs no gradient (its
    weight gradient only)."""
    layers = layer_flops(cfg["frame"], cfg["n_actions"], cfg.get("input_scale", 1))
    fwd = sum(layers)
    bwd = 2 * fwd - layers[0]
    num_envs = traffic["num_envs"] // traffic["dp"]
    batch = num_envs * traffic["n_steps"]
    return (batch + num_envs) * fwd + traffic["noptepochs"] * batch * (fwd + bwd)

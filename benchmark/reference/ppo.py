"""PPO2's arithmetic (Schulman et al. 2017, as stable-baselines' PPO2 and
optax compute it), written plainly in float32: generalized advantage
estimation, the clipped loss of a minibatch, the global-norm clip and
Adam."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2 = 0.9, 0.999


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """(advantages, returns) [T, N]; a done at step t cuts the bootstrap
    from t + 1."""
    adv = torch.zeros_like(values)
    next_value, next_adv = last_value, torch.zeros_like(last_value)
    for t in reversed(range(values.shape[0])):
        live = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * next_value * live - values[t]
        next_adv = delta + gamma * lam * live * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values


def log_prob(logits, actions):
    return F.log_softmax(logits, -1).gather(-1, actions.long()[:, None])[:, 0]


def minibatch_loss(logits, values, actions, old_logp, old_values, adv, returns,
                   adv_mean, adv_std, size: int, cfg: dict):
    """The part of a minibatch's clipped loss that these rows contribute:
    each term summed over the rows and divided by the minibatch's ``size``,
    the advantages normalized with the minibatch's mean and std (ddof 0).
    Returns (loss, the same sum of the terms' magnitudes)."""
    clip = cfg["cliprange"]
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(-1, actions.long()[:, None])[:, 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1)
    adv = (adv - adv_mean) / (adv_std + 1e-8)
    ratio = torch.exp(logp - old_logp)
    pg = torch.maximum(-adv * ratio, -adv * ratio.clamp(1.0 - clip, 1.0 + clip))
    v_clipped = old_values + (values - old_values).clamp(-clip, clip)
    vf = 0.5 * torch.maximum((values - returns) ** 2, (v_clipped - returns) ** 2)
    total = pg - cfg["ent_coef"] * entropy + cfg["vf_coef"] * vf
    size_ = (pg.abs() + cfg["ent_coef"] * entropy.abs() + cfg["vf_coef"] * vf.abs()).detach()
    return total.sum() / size, size_.sum() / size


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    if norm < max_norm:
        return grads
    return {k: g * (max_norm / norm) for k, g in grads.items()}


def adam_step(params: dict, grads: dict, state: dict, lr: float, eps: float) -> dict:
    """One Adam step (optax: bias-corrected moments, m / (sqrt(v) + eps));
    returns the new parameters and updates ``state`` in place."""
    state["count"] += 1
    c1, c2 = 1 - ADAM_B1 ** state["count"], 1 - ADAM_B2 ** state["count"]
    new = {}
    for k, g in grads.items():
        state["mu"][k] = ADAM_B1 * state["mu"][k] + (1 - ADAM_B1) * g
        state["nu"][k] = ADAM_B2 * state["nu"][k] + (1 - ADAM_B2) * g * g
        new[k] = params[k] - lr * (state["mu"][k] / c1) / (
            torch.sqrt(state["nu"][k] / c2) + eps)
    return new

"""The comparison that decides ``correct``: the reference follows the
program's first update, and each number below is held to its limit.

The rollout is followed step by step from the program's own env states (the
reference cannot sample the program's bfloat16 policy's actions itself, so
the actions are the program's, judged as a served model's tokens are):

* ``env_gap``: the widest gap, over every field of the env state, the
  reward, done and the episode counters, between the reference's reset of
  the drawn noise and the program's first state, and between the
  reference's auto-resetting step of each program state (with its action
  and drawn noise) and the program's next state;
* ``frame_gap``: over the observations the program returned at a few
  steps, against the reference's observation of the same state (the
  network's ``observe``: the render, or ground truth, or a frozen stage's
  encoding of the render): for uint8 frames the largest share of a frame's
  values that lie more than 2 from the reference's; for float observations
  the widest gap of a step's batch over the root mean square of the
  reference's;
* ``logp_gap``: the widest gap between the program's log-probability of
  each action it took and the reference's, over every step and env, the
  reference's policy run in float32 on its own observations (normalized as
  PPO2's running normalizer does, from the same start, where the
  configuration's ``normalize_obs`` says so: ``reference/normalize.py``);
* ``value_gap``: the root mean square gap between the program's values
  and the reference's, over the root mean square of the value head's
  magnitude (the sum of |weight x feature| over its inputs, from the
  network's ``forward``): the values of fresh weights sum terms of either
  sign, and over their own size a rounding gap swings with the seed;
* ``action_gap``: the widest gap by which the action the program took lies
  below the reference's best under the same Gumbel draw;
* ``gae_gap``: the widest gap between the program's advantages (and
  returns) and the reference's GAE of the reference's rewards and dones and
  the program's values and last value, over their root mean square: the
  arithmetic and the masking at episode ends, followed from the program's
  state (``value_gap`` judges the values).

No episode ends in the first update, so ``env_gap``, ``frame_gap`` and
``gae_gap`` are also read, the same way, over the first update after the
window in which one ends (``cell.check_update``): the auto-reset of the
env step, the frames of fresh episodes and GAE's cut of the bootstrap.
Where no such update came, ``env_gap`` reads ``MISSING``.

``schedule_gap`` is exact: whether the update ran its whole schedule. It
reads 1 where a row of the program's permutations is not a permutation of
the batch's rows or there are not ``noptepochs`` of them; otherwise the
largest of the share of the ``noptepochs x nminibatches`` optimizer steps
that did not run, and, epoch by epoch, the share of the batch's rows whose
(old log-probability, old value) the losses of that epoch did not see
exactly once (the multisets compared, sorted). It covers the steps past
the three that the reference follows.

Then the first three optimizer steps, on the program's permutation, from
the same weights (the network's trained leaves; a frozen stage is only
observed through): the reference's loss of each minibatch, its clip and
Adam, on its own frames, log-probabilities and values, with the program's
advantages (followed from the program's state; ``value_gap`` and
``gae_gap`` judge them): the returns are those advantages plus the
reference's values, as GAE makes them. An untrained policy's normalized
advantages are mostly its values' rounding, so the reference's own would
make every later number swing with the seed:

* ``mb_logp_gap``: the widest gap between the log-probabilities that the
  program's loss computed for the first step's minibatch, row by row in the
  permutation's order, and the reference's; where the program's loss saw
  another number of rows than the minibatch holds, ``MISSING``;
* ``loss_gap``: the gap between the first step's loss and the
  reference's, over the reference's sum of the loss terms' magnitudes (the
  terms cancel: the policy term's mean is near 0 at the first step). The
  later steps' losses are kept in the details and not compared: after one
  Adam step each weight has moved by about the learning rate in the sign of
  its gradient, and where that sign is rounding the two sides part, so their
  gaps follow the seed (PERF.md);
* ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step over 1 - beta1), by the worst leaf: the gap between the program's
  norm of the leaf and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``update_gap``: the change of the parameters after three steps, by the
  worst leaf, as for ``grad_gap``; leaves whose reference gradient is
  under a thousandth of the median leaf's are left out (they move by
  rounding alone under Adam);
* ``grad_diff``: the norm of the difference between the program's first
  gradient and the reference's, over the reference's norm, all leaves
  together. The norms of a leaf cannot tell a gradient of half the
  minibatch (after the global-norm clip, about as long) from the whole
  one's; the difference can.
* ``grad_norm_gap``: the first gradient as the program hands it to its
  optimizer step, before the global-norm clip, all leaves together: the gap
  between its norm and the reference's, over the reference's. After the clip
  a gradient of every rank's rows and one of a single rank's (or of three of
  four) point the same way at the same length, and neither ``grad_gap`` nor
  ``grad_diff`` can tell them apart; before it, the sum of a missing rank's
  rows is missing from the length.

A step that the program did not take makes the numbers read from it
``MISSING``.

``control`` puts the reference computed in float8 in the program's place:
its outputs are judged as the program's are.

On a dp mesh (``ranks``, the harness's collectives, ``ranks.py``) each
rank's reference follows that rank's own rows from the noise that rank drew,
and the optimizer steps are of the global minibatch: each rank's reference
computes the loss terms and gradient sums of the rows it owns, with the
minibatch's global advantage mean and std, and the harness adds them over
the ranks, apart from the program's collectives, so that a rank's gradient
missing from the program's all-reduce shows. The program's first losses
are its ranks' shares, added the same way. Each number is the worst rank's.
A normalizer's statistics over the ranks are not followed yet: such a cell
is refused."""
from __future__ import annotations

import math

import torch

from reference import normalize, ppo
from reference import vec_env as ref_env
from record import FOLLOWED_STEPS

NUMBERS = ("env_gap", "frame_gap", "logp_gap", "value_gap", "action_gap", "gae_gap",
           "schedule_gap", "mb_logp_gap", "loss_gap", "grad_gap", "update_gap", "grad_diff",
           "grad_norm_gap")
# The reading of a number that has nothing to compare (a row or a reset
# that the program did not produce): far above any limit, and plain JSON.
MISSING = 1e30
# Frames per block of the reference's forward and backward.
BLOCK = 2048


def _max_gap(a: dict, b: dict) -> float:
    gap = 0.0
    for k, x in a.items():
        y = b[k]
        if x.shape != y.shape:
            return MISSING
        if x.numel():
            gap = max(gap, float((x.double() - y.double()).abs().max()))
    return gap


def follow_env(rec, cfg, env) -> tuple:
    """(env_gap, the program's env state before each step and after the
    last, the reference's rewards [T, N] and dones [T, N]); for the first
    update, the reset too."""
    env_id = cfg["env_id"]
    ep_ret, ep_len = rec.ep0
    gap = 0.0
    if rec.reset_noise is not None:
        gap = max(_max_gap(ref_env.fields_of(env.apply_reset(rec.reset_noise)), rec.state0),
                  _max_gap({"ret": torch.zeros_like(ep_ret), "len": torch.zeros_like(ep_len)},
                           {"ret": ep_ret, "len": ep_len}))
    states = [rec.state0]
    rewards, dones = [], []
    for s in rec.steps:
        try:
            new, r, d, ret2, len2 = ref_env.step(
                env, ref_env.state_of(env_id, states[-1]), ep_ret, ep_len, s["action"],
                s["step_noise"], s["reset_noise"])
        except ValueError:
            return MISSING, states, None, None
        gap = max(gap, _max_gap(ref_env.fields_of(new), s["state"]),
                  _max_gap({"r": r, "d": d, "ret": ret2, "len": len2},
                           {"r": s["reward"], "d": s["done"], "ret": s["ep_return"],
                            "len": s["ep_length"]}))
        rewards.append(r)
        dones.append(d)
        states.append(s["state"])
        ep_ret, ep_len = s["ep_return"], s["ep_length"]
    return gap, states, torch.stack(rewards), torch.stack(dones)


def observe(net, env, env_id, state, params):
    """The program's observation, by the reference, of one state's fields."""
    return net.observe(env, ref_env.state_of(env_id, state), params)


def frame_gap(rec, obs) -> float:
    """The gap between the program's observations (the first state's, and
    those of the recorded steps) and the reference's, ``obs(i)`` those of
    state ``i``: for uint8 frames the largest share of one frame's values
    more than 2 from the reference's, for float observations the widest gap
    of a step over the reference's root mean square at that step."""
    pairs = [(rec.obs0, obs(0))] + [(f, obs(t + 1)) for t, f in rec.frames.items()]
    worst = 0.0
    for prog, ref in pairs:
        if prog.shape != ref.shape:
            return MISSING
        if ref.dtype == torch.uint8:
            off = (prog.to(ref.device).int() - ref.int()).abs() > 2
            worst = max(worst, float(off.flatten(1).float().mean(1).max()))
        else:
            gap = float((prog.to(ref.device).double() - ref.double()).abs().max())
            worst = max(worst, _over(gap, _rms(ref)))
    return worst


@torch.no_grad()
def policy(net, params, obs, cfg, precision):
    """(logits [M, A], values [M], the value head's magnitude [M]) of
    observations [M, ...], in blocks."""
    outs = [net.forward(params, obs[i:i + BLOCK], cfg, precision, magnitude=True)
            for i in range(0, obs.shape[0], BLOCK)]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def owned(idx, ranks):
    """The flat rows ``t * n + env`` of this rank's batch that the global
    flat indices ``idx`` (``t * N + env``) name, in ``idx``'s order: the
    rows whose env lies in the rank's ``[lo, hi)`` (all of ``idx`` without
    ``ranks``)."""
    if ranks is None:
        return idx
    lo, hi, n = ranks.rows
    env = idx % n
    keep = (env >= lo) & (env < hi)
    return ((idx // n) * (hi - lo) + env - lo)[keep]


def minibatch_stats(adv, ranks):
    """(mean, std with ddof 0) of a minibatch's advantages, over every rank's
    rows of it (two sums over the ranks: the mean, then the squared
    deviations from it)."""
    if ranks is None:
        return adv.mean(), adv.std(unbiased=False)
    a = adv.double()
    total = ranks.sum(torch.stack([a.sum(), a.new_tensor(float(a.numel()))]))
    mean = total[0] / total[1]
    var = ranks.sum(((a - mean) ** 2).sum()) / total[1]
    return mean.float(), var.sqrt().float()


def reference_pass(rec, net, cfg, traffic, params0, frames, rewards, dones, precision,
                   advantages=None, ranks=None):
    """The reference's outputs of the first update: log-probabilities of the
    program's actions, logits, values and their head's magnitude,
    advantages, returns, the first three losses and their terms' magnitude,
    the first gradient and the change after three steps. ``params0`` are
    the network's trained leaves, ``frames`` every state's observation as
    the policy gets it. The steps' advantages (flat) are ``advantages``, or
    the reference's own. With ``ranks``, the losses, gradients and changes
    are the global minibatch's (module docstring); the rest are this rank's
    rows'."""
    algo = {**cfg["algo_config"], **{k: traffic[k] for k in
                                     ("n_steps", "nminibatches", "noptepochs")}}
    t1, n = frames.shape[0] - 1, frames.shape[1]
    logits, values, v_scale = policy(net, params0, frames.flatten(0, 1), cfg, precision)
    logits = logits.view(t1 + 1, n, -1)
    values = values.view(t1 + 1, n)
    actions = torch.stack([s["action"] for s in rec.steps])
    logp = ppo.log_prob(logits[:t1].flatten(0, 1), actions.flatten()).view(t1, n)
    adv, ret = ppo.gae(rewards, values[:t1], dones, values[t1], algo["gamma"], algo["lam"])

    flat = lambda x: x.flatten(0, 1)
    fl_frames, fl_actions = frames[:t1].flatten(0, 1), flat(actions)
    fl_logp, fl_values = flat(logp), flat(values[:t1])
    fl_adv = flat(adv) if advantages is None else advantages
    fl_ret = fl_adv + fl_values
    mb = rec.perms.shape[1] // algo["nminibatches"]
    params = {k: v.clone() for k, v in params0.items()}
    opt = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    steps = [rec.perms[e, i * mb:(i + 1) * mb] for e in range(algo["noptepochs"])
             for i in range(algo["nminibatches"])][:FOLLOWED_STEPS]
    losses, sizes, g1, mb_logp = [], [], None, []
    for k, idx in enumerate(steps):
        lr = algo["learning_rate"]
        idx = owned(idx, ranks)
        stats = minibatch_stats(fl_adv[idx], ranks)
        loss = torch.zeros((), device=idx.device)
        size = torch.zeros((), device=idx.device)
        grads = {k2: torch.zeros_like(v) for k2, v in params.items()}
        for i in range(0, idx.shape[0], BLOCK):
            rows = idx[i:i + BLOCK]
            leaves = {k2: v.detach().requires_grad_(True) for k2, v in params.items()}
            lg, vp = net.forward(leaves, fl_frames[rows], cfg, precision)
            part, part_size = ppo.minibatch_loss(lg, vp, fl_actions[rows], fl_logp[rows],
                                                 fl_values[rows], fl_adv[rows], fl_ret[rows],
                                                 *stats, mb, algo)
            size = size + part_size
            if k == 0:
                mb_logp.append(ppo.log_prob(lg.detach(), fl_actions[rows]))
            for k2, g in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
                grads[k2] += g
            loss = loss + part.detach()
        if ranks is not None:
            loss, size = ranks.sum(torch.stack([loss, size]))
            summed = ranks.sum(torch.cat([g.reshape(-1) for g in grads.values()]))
            parts = torch.split(summed, [g.numel() for g in grads.values()])
            grads = {k2: p.view_as(g) for (k2, g), p in zip(grads.items(), parts)}
        losses.append(loss)
        sizes.append(size)
        if k == 0:
            g1_norm = _norm(grads)
        grads = ppo.clip_by_global_norm(grads, algo["max_grad_norm"])
        if k == 0:
            g1 = grads
        params = ppo.adam_step(params, grads, opt, lr, algo["adam_eps"])
    return {"logits": logits[:t1], "logp": logp, "values": values[:t1],
            "value_scale": v_scale.view(t1 + 1, n)[:t1], "adv": adv, "ret": ret,
            "gae_values": (values[:t1], values[t1]), "advantages": flat(adv),
            "losses": torch.stack(losses), "loss_scale": torch.stack(sizes), "g1": g1,
            "g1_norm": g1_norm,
            "mb_logp": torch.cat(mb_logp),
            "delta": {k: params[k] - params0[k] for k in params}}


def gae_gap(adv, ret, values, last_value, rewards, dones, algo) -> float:
    """The program's advantages and returns against the reference's GAE of
    the reference's rewards and dones and the program's values."""
    ref_adv, ref_ret = ppo.gae(rewards, values, dones, last_value, algo["gamma"], algo["lam"])
    if adv.shape != ref_adv.shape:
        return MISSING
    return max(_over(float((adv - ref_adv).abs().max()), _rms(ref_adv)),
               _over(float((ret - ref_ret).abs().max()), _rms(ref_ret)))


def schedule_gap(rec, algo, dp: int = 1) -> float:
    """Whether the recorded update ran its whole schedule (module
    docstring): 0 where it did. On a mesh of ``dp`` ranks the permutations
    are of the global batch, ``dp`` times this rank's rows, and each epoch's
    losses see this rank's rows."""
    epochs, mbs = algo["noptepochs"], algo["nminibatches"]
    _, logp, values, _, _ = rec.data
    rows = logp.shape[0]
    perms = rec.perms
    if perms.shape != (epochs, rows * dp):
        return 1.0
    whole = torch.arange(rows * dp, device=perms.device)
    if not all(torch.equal(p.sort().values, whole) for p in perms):
        return 1.0
    gap = abs(rec.n_opt_steps - epochs * mbs) / (epochs * mbs)
    if len(rec.seen) != epochs * mbs:
        return max(gap, abs(len(rec.seen) - epochs * mbs) / (epochs * mbs))
    batch = (logp.sort().values, values.sort().values)
    for e in range(epochs):
        parts = rec.seen[e * mbs:(e + 1) * mbs]
        seen = [torch.cat([p[k] for p in parts]).sort().values for k in range(2)]
        if seen[0].shape != batch[0].shape:
            gap = max(gap, abs(seen[0].shape[0] - rows) / rows)
            continue
        differ = (seen[0] != batch[0]) | (seen[1] != batch[1])
        gap = max(gap, float(differ.float().mean()))
    return gap


def check_numbers(rec, net, cfg, env, algo, params0) -> dict:
    """``env_gap``, ``frame_gap`` and ``gae_gap`` of an update after the
    window (``MISSING`` env_gap where no episode ended in it)."""
    gap, states, rewards, dones = follow_env(rec, cfg, env)
    if rewards is None:
        return dict.fromkeys(("env_gap", "frame_gap", "gae_gap"), MISSING)
    if not rec.dones():
        gap = MISSING
    obs = lambda i: observe(net, env, cfg["env_id"], states[i], params0)
    g = rec.gae
    return {"env_gap": gap, "frame_gap": frame_gap(rec, obs),
            "gae_gap": gae_gap(g["adv"], g["ret"], g["values"], g["last_value"], rewards,
                               dones, algo)}


def program_outputs(rec, params0, t1, n):
    actions, logp, values, adv, ret = rec.data
    g = rec.gae
    mb = (torch.cat([ppo.log_prob(lg.float(), a) for lg, a in rec.mb]) if rec.mb
          else torch.zeros(0))
    return {"advantages": adv, "actions": actions.view(t1, n), "mb_logp": mb,
            "logp": logp.view(t1, n),
            "values": values.view(t1, n), "adv": adv.view(t1, n), "ret": ret.view(t1, n),
            "gae_values": (g["values"], g["last_value"]),
            "losses": torch.stack(rec.losses) if rec.losses else None,
            "g1_norm": rec.grad_norm,
            "g1": None if rec.mu1 is None else
            {k: v / (1 - ppo.ADAM_B1) for k, v in rec.mu1.items()},
            "delta": None if rec.params3 is None else
            {k: rec.params3[k] - params0[k] for k in params0}}


def control_outputs(ctl, gumbel):
    return dict(ctl, actions=torch.argmax(ctl["logits"] + gumbel, -1))


def _norm(tree: dict) -> float:
    """The norm of every leaf of ``tree`` together, in float64."""
    return math.sqrt(sum(float(v.double().square().sum()) for v in tree.values()))


def _rms(x):
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


def _over(gap: float, scale: float) -> float:
    """``gap`` over ``scale``: 0 where both are, ``MISSING`` over a zero
    scale."""
    return gap / scale if scale > 0 else (0.0 if gap == 0 else MISSING)


def _leaf_gap(out: dict, ref: dict, keep) -> float:
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    median = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in keep:
        prog = float(torch.linalg.vector_norm(out[k].double()))
        worst = max(worst, abs(prog - norms[k]) / max(norms[k], median, 1e-30))
    return worst


def leaf_norms(out, ref) -> dict:
    """{leaf: [the program's first-gradient norm, the reference's, the
    program's change norm, the reference's]}: what ``grad_gap`` and
    ``update_gap`` are taken from, for a look at a reading."""
    n = lambda v: float(torch.linalg.vector_norm(v.double()))
    return {k: [n(out["g1"][k]), n(ref["g1"][k]), n(out["delta"][k]), n(ref["delta"][k])]
            for k in ref["g1"]}


def numbers(out, ref, gumbel, rewards, dones, algo) -> dict:
    """The rollout's and the steps' numbers of ``out`` (the program's or the
    control's outputs) against the float32 reference's ``ref``; ``rewards``
    and ``dones`` are the reference env's."""
    scores = ref["logits"] + gumbel
    taken = scores.gather(-1, out["actions"].long()[..., None])[..., 0]
    g_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["g1"].items()}
    g_median = sorted(g_norms.values())[len(g_norms) // 2]
    moving = [k for k, v in g_norms.items() if v >= 1e-3 * g_median]
    flat = lambda g: torch.cat([v.reshape(-1).double() for v in g.values()])
    g_ref = flat(ref["g1"])
    mb_gap = (float((out["mb_logp"] - ref["mb_logp"]).abs().max())
              if out["mb_logp"].shape == ref["mb_logp"].shape else MISSING)
    steps = {
        "loss_gap": lambda: _over(float((out["losses"][0] - ref["losses"][0]).abs()),
                                  float(ref["loss_scale"][0])),
        "grad_gap": lambda: _leaf_gap(out["g1"], ref["g1"], list(ref["g1"])),
        "update_gap": lambda: _leaf_gap(out["delta"], ref["delta"], moving),
        "grad_norm_gap": lambda: _over(abs(out["g1_norm"] - ref["g1_norm"]), ref["g1_norm"]),
        "grad_diff": lambda: _over(float(torch.linalg.vector_norm(flat(out["g1"]) - g_ref)),
                                   float(torch.linalg.vector_norm(g_ref))),
    }
    # A step that the program did not take reads ``MISSING``.
    needs = {"loss_gap": "losses", "grad_gap": "g1", "update_gap": "delta", "grad_diff": "g1",
             "grad_norm_gap": "g1_norm"}
    return {
        "logp_gap": float((out["logp"] - ref["logp"]).abs().max()),
        "mb_logp_gap": mb_gap,
        "value_gap": _over(_rms(out["values"] - ref["values"]), _rms(ref["value_scale"])),
        "action_gap": float((scores.max(-1).values - taken).max()),
        "gae_gap": gae_gap(out["adv"], out["ret"], *out["gae_values"], rewards, dones, algo),
        **{k: MISSING if out[needs[k]] is None else f() for k, f in steps.items()},
    }


def judge(rec, cell, params0, control: bool = False, details=None, check=None,
          ranks=None) -> dict:
    """Every number of ``NUMBERS`` for the recorded first update: the
    program's, or with ``control`` the float8 reference's in its place;
    with ``check``, the record of an update after the window, its env,
    frames and GAE too (and ``resets_checked``, the episode ends in it).
    ``details``, a dict, gets each leaf's norms and each step's losses.
    With ``ranks`` (a mesh: every rank calls it), the worst rank's numbers
    (module docstring)."""
    values = _judge(rec, cell, params0, control, details, check, ranks)
    return values if ranks is None else ranks.worst(values)


def _judge(rec, cell, params0, control, details, check, ranks) -> dict:
    cfg, traffic, net = cell.config, cell.traffic, cell.network
    algo = {**cfg["algo_config"], **{k: traffic[k] for k in
                                     ("n_steps", "nminibatches", "noptepochs")}}
    normalized = cfg.get("normalize_obs", False)
    if normalized and ranks is not None:
        raise ValueError("a normalizer's statistics over the ranks are not followed yet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trained = {k: v for k, v in params0.items() if net.trained(k)}
    env = ref_env.make_env(cfg["env_id"], cfg["env_options"])
    env_gap, states, rewards, dones = follow_env(rec, cfg, env)
    followed = rewards is not None
    if ranks is not None:
        # The ranks take the reference's steps together, or none does.
        followed = ranks.all(followed)
    if not followed:
        return dict.fromkeys(NUMBERS, MISSING)
    obs = torch.stack([observe(net, env, cfg["env_id"], s, params0) for s in states])
    frames = normalize.follow(obs) if normalized else obs
    dp = 1 if ranks is None else traffic["dp"]
    gap = {"env_gap": env_gap, "frame_gap": frame_gap(rec, lambda i: obs[i]),
           "schedule_gap": 0.0 if control else schedule_gap(rec, algo, dp)}
    t1, n = len(rec.steps), rewards.shape[1]
    gumbel = -torch.log(-torch.log(torch.stack(rec.u)))
    if control:
        out = control_outputs(reference_pass(rec, net, cfg, traffic, trained, frames,
                                             rewards, dones, "fp8", ranks=ranks), gumbel)
    else:
        out = program_outputs(rec, trained, t1, n)
        if ranks is not None:
            # The program's losses are its ranks' shares of the global ones.
            if ranks.all(out["losses"] is not None):
                out["losses"] = ranks.sum(out["losses"])
            else:
                out["losses"] = None
    ref = reference_pass(rec, net, cfg, traffic, trained, frames, rewards, dones, "fp32",
                         out["advantages"], ranks)
    if details is not None and all(out[k] is not None for k in ("g1", "delta", "losses")):
        details.update(leaves=leaf_norms(out, ref),
                       losses=[out["losses"].tolist(), ref["losses"].tolist(),
                               ref["loss_scale"].tolist()])
    values = {**gap, **numbers(out, ref, gumbel, rewards, dones, algo)}
    if check is not None:
        later = check_numbers(check, net, cfg, env, algo, params0)
        values.update({k: max(values[k], v) for k, v in later.items()},
                      resets_checked=check.dones())
    return values


def compared(limits: dict) -> list:
    """The numbers a cell holds to a limit: a limit of None marks a number
    with no upper reading in that cell, which is read but not compared
    (PERF.md names each with its readings)."""
    return [k for k in NUMBERS if limits.get(k) is not None]


def verdict(values: dict, limits: dict) -> bool:
    """Correct when every compared number is within its limit (and is a
    number)."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in compared(limits))

"""TRPO, port against reference on the CPU, on a discrete and a continuous
MobileRobot env (ground truth, MLP, 4 envs, 16 steps an update).

The reference runs one ``train_iteration``. Its internals (the surrogate's
gradient ``g``, the conjugate-gradient solution ``x`` and the accepted
line-search halving) are rebuilt in the test from the same formulas
(srl_tpu/agents/trpo.py:110-176) on the same rollout batch, rebuilt with
``collect_rollout`` under the same ``k_roll`` split; the port's ``update``
is fed that batch. ``g`` and ``x`` agree within rtol 1e-4 (plus 1e-4 of
their largest entry: the port's Fisher-vector product is a reverse-over-
reverse Hessian-vector product, the reference's a JVP of the KL gradient),
compared in the port's parameter order after the bridge maps the
reference's flat vector back; the accepted halving is the same; the final
parameters (after the 3 value-function Adam steps, which move the shared
torso too) within atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.trpo import TRPO as JTRPO
from srl_tpu.agents.trpo import TRPOConfig as JTRPOConfig
from srl_tpu.agents.trpo import _kl
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.trpo import TRPO, TRPOConfig
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)


def reference_internals(jagent, state):
    """(batch, g, x, accepted halving or -1) of the reference's update."""
    cfg = jagent.config
    apply = jagent.policy.apply
    _, k_roll = jax.random.split(state.key)
    _, _, _, last_obs, batch = jcommon.collect_rollout(
        jagent.vec_env, apply, state.params, state.vstate, state.obs, state.obs_norm,
        k_roll, cfg.n_steps)
    _, last_value = apply(state.params, last_obs)
    adv, ret = jcommon.compute_gae(batch.rewards, batch.values, batch.dones, last_value,
                                   cfg.gamma, cfg.lam)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    data = (flat(batch.obs), flat(batch.actions), flat(batch.log_probs), flat(adv),
            flat(ret))
    b_obs, b_act, b_logp, b_adv, _ = data
    b_adv = (b_adv - jnp.mean(b_adv)) / (jnp.std(b_adv) + 1e-8)
    flat_params, unravel = ravel_pytree(state.params)
    old_dist = jax.tree.map(jax.lax.stop_gradient, apply(state.params, b_obs)[0])

    def surrogate(fp):
        dist, _ = apply(unravel(fp), b_obs)
        ratio = jnp.exp(dist.log_prob(b_act) - b_logp)
        return jnp.mean(ratio * b_adv) + cfg.entcoeff * jnp.mean(dist.entropy())

    def mean_kl(fp):
        return jnp.mean(_kl(old_dist, apply(unravel(fp), b_obs)[0]))

    g = jax.grad(surrogate)(flat_params)

    def fvp(v):
        return jax.jvp(jax.grad(mean_kl), (flat_params,), (v,))[1] + cfg.cg_damping * v

    def cg_body(i, carry):
        x, r, p, rr = carry
        ap = fvp(p)
        alpha = rr / (jnp.dot(p, ap) + 1e-10)
        x, r = x + alpha * p, r - alpha * ap
        rr_new = jnp.dot(r, r)
        return x, r, r + (rr_new / (rr + 1e-10)) * p, rr_new

    x = jax.lax.fori_loop(0, cfg.cg_iters, cg_body, (jnp.zeros_like(g), g, g, jnp.dot(g, g)))[0]
    full_step = x * jnp.sqrt(2 * cfg.max_kl / jnp.maximum(jnp.dot(x, fvp(x)), 1e-10))
    before = surrogate(flat_params)
    ok = jnp.stack([
        (surrogate(flat_params + 0.5 ** i * full_step) - before > 0)
        & (mean_kl(flat_params + 0.5 ** i * full_step) <= cfg.max_kl * 1.5)
        for i in range(cfg.ls_steps)])
    accepted = jnp.where(ok.any(), jnp.argmax(ok), -1)
    return data, unravel(g), unravel(x), accepted


def in_port_order(tree, names):
    sd = bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), "mlp")
    return torch.cat([sd[k].reshape(-1) for k in names])


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_trpo_update_matches_reference(continuous):
    jagent = JTRPO(env=JMobile(max_steps=30, is_discrete=not continuous), num_envs=4,
                   config=JTRPOConfig(n_steps=16))
    state0 = jagent.init_state(jax.random.PRNGKey(0))
    state1, jmetrics = jax.jit(jagent.train_iteration)(state0)
    data, g_tree, x_tree, accepted = jax.jit(lambda s: reference_internals(jagent, s))(state0)

    agent = TRPO(env=MobileRobotEnv(max_steps=30, is_discrete=not continuous), num_envs=4,
                 config=TRPOConfig(n_steps=16), device="cpu")
    params = bridge.flax_to_state_dict(jax.tree.map(np.asarray, state0.params), "mlp")
    out, opt, metrics, diag = agent.update(
        params, agent.opt_init(params), tuple(torch.as_tensor(np.asarray(x)) for x in data))

    names = list(params)
    for got, ref in ((diag["g"], in_port_order(g_tree, names)),
                     (diag["x"], in_port_order(x_tree, names))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))
    assert diag["accepted_at"] == int(accepted) >= 0
    assert float(metrics["line_search_accepted"]) == float(jmetrics["line_search_accepted"])
    np.testing.assert_allclose(float(metrics["kl"]), float(jmetrics["kl"]), rtol=1e-3)
    assert opt["count"] == int(state1.opt_state[0].count) == 3
    expect = bridge.flax_to_state_dict(jax.tree.map(np.asarray, state1.params), "mlp")
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)

"""srl_tpu_torch.agents (PPO2, GAE) against srl_tpu.agents on the CPU.

``update_epochs`` runs 4 epochs x 4 minibatches with the MLP torso from
parameters and Adam state that the reference produced (one reference update
first, so the moments and the step count are not trivial), with the
reference's own permutations: parameters and metrics allclose at rtol 1e-4
(atol 1e-6 for values that start at zero). GAE agrees to 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.core.normalize import RunningNorm as JNorm
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu_torch import bridge
from srl_tpu_torch.agents import common as tcommon
from srl_tpu_torch.agents import ppo as tppo
from srl_tpu_torch.core.normalize import RunningNorm as TNorm
from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka

torch.set_num_threads(1)

N_UPDATES = 3
BATCH = 64


def jax_update_epochs(agent, params, opt_state, data, perms):
    """The reference's scanned epochs (srl_tpu/agents/ppo.py:266-297) with
    the permutations passed in."""
    cfg = agent.config
    mb_size = perms.shape[1] // cfg.nminibatches

    @jax.jit
    def step(params, opt_state, mb):
        (_, aux), grads = jax.value_and_grad(agent._loss, has_aux=True)(
            params, mb, cfg.cliprange)
        updates, opt_state = agent._tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, aux

    auxs = []
    for perm in perms:
        for i in range(cfg.nminibatches):
            idx = perm[i * mb_size:(i + 1) * mb_size]
            params, opt_state, aux = step(params, opt_state,
                                          tuple(x[idx] for x in data))
            auxs.append(aux)
    return params, opt_state, jax.tree.map(lambda *x: np.mean(np.stack(x)), *auxs)


@pytest.fixture(scope="module")
def setup():
    jagent = JPPO2(env=JKuka(srl_model="ground_truth"), num_envs=4, policy="mlp")
    jagent._tx = jagent._make_optimizer(N_UPDATES)
    tagent = tppo.PPO2(env=TKuka(srl_model="ground_truth"), num_envs=4, policy="mlp",
                       device="cpu")
    tagent.n_updates = N_UPDATES
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(BATCH, 3)).astype(np.float32)
    params = jagent.policy.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    dist, values = jagent.policy.apply(params, jnp.asarray(obs))
    actions = rng.integers(0, 6, BATCH).astype(np.int32)
    old_logp = np.asarray(dist.log_prob(jnp.asarray(actions)))
    old_values = np.asarray(values) + rng.normal(0, 0.1, BATCH).astype(np.float32)
    adv = rng.normal(size=BATCH).astype(np.float32)
    data = (obs, actions, old_logp, old_values, adv, (old_values + adv).astype(np.float32))
    return jagent, tagent, params, data


def perms_from(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return np.stack([np.asarray(jax.random.permutation(k, BATCH)) for k in keys])


def port_state(tree):
    return bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), "mlp")


def test_update_epochs_matches(setup):
    jagent, tagent, params, data = setup
    jdata = tuple(jnp.asarray(x) for x in data)
    # One reference update gives non-trivial Adam moments and step count 16.
    params1, opt1, _ = jax_update_epochs(jagent, params, jagent._tx.init(params), jdata,
                                         perms_from(1))
    adam = opt1[1][0]
    assert int(adam.count) == int(opt1[1][1].count) == 16
    perms = perms_from(2)
    params2, _, jmetrics = jax_update_epochs(jagent, params1, opt1, jdata, perms)

    t_params = port_state(params1)
    t_opt = {"count": int(adam.count), "mu": port_state(adam.mu),
             "nu": port_state(adam.nu)}
    t_data = tuple(torch.tensor(np.asarray(x)) for x in data)
    before = {k: v.clone() for k, v in t_params.items()}
    out_params, out_opt, metrics = tagent.update_epochs(
        t_params, t_opt, t_data, torch.from_numpy(perms).long())
    assert out_opt["count"] == 32 and t_opt["count"] == 16
    for k, v in t_params.items():  # the inputs are left as they are
        assert torch.equal(v, before[k]), k
    ref = port_state(params2)
    for k, v in out_params.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_global_norm_clip_matches_optax():
    rng = np.random.default_rng(3)
    for scale in (0.01, 1.0, 30.0):  # below, around and above max_norm 0.5
        grads = {"a": (scale * rng.normal(size=(5, 4))).astype(np.float32),
                 "b": (scale * rng.normal(size=7)).astype(np.float32)}
        ref, _ = optax.clip_by_global_norm(0.5).update(
            jax.tree.map(jnp.asarray, grads), optax.EmptyState())
        out = tppo.clip_by_global_norm_(
            {k: torch.tensor(v) for k, v in grads.items()}, 0.5)
        for k in grads:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                       atol=1e-9)


def test_lr_anneal_index_matches(setup):
    """The reference's lr at schedule step c, read off one optax update with
    a fixed Adam state: lr(c) = lr(0) * update(c) / update(0)."""
    jagent, tagent, params, _ = setup
    grads = jax.tree.map(lambda x: 1e-3 * jnp.ones_like(x), params)
    opt = jagent._tx.init(params)

    def first_update(count):
        sched = opt[1][1]._replace(count=jnp.asarray(count, jnp.int32))
        upd, _ = jagent._tx.update(grads, (opt[0], (opt[1][0], sched)), params)
        return float(upd["params"]["vf"]["bias"][0])

    base = first_update(0)
    for count in (0, 15, 16, 17, 31, 32, 47, 48, 64):
        expect = jagent.config.learning_rate * first_update(count) / base
        assert tagent.learning_rate(count) == pytest.approx(expect, rel=1e-6, abs=1e-12)


def test_compute_gae_within_one_ulp():
    rng = np.random.default_rng(4)
    t, n = 16, 8
    rewards = rng.normal(size=(t, n)).astype(np.float32)
    values = rng.normal(size=(t, n)).astype(np.float32)
    dones = rng.uniform(size=(t, n)) < 0.15
    last = rng.normal(size=n).astype(np.float32)
    gae = jax.jit(jcommon.compute_gae, static_argnums=(4, 5))
    jadv, jret = gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                     jnp.asarray(last), 0.99, 0.95)
    adv, ret = tcommon.compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                                   torch.from_numpy(dones), torch.from_numpy(last),
                                   0.99, 0.95)
    np.testing.assert_array_max_ulp(adv.numpy(), np.asarray(jadv), maxulp=1)
    np.testing.assert_array_max_ulp(ret.numpy(), np.asarray(jret), maxulp=1)


def test_explained_variance_matches():
    rng = np.random.default_rng(5)
    y = rng.normal(size=256).astype(np.float32)
    pred = (y + rng.normal(0, 0.5, 256)).astype(np.float32)
    ref = float(jcommon.explained_variance(jnp.asarray(pred), jnp.asarray(y)))
    out = float(tcommon.explained_variance(torch.from_numpy(pred), torch.from_numpy(y)))
    assert out == pytest.approx(ref, rel=1e-5)
    flat = torch.ones(8)
    assert np.isnan(float(tcommon.explained_variance(flat, flat)))


def test_jax_checkpoint_loads_into_port(setup, tmp_path):
    jagent, _, params, _ = setup
    jagent.state = jagent.init_state(jax.random.PRNGKey(0), N_UPDATES)
    path = str(tmp_path / "ppo2_model.pkl")
    jagent.save(path)
    agent = tppo.PPO2.load(path, env=TKuka(srl_model="ground_truth"), device="cpu")
    ref = port_state(jagent.state.params)
    for k, v in agent.state.params.items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy())
    np.testing.assert_array_equal(agent.state.obs_norm.mean.numpy(),
                                  np.asarray(jagent.state.obs_norm.mean))
    obs = np.zeros((2, 3), np.float32)
    np.testing.assert_array_equal(agent.getAction(obs, deterministic=True),
                                  jagent.getAction(obs, deterministic=True))


def test_running_norm_matches():
    """Chan update (ddof 0) over a few batches, then the clipped normalize."""
    rng = np.random.default_rng(6)
    jn, tn = JNorm.create((3,)), TNorm.create((3,))
    for _ in range(4):
        batch = (rng.normal(size=(16, 3)) * [1.0, 5.0, 0.01] + [0.0, 2.0, -1.0]).astype(
            np.float32)
        jn, tn = jn.update(jnp.asarray(batch)), tn.update(torch.from_numpy(batch))
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tn, k).numpy(), np.asarray(getattr(jn, k)),
                                   rtol=1e-5, err_msg=k)
    x = (rng.normal(size=(8, 3)) * 50).astype(np.float32)
    np.testing.assert_allclose(tn.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jn.normalize(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)

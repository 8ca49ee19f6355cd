"""PPO2 data-parallel over the ranks of a mesh (srl_tpu_torch.parallel),
against srl_tpu.parallel and the port's one-process runs, on the CPU
(tests/test_sharding.py:68-123). The ranks are threads of this process
(``run_ranks`` of tests/test_torch_parallel.py):

* one dp=4 ``update_epochs`` from the reference's data and permutations is
  within 1e-4 (pg_loss) and 1e-3 (parameters) of the reference's update on a
  ``make_mesh(n_devices=4)`` layout of the same state; every rank ends with
  the same parameters;
* a 12-update PPO2 curve on MobileRobot ground truth (normalized
  observations) on dp 1, 2 and 4 is within the reference's 5e-3 of the
  one-process curve.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.envs import mobile_robot as tm
from srl_tpu_torch.parallel import shard_ppo_state

from .test_torch_parallel import BUILD, run_ranks

torch.set_num_threads(1)


T_UPD, N_UPD = 8, 8


def test_dp4_update_matches_the_reference_mesh_update():
    """The update of tests/test_torch_ppo.py (the reference's data, Adam
    state after one update, permutations) with its [8 steps, 8 envs] batch
    over 4 ranks, against the reference's on a make_mesh(n_devices=4)
    layout of the same data and state."""
    from srl_tpu.agents.ppo import PPO2 as JPPO2
    from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
    from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka

    from .test_torch_ppo import jax_update_epochs, port_state

    batch = T_UPD * N_UPD
    jagent = JPPO2(env=JKuka(srl_model="ground_truth"), num_envs=N_UPD, policy="mlp")
    jagent._tx = jagent._make_optimizer(3)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(batch, 3)).astype(np.float32)
    params = jagent.policy.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    dist0, values = jagent.policy.apply(params, jnp.asarray(obs))
    actions = rng.integers(0, 6, batch).astype(np.int32)
    old_logp = np.asarray(dist0.log_prob(jnp.asarray(actions)))
    old_values = np.asarray(values) + rng.normal(0, 0.1, batch).astype(np.float32)
    adv = rng.normal(size=batch).astype(np.float32)
    data = (obs, actions, old_logp, old_values, adv, (old_values + adv).astype(np.float32))

    def perms_from(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), 4)
        return np.stack([np.asarray(jax.random.permutation(k, batch)) for k in keys])

    jdata = tuple(jnp.asarray(x) for x in data)
    params1, opt1, _ = jax_update_epochs(jagent, params, jagent._tx.init(params), jdata,
                                         perms_from(1))
    perms = perms_from(2)
    mesh4 = jmesh.make_mesh(n_devices=4, tp=1)
    params2, _, jmetrics = jax_update_epochs(
        jagent, jmesh.shard_params(params1, mesh4), jmesh.shard_params(opt1, mesh4),
        jmesh.shard_batch(jdata, mesh4), perms)
    assert len(jmesh.shard_batch(jdata, mesh4)[0].sharding.device_set) == 4

    adam = opt1[1][0]
    t_params = port_state(params1)
    t_opt = {"count": int(adam.count), "mu": port_state(adam.mu), "nu": port_state(adam.nu)}

    def rank_update(mesh):
        with BUILD:
            tagent = PPO2(env=TKuka(srl_model="ground_truth"), num_envs=N_UPD, policy="mlp",
                          device="cpu")
        tagent.n_updates = 3
        lo, hi = mesh.env_slice(N_UPD)
        local = tuple(torch.from_numpy(x.reshape((T_UPD, N_UPD) + x.shape[1:])[:, lo:hi]
                                       .reshape((-1,) + x.shape[1:]).copy()) for x in data)
        return tagent.update_epochs(t_params, t_opt, local, torch.from_numpy(perms).long(),
                                    mesh)

    out = run_ranks(4, rank_update)
    ref = port_state(params2)
    for new_params, new_opt, metrics in out:
        assert new_opt["count"] == 32
        for k, v in new_params.items():
            assert torch.equal(v, out[0][0][k]), f"ranks disagree on {k}"
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(metrics["pg_loss"]), float(jmetrics["pg_loss"]),
                                   rtol=1e-4, atol=1e-5)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def ppo_curve(mesh=None, updates=12):
    """pg_loss per update and the final flat parameters of PPO2 on
    MobileRobot ground truth (16 envs, 8 steps, 2 minibatches, 1 epoch),
    seed 3; with ``mesh``, data-parallel."""
    with BUILD:
        agent = PPO2(env=tm.MobileRobotEnv(), num_envs=16, device="cpu",
                     config=PPOConfig(n_steps=8, nminibatches=2, noptepochs=1))
        gen = torch.Generator().manual_seed(3)
        state = agent.init_state(gen, seed=3)
    agent.n_updates = updates
    if mesh is not None:
        state = shard_ppo_state(state, mesh)
    losses = []
    for _ in range(updates):
        state, metrics = agent.train_iteration(state, gen)
        losses.append(float(metrics["pg_loss"]))
    flat = torch.cat([v.reshape(-1) for v in state.params.values()])
    return np.array(losses), flat.numpy(), metrics, state


@pytest.fixture(scope="module")
def one_process_curve():
    return ppo_curve()


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_ppo_curve_across_dp(dp, one_process_curve):
    ref_losses, ref_params, ref_metrics, ref_state = one_process_curve
    out = run_ranks(dp, ppo_curve)
    for losses, params, metrics, state in out:
        assert np.array_equal(params, out[0][1]), "ranks disagree on the parameters"
        np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=1e-4)
        np.testing.assert_allclose(params, ref_params, rtol=5e-3, atol=1e-4)
        for k in ("vf_loss", "entropy", "explained_variance", "mean_reward_per_step"):
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=5e-3,
                                       atol=1e-4, err_msg=k)
        assert metrics["episode_return"].shape == ref_metrics["episode_return"].shape
        np.testing.assert_array_equal(metrics["episode_length"].numpy(),
                                      ref_metrics["episode_length"].numpy())
        for f in dataclasses.fields(state.obs_norm):
            np.testing.assert_allclose(getattr(state.obs_norm, f.name).numpy(),
                                       getattr(ref_state.obs_norm, f.name).numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert state.mesh.shape == {"dp": dp, "tp": 1} and state.obs.shape[0] == 16 // dp


def test_a_rank_that_owns_no_row_of_a_minibatch_still_steps():
    """Minibatches of 2 rows over 4 ranks: each minibatch leaves at least 2
    ranks without a row; they add zero gradients and join every all-reduce,
    and every rank takes the one-process step."""
    rng = np.random.default_rng(1)
    t, n = 4, 4
    cfg = PPOConfig(n_steps=t, nminibatches=8, noptepochs=2)

    def agent():
        with BUILD:
            a = PPO2(env=tm.MobileRobotEnv(), num_envs=n, device="cpu", config=cfg)
            params = a.init_params(0)
        return a, params

    one, params = agent()
    obs = torch.from_numpy(rng.normal(size=(t * n, 2)).astype(np.float32))
    with torch.no_grad():
        dist0, values = one.apply(params, obs)
    actions = torch.from_numpy(rng.integers(0, 4, t * n))
    adv = torch.from_numpy(rng.normal(size=t * n).astype(np.float32))
    data = (obs, actions, dist0.log_prob(actions), values, adv, values + adv)
    perms = torch.stack([torch.randperm(t * n, generator=torch.Generator().manual_seed(e))
                         for e in range(cfg.noptepochs)])
    want, _, want_metrics = one.update_epochs(params, one.opt_init(params), data, perms)

    def rank(mesh):
        a, _ = agent()
        lo, hi = mesh.env_slice(n)
        local = tuple(x.reshape((t, n) + x.shape[1:])[:, lo:hi].reshape((-1,) + x.shape[1:])
                      for x in data)
        return a.update_epochs(params, a.opt_init(params), local, perms, mesh)

    for got, _, metrics in run_ranks(4, rank):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), float(want_metrics[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)

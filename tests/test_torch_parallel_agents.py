"""PPO1, A2C and TRPO on a dp x tp mesh (srl_tpu_torch.parallel.
shard_ppo_state) against srl_tpu.parallel and against the port's
one-process runs, on the CPU. The ranks are threads of this process
(``run_ranks`` of tests/test_torch_parallel.py); the reference lays its
mesh over 2 of the 8 virtual CPU devices of tests/conftest.py.

* One update on dp2 ranks (MobileRobot ground truth, 8 envs, 8 steps; A2C
  its default 5),
  fed the reference's rollout batch (rebuilt under the same key splits)
  and, for PPO1, its epoch permutations, against the reference's jitted
  ``train_iteration`` on ``shard_ppo_state(state, make_mesh(n_devices=2))``
  from the same state, within the tolerances of each agent's one-process
  parity test: PPO1 tests/test_torch_ppo.py (parameters and metrics rtol
  1e-4, atol 1e-6), A2C tests/test_torch_a2c.py (its second update, from
  the mesh's RMSProp state: parameters rtol 1e-6, ``nu`` rtol 2e-6, losses
  rtol 1e-5), TRPO tests/test_torch_trpo.py (the line search accepting as
  the reference's, the KL rtol 1e-3, parameters atol 1e-5; its ``g`` and
  ``x`` are held there). Every rank ends with the same parameters.
* A 4-update curve on MobileRobot ground truth (16 envs) on dp 1 and dp 2 is
  within 5e-3 of the port's one process (tests/test_torch_parallel_ppo.py's
  bar), every rank alike.
* tp changes placement only: dp2 x tp2 is dp2 x tp1 bit for bit (parameters,
  the optimizer's moments, the normalizer, the metrics).
* The first gradients the agent hands on (``BaseRLAgent.grad_probe``) are
  one process's on every dp2 rank, |g_dp - g_one| <= 1e-5 |g_one|.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.a2c import A2C as JA2C
from srl_tpu.agents.ppo import PPOConfig as JPPOConfig
from srl_tpu.agents.ppo1 import PPO1 as JPPO1
from srl_tpu.agents.trpo import TRPO as JTRPO
from srl_tpu.agents.trpo import TRPOConfig as JTRPOConfig
from srl_tpu.core.env import VecEnvState as JVecEnvState
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.envs.mobile_robot import MobileRobotState as JMobileRobotState
from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.a2c import A2C
from srl_tpu_torch.agents.ppo import PPOConfig
from srl_tpu_torch.agents.ppo1 import PPO1
from srl_tpu_torch.agents.trpo import TRPO, TRPOConfig
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from srl_tpu_torch.parallel import shard_params, shard_ppo_state

from .test_torch_parallel import BUILD, run_ranks

torch.set_num_threads(1)

N, T, N_UPDATES = 8, 8, 3
PPO1_CONFIG = dict(n_steps=T, nminibatches=2, noptepochs=2, learning_rate=1e-3)
t = lambda x: torch.as_tensor(np.array(x))


def to_port(tree):
    return bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), "mlp")


def reference_state(jagent, agent, *args, seed=0):
    """The reference's fresh state (``jagent.init_state(key, *args)``, run
    eagerly) around the port's fresh env batch and parameters from
    ``seed``: the reference's env reset and network init hand back the
    port's, so no init is compiled (a compile costs several seconds of the
    test budget). The env keys are fresh; the tests read every draw off the
    state's keys."""
    port = agent.init_state(torch.Generator().manual_seed(seed), seed)
    n = agent.num_envs
    env = port.vstate.env_state
    vstate = JVecEnvState(
        env_state=JMobileRobotState(
            key=jax.random.split(jax.random.PRNGKey(seed + 1), n),
            **{f.name: jnp.asarray(getattr(env, f.name).numpy())
               for f in dataclasses.fields(env)}),
        ep_return=jnp.zeros(n, jnp.float32), ep_length=jnp.zeros(n, jnp.int32),
        key=jax.random.PRNGKey(seed + 2))
    params = jax.tree.map(jnp.asarray, agent._flax(port.params))
    net = "net" if hasattr(jagent, "net") else "policy"
    real_net, real_reset = getattr(jagent, net), jagent.vec_env.reset
    setattr(jagent, net, types.SimpleNamespace(init=lambda *a: params,
                                               n_lstm=getattr(real_net, "n_lstm", None)))
    jagent.vec_env.reset = lambda key: (vstate, jnp.asarray(port.obs.numpy()))
    try:
        return jagent.init_state(jax.random.PRNGKey(seed), *args)
    finally:
        setattr(jagent, net, real_net)
        jagent.vec_env.reset = real_reset


# name -> (reference agent, port agent, keys train_iteration splits its key into)
AGENTS = {
    "ppo1": (lambda: JPPO1(env=JMobile(max_steps=30), num_envs=N,
                           config=JPPOConfig(**PPO1_CONFIG)),
             lambda: PPO1(env=MobileRobotEnv(max_steps=30), num_envs=N, device="cpu",
                          config=PPOConfig(**PPO1_CONFIG)), 3),
    "a2c": (lambda: JA2C(env=JMobile(max_steps=30), num_envs=N),
            lambda: A2C(env=MobileRobotEnv(max_steps=30), num_envs=N, device="cpu"), 2),
    "trpo": (lambda: JTRPO(env=JMobile(max_steps=30), num_envs=N,
                           config=JTRPOConfig(n_steps=T)),
             lambda: TRPO(env=MobileRobotEnv(max_steps=30), num_envs=N, device="cpu",
                          config=TRPOConfig(n_steps=T)), 2),
}


def reference_batch(jagent, state, n_keys, lam):
    """The flat rollout batch (obs, actions, log_probs, values, advantages,
    returns) of ``state``'s ``train_iteration``, rebuilt under its key
    split."""
    cfg = jagent.config
    k_roll = jax.random.split(state.key, n_keys)[1]
    _, _, _, last_obs, batch = jcommon.collect_rollout(
        jagent.vec_env, jagent.policy.apply, state.params, state.vstate, state.obs,
        state.obs_norm, k_roll, cfg.n_steps)
    _, last_value = jagent.policy.apply(state.params, last_obs)
    adv, ret = jcommon.compute_gae(batch.rewards, batch.values, batch.dones, last_value,
                                   cfg.gamma, lam)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return tuple(flat(x) for x in (batch.obs, batch.actions, batch.log_probs, batch.values,
                                   adv, ret))


@functools.lru_cache(maxsize=None)
def reference_step(name):
    """(reference agent, state, its jitted train_iteration on a dp2 mesh:
    (state', metrics), the batch rebuilt from the state, PPO1's
    permutations). PPO1's and TRPO's batch comes out of the step's own jit
    (one compile); A2C's state is the mesh's after one update, so that
    RMSProp's ``nu`` is not zero (as tests/test_torch_a2c.py), and its batch
    is rebuilt apart, as that test rebuilds it (fused into the step, the
    rollout rounds a bias's second update 4e-6 away)."""
    make, make_port, n_keys = AGENTS[name]
    jagent = make()
    if name == "a2c":
        # The reference's own initial state (key 0, as tests/test_torch_a2c.py):
        # A2C's rtol 1e-6 on its second update sits at the float32 rounding of
        # the ranks' sums, and from the port's initial state vf.bias ends
        # 3.8e-6 off.
        state = jax.jit(lambda k: jagent.init_state(k, N_UPDATES))(jax.random.PRNGKey(0))
    else:
        state = reference_state(jagent, make_port(), N_UPDATES)
    state = jmesh.shard_ppo_state(state, jmesh.make_mesh(n_devices=2))
    if name == "a2c":
        step = jax.jit(jagent.train_iteration)
        state, _ = step(state)
        new_state, jmetrics = step(state)
        batch = jax.jit(lambda s: reference_batch(jagent, s, n_keys, 1.0))(state)
    else:
        (new_state, jmetrics), batch = jax.jit(lambda s: (
            jagent.train_iteration(s), reference_batch(jagent, s, n_keys, jagent.config.lam)))(
                state)
    assert len(new_state.vstate.env_state.robot_pos.sharding.device_set) == 2
    perms = None
    if name == "ppo1":
        k_perm = jax.random.split(state.key, 3)[2]
        perms = np.stack([np.asarray(jax.random.permutation(k, N * T)) for k in
                          jax.random.split(k_perm, jagent.config.noptepochs)])
    return jagent, state, new_state, jmetrics, batch, perms


def rank_rows(x, mesh):
    """The rank's env columns of a flat [steps * N, ...] batch, flat."""
    lo, hi = mesh.env_slice(N)
    x = torch.as_tensor(np.array(x))
    return x.reshape((-1, N) + x.shape[1:])[:, lo:hi].reshape((-1,) + x.shape[1:])


def rank_update(name, mesh):
    """The port's update on this rank from the reference's state and batch:
    (whole parameters, whole optimizer moments, metrics, diagnostics)."""
    jagent, state, _, _, batch, perms = reference_step(name)
    with BUILD:
        agent = AGENTS[name][1]()
    agent.n_updates = N_UPDATES
    params = to_port(state.params)
    opt = agent.opt_init(params)
    if name == "a2c":
        opt = {"count": 1, "nu": to_port(state.opt_state[1][0].nu)}
    params, opt = shard_params(params, mesh), shard_params(opt, mesh)
    diag = None
    if name == "ppo1":
        data = tuple(rank_rows(x, mesh) for x in batch)
        params, opt, metrics = agent.update_epochs(params, opt, data, t(perms).long(), mesh)
    elif name == "a2c":
        obs, actions, _, _, adv, ret = (rank_rows(x, mesh) for x in batch)
        params, opt, metrics = agent.update(params, opt, (obs, actions, adv, ret), mesh)
    else:
        obs, actions, logp, _, adv, ret = (rank_rows(x, mesh) for x in batch)
        params, opt, metrics, diag = agent.update(params, opt, (obs, actions, logp, adv, ret),
                                                  mesh)
    moments = {m: agent.whole_params(opt[m], mesh) for m in ("mu", "nu") if m in opt}
    return agent.whole_params(params, mesh), moments, opt["count"], metrics, diag


@pytest.mark.parametrize("name", list(AGENTS))
def test_dp2_update_matches_the_reference_mesh_step(name):
    jagent, _, new_state, jmetrics, batch, _ = reference_step(name)
    out = run_ranks(2, lambda mesh: rank_update(name, mesh))
    ref = to_port(new_state.params)
    for params, moments, count, metrics, diag in out:
        for k, v in params.items():
            assert torch.equal(v, out[0][0][k]), f"ranks disagree on {k}"
        if name == "ppo1":
            adam = new_state.opt_state[1][0]
            assert count == int(adam.count) == 4
            for k, v in params.items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
            for k, v in metrics.items():
                np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        elif name == "a2c":
            assert count == 2
            nu = to_port(new_state.opt_state[1][0].nu)
            for k, v in params.items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-9,
                                           err_msg=k)
                np.testing.assert_allclose(moments["nu"][k].numpy(), nu[k].numpy(), rtol=2e-6,
                                           atol=1e-12, err_msg=k)
            for k, v in metrics.items():
                np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5, err_msg=k)
        else:
            assert diag["accepted_at"] >= 0
            assert (float(metrics["line_search_accepted"])
                    == float(jmetrics["line_search_accepted"]))
            np.testing.assert_allclose(float(metrics["kl"]), float(jmetrics["kl"]), rtol=1e-3)
            assert count == int(new_state.opt_state[0].count) == 3
            for k, v in params.items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-5,
                                           err_msg=k)


# ---- curves and tp -----------------------------------------------------------------

CURVE_AGENTS = {
    "ppo1": lambda: PPO1(env=MobileRobotEnv(), num_envs=16, device="cpu",
                         config=PPOConfig(**PPO1_CONFIG)),
    "a2c": lambda: A2C(env=MobileRobotEnv(), num_envs=16, device="cpu"),
    "trpo": lambda: TRPO(env=MobileRobotEnv(), num_envs=16, device="cpu",
                         config=TRPOConfig(n_steps=T)),
}
CURVE_METRIC = {"ppo1": "pg_loss", "a2c": "pg_loss", "trpo": "kl"}


def curve(name, mesh=None, updates=4):
    """The per-update losses, the whole final state, the last metrics and
    the first gradients (``grad_probe``) of ``updates`` updates on
    MobileRobot ground truth (normalized observations), seed 3; with
    ``mesh``, laid out on it."""
    with BUILD:
        agent = CURVE_AGENTS[name]()
        gen = torch.Generator().manual_seed(3)
        state = agent.init_state(gen, seed=3)
    agent.n_updates = updates
    agent.grad_probe = {}
    if mesh is not None:
        state = shard_ppo_state(state, mesh)
    losses = []
    for _ in range(updates):
        state, metrics = agent.train_iteration(state, gen)
        losses.append(float(metrics[CURVE_METRIC[name]]))
    return np.array(losses), agent.whole_state(state), metrics, agent.grad_probe


@functools.lru_cache(maxsize=None)
def curves(name, n=0, tp=1):
    """``curve`` in one process (n = 0) or on each rank of a mesh of n."""
    return [curve(name)] if n == 0 else run_ranks(n, lambda mesh: curve(name, mesh), tp=tp)


def flat_params(state):
    return torch.cat([v.reshape(-1) for v in state.params.values()]).numpy()


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("name", list(CURVE_AGENTS))
def test_curve_across_dp(name, dp):
    (ref_losses, ref_state, ref_metrics, _), = curves(name)
    out = curves(name, dp)
    for losses, state, metrics, _ in out:
        assert state.mesh.shape == {"dp": dp, "tp": 1} and state.obs.shape[0] == 16 // dp
        assert np.array_equal(flat_params(state), flat_params(out[0][1]))
        np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=1e-4)
        np.testing.assert_allclose(flat_params(state), flat_params(ref_state), rtol=5e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(float(metrics["mean_reward_per_step"]),
                                   float(ref_metrics["mean_reward_per_step"]), rtol=5e-3,
                                   atol=1e-4)
        np.testing.assert_array_equal(metrics["episode_length"].numpy(),
                                      ref_metrics["episode_length"].numpy())
        for f in dataclasses.fields(state.obs_norm):
            np.testing.assert_allclose(getattr(state.obs_norm, f.name).numpy(),
                                       getattr(ref_state.obs_norm, f.name).numpy(),
                                       rtol=1e-5, atol=1e-6)


def flat_state(state, metrics) -> dict:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"{m}/{k}": v for m, tree in state.opt_state.items() if isinstance(tree, dict)
                for k, v in tree.items()})
    out.update({f"obs_norm/{f.name}": getattr(state.obs_norm, f.name)
                for f in dataclasses.fields(state.obs_norm)})
    out.update({f"metrics/{k}": v for k, v in metrics.items()})
    out["count"] = torch.tensor(state.opt_state["count"])
    return out


@pytest.mark.parametrize("name", list(CURVE_AGENTS))
def test_dp2_tp2_is_dp2_tp1(name):
    tp1, tp2 = curves(name, 2), curves(name, 4, 2)
    for r, (losses, state, metrics, _) in enumerate(tp2):
        assert state.mesh.shape == {"dp": 2, "tp": 2} and state.obs.shape[0] == 8
        got, want = flat_state(state, metrics), flat_state(*tp1[r // 2][1:3])
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v) or (v.isnan().all() and got[k].isnan().all()), k
        assert np.array_equal(losses, tp1[r // 2][0])


@pytest.mark.parametrize("name", list(CURVE_AGENTS))
def test_first_gradients_on_dp2_are_one_process_s(name):
    (*_, want), = curves(name)
    assert set(want) == ({"grads", "surrogate"} if name == "trpo" else {"grads"})
    for *_, got in curves(name, 2):
        assert set(got) == set(want)
        for site, g in want.items():
            assert (got[site] - g).norm() <= 1e-5 * g.norm(), site

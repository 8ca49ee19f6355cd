"""PPO2 on a dp x tp mesh (srl_tpu_torch.parallel with ``tp > 1``) against
srl_tpu.parallel and against the port's dp runs, on the CPU. The ranks are
threads of this process, the dp and tp sub-groups gloo backends on prefixes
of the ranks' shared store (``run_ranks`` of tests/test_torch_parallel.py);
the reference lays its meshes over the 8 virtual CPU devices of
tests/conftest.py.

* The layout, leaf by leaf: the leaves ``jmesh.shard_params`` spreads over
  ``tp`` (read from each leaf's ``NamedSharding.spec``) are the leaves the
  port shards, on the MLP, the Nature CNN with its conv1 fold and a
  continuous head, at tp 2 and 4 (Kuka's ``pi.weight`` [6, 512] stays whole
  at tp 4); each rank's shard is its slice of the bridged whole leaf.
* One dp4 x tp2 ``update_epochs``, from a first update's Adam moments, is
  within the reference's bars of its update on ``make_mesh(n_devices=8,
  tp=2)``, and one dp4 x tp2 ``train_iteration`` on MobileRobot, fed the
  reference's draws, of the reference's ``train_iteration`` on that mesh
  (tests/test_sharding.py:127-145).
* tp changes placement only: dp2 x tp2 is dp2 x tp1 bit for bit
  (parameters, Adam's state, the normalizer and its count, the metrics),
  where the clip fires too (the norm's squares are summed in float64, so
  the tp group's partial sums round as the whole leaves do); the same for a
  dp1 x tp2 CNN update over 36x36 frames with the conv1 fold.
* A tp run's ``save`` and ``save_checkpoint`` write whole leaves that both
  packages read, and a loaded checkpoint laid out on a tp mesh gives each
  rank its slice.
"""
import dataclasses
import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.agents.ppo import PPOConfig as JPPOConfig
from srl_tpu.core import spaces as jspaces
from srl_tpu.envs import mobile_robot as jm
from srl_tpu.models.policies import make_policy as jmake_policy
from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import PPOState
from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.core import spaces as tspaces
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.envs import mobile_robot as tm
from srl_tpu_torch.models.policies import make_policy
from srl_tpu_torch.parallel import shard_params, shard_ppo_state
from srl_tpu_torch.parallel.mesh import gather_params

from .test_torch_mobile_robot import _reset_draws, _step_draws, jax_reset_noise
from .test_torch_parallel import BUILD, run_ranks

torch.set_num_threads(1)

PG_RTOL, PG_ATOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5, 1e-3, 1e-5


def to_port(tree, torso="mlp"):
    return bridge.flax_to_state_dict(jax.tree.map(np.asarray, tree), torso)


# ---- the layout (srl_tpu/parallel/mesh.py:60-73) -----------------------------

POLICIES = {
    # MobileRobot ground truth: 2-d states, 4 actions.
    "mlp": (lambda s: s.Discrete(4), (2,), "mlp", 1),
    # Kuka's coarse pixels: 6 actions, the 2x upsample folded into conv1.
    "cnn": (lambda s: s.Discrete(6), (32, 32, 3), "cnn", 2),
    # A continuous head: log_std [2].
    "continuous": (lambda s: s.Box(-1.0, 1.0, (2,)), (2,), "mlp", 1),
}


@functools.lru_cache(maxsize=None)
def layout_case(kind):
    """(the port's fresh parameters, the same in the reference's tree),
    the tree held to the shapes the reference's ``init`` gives."""
    space, obs_shape, torso, scale = POLICIES[kind]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        whole = {k: v.detach() for k, v in
                 make_policy(space(tspaces), obs_shape, torso, scale).state_dict().items()}
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(whole, torso))
    jpolicy = jmake_policy(space(jspaces), obs_shape, torso, input_scale=scale)
    obs = jax.ShapeDtypeStruct((1,) + obs_shape, jnp.uint8 if torso == "cnn" else jnp.float32)
    want = jax.eval_shape(jpolicy.init, jax.random.PRNGKey(0), obs)
    assert jax.tree.structure(want) == jax.tree.structure(params)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(want),
                                                    jax.tree.leaves(params)))
    return whole, params


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(POLICIES))
def test_layout_matches_the_reference_leaf_by_leaf(kind, tp):
    torso = POLICIES[kind][2]
    whole, params = layout_case(kind)
    laid = jmesh.shard_params(params, jmesh.make_mesh(n_devices=8, tp=tp))
    # Each leaf's "is it spread over tp" as a leaf of its own shape, named
    # through the bridge.
    spread = to_port(jax.tree.map(
        lambda x: np.full(x.shape, "tp" in tuple(x.sharding.spec), np.float32), laid), torso)
    ref_sharded = {k for k, v in spread.items() if v.reshape(-1)[0] == 1}
    assert set(spread) == set(whole)
    shapes = {k: tuple(v.shape) for k, v in whole.items()}

    def rank(mesh):
        shards = shard_params(whole, mesh)
        return mesh.tp_index, shards, gather_params(shards, mesh, shapes)

    out = run_ranks(tp, rank, tp=tp)
    for t, shards, gathered in out:
        assert {k for k, v in shards.items() if v.shape != whole[k].shape} == ref_sharded
        for k, v in shards.items():
            n = v.shape[0] if k in ref_sharded else 0
            assert torch.equal(v, whole[k][t * n:(t + 1) * n] if n else whole[k]), k
            assert torch.equal(gathered[k], whole[k]), k
    assert "vf.weight" not in ref_sharded  # [1, 64] or [1, 512]: whole
    if kind == "cnn":
        assert ("pi.weight" in ref_sharded) == (tp == 2)  # [6, 512]: whole at tp 4
        assert {"torso.c1.weight", "torso.c2.weight", "torso.fc.weight"} <= ref_sharded
    if kind == "continuous":
        assert ("log_std" in ref_sharded) == (tp == 2)


# ---- one update against the reference's dp4 x tp2 ------------------------------

T_UPD, N_UPD = 8, 8


def test_dp4_tp2_update_matches_the_reference_mesh_update():
    """tests/test_torch_parallel_ppo.py's dp4 update on a dp4 x tp2 mesh:
    the rank's rows of the data, its tp shards of the parameters and of
    Adam's moments after a first update (one process here, on the mesh in
    the reference's one call over both updates' epochs)."""
    from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
    from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka

    from .test_torch_ppo import jax_update_epochs

    batch = T_UPD * N_UPD
    jagent = JPPO2(env=JKuka(srl_model="ground_truth"), num_envs=N_UPD, policy="mlp")
    jagent._tx = jagent._make_optimizer(3)
    with BUILD:
        tagent = PPO2(env=TKuka(srl_model="ground_truth"), num_envs=N_UPD, policy="mlp",
                      device="cpu")
        t_params = tagent.init_params(0)
    # The port's initial parameters and policy outputs, one compile fewer
    # for the reference.
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(t_params, "mlp"))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(batch, 3)).astype(np.float32)
    actions = rng.integers(0, 6, batch).astype(np.int32)
    with torch.no_grad():
        dist0, values = tagent.apply(t_params, torch.from_numpy(obs))
        old_logp = dist0.log_prob(torch.from_numpy(actions)).numpy()
    old_values = values.numpy() + rng.normal(0, 0.1, batch).astype(np.float32)
    adv = rng.normal(size=batch).astype(np.float32)
    data = (obs, actions, old_logp, old_values, adv, (old_values + adv).astype(np.float32))

    # Two updates' epochs in one reference call (one compile): the second
    # update starts from the first's Adam moments and count.
    jdata = tuple(jnp.asarray(x) for x in data)
    perms = [np.stack([rng.permutation(batch) for _ in range(4)]) for _ in range(2)]
    mesh8 = jmesh.make_mesh(n_devices=8, tp=2)
    laid = jmesh.shard_params(params, mesh8)
    assert len(laid["params"]["MlpTorso_0"]["fc0"]["kernel"].sharding.device_set) == 8
    params2, _, jmetrics = jax_update_epochs(
        jagent, laid, jmesh.shard_params(jagent._tx.init(params), mesh8),
        jmesh.shard_batch(jdata, mesh8), np.concatenate(perms))

    # The port's first update in one process gives the mesh update
    # non-trivial Adam moments to start from.
    tagent.n_updates = 3
    params1, opt1, metrics1 = tagent.update_epochs(
        t_params, tagent.opt_init(t_params), tuple(torch.from_numpy(x) for x in data),
        torch.from_numpy(perms[0]).long())

    def rank_update(mesh):
        with BUILD:
            tagent = PPO2(env=TKuka(srl_model="ground_truth"), num_envs=N_UPD, policy="mlp",
                          device="cpu")
        tagent.n_updates = 3
        lo, hi = mesh.env_slice(N_UPD)
        local = tuple(torch.from_numpy(x.reshape((T_UPD, N_UPD) + x.shape[1:])[:, lo:hi]
                                       .reshape((-1,) + x.shape[1:]).copy()) for x in data)
        new_params, new_opt, metrics = tagent.update_epochs(
            shard_params(params1, mesh), shard_params(opt1, mesh), local,
            torch.from_numpy(perms[1]).long(), mesh)
        metrics = {k: (metrics1[k] + v) / 2 for k, v in metrics.items()}
        return (new_params, tagent.whole_params(new_params, mesh), new_opt["count"], metrics)

    out = run_ranks(8, rank_update, tp=2)
    ref = to_port(params2)
    for shards, whole, count, metrics in out:
        assert count == 32
        assert shards["torso.fc0.weight"].shape == (32, 3)
        for k, v in whole.items():
            assert torch.equal(v, out[0][1][k]), f"ranks disagree on {k}"
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(float(metrics["pg_loss"]), float(jmetrics["pg_loss"]),
                                   rtol=PG_RTOL, atol=PG_ATOL)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


# ---- train_iteration as test_dp_tp_mesh_ppo_compiles_and_runs -------------------

N_ENVS, N_STEPS = 8, 8
TI_CONFIG = dict(n_steps=N_STEPS, nminibatches=2, noptepochs=2)


def test_dp4_tp2_train_iteration_matches_the_reference():
    """MobileRobot, 8 envs, 8 steps, 2 minibatches, 2 epochs on dp4 x tp2;
    the port's ranks act, step and shuffle with the reference's draws (its
    sampled actions, env noise and permutations, read off its keys)."""
    jenv = jm.MobileRobotEnv()
    jagent = JPPO2(env=jenv, num_envs=N_ENVS, config=JPPOConfig(**TI_CONFIG))
    key = jax.random.PRNGKey(1)
    state = jax.jit(lambda k: jagent.init_state(k, n_updates=2))(key)
    new_state, jmetrics = jax.jit(jagent.train_iteration)(
        jmesh.shard_ppo_state(state, jmesh.make_mesh(n_devices=8, tp=2)))
    assert int(new_state.update_idx) == 1
    assert len(new_state.params["params"]["MlpTorso_0"]["fc0"]["kernel"]
               .sharding.device_set) >= 2

    # The reference's draws: its reset, then its rollout's keys step by step.
    _, k_env, _ = jax.random.split(key, 3)
    reset0 = jax_reset_noise(jenv, jax.random.split(jax.random.split(k_env)[1], N_ENVS))
    _, k_roll, k_perm = jax.random.split(state.key, 3)

    @jax.jit
    def rollout_step(jv, jobs, jnorm, k):
        """One step of the reference's rollout and what it drew."""
        jnorm = jnorm.update(jobs)
        k, k_act = jax.random.split(k)
        jdist, _ = jagent.policy.apply(state.params, jnorm.normalize(jobs))
        action = jdist.sample(k_act)
        _, sub = jax.random.split(jv.key)
        noise = (_step_draws(jenv)(jv.env_state.key),
                 _reset_draws(jenv)(jax.random.split(sub, N_ENVS)))
        jv, jtr = jagent.vec_env.step(jv, action)
        return jv, jtr.obs, jnorm, k, action, noise

    as_torch = lambda x: torch.as_tensor(np.array(x))
    jv, jobs, jnorm, k = state.vstate, state.obs, state.obs_norm, k_roll
    draws = []
    for _ in range(N_STEPS):
        jv, jobs, jnorm, k, action, (dv, reset) = rollout_step(jv, jobs, jnorm, k)
        draws.append((as_torch(action), {"dv": as_torch(dv)},
                      {name: as_torch(v) for name, v in reset.items()}))
    perms = [torch.from_numpy(np.array(jax.random.permutation(kp, N_ENVS * N_STEPS))).long()
             for kp in jax.random.split(k_perm, TI_CONFIG["noptepochs"])]
    params0 = to_port(state.params)
    fed = threading.local()
    randperm = torch.randperm

    def rank(mesh):
        with BUILD:
            agent = PPO2(env=tm.MobileRobotEnv(), num_envs=N_ENVS, device="cpu",
                         config=PPOConfig(**TI_CONFIG))
        agent.n_updates = 2
        vstate, obs = agent.vec_env.reset(None, noise=reset0)
        assert np.array_equal(obs.numpy(), np.asarray(state.obs))
        t = [0]  # the step whose draws the env and the policy take

        def step_noise(gen, n):
            t[0] += 1
            return draws[t[0] - 1][1]

        agent.vec_env.env.draw_step_noise = step_noise
        agent.vec_env.env.draw_reset_noise = lambda gen, n: draws[t[0] - 1][2]
        apply_one = agent.apply

        def apply_fed(params, obs):
            dist, value = apply_one(params, obs)
            dist.sample = lambda gen, rows: draws[t[0]][0][rows[0]:rows[0] + obs.shape[0]]
            return dist, value

        agent.apply = apply_fed
        fed.perms = iter(perms)
        params = {k: v.clone() for k, v in params0.items()}
        s = shard_ppo_state(PPOState(params=params, opt_state=agent.opt_init(params),
                                     vstate=vstate, obs=obs,
                                     obs_norm=RunningNorm.create((2,))), mesh)
        new, metrics = agent.train_iteration(s, torch.Generator().manual_seed(0))
        assert t[0] == N_STEPS
        return new, agent.whole_params(new.params, mesh), metrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randperm", lambda *a, **k: next(fed.perms)
                   if hasattr(fed, "perms") else randperm(*a, **k))
        out = run_ranks(8, rank, tp=2)
    ref = to_port(new_state.params)
    for new, whole, metrics in out:
        assert new.update_idx == 1 and new.mesh.shape == {"dp": 4, "tp": 2}
        assert new.params["torso.fc0.weight"].shape == (32, 2)
        assert whole["torso.fc0.weight"].shape == (64, 2)
        np.testing.assert_allclose(float(metrics["pg_loss"]), float(jmetrics["pg_loss"]),
                                   rtol=PG_RTOL, atol=PG_ATOL)
        for k, v in whole.items():
            assert torch.equal(v, out[0][1][k]), f"ranks disagree on {k}"
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


# ---- tp changes placement only ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tp_runs(max_grad_norm: float, n: int, tp: int = 1) -> list:
    """``tp_run`` on each rank of a dp x tp mesh of ``n`` ranks."""
    return run_ranks(n, lambda mesh: tp_run(mesh, max_grad_norm), tp=tp)


def tp_run(mesh, max_grad_norm: float, updates: int = 3):
    """PPO2 on MobileRobot ground truth (16 envs, 8 steps, 2 minibatches, 2
    epochs), seed 3, laid out on ``mesh``: the whole state and the last
    metrics."""
    with BUILD:
        agent = PPO2(env=tm.MobileRobotEnv(), num_envs=16, device="cpu",
                     config=PPOConfig(n_steps=8, nminibatches=2, noptepochs=2,
                                      max_grad_norm=max_grad_norm))
        gen = torch.Generator().manual_seed(3)
        state = agent.init_state(gen, seed=3)
    agent.n_updates = updates
    state = shard_ppo_state(state, mesh)
    for _ in range(updates):
        state, metrics = agent.train_iteration(state, gen)
    return agent.whole_state(state), metrics


def flat_state(state, metrics) -> dict:
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"{m}/{k}": v for m in ("mu", "nu") for k, v in state.opt_state[m].items()})
    out.update({f"obs_norm/{f.name}": getattr(state.obs_norm, f.name)
                for f in dataclasses.fields(state.obs_norm)})
    out.update({f"metrics/{k}": v for k, v in metrics.items()})
    out["count"] = torch.tensor(state.opt_state["count"])
    return out


# The clip never fires at 1e9; these gradients' norms are above 0.01 (below
# the default 0.5), so there it fires on every step.
@pytest.mark.parametrize("max_grad_norm", [1e9, 0.01], ids=["no_clip", "clip"])
def test_dp2_tp2_is_dp2_tp1(max_grad_norm):
    """Bit for bit, the clip's norm too: its squares are summed in float64,
    so the tp group's partial sums round as the whole leaves do."""
    tp1, tp2 = tp_runs(max_grad_norm, 2), tp_runs(max_grad_norm, 4, tp=2)
    for r, (state, metrics) in enumerate(tp2):
        assert state.mesh.shape == {"dp": 2, "tp": 2} and state.obs.shape[0] == 8
        got, want = flat_state(state, metrics), flat_state(*tp1[r // 2])
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v) or (v.isnan().all() and got[k].isnan().all()), k
        # Each env step counts once: the dp batch of 16 rows, 8 steps an
        # update, 3 updates, after the normalizer's prior count.
        assert float(state.obs_norm.count) == float(torch.tensor(1e-4) + 16 * 8 * 3)
    if max_grad_norm < 1e6:  # the clip fired: the step is not the unclipped one
        unclipped = tp_runs(1e9, 2)
        assert not torch.equal(unclipped[0][0].params["pi.weight"],
                               tp1[0][0].params["pi.weight"])


def test_dp1_tp2_cnn_update_is_dp1_tp1():
    """One update of the Nature CNN over 36x36 coarse frames with the conv1
    fold (``input_scale`` 2, as Kuka's coarse observations): conv weights
    sharded as [O/2, C, kh, kw], bit-equal to the tp1 update where the clip
    does not fire."""
    t, n = 4, 4
    rng = np.random.default_rng(2)
    obs = torch.from_numpy(rng.integers(0, 256, (t * n, 36, 36, 3), dtype=np.uint8))
    actions = torch.from_numpy(rng.integers(0, 4, t * n))
    adv = torch.from_numpy(rng.normal(size=t * n).astype(np.float32))
    perms = torch.stack([torch.randperm(t * n, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])

    def rank(mesh):
        with BUILD:
            agent = PPO2(env=tm.MobileRobotEnv(), num_envs=n, device="cpu", config=PPOConfig(
                n_steps=t, nminibatches=2, noptepochs=2, max_grad_norm=1e9))
            # The policy over coarse frames in place of the env's MLP.
            agent.obs_shape, agent.input_scale, agent.policy_kind = (36, 36, 3), 2, "cnn"
            agent.policy = agent._make_policy()
            params = agent.init_params(0)
        assert agent.policy.torso.c1.input_scale == 2
        with torch.no_grad():
            dist0, values = agent.apply(params, obs)
        data = (obs, actions, dist0.log_prob(actions), values, adv, values + adv)
        new, opt, metrics = agent.update_epochs(shard_params(params, mesh),
                                                shard_params(agent.opt_init(params), mesh),
                                                data, perms, mesh)
        return new, agent.whole_params(new, mesh), metrics

    (_, want, want_metrics), = run_ranks(1, rank)
    for shards, whole, metrics in run_ranks(2, rank, tp=2):
        assert shards["torso.c1.weight"].shape == (16, 3, 8, 8)
        assert shards["torso.c2.weight"].shape == (32, 32, 4, 4)
        assert shards["torso.fc.weight"].shape == (256, 5 * 5 * 64)
        for k, v in want.items():
            assert torch.equal(whole[k], v), k
        for k, v in want_metrics.items():
            assert torch.equal(metrics[k], v), k


# ---- weights carried across ----------------------------------------------------------

def test_tp_state_saves_whole_leaves_and_loads_into_shards(tmp_path):
    """dp1 x tp2 after one update: the policy pickle and the checkpoint hold
    the whole parameters and Adam moments (read by the reference's
    ``PPO2.load`` and by ``bridge.read_reference_pickle``), ``getAction``
    acts on them, and the checkpoint laid out on the mesh again gives each
    rank its slice."""

    def rank(mesh):
        with BUILD:
            agent = PPO2(env=tm.MobileRobotEnv(), num_envs=8, device="cpu",
                         config=PPOConfig(n_steps=8, nminibatches=2, noptepochs=1))
            gen = agent._start(5)
            state = agent.init_state(gen, seed=5)
        state, _ = agent.train_iteration(shard_ppo_state(state, mesh), gen)
        agent.state = state
        whole = agent.whole_state(state)
        policy, ckpt = tmp_path / f"ppo2_{mesh.rank}.pkl", tmp_path / f"ckpt_{mesh.rank}.pkl"
        agent.save(str(policy))
        agent.save_checkpoint(str(ckpt))
        probe = np.random.default_rng(0).normal(size=(5, 2)).astype(np.float32)
        acted = agent.getActionProba(probe)
        loaded, _ = PPO2.load_checkpoint(str(ckpt))
        again = shard_ppo_state(agent.restore(loaded, 5), mesh)
        return mesh.tp_index, state, whole, policy, ckpt, acted, again

    for t, state, whole, policy, ckpt, acted, again in run_ranks(2, rank, tp=2):
        assert state.params["torso.fc0.weight"].shape == (32, 2)
        with open(policy, "rb") as f:
            payload = pickle.load(f)
        for k, v in to_port(payload["params"]).items():
            assert torch.equal(v, whole.params[k]), k
        ref = JPPO2.load(str(policy), env=jm.MobileRobotEnv())
        for k, v in to_port(ref.state.params).items():
            assert torch.equal(v, whole.params[k]), k
        saved = bridge.read_reference_pickle(str(ckpt))["state"]
        adam = saved.opt_state[1][0]
        for name, tree in (("params", saved.params), ("mu", adam.mu), ("nu", adam.nu)):
            want = whole.params if name == "params" else whole.opt_state[name]
            for k, v in to_port(tree).items():
                assert torch.equal(v, want[k]), f"{name} {k}"
        solo = PPO2(env=tm.MobileRobotEnv(), num_envs=8, device="cpu")
        solo.state = dataclasses.replace(whole, mesh=None)
        probe = np.random.default_rng(0).normal(size=(5, 2)).astype(np.float32)
        np.testing.assert_array_equal(acted, solo.getActionProba(probe))
        for k, v in again.params.items():
            assert torch.equal(v, state.params[k]), k
        for m in ("mu", "nu"):
            for k, v in again.opt_state[m].items():
                assert torch.equal(v, state.opt_state[m][k]), f"{m} {k}"
        assert again.opt_state["count"] == state.opt_state["count"] == 2

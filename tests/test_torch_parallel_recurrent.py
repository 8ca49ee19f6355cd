"""The recurrent PPO2 and A2C on a dp x tp mesh (srl_tpu_torch.parallel.
shard_ppo_state) against srl_tpu.parallel and against the port's
one-process runs, on the CPU (ACER and RecurrentACER:
tests/test_torch_parallel_acer.py, which shares the checks here). The
ranks are threads of this process (``run_ranks`` of
tests/test_torch_parallel.py); the reference lays its mesh over 2 of the 8
virtual CPU devices of tests/conftest.py.

* One update on dp2 ranks (MobileRobot ground truth, 4 envs, ``lstm``),
  against the reference's jitted ``train_iteration`` on
  ``shard_ppo_state(state, make_mesh(n_devices=2))`` from the same state,
  within the tolerances of each agent's one-process parity test:
  - RecurrentPPO2 (tests/test_torch_recurrent_ppo.py, its tuned config at 8
    steps): fed the reference's segment, carry and env-column permutations;
    each minibatch is one env column, so one rank owns none of it and joins
    the all-reduces with zero gradients. Parameters and Adam's moments
    within 1e-4 of each tensor's scale (the value bias 1e-3), the loss rtol
    1e-4.
  - RecurrentA2C (tests/test_torch_recurrent_a2c.py): fed the reference's
    segment and carry; parameters rtol 1e-6 (atol 1e-8), ``nu`` rtol 2e-6,
    losses rtol 1e-5.
  Every rank ends with the same parameters.
* The ``cnnlstm`` case at a small frame: one RecurrentA2C update over 36x36
  pixel segments on dp2 ranks against the port's one process, within 1e-2 of
  each tensor's scale (its convolutions and fc run in bfloat16, which sums
  each rank's rows apart; tests/test_torch_acer.py's bar for the CNN).
* A 3-update curve of each agent (ACER's too) on MobileRobot ground truth
  (8 envs; the recurrent PPO2 at 8 steps and 2 epochs) on dp2 against the
  port's one process: the losses within 5e-3
  (tests/test_torch_parallel_ppo.py's bar), the parameters, the optimizer's
  moments and ACER's average policy within 5e-3 of each tensor's scale (the
  recurrent PPO2's Adam steps at its tuned lr 4.9e-3 carry the float32
  rounding of the ranks' sums into single small entries of the cell's
  weights); and dp2 x tp2 equal to dp2 x tp1 bit for bit (parameters, the
  optimizer's moments, ACER's average policy, the normalizer, the
  metrics).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.a2c import RecurrentA2C as JRecurrentA2C
from srl_tpu.agents.recurrent_ppo import RecurrentPPO2 as JRecurrentPPO2
from srl_tpu.agents.recurrent_ppo import lstm_ppo_config as jlstm_ppo_config
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch.agents.a2c import RecurrentA2C
from srl_tpu_torch.agents.acer import ACER, ACERConfig, RecurrentACER
from srl_tpu_torch.agents.recurrent_ppo import RecurrentPPO2, lstm_ppo_config
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from srl_tpu_torch.parallel import shard_params, shard_ppo_state

from . import test_torch_acer as tacer
from . import test_torch_recurrent_a2c as tra2c
from . import test_torch_recurrent_ppo as trppo
from .test_torch_parallel import BUILD, run_ranks
from .test_torch_parallel_agents import reference_state

torch.set_num_threads(1)

N = 4  # the envs of the one-process parity tests this file follows
t = lambda x: torch.as_tensor(np.array(x))
MESH2 = functools.lru_cache(maxsize=None)(lambda: jmesh.make_mesh(n_devices=2))


def rank_cols(x, mesh, axis=1):
    """The rank's env columns of ``x`` along ``axis``."""
    lo, hi = mesh.env_slice(N)
    return t(x).narrow(axis, lo, hi - lo)


def assert_ranks_alike(trees):
    for k, v in trees[0].items():
        assert all(torch.equal(v, tree[k]) for tree in trees), f"ranks disagree on {k}"


# ---- the recurrent PPO2 and A2C: one update against the reference's mesh ------------

@functools.lru_cache(maxsize=None)
def reference_recurrent(name):
    """(reference agent, its fresh state (around the port's: ``reference_state``)
    on a dp2 mesh, the meshed update's (state', metrics), the segment rebuilt
    from that state and, for PPO2, the env permutations)."""
    if name == "ppo2":
        jagent = JRecurrentPPO2(env=JMobile(max_steps=30), num_envs=N, policy="lstm",
                                config=trppo.config(jlstm_ppo_config))
    else:
        jagent = JRecurrentA2C(env=JMobile(max_steps=30), num_envs=N, policy="lstm")
    module = trppo if name == "ppo2" else tra2c
    state = reference_state(jagent, port_recurrent_agent(name), 3)
    state = jmesh.shard_ppo_state(state, MESH2())
    # The step and the segment in one jit: one compile.
    (new_state, jmetrics), segment = jax.jit(lambda s: (
        jagent.train_iteration(s), module.reference_segment(jagent, s)))(state)
    assert len(new_state.vstate.env_state.robot_pos.sharding.device_set) == 2
    return jagent, state, new_state, jmetrics, segment


def port_recurrent_agent(name):
    if name == "ppo2":
        return RecurrentPPO2(env=MobileRobotEnv(max_steps=30), num_envs=N, policy="lstm",
                             config=trppo.config(lstm_ppo_config), device="cpu")
    return RecurrentA2C(env=MobileRobotEnv(max_steps=30), num_envs=N, policy="lstm",
                        device="cpu")


def rank_recurrent_update(name, mesh):
    _, state, _, _, segment = reference_recurrent(name)
    with BUILD:
        agent = port_recurrent_agent(name)
    agent.n_updates = 3
    params = shard_params(agent._state_dict(jax.tree.map(np.asarray, state.params)), mesh)
    carry0 = tuple(rank_cols(x, mesh, 0) for x in state.lstm_state)
    if name == "ppo2":
        (obs, done_in, act, logp, val, adv, ret), perms = segment
        adam = state.opt_state[1][0]
        opt = shard_params({"count": int(adam.count), "mu": agent._state_dict(adam.mu),
                            "nu": agent._state_dict(adam.nu)}, mesh)
        cols = lambda x: rank_cols(x, mesh)
        data = (cols(obs), cols(done_in), carry0, cols(act), cols(logp), cols(val), cols(adv),
                cols(ret))
        params, opt, metrics = agent.update_epochs(params, opt, data, t(perms), mesh)
    else:
        obs, done_in, act, adv, ret = (rank_cols(x, mesh) for x in segment)
        opt = shard_params({"count": 0, "nu": agent._state_dict(state.opt_state[1][0].nu)},
                           mesh)
        params, opt, metrics = agent.update(params, opt,
                                            ((obs, done_in, carry0), act, adv, ret), mesh)
    moments = {m: agent.whole_params(opt[m], mesh) for m in ("mu", "nu") if m in opt}
    return agent, agent.whole_params(params, mesh), moments, opt["count"], metrics


@pytest.mark.parametrize("name", ["ppo2", "a2c"])
def test_recurrent_dp2_update_matches_the_reference_mesh_step(name):
    _, _, new_state, jmetrics, _ = reference_recurrent(name)
    out = run_ranks(2, lambda mesh: rank_recurrent_update(name, mesh))
    assert_ranks_alike([o[1] for o in out])
    agent = out[0][0]
    ref_opt = new_state.opt_state[1][0]
    ref = {"params": new_state.params, **{m: getattr(ref_opt, m) for m in out[0][2]}}
    ref = {k: agent._state_dict(jax.tree.map(np.asarray, v)) for k, v in ref.items()}
    for _, params, moments, count, metrics in out:
        ours = {"params": params, **moments}
        if name == "ppo2":
            assert count == int(ref_opt.count) == 32
            for tree in ours:
                for k, v in ours[tree].items():
                    scale = np.abs(ref[tree][k].numpy()).max()
                    tol = 1e-3 if k == "vf.bias" else 1e-4
                    assert np.abs(v.numpy() - ref[tree][k].numpy()).max() <= tol * scale, k
            np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                                       rtol=1e-4)
        else:
            assert count == 1
            for k, v in params.items():
                np.testing.assert_allclose(v.numpy(), ref["params"][k].numpy(), rtol=1e-6,
                                           atol=1e-8, err_msg=k)
                np.testing.assert_allclose(moments["nu"][k].numpy(), ref["nu"][k].numpy(),
                                           rtol=2e-6, atol=1e-12, err_msg=k)
            for k, v in metrics.items():
                np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def test_cnnlstm_update_over_ranks_is_the_one_process_update():
    """RecurrentA2C's ``cnnlstm`` over [5 steps, 4 envs] of 36x36 frames
    (the Nature CNN's smallest), one update on dp2 against one process."""
    rng = np.random.default_rng(4)
    steps = 5
    obs = torch.from_numpy(rng.integers(0, 256, (steps, N, 36, 36, 3), dtype=np.uint8))
    done_in = torch.zeros(steps, N, dtype=torch.bool)
    done_in[2, 1] = True
    actions = torch.from_numpy(rng.integers(0, 4, (steps, N)))
    adv = torch.from_numpy(rng.normal(size=(steps, N)).astype(np.float32))

    def rank(mesh=None):
        with BUILD:
            agent = RecurrentA2C(env=MobileRobotEnv(), num_envs=N, policy="lstm",
                                 device="cpu")
            # The cnnlstm policy over 36x36 frames in place of the env's.
            agent.obs_shape, agent.policy_kind = (36, 36, 3), "cnnlstm"
            agent.policy = agent._make_policy()
            params = agent.init_params(0)
        carry0 = tuple(torch.from_numpy(np.random.default_rng(c).normal(
            0, 0.5, (N, agent.n_lstm)).astype(np.float32)) for c in range(2))
        lo, hi = (0, N) if mesh is None else mesh.env_slice(N)
        cols = lambda x: x[:, lo:hi]
        data = ((cols(obs), cols(done_in), tuple(c[lo:hi] for c in carry0)), cols(actions),
                cols(adv), cols(adv + 1.0))
        opt = agent.opt_init(params)
        if mesh is not None:
            params, opt = shard_params(params, mesh), shard_params(opt, mesh)
        new, opt, losses = agent.update(params, opt, data, mesh)
        return agent.whole_params(new, mesh), agent.whole_params(opt["nu"], mesh), losses

    want, want_nu, want_losses = rank()
    dp = run_ranks(2, rank)
    tp = run_ranks(4, rank, tp=2)
    assert_ranks_alike([p for p, _, _ in dp + tp])
    for params, nu, losses in dp:
        for k, v in params.items():
            tacer.assert_close_to_scale(v.numpy(), want[k].numpy(), 1e-2, k)
        for k, v in losses.items():
            np.testing.assert_allclose(float(v), float(want_losses[k]), rtol=1e-2)
    for (params, nu, losses), (p1, nu1, l1) in zip(tp, [dp[0], dp[0], dp[1], dp[1]]):
        for k, v in params.items():
            assert torch.equal(v, p1[k]) and torch.equal(nu[k], nu1[k]), k
        assert all(torch.equal(v, l1[k]) for k, v in losses.items())


# ---- curves and tp ----------------------------------------------------------------

ACER_CURVE = dict(n_steps=4, buffer_segments=3, replay_start=2, replay_ratio=2)
CURVE_AGENTS = {
    "recurrent_ppo2": (lambda: RecurrentPPO2(env=MobileRobotEnv(), num_envs=8, policy="lstm",
                                             device="cpu", config=dataclasses.replace(
                                                 trppo.config(lstm_ppo_config), noptepochs=2)),
                       "loss"),
    "recurrent_a2c": (lambda: RecurrentA2C(env=MobileRobotEnv(), num_envs=8, policy="lstm",
                                           device="cpu"), "pg_loss"),
    "acer": (lambda: ACER(env=MobileRobotEnv(), num_envs=8, device="cpu",
                          config=ACERConfig(**ACER_CURVE)), "loss_policy"),
    "recurrent_acer": (lambda: RecurrentACER(env=MobileRobotEnv(), num_envs=8, policy="lstm",
                                             device="cpu", config=ACERConfig(**ACER_CURVE)),
                       "loss_policy"),
}


def curve(name, mesh=None, updates=3):
    """The per-update losses, the whole final state and the last metrics of
    ``updates`` updates on MobileRobot ground truth, seed 3; with ``mesh``,
    laid out on it."""
    make, metric = CURVE_AGENTS[name]
    with BUILD:
        agent = make()
        gen = torch.Generator().manual_seed(3)
        state = agent.init_state(gen, seed=3)
    agent.n_updates = updates
    if mesh is not None:
        state = shard_ppo_state(state, mesh)
    losses = []
    for _ in range(updates):
        state, metrics = agent.train_iteration(state, gen)
        losses.append(float(metrics[metric]))
    return np.array(losses), agent.whole_state(state), metrics


@functools.lru_cache(maxsize=None)
def curves(name, n=0, tp=1):
    """``curve`` in one process (n = 0) or on each rank of a mesh of n."""
    return [curve(name)] if n == 0 else run_ranks(n, lambda mesh: curve(name, mesh), tp=tp)


def trees(state) -> dict:
    out = {"params": state.params, **{m: v for m, v in state.opt_state.items()
                                      if isinstance(v, dict)}}
    if hasattr(state, "avg_params"):
        out["avg_params"] = state.avg_params
    return out


def check_curve_on_dp2(name):
    """The agent's curve on dp2 ranks against the port's one process."""
    (ref_losses, ref_state, ref_metrics), = curves(name)
    out = curves(name, 2)
    assert_ranks_alike([s.params for _, s, _ in out])
    for losses, state, metrics in out:
        assert state.mesh.shape == {"dp": 2, "tp": 1} and state.obs.shape[0] == 4
        np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=1e-4)
        for tree, ref in trees(ref_state).items():
            for k, v in trees(state)[tree].items():
                tacer.assert_close_to_scale(v.numpy(), ref[k].numpy(), 5e-3, f"{tree} {k}")
        np.testing.assert_array_equal(metrics["episode_length"].numpy(),
                                      ref_metrics["episode_length"].numpy())


def check_dp2_tp2_is_dp2_tp1(name):
    """The agent's dp2 x tp2 ranks against its dp2 x tp1 ranks, bit for bit."""
    tp1, tp2 = curves(name, 2), curves(name, 4, 2)
    for r, (losses, state, metrics) in enumerate(tp2):
        assert state.mesh.shape == {"dp": 2, "tp": 2} and state.obs.shape[0] == 4
        want_losses, want, want_metrics = tp1[r // 2]
        assert np.array_equal(losses, want_losses)
        for tree, ref in trees(want).items():
            for k, v in trees(state)[tree].items():
                assert torch.equal(v, ref[k]), f"{tree} {k}"
        for f in dataclasses.fields(state.obs_norm):
            assert torch.equal(getattr(state.obs_norm, f.name), getattr(want.obs_norm, f.name))
        for k, v in metrics.items():
            assert torch.equal(v, want_metrics[k]) or (v.isnan().all() and
                                                       want_metrics[k].isnan().all()), k


RECURRENT = ["recurrent_ppo2", "recurrent_a2c"]


@pytest.mark.parametrize("name", RECURRENT)
def test_curve_on_dp2_is_the_one_process_curve(name):
    check_curve_on_dp2(name)


@pytest.mark.parametrize("name", RECURRENT)
def test_dp2_tp2_is_dp2_tp1(name):
    check_dp2_tp2_is_dp2_tp1(name)

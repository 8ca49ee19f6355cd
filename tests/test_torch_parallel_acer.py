"""ACER and RecurrentACER on a dp x tp mesh (srl_tpu_torch.parallel.
shard_ppo_state) against srl_tpu.parallel and against the port's one-process
runs, on the CPU. The ranks are threads of this process (``run_ranks`` of
tests/test_torch_parallel.py); the reference lays its mesh over 2 of the 8
virtual CPU devices of tests/conftest.py. (Apart from
tests/test_torch_parallel_recurrent.py, whose helpers it shares, to keep
each file's reference compiles inside the test budget.)

* One iteration on dp2 ranks (MobileRobot ground truth, 4 envs, ``mlp`` and
  ``lstm``) against the reference's jitted ``train_iteration`` on
  ``shard_ppo_state(state, make_mesh(n_devices=2))`` from the same fresh
  state, within the tolerances of tests/test_torch_acer.py and
  _recurrent_acer.py: 4 steps with episodes of 3 ending in the segment, a
  store of 3 segments, ``replay_start`` 1, so the segment just stored is
  replayed 4 times; fed the Gumbel noise, the replay indices and the
  auto-reset draws the reference drew for the whole batch (step noise off).
  The ranks' segment stores (half the env rows each), env rows, ``done`` and
  carries put together equal the reference's (``mus`` and the normalized
  observations rtol 1e-6, the carry rtol 1e-5); parameters, the average
  policy and RMSProp's ``nu`` within 1e-4 of each tensor's scale; every
  rank ends with the same parameters.
* A 3-update curve of each on MobileRobot ground truth (8 envs, replays from
  the second iteration) on dp2 against the port's one process, and dp2 x
  tp2 equal to dp2 x tp1 bit for bit (the checks of
  tests/test_torch_parallel_recurrent.py).
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.acer import ACER as JACER
from srl_tpu.agents.acer import ACERConfig as JACERConfig
from srl_tpu.agents.acer import RecurrentACER as JRecurrentACER
from srl_tpu.envs import mobile_robot as jm
from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch.agents.acer import ACER, ACERConfig, RecurrentACER
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from srl_tpu_torch.parallel import shard_ppo_state

from . import test_torch_acer as tacer
from . import test_torch_recurrent_acer as tracer
from .test_torch_parallel import BUILD, run_ranks
from .test_torch_parallel_agents import reference_state
from .test_torch_parallel_recurrent import (MESH2, N, assert_ranks_alike, check_curve_on_dp2,
                                            check_dp2_tp2_is_dp2_tp1)

torch.set_num_threads(1)

# ---- ACER and RecurrentACER: one iteration against the reference's mesh -------------

@functools.lru_cache(maxsize=None)
def reference_acer(recurrent):
    """(reference agent, its fresh state (around the port's:
    ``reference_state``), its first iteration's state on a dp2 mesh, the
    draws of that iteration: the auto-reset noise, the Gumbel noise and the
    replay indices). The draws are read off the fresh state on one device:
    the reference's ``shard_batch`` spreads the vector env's 2-word key over
    dp, and the key that a meshed iteration returns cannot be split outside
    a jit."""
    cls = JRecurrentACER if recurrent else JACER
    jagent = cls(env=jm.MobileRobotEnv(**ACER_ENV), num_envs=N,
                 policy="lstm" if recurrent else "mlp", config=JACERConfig(**tacer.CFG))
    js = reference_state(jagent, port_acer_agent(recurrent))
    js1, _ = jax.jit(jagent.train_iteration)(jmesh.shard_ppo_state(js, MESH2()))
    assert len(js1.vstate.env_state.robot_pos.sharding.device_set) == 2
    _, k_roll, k_replay = jax.random.split(js.key, 3)
    draws = (tacer.reset_noise_of(jagent.env, js.vstate.key, tacer.T),
             tacer.gumbel_draws(k_roll, 4, recurrent),
             tacer.replay_draws(k_replay, jagent.config.replay_ratio, 1))
    return js, js1, draws


# Step noise off (the tests feed the reset draws only); episodes of 3 steps
# end inside the 4-step segment.
ACER_ENV = dict(noise_std=0.0, max_steps=3)


def port_acer_agent(recurrent):
    env, cfg = MobileRobotEnv(**ACER_ENV), ACERConfig(**tacer.CFG)
    if recurrent:
        return RecurrentACER(env=env, num_envs=N, policy="lstm", config=cfg, device="cpu")
    return ACER(env=env, num_envs=N, policy="mlp", config=cfg, device="cpu")


def rank_acer_iteration(recurrent, mesh):
    js, _, (resets, gumbel, replay_idx) = reference_acer(recurrent)
    with BUILD:
        agent = port_acer_agent(recurrent)
    state = (tracer.port_recurrent_state if recurrent else tacer.port_acer_state)(agent, js)
    state = shard_ppo_state(state, mesh)
    tacer.feed_resets(agent, resets)
    state, metrics = agent.train_iteration(state, torch.Generator().manual_seed(0),
                                           gumbel=gumbel, replay_idx=replay_idx)
    return agent, state, metrics


def put_together(states):
    """The ranks' states as one: their env rows joined, the rest rank 0's."""
    cat = lambda xs, axis=0: torch.cat(list(xs), axis)
    s0 = states[0]
    buf = s0.buffer
    buffer = dataclasses.replace(buf, **{
        name: cat((getattr(s.buffer, name) for s in states), buf.ENV_AXIS.get(name, 2))
        for name in buf.tensor_names()})
    env_state = types.SimpleNamespace(**{
        f: cat(getattr(s.vstate.env_state, f) for s in states)
        for f in ("robot_pos", "step_count")})
    fields = dict(buffer=buffer, vstate=types.SimpleNamespace(env_state=env_state),
                  obs=cat(s.obs for s in states))
    if hasattr(s0, "lstm_state"):
        fields.update(done=cat(s.done for s in states),
                      lstm_state=tuple(cat(xs) for xs in zip(*(s.lstm_state for s in states))))
    return dataclasses.replace(s0, **fields)


@pytest.mark.parametrize("recurrent", [False, True], ids=["acer", "recurrent_acer"])
def test_acer_dp2_iteration_matches_the_reference_mesh_iteration(recurrent):
    _, js1, _ = reference_acer(recurrent)
    out = run_ranks(2, lambda mesh: rank_acer_iteration(recurrent, mesh))
    agent = out[0][0]
    states = [s for _, s, _ in out]
    for tree in ("params", "avg_params"):
        assert_ranks_alike([getattr(s, tree) for s in states])
    assert all(s.buffer.obs.shape[2] == N // 2 for s in states)  # the rank's rows
    whole = put_together(states)
    # One segment stored, an episode ended in it, and replayed 4 times.
    assert (whole.buffer.cursor, whole.buffer.size) == (1, 1) and whole.buffer.dones[0].any()
    for _, _, metrics in out:
        tacer.assert_iteration_matches(agent, whole, js1, metrics)
    if recurrent:
        np.testing.assert_array_equal(whole.done.numpy(), np.asarray(js1.done))
        for ours, ref in zip(whole.lstm_state, js1.lstm_state):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["acer", "recurrent_acer"])
def test_curve_on_dp2_is_the_one_process_curve(name):
    check_curve_on_dp2(name)


@pytest.mark.parametrize("name", ["acer", "recurrent_acer"])
def test_dp2_tp2_is_dp2_tp1(name):
    check_dp2_tp2_is_dp2_tp1(name)

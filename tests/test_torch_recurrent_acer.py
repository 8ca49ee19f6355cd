"""RecurrentACER, port against reference on the CPU (MobileRobot ground
truth, 4 envs, T = 4, the LSTM of 64).

* The segment forward (the torso once over the (T+1) x N frames, the cell
  looped over T+1 steps) against the reference's ``_scan_forward`` (the
  whole net stepped T+1 times), from a random carry, with a ``dones_in``
  mask that zeroes the carry mid-segment: logits and Q within rtol 1e-5
  (float32 sums in another order), ``lstm`` (``lnlstm`` runs in the
  iteration below).
* ``segment_grads`` (backpropagation through time from the stored carry)
  against the reference's ``_segment_loss_grads``: within 1e-5 of each
  tensor's scale (max |reference|).
* One whole ``train_iteration`` with ``lnlstm`` and replays from stored
  carries: the reference runs three iterations (a buffer of 3 segments,
  ``replay_start`` 1, 4 replays); the port starts from the reference's
  state after the second, fed the Gumbel noise (one key a step), the replay
  indices and the auto-reset draws of the reference's third (step noise
  off; ``max_steps`` 4, so an episode ends inside the segment and
  ``dones_in`` zeroes the carry). The buffer (its carries and
  ``dones_in`` too), ``done`` and the env batch equal the reference's,
  ``mus`` and the normalized observations within rtol 1e-6, the carry
  within rtol 1e-5; parameters, average policy and RMSProp's ``nu`` within
  1e-4 of each tensor's scale (as tests/test_torch_acer.py).
* Stateful acting (``getAction`` advances the carry, ``dones`` zeroes it,
  ``getActionProba`` reads the last context) from the same ``lnlstm``
  parameters (the reference's after 3 iterations): actions equal,
  probabilities within rtol 1e-5.
* The ``"acer_lstm"`` pickle and a checkpoint (``RecurrentACERState`` with
  its ``RecurrentSegmentBuffer``) read both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.acer import ACERConfig as JACERConfig
from srl_tpu.agents.acer import RecurrentACER as JRecurrentACER
from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.acer import (ACERConfig, RecurrentACER, RecurrentACERState,
                                       RecurrentSegmentBuffer)
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.envs import mobile_robot as tm
from tests.test_torch_acer import (CFG, N, T, assert_iteration_matches, assert_trees_close,
                                   feed_resets, gumbel_draws, perturbed_pair, port_norm,
                                   port_opt_state,
                                   port_params, port_vstate, reference_iterations,
                                   replay_draws, reset_noise_of, t)

torch.set_num_threads(1)

N_ACT = 4


def make_pair(policy, **env_kwargs):
    jagent = JRecurrentACER(env=jm.MobileRobotEnv(**env_kwargs), num_envs=N, policy=policy,
                            config=JACERConfig(**CFG))
    agent = RecurrentACER(env=tm.MobileRobotEnv(**env_kwargs), num_envs=N, policy=policy,
                          config=ACERConfig(**CFG), device="cpu")
    return jagent, agent


def random_segment(rng):
    """A segment with a random carry, an episode start mid-segment in env 1
    and at the first step in env 2."""
    obs = rng.normal(0, 1, (T + 1, N, 2)).astype(np.float32)
    dones_in = np.zeros((T + 1, N), bool)
    dones_in[2, 1] = dones_in[0, 2] = True
    dones = np.zeros((T, N), bool)
    dones[1, 1] = True
    mus = np.asarray(jax.nn.softmax(rng.normal(0, 1, (T, N, N_ACT)).astype(np.float32)))
    return {"obs": obs, "actions": rng.integers(0, N_ACT, (T, N)).astype(np.int32),
            "rewards": rng.normal(0, 1, (T, N)).astype(np.float32), "dones": dones,
            "dones_in": dones_in, "mus": mus,
            "lstm_c": rng.normal(0, 0.5, (N, 64)).astype(np.float32),
            "lstm_h": rng.normal(0, 0.5, (N, 64)).astype(np.float32)}


def test_segment_forward_and_grads_match_reference():
    rng = np.random.default_rng(0)
    jagent, agent = make_pair("lstm")
    seg = random_segment(rng)
    carry0 = (jnp.asarray(seg["lstm_c"]), jnp.asarray(seg["lstm_h"]))
    params, avg = perturbed_pair(agent, agent.init_params(1))
    jlogits, jq = jax.jit(jagent._scan_forward)(params, jnp.asarray(seg["obs"]),
                                                jnp.asarray(seg["dones_in"]), carry0)
    jseg = tuple(jnp.asarray(seg[k]) for k in ("obs", "actions", "rewards", "dones",
                                               "dones_in", "mus")) + (carry0,)
    jgrads = jax.jit(jagent._segment_loss_grads)(params, avg, jseg)

    tseg = {k: t(v) for k, v in seg.items()}
    logits, q = agent.segment_outputs(port_params(agent, params), tseg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    grads = agent.segment_grads(port_params(agent, params), port_params(agent, avg), tseg)
    assert_trees_close(agent._flax(grads), jax.tree.map(np.asarray, jgrads), 1e-5)


def port_recurrent_state(agent, js):
    return RecurrentACERState(
        params=port_params(agent, js.params), avg_params=port_params(agent, js.avg_params),
        opt_state=port_opt_state(agent, js.opt_state),
        buffer=RecurrentSegmentBuffer.from_reference(js.buffer), vstate=port_vstate(js.vstate),
        obs=t(js.obs), done=t(js.done), lstm_state=tuple(t(x) for x in js.lstm_state),
        obs_norm=port_norm(js.obs_norm), update_idx=int(js.update_idx))


@pytest.fixture(scope="module")
def reference_run():
    jagent, agent = make_pair("lnlstm", noise_std=0.0, max_steps=4)
    return jagent, agent, reference_iterations(jagent)


def test_iteration_with_replays_matches_reference(reference_run):
    jagent, agent, run = reference_run
    (js, _), (js3, _) = run[1], run[2]
    state = port_recurrent_state(agent, js)
    _, k_roll, k_replay = jax.random.split(js.key, 3)
    feed_resets(agent, reset_noise_of(jagent.env, js.vstate.key, T))
    state, metrics = agent.train_iteration(
        state, torch.Generator().manual_seed(0), gumbel=gumbel_draws(k_roll, N_ACT, True),
        replay_idx=replay_draws(k_replay, agent.config.replay_ratio, 3))
    assert state.buffer.dones_in[2, 1:].any()  # an episode started inside the segment
    assert_iteration_matches(agent, state, js3, metrics)
    np.testing.assert_array_equal(state.done.numpy(), np.asarray(js3.done))
    for ours, ref in zip(state.lstm_state, js3.lstm_state):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_stateful_acting_matches_reference(reference_run, tmp_path):
    jagent, _, run = reference_run
    jagent.state = run[2][0]
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = RecurrentACER.load(path, tm.MobileRobotEnv(), None, device="cpu")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(3, 2)).astype(np.float32)
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-5, atol=1e-7)
    for dones in (None, np.array([False, True, False]), np.array([True, False, False])):
        obs = rng.normal(size=(3, 2)).astype(np.float32)
        np.testing.assert_array_equal(agent.getAction(obs, dones, deterministic=True),
                                      jagent.getAction(obs, dones, deterministic=True))
        proba = agent.getActionProba(obs)
        np.testing.assert_allclose(proba, jagent.getActionProba(obs), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(agent.getActionProba(obs), proba)


def test_acer_lstm_pickle_and_checkpoint_cross_both_ways(reference_run, tmp_path):
    agent = RecurrentACER(env=tm.MobileRobotEnv(max_steps=30), num_envs=N, policy="lnlstm",
                          config=ACERConfig(n_steps=T, buffer_segments=3), device="cpu")
    agent.learn(2 * N * T, seed=1)
    path = str(tmp_path / "port.pkl")
    agent.save(path)
    assert agent._load_pickle(path)["name"] == "acer_lstm"
    back = JRecurrentACER.load(path, env=jm.MobileRobotEnv())
    assert type(back).__name__ == "RecurrentACER" and back.policy_kind == "lnlstm"
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 agent._flax(agent.state.params))
    again = RecurrentACER.load(path, tm.MobileRobotEnv(), device="cpu")
    for k, v in again.state.params.items():
        assert torch.equal(v, agent.state.params[k]), k

    ckpt = str(tmp_path / "checkpoint.pkl")
    agent.save_checkpoint(ckpt, meta={"num_timesteps": 2 * N * T})
    jstate, _ = JBase.load_checkpoint(ckpt)
    s = agent.state
    assert type(jstate).__name__ == "RecurrentACERState"
    assert type(jstate.buffer).__name__ == "RecurrentSegmentBuffer"
    for name in s.buffer.tensor_names():
        np.testing.assert_array_equal(np.asarray(getattr(jstate.buffer, name)),
                                      getattr(s.buffer, name).numpy(), err_msg=name)
    for ref, ours in zip(jstate.lstm_state, s.lstm_state):
        np.testing.assert_array_equal(np.asarray(ref), ours.numpy())

    jagent, _, run = reference_run
    jagent.state = run[0][0]
    ref_ckpt = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(ref_ckpt, meta={})
    state, _ = BaseRLAgent.load_checkpoint(ref_ckpt)
    assert state.ref_name == "srl_tpu.agents.acer.RecurrentACERState"
    buffer = RecurrentSegmentBuffer.from_reference(state.buffer)
    assert (buffer.cursor, buffer.size) == (1, 1)
    np.testing.assert_array_equal(buffer.lstm_h.numpy(), np.asarray(jagent.state.buffer.lstm_h))
    assert bridge.read_reference_pickle(ref_ckpt)["state"].lstm_state[0].shape == (N, 64)

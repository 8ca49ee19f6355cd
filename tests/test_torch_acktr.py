"""ACKTR and RecurrentACKTR, port against reference on the CPU.

* The update (MobileRobot ground truth, 4 envs, 8 steps, ``mlp``, ``lstm``
  and ``lnlstm``): the reference runs two of its ``train_iteration``s; the
  port's ``update`` is fed the reference's second batch (rebuilt under the
  same key splits), its parameters, momentum and factors after the first,
  and the reference's Fisher draws (an action and a value noise per sample,
  from ``k_fisher``). The factors A and G agree within rtol 1e-5 (float32
  sums in another order), ``eta`` and the loss within 1e-5; the momentum
  within 1e-4 of each tensor's scale (max |reference|), since the
  preconditioned gradient passes through two inverses of damped factors
  whose conditioning amplifies the factors' rounding (elements near zero
  are off by more than 1e-4 of themselves, up to 5% with ``lnlstm``); the
  parameters within rtol 1e-6, their float32 rounding, plus 1e-4 of the
  update's step.
* The CNN's K-FAC at a 36x36 input (pool 1, a 64-wide fc input), one step
  from zero factors with given gradients: the logits within 2e-2 of their
  scale (the bf16 CNN, as tests/test_torch_policy.py holds it); the conv
  patches' factors A in
  float32 within rtol 1e-5 of the reference's
  ``conv_general_dilated_patches`` ones; G within 5e-2 of its scale, since
  a conv's per-sample pre-activation gradients are bfloat16 on both sides
  and summed over space in another order and precision (conv1 sums 64
  positions, 2.7% of scale here; conv2 nine, 0.5%; conv3 one, exact); the
  step of every parameter and ``eta`` within 1e-2 of their scale (0.5% at
  most here, the convs').
* The ``acktr`` and ``acktr_lstm`` pickles, written by either package and
  read by the other; a ``checkpoint.pkl`` the port's CLI writes, read by the
  reference's ``load_checkpoint``, and one the reference writes read by the
  port's.
"""
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.agents.acktr import ACKTR as JACKTR
from srl_tpu.agents.acktr import ACKTRConfig as JACKTRConfig
from srl_tpu.agents.acktr import RecurrentACKTR as JRecurrentACKTR
from srl_tpu.agents.base import BaseRLAgent as JBase
from srl_tpu.agents.common import compute_gae as jgae
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.acktr import (ACKTR, ACKTRConfig, ACKTRState, RecurrentACKTR,
                                        RecurrentACKTRState)
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from srl_tpu_torch.experiments import train

torch.set_num_threads(1)

N, T = 4, 8
t = lambda x: torch.as_tensor(np.array(x))


def reference_batch(jagent, state):
    """The reference's rollout, GAE and Fisher draws of ``state``'s
    ``train_iteration`` (srl_tpu/agents/acktr.py:252-309, 722-799)."""
    cfg = jagent.config
    recurrent = isinstance(jagent, JRecurrentACKTR)
    _, k_roll, k_fisher = jax.random.split(state.key, 3)

    def body(carry, k_step):
        vstate, obs, done, lstm, obs_norm, k = carry
        obs_norm = obs_norm.update(obs)
        norm_obs = obs_norm.normalize(obs)
        if recurrent:
            logits, value, lstm, _ = jagent._forward_step(state.params, norm_obs, lstm, done)
        else:
            k, k_step = jax.random.split(k)
            logits, value, _ = jagent._forward(state.params, norm_obs)
        action = jax.random.categorical(k_step, logits).astype(jnp.int32)
        vstate, tr = jagent.vec_env.step(vstate, action)
        return ((vstate, tr.obs, tr.done, lstm, obs_norm, k),
                (norm_obs, done, action, value, tr.reward, tr.done))

    done0 = state.done if recurrent else jnp.zeros(N, bool)
    lstm0 = state.lstm_state if recurrent else None
    keys = jax.random.split(k_roll, cfg.n_steps) if recurrent else None
    (_, obs, done, lstm, obs_norm, _), (b_obs, b_done_in, b_act, b_val, b_rew, b_done) = \
        jax.lax.scan(body, (state.vstate, state.obs, done0, lstm0, state.obs_norm, k_roll),
                     keys, length=cfg.n_steps)
    last = obs_norm.normalize(obs)
    if recurrent:
        _, last_value, _, _ = jagent._forward_step(state.params, last, lstm, done)
    else:
        _, last_value, _ = jagent._forward(state.params, last)
    adv, ret = jgae(b_rew, b_val, b_done, last_value, cfg.gamma, 1.0)
    ns = cfg.kfac_obs_samples
    flat_obs = b_obs.reshape((-1,) + b_obs.shape[2:])
    if recurrent:
        # The h_in, c_in the first samples stepped from.
        def scan_policy(lstm, inp):
            o, d = inp
            _, _, new_lstm, acts = jagent._forward_step(state.params, o, lstm, d)
            return new_lstm, (acts["_h_in"], acts["_c_in"])

        _, (h_in, c_in) = jax.lax.scan(scan_policy, state.lstm_state, (b_obs, b_done_in))
        e, _ = jagent._torso(state.params, flat_obs[:ns])
        h_s, c_s = h_in.reshape(-1, h_in.shape[-1])[:ns], c_in.reshape(-1, c_in.shape[-1])[:ns]
        logits, value, _, _, _ = jagent._lstm_heads(state.params, e, h_s, c_s,
                                                    jnp.zeros(ns, bool))
    else:
        logits, value, _ = jagent._forward(state.params, flat_obs[:ns])
    k1, k2 = jax.random.split(k_fisher)
    draws = (jax.random.categorical(k1, logits), jax.random.normal(k2, value.shape))
    return (b_obs, b_done_in, b_act, adv, ret), draws


def port_state(jstate, recurrent):
    fields = dict(
        params=bridge.acktr_params_from_reference(jax.tree.map(np.asarray, jstate.params)),
        momentum=bridge.acktr_params_from_reference(jax.tree.map(np.asarray, jstate.momentum)),
        kfac_A={k: t(v) for k, v in jstate.kfac_A.items()},
        kfac_G={k: t(v) for k, v in jstate.kfac_G.items()},
        vstate=None, obs=None, obs_norm=None, update_idx=int(jstate.update_idx))
    if recurrent:
        return RecurrentACKTRState(**fields, done=None, lstm_state=None)
    return ACKTRState(**fields)


@pytest.mark.parametrize("policy", ["mlp", "lstm", "lnlstm"])
def test_update_matches_reference(policy):
    recurrent = "lstm" in policy
    jcls, tcls = (JRecurrentACKTR, RecurrentACKTR) if recurrent else (JACKTR, ACKTR)
    jagent = jcls(env=JMobile(max_steps=30), num_envs=N, policy=policy,
                  config=JACKTRConfig(n_steps=T))
    state0 = jagent.init_state(jax.random.PRNGKey(0))
    step = jax.jit(jagent.train_iteration)
    state1, _ = step(state0, 0.0)
    state2, jmetrics = step(state1, 0.0)
    (b_obs, b_done_in, b_act, adv, ret), draws = jax.jit(
        lambda s: reference_batch(jagent, s))(state1)

    agent = tcls(env=MobileRobotEnv(max_steps=30), num_envs=N, policy=policy,
                 config=ACKTRConfig(n_steps=T), device="cpu")
    state = port_state(state1, recurrent)
    if recurrent:
        carry = tuple(t(x) for x in state1.lstm_state)
        data = (t(b_obs), t(b_done_in), carry, t(b_act), t(adv), t(ret))
    else:
        flat = lambda x: t(x).reshape((-1,) + x.shape[2:])
        data = (flat(b_obs), flat(b_act), flat(adv), flat(ret))
    before = {k: v.clone() for k, v in state.params.items()}
    params, momentum, kfac_A, kfac_G, metrics = agent.update(
        state, data, fisher_draws=(t(draws[0]), t(draws[1])))
    for k, v in state.params.items():  # the inputs are left as they are
        assert torch.equal(v, before[k]), k
    for k in kfac_A:
        np.testing.assert_allclose(kfac_A[k].numpy(), np.asarray(state2.kfac_A[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(kfac_G[k].numpy(), np.asarray(state2.kfac_G[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(metrics["eta"]), float(jmetrics["eta"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    expect = bridge.acktr_params_from_reference(jax.tree.map(np.asarray, state2.params))
    expect_m = bridge.acktr_params_from_reference(jax.tree.map(np.asarray, state2.momentum))
    assert set(params) == set(expect)
    for k in params:
        ref = expect_m[k].numpy()
        assert np.abs(momentum[k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k
        step = np.abs((expect[k] - state.params[k]).numpy()).max()
        np.testing.assert_allclose(params[k].numpy(), expect[k].numpy(), rtol=1e-6,
                                   atol=1e-4 * step, err_msg=k)


def test_cnn_kfac_patches_and_factors_match_reference():
    rng = np.random.default_rng(0)
    shape, n = (36, 36, 3), 8
    jagent = JACKTR(policy="cnn")
    jagent.n_act = 4
    jagent._cnn_geometry(shape)
    agent = ACKTR(policy="cnn", device="cpu")
    agent.n_act = 4
    agent._cnn_geometry(shape)
    assert (agent.pool, agent.cnn_flat_dim) == (jagent.pool, jagent.cnn_flat_dim) == (1, 64)
    jparams = jagent._init_params(jax.random.PRNGKey(3))
    x = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    zeros = lambda d: {k: jnp.zeros_like(v) for k, v in d.items()}
    jlogits, jvalue, jacts = jax.jit(jagent._forward)(jparams, jnp.asarray(x))
    jfisher = jax.jit(jagent._fisher_G)(jparams, jnp.asarray(x), jax.random.PRNGKey(4))
    grads = {k: jnp.asarray(rng.normal(0, 1e-2, v.shape).astype(np.float32))
             for k, v in jparams.items()}
    specs = jagent._layer_specs()
    params = bridge.acktr_params_from_reference(jax.tree.map(np.asarray, jparams))
    kA, kG = agent._zero_factors(params)
    jstate = types.SimpleNamespace(
        params=jparams, momentum=zeros(jparams), update_idx=jnp.int32(0),
        kfac_A={k: jnp.asarray(v.numpy()) for k, v in kA.items()},
        kfac_G={k: jnp.asarray(v.numpy()) for k, v in kG.items()})
    jparams2, _, jA, jG, jeta = jax.jit(lambda g, a, f: jagent._kfac_apply(jstate, g, a, f, 0.0))(
        grads, jacts, jfisher)

    acts = {}
    with torch.no_grad():
        logits, _ = agent._forward(params, torch.from_numpy(x), acts)
    ref = np.asarray(jlogits)  # the bf16 CNN, as tests/test_torch_policy.py holds it
    assert np.abs(logits.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
    # The reference's Fisher draws for these samples.
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    draws = (t(jax.random.categorical(k1, jlogits)), t(jax.random.normal(k2, jvalue.shape)))
    fisher = agent.fisher_G(params, torch.from_numpy(x), draws=draws)
    A, G = agent.update_factors(kA, kG, acts, fisher)
    tgrads = bridge.acktr_params_from_reference(jax.tree.map(np.asarray, grads))
    precond = agent.precondition(tgrads, A, G, 0)
    new, _, eta = agent.kfac_step(params, {k: torch.zeros_like(v) for k, v in params.items()},
                                  tgrads, precond, agent.config.learning_rate)
    for w, _, kind, _ in specs:
        ref = np.asarray(jG[w])
    for w, _, kind, _ in specs:
        ref = np.asarray(jG[w])
        assert np.abs(G[w].numpy() - ref).max() <= 5e-2 * np.abs(ref).max(), w
    expect = bridge.acktr_params_from_reference(jax.tree.map(np.asarray, jparams2))
    for k in new:
        step, ref_step = (new[k] - params[k]).numpy(), (expect[k] - params[k]).numpy()
        assert np.abs(step - ref_step).max() <= 1e-2 * np.abs(ref_step).max(), k
    np.testing.assert_allclose(float(eta), float(jeta), rtol=1e-2)


@pytest.mark.parametrize("policy", ["auto", "lnlstm"])
def test_pickles_cross_both_ways(policy, tmp_path):
    recurrent = "lstm" in policy
    jcls, tcls = (JRecurrentACKTR, RecurrentACKTR) if recurrent else (JACKTR, ACKTR)
    name = "acktr_lstm" if recurrent else "acktr"
    obs = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
    dones = np.array([False, True, False])

    jagent = jcls(env=JMobile(), num_envs=N, policy=policy)
    jagent.state = jagent.init_state(jax.random.PRNGKey(0))
    jpath = str(tmp_path / "ref.pkl")
    jagent.save(jpath)
    agent = tcls.load(jpath, env=MobileRobotEnv(), device="cpu")
    assert type(agent) is tcls and agent.policy_kind == ("lnlstm" if recurrent else "mlp")
    for k, v in bridge.acktr_params_from_reference(
            jax.tree.map(np.asarray, jagent.state.params)).items():
        assert torch.equal(agent.state.params[k], v), k
    for _ in range(2):  # the carry advances alike on both sides
        a = agent.getAction(obs, dones, deterministic=True)
        ja = jagent.getAction(obs, dones, deterministic=True)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_allclose(agent.getActionProba(obs, dones),
                                   jagent.getActionProba(obs, dones), rtol=1e-5, atol=1e-7)

    agent.state = agent.init_state(torch.Generator().manual_seed(0), seed=5)
    path = str(tmp_path / "port.pkl")
    agent.save(path)
    with open(path, "rb") as f:
        assert pickle.load(f)["name"] == name
    back = jcls.load(path, env=JMobile())
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.state.params),
                 bridge.acktr_params_to_reference(agent.state.params))
    assert back.policy_kind == agent.policy_kind


def test_cnn_pickle_carries_its_geometry(tmp_path):
    """An ``acktr`` CNN pickle loads without an env: the geometry rides in
    ``cnn_geom``."""
    jagent = JACKTR(policy="cnn")
    jagent.n_act, jagent.cnn_in_channels = 4, 3
    jagent._cnn_geometry((36, 36, 3))
    jagent.state = types.SimpleNamespace(params=jax.tree.map(
        np.asarray, jagent._init_params(jax.random.PRNGKey(0))), obs_norm=None)
    jagent.normalize_obs = False
    path = str(tmp_path / "cnn.pkl")
    jagent.save(path)
    agent = ACKTR.load(path, device="cpu")
    assert (agent.pool, agent.cnn_flat_dim, agent.cnn_in_channels) == (1, 64, 3)
    assert tuple(agent.state.params["C1"].shape) == (32, 3, 8, 8)
    for k, v in jagent.state.params.items():
        np.testing.assert_array_equal(bridge.acktr_params_to_reference(
            {k: agent.state.params[k]})[k], v)
    x = np.random.default_rng(1).integers(0, 256, (2, 36, 36, 3), dtype=np.uint8)
    assert agent.getAction(x, deterministic=True).shape == (2,)


@pytest.mark.parametrize("policy", ["auto", "lstm"])
def test_checkpoints_cross_both_ways(policy, tmp_path):
    recurrent = policy == "lstm"
    log_dir = train.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                          "--algo", "acktr", "--policy", policy, "--num-envs", "4",
                          "--num-timesteps", "150", "--checkpoint-interval", "1",
                          "--device", "cpu", "--no-vis", "--log-dir", str(tmp_path)])
    jstate, meta = JBase.load_checkpoint(os.path.join(log_dir, "checkpoint.pkl"))
    cls = "RecurrentACKTRState" if recurrent else "ACKTRState"
    assert type(jstate).__name__ == cls and meta["num_timesteps"] == 160
    final = BaseRLAgent._load_pickle(os.path.join(log_dir, "acktr_final_model.pkl"))
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.params),
                 final["params"])
    assert int(jstate.update_idx) == 2 and set(jstate.kfac_A) == set(jstate.kfac_G)
    if recurrent:
        assert [x.shape for x in jstate.lstm_state] == [(4, 64), (4, 64)]

    # The reference's own checkpoint (of a fresh state), read by the port.
    jcls = JRecurrentACKTR if recurrent else JACKTR
    jagent = jcls(env=JMobile(max_steps=30), num_envs=N, policy=policy)
    jagent.state = jagent.init_state(jax.random.PRNGKey(2))
    path = str(tmp_path / "ref_checkpoint.pkl")
    jagent.save_checkpoint(path, meta={"num_timesteps": 160})
    state, meta = BaseRLAgent.load_checkpoint(path)
    assert state.ref_name == f"srl_tpu.agents.acktr.{cls}" and meta["num_timesteps"] == 160
    for k, v in bridge.acktr_params_from_reference(state.params).items():
        np.testing.assert_array_equal(
            v.numpy(), bridge.acktr_params_from_reference(
                {k: np.asarray(jagent.state.params[k])})[k].numpy())
    for k in jagent.state.kfac_A:
        np.testing.assert_array_equal(state.kfac_A[k], np.asarray(jagent.state.kfac_A[k]))
    if recurrent:
        port = bridge.to_port(state.lstm_state)
        np.testing.assert_array_equal(port[0].numpy(), np.asarray(jagent.state.lstm_state[0]))

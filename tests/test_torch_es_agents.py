"""ARS, CMA-ES and the random agent, port against reference on the CPU.

* ARS, one generation (srl_tpu/agents/ars.py:75-129) of 8 pairs over 16
  steps of MobileRobot ground truth (random targets, so some envs score;
  ``max_steps`` 8, so envs step on past their first ``done``; the step
  noise off) from a random ``M``: discrete
  actions with ``v2`` normalization, and continuous ones with ``v1``. The
  port is fed the reference's deltas, its Gumbel noise (a key per member
  and step) and its reset and auto-reset draws. The returns equal the
  reference's (sparse rewards, so the pairs tie, and the stable ranking
  matters), ``M`` within rtol 1e-5 (float32 sums in another order), the
  normalizer within rtol 1e-6.
* CMA-ES:
  - the flat vector's layout (``bridge.cmaes_layout``) is the reference's
    ``ravel_pytree`` of its MLP (704 on MobileRobot ground truth) and its
    CNN (7,572 on 224x224 pixels), leaf for leaf; a reference
    ``best_model`` acts alike in both packages: the reference agent's on
    the MLP (its pickle read both ways), the reference ``_CNNPolicy``'s
    logits of the vector unravelled as the agent does on the CNN at 56x56,
    Kuka's coarse frames at render scale 4 (actions equal, probabilities
    within rtol 1e-5: float32 convolutions in another order; the three
    stride-2 convs and pools leave no pixel of 36x36 or 28x28 frames, where
    the reference's Dense cannot initialize);
  - the population's logits (one grouped convolution, ``groups=P``)
    against a loop of the reference's per-member logits, within rtol 1e-5;
  - two generations of 20 members over 16 steps of MobileRobot ground
    truth (n = 704, the ARS env): the reference's ``learn`` with ``np.linalg.eigh`` wrapped
    to record its inputs and outputs, and its state read at each callback;
    the port's ``ask`` and ``tell`` fed the recorded eigendecompositions
    (LAPACK's eigenvector signs are its own). The population within 1e-10
    (float64), the port's rollout of it (fed the reference's draws) equal
    in its returns, and after each generation ``mean``, ``C``, ``ps``,
    ``pc`` and ``sigma`` within 1e-10 relative, ``best_model`` equal.
* The random agent: its actions lie in range (discrete and continuous),
  and its callback counts steps, updates and chunks as the reference's.
* The ``"ars"``, ``"cma-es"`` (MLP) and ``"random_agent"`` pickles read
  both ways.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
import pytest
import torch
from threadpoolctl import threadpool_limits

from srl_tpu.agents.ars import ARS as JARS
from srl_tpu.agents.ars import ARSConfig as JARSConfig
from srl_tpu.agents.cma_es import CMAES as JCMAES
from srl_tpu.agents.cma_es import CMAESConfig as JCMAESConfig
from srl_tpu.agents.cma_es import _CNNPolicy, _MLPPolicy
from srl_tpu.agents.random_agent import RandomAgent as JRandomAgent
from srl_tpu.envs import mobile_robot as jm
from srl_tpu.utils.logging import softmax as jsoftmax
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.ars import ARS, ARSConfig
from srl_tpu_torch.agents.cma_es import CMAES, CMAESConfig, cma_constants
from srl_tpu_torch.agents.random_agent import RandomAgent
from srl_tpu_torch.core import spaces as tspaces
from srl_tpu_torch.envs import mobile_robot as tm
from tests.test_torch_acer import _reset_draws, t

torch.set_num_threads(1)

ENV = dict(noise_std=0.0, max_steps=8, random_target=True)


def stub_env(obs_shape, n_act=4):
    """An image env for the port's constructors."""
    env = type("Stub", (), {})()
    env.observation_space = tspaces.Box(0, 255, obs_shape, np.uint8)
    env.action_space = tspaces.Discrete(n_act)
    env.srl_model = "raw_pixels"
    return env


def rollout_draws(jenv, k_reset, k_roll, n, steps, n_act=None):
    """The draws of the reference's lock-step rollout (``ars.py:89-118``,
    ``cma_es.py:106-131``): the reset's, each step's auto-reset draws from
    the vector env's key, and each step's Gumbel noise, a key per member
    (None for continuous actions)."""
    vkey, sub = jax.random.split(k_reset)
    reset = {k: t(v) for k, v in _reset_draws(jenv)(jax.random.split(sub, n)).items()}
    autoresets, gumbel, k = [], [], k_roll
    for _ in range(steps):
        vkey, sub = jax.random.split(vkey)
        autoresets.append({k_: t(v) for k_, v in
                           _reset_draws(jenv)(jax.random.split(sub, n)).items()})
        k, sub = jax.random.split(k)
        if n_act is not None:
            gumbel.append(np.asarray(_member_gumbels(jax.random.split(sub, n), n_act)))
    return reset, autoresets, (t(np.stack(gumbel)) if n_act is not None else None)


@functools.partial(jax.jit, static_argnums=1)
def _member_gumbels(keys, n_act):
    """Each member's Gumbel noise, as ``jax.random.categorical`` draws it
    from the member's key."""
    return jax.vmap(lambda kk: jax.random.gumbel(kk, (n_act,)))(keys)


def feed_autoresets(agent, noises):
    """The port's vector env steps with the given auto-reset draws, in
    order (replacing any earlier feed)."""
    vec, it = agent.vec_env, iter(noises)
    vec.step = lambda vs, a, gen: type(vec).step(vec, vs, a, gen, reset_noise=next(it))


# ---- ARS ----------------------------------------------------------------------
@pytest.mark.parametrize("discrete, algo_type", [(True, "v2"), (False, "v1")],
                         ids=["discrete-v2", "continuous-v1"])
def test_ars_generation_matches_reference(discrete, algo_type):
    cfg = dict(num_population=8, top_population=3, max_episode_steps=16, algo_type=algo_type)
    jenv, env = (jm.MobileRobotEnv(is_discrete=discrete, **ENV),
                 tm.MobileRobotEnv(is_discrete=discrete, **ENV))
    jagent = JARS(env=jenv, config=JARSConfig(**cfg))
    agent = ARS(env=env, config=ARSConfig(**cfg), device="cpu")
    assert (agent.obs_norm is None) == (algo_type == "v1")
    M = np.random.default_rng(0).normal(0, 0.5, agent.M.shape).astype(np.float32)
    key = jax.random.PRNGKey(5)  # a generation whose top pairs score apart
    jM, jnorm, _, jmean, _ = jax.jit(jagent._generation)(jnp.asarray(M), jagent.obs_norm, key)

    _, k_delta, k_reset, k_roll = jax.random.split(key, 4)
    delta = jax.random.normal(k_delta, (8,) + M.shape)
    reset, autoresets, gumbel = rollout_draws(jenv, k_reset, k_roll, 16, 16,
                                              agent.act_dim if discrete else None)
    feed_autoresets(agent, autoresets)
    M2, norm, r = agent.generation(t(M), agent.obs_norm, torch.Generator(), delta=t(delta),
                                   gumbel=gumbel, reset_noise=reset)
    assert float(r.mean()) == float(jmean)
    returns = r.numpy().ravel()
    assert len(set(np.max(r.numpy(), 1).tolist())) < 8  # tied pairs
    assert (returns != 0).any()
    assert not np.allclose(np.asarray(jM), M)  # a real step
    np.testing.assert_allclose(M2.numpy(), np.asarray(jM), rtol=1e-5, atol=1e-6)
    if algo_type == "v2":
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(norm, f).numpy(), np.asarray(getattr(jnorm, f)),
                                       rtol=1e-6)


def test_ars_pickle_crosses_both_ways(tmp_path):
    jagent = JARS(env=jm.MobileRobotEnv())
    rng = np.random.default_rng(1)
    jagent.M = jnp.asarray(rng.normal(size=jagent.M.shape).astype(np.float32))
    jagent.obs_norm = jagent.obs_norm.update(jnp.asarray(rng.normal(size=(7, 2)), jnp.float32))
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = ARS.load(path, tm.MobileRobotEnv(), None, device="cpu")
    obs = rng.normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs), jagent.getAction(obs))
    # getActionProba reads the observation unnormalized, as the reference's.
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs), rtol=1e-6)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    back = JARS.load(port_path, env=jm.MobileRobotEnv())
    np.testing.assert_array_equal(np.asarray(back.M), np.asarray(jagent.M))
    np.testing.assert_array_equal(np.asarray(back.obs_norm.var), np.asarray(jagent.obs_norm.var))
    assert agent._load_pickle(port_path)["name"] == "ars" and agent.state[0] is agent.M


# ---- CMA-ES ---------------------------------------------------------------------
def reference_cnn_logits(obs_shape, n_act=4):
    """The reference's ``_CNNPolicy`` logits of a flat vector, unravelled as
    its ``CMAES`` does (``ravel_pytree`` of the tree's structure), jitted:
    building a ``CMAES`` agent with the CNN runs ``init`` op by op, about
    9 s of compiles on the CPU."""
    net = _CNNPolicy(n_act)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))
    _, unravel = ravel_pytree(jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes))
    return jax.jit(lambda flat, obs: net.apply(unravel(flat), obs))


def test_cmaes_flat_layout_and_acting_match_reference(tmp_path):
    # The reference's trees (shapes only) and the layout, leaf for leaf.
    for shape, dim in (((2,), 704), ((224, 224, 3), 7572)):
        net = (_MLPPolicy if len(shape) == 1 else _CNNPolicy)(4)
        tree = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1,) + shape))
        layout = bridge.cmaes_layout(shape, 4)
        assert [leaf.shape for leaf in jax.tree.leaves(tree)] == [s for _, _, s in layout]
        assert sum(int(np.prod(s)) for _, _, s in layout) == dim
    rng = np.random.default_rng(2)
    # The MLP: a reference agent's best_model, its pickle both ways.
    jagent = JCMAES(env=jm.MobileRobotEnv())
    flat = rng.normal(0, 0.3, jagent.dim).astype(np.float32)
    ref = jagent._unravel(jnp.asarray(flat))["params"]
    for path, leaf in bridge.cmaes_unravel(flat, bridge.cmaes_layout((2,), 4)).items():
        module, name = path.split("/")
        np.testing.assert_array_equal(leaf, np.asarray(ref[module][name]), err_msg=path)
    jagent.best_model = flat
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    agent = CMAES.load(path, tm.MobileRobotEnv(), None, device="cpu")
    obs = rng.normal(size=(6, 2)).astype(np.float32)
    np.testing.assert_array_equal(agent.getAction(obs), jagent.getAction(obs))
    np.testing.assert_allclose(agent.getActionProba(obs), jagent.getActionProba(obs),
                               rtol=1e-5, atol=1e-7)
    port_path = str(tmp_path / "port.pkl")
    agent.save(port_path)
    np.testing.assert_array_equal(JCMAES.load(port_path, env=jm.MobileRobotEnv()).best_model,
                                  flat)
    assert agent._load_pickle(port_path)["name"] == "cma-es"
    # The CNN at 56x56: the reference's logits of a best_model, acted on.
    agent = CMAES(env=stub_env((56, 56, 3)), device="cpu")
    agent.best_model = rng.normal(0, 0.3, agent.dim).astype(np.float32)
    obs = rng.integers(0, 256, (6, 56, 56, 3)).astype(np.uint8)
    logits = np.asarray(reference_cnn_logits((56, 56, 3))(jnp.asarray(agent.best_model),
                                                          jnp.asarray(obs)))
    np.testing.assert_array_equal(agent.getAction(obs), np.argmax(logits, -1))
    np.testing.assert_allclose(agent.getActionProba(obs), jsoftmax(logits), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(2,), (56, 56, 3)], ids=["mlp", "cnn"])
def test_cmaes_population_logits_match_a_loop_of_the_reference(shape):
    rng = np.random.default_rng(3)
    if len(shape) == 1:  # the reference agent's own per-member logits
        agent = CMAES(env=tm.MobileRobotEnv(), device="cpu")
        one = jax.jit(JCMAES(env=jm.MobileRobotEnv())._policy_logits)
    else:  # its _CNNPolicy, as _policy_logits applies it (one member, one frame)
        agent = CMAES(env=stub_env(shape), device="cpu")
        cnn = reference_cnn_logits(shape)
        one = lambda flat, o: cnn(flat, o[None])[0]
    P = 5
    pop = rng.normal(0, 0.3, (P, agent.dim)).astype(np.float32)
    obs = (rng.normal(size=(P,) + shape).astype(np.float32) if len(shape) == 1
           else rng.integers(0, 256, (P,) + shape).astype(np.uint8))
    ref = np.stack([np.asarray(one(jnp.asarray(pop[i]), jnp.asarray(obs[i]))) for i in range(P)])
    ours = agent.logits(t(pop), t(obs)[None])[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


P_CMA, T_CMA = 20, 16


@pytest.fixture(scope="module")
def cma_reference():
    """The reference's two generations: each one's eigh (input, outputs),
    and its state at each callback (mean, C, ps, pc, sigma, r, pop, y,
    best_model)."""
    jagent = JCMAES(env=jm.MobileRobotEnv(**ENV), config=JCMAESConfig(max_episode_steps=T_CMA))
    eighs, states = [], []
    real = np.linalg.eigh

    def recording(C):
        out = real(C)
        eighs.append((C.copy(), out[0].copy(), out[1].copy()))
        return out

    def callback(_locals, _globals):
        f = sys._getframe(1).f_locals
        states.append({k: np.array(f[k]) for k in ("mean", "C", "ps", "pc", "sigma", "r", "pop")}
                      | {"best_model": np.array(jagent.best_model)})

    mp = pytest.MonkeyPatch()
    mp.setattr(np.linalg, "eigh", recording)
    # One BLAS thread: beside the other test workers, OpenBLAS's own threads
    # make the reference's float64 products several times slower.
    limits = threadpool_limits(1)
    try:
        jagent.learn(2 * P_CMA * T_CMA, seed=4, callback=callback)
    finally:
        mp.undo()
        limits.restore_original_limits()
    return jagent, eighs, states


def test_cmaes_two_generations_match_reference(cma_reference):
    jagent, eighs, states = cma_reference
    assert len(eighs) == len(states) == 2
    agent = CMAES(env=tm.MobileRobotEnv(**ENV), config=CMAESConfig(max_episode_steps=T_CMA),
                  device="cpu")
    n = agent.dim
    k = cma_constants(P_CMA, n)
    s = agent.initial_cma(np.zeros(n))
    rng = np.random.RandomState(4)
    key = jax.random.PRNGKey(4)
    close = lambda ours, ref: np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-10,
                                                         atol=1e-12)
    for (C_in, d2, B), ref in zip(eighs, states):
        close(s.C, C_in)
        s.B, s.D = agent.eigen(s.C, eigh=lambda _: (torch.as_tensor(d2), torch.as_tensor(B)))
        y, pop = agent.ask(s, torch.as_tensor(rng.randn(P_CMA, n)))
        close(pop, ref["pop"])
        # The port's rollout of the population, fed the reference's draws.
        key, sub = jax.random.split(key)
        _, k_reset, k_roll = jax.random.split(sub, 3)
        reset, autoresets, gumbel = rollout_draws(jagent.env, k_reset, k_roll, P_CMA, T_CMA, 4)
        feed_autoresets(agent, autoresets)
        r = agent.eval_population(pop.to(torch.float32), torch.Generator(), gumbel, reset)
        np.testing.assert_array_equal(r.numpy(), ref["r"])
        s = agent.tell(s, y, pop, ref["r"], k)
        for name in ("mean", "C", "ps", "pc"):
            close(getattr(s, name), ref[name])
        np.testing.assert_allclose(s.sigma, ref["sigma"], rtol=1e-10)
        np.testing.assert_array_equal(agent.best_model, ref["best_model"])
    assert not np.array_equal(eighs[1][0], np.eye(n))  # the second eigh saw an updated C


# ---- the random agent -------------------------------------------------------------
@pytest.fixture(scope="module")
def random_agent_calls():
    """What the reference's random agent hands its callback over 1500 steps
    of 4 envs: (steps, update, n_updates, episode lengths) per chunk."""
    calls = []
    JRandomAgent(env=jm.MobileRobotEnv(), num_envs=4).learn(1500, seed=0, callback=lambda lc, _: (
        calls.append((lc["num_timesteps"], lc["update"], lc["n_updates"],
                      len(lc["episode_lengths"])))))
    return calls


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_random_agent_chunks_match_reference(discrete, random_agent_calls, tmp_path):
    jagent = JRandomAgent(env=jm.MobileRobotEnv(is_discrete=discrete), num_envs=4)
    agent = RandomAgent(env=tm.MobileRobotEnv(is_discrete=discrete), num_envs=4, device="cpu")
    calls, actions = [], []
    step = agent.vec_env.step
    agent.vec_env.step = lambda vs, a, gen: (actions.append(a), step(vs, a, gen))[1]
    agent.learn(1500, seed=0, callback=lambda lc, _: calls.append(
        (lc["num_timesteps"], lc["update"], lc["n_updates"], len(lc["episode_lengths"]))))
    # The count does not depend on the action space.
    assert calls == random_agent_calls == [(1024, 1024, 1500, 0), (2048, 2048, 1500, 0)]
    a = torch.stack(actions)
    assert a.shape == ((512, 4) if discrete else (512, 4, 2))
    if discrete:
        assert a.min() == 0 and a.max() == 3
    else:
        assert a.min() >= -1 and a.max() <= 1 and a.min() < -0.99 and a.max() > 0.99
    obs = np.zeros((3, 2), np.float32)
    assert agent.getAction(obs).shape == np.asarray(jagent.getAction(obs)).shape
    np.testing.assert_array_equal(agent.getActionProba(obs), jagent.getActionProba(obs))
    path = str(tmp_path / "ref.pkl")
    jagent.save(path)
    assert RandomAgent.load(path, agent.env, None, device="cpu").num_envs == 4
    agent.save(path)
    assert JRandomAgent.load(path, env=jagent.env).num_envs == 4

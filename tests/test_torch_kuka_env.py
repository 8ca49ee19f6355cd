"""srl_tpu_torch.envs.kuka and core.env against srl_tpu on the CPU.

States come from the reference's ``reset`` and cross through the bridge; the
port's ``apply_step`` / ``apply_reset`` are fed the normals and uniforms that
the reference drew from its keys (``jax_step_noise`` / ``jax_reset_noise``
repeat the reference's key splits, srl_tpu/envs/kuka.py:266-300, 331/340,
385, 426). Rewards and dones must be equal; q and tip allclose at 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs import kuka as jk
from srl_tpu_torch import bridge
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs import kuka as tk
from srl_tpu_torch.envs.registry import make_env

torch.set_num_threads(1)

VARIANTS = {
    "button": (jk.KukaButtonEnv, tk.KukaButtonEnv),
    "rand": (jk.KukaRandButtonEnv, tk.KukaRandButtonEnv),
    "2button": (jk.Kuka2ButtonEnv, tk.Kuka2ButtonEnv),
}


def jax_reset_noise(env, keys) -> dict:
    """The random numbers ``env.reset(key)`` draws, for a batch of keys."""
    return {k: torch.as_tensor(np.array(v)) for k, v in _reset_draws(env)(keys).items()}


@functools.lru_cache(maxsize=None)
def _reset_draws(env):
    def one(key):
        _, k_btn, k_init, k_obj, _ = jax.random.split(key, 5)
        out = {}
        if env.random_target:
            if env.n_buttons == 1:
                out["button_u"] = jax.random.uniform(k_btn, (2,), minval=-1.0, maxval=1.0)
            else:
                k1, k2 = jax.random.split(k_btn)
                out["button_u"] = jnp.stack([jax.random.uniform(k1, (2,)),
                                             jax.random.uniform(k2, (2,))])
        if env.rand_objects:
            out["object_u"] = jax.random.uniform(
                k_obj, (jk.N_DISTRACTORS, 2), minval=-1.0, maxval=1.0)
        init_keys = jax.random.split(k_init, jk.N_RANDOM_ACTIONS_AT_INIT)
        ka, kb = jax.vmap(jax.random.split, out_axes=1)(init_keys)
        if env.is_discrete:
            out["init_u"] = jax.vmap(jax.random.uniform)(ka)
            out["init_axis"] = jax.vmap(lambda k: jax.random.randint(k, (), 0, 3))(kb)
        else:
            out["init_dir"] = jax.vmap(lambda k: jax.random.normal(k, (3,)))(ka)
        return out

    return jax.jit(jax.vmap(one))


def jax_step_noise(env, state_keys) -> dict:
    """The random numbers ``env.step`` draws from each env's ``state.key``."""
    return {k: torch.as_tensor(np.array(v)) for k, v in _step_draws(env)(state_keys).items()}


@functools.lru_cache(maxsize=None)
def _step_draws(env):
    def one(key):
        key, k_noise = jax.random.split(key)
        out = {"dv": jax.random.normal(k_noise, ())}
        if env.rand_objects:
            k_kick, _ = jax.random.split(key)
            out["kick"] = jax.random.normal(k_kick, (2,))
        return out

    return jax.jit(jax.vmap(one))


def jit_reset(fn):
    """``jax.jit`` of a function that resets reference Kuka envs. Their
    settled arm pose is a host constant computed on first use, which must
    happen outside the trace."""
    jk._settled_q()
    return jax.jit(fn)


def to_port_state(jstate):
    return bridge.kuka_state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)})


def test_make_env_unknown_id_names_known_ids():
    with pytest.raises(KeyError, match="KukaButtonGymEnv-v0"):
        make_env("NoSuchEnv-v0")
    assert isinstance(make_env("Kuka2ButtonGymEnv-v0"), tk.Kuka2ButtonEnv)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reset_matches(variant):
    jcls, tcls = VARIANTS[variant]
    jenv, tenv = jcls(srl_model="ground_truth"), tcls(srl_model="ground_truth")
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    jstate = jit_reset(jax.vmap(jenv.reset))(keys)
    tstate = tenv.apply_reset(jax_reset_noise(jenv, keys))
    ref = to_port_state(jstate)
    for f in dataclasses.fields(tstate):
        np.testing.assert_allclose(getattr(tstate, f.name).numpy(),
                                   getattr(ref, f.name).numpy(), atol=1e-5, rtol=0,
                                   err_msg=f.name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fifty_steps_match(variant):
    jcls, tcls = VARIANTS[variant]
    jenv, tenv = jcls(srl_model="ground_truth"), tcls(srl_model="ground_truth")
    n = 6
    jstate = jit_reset(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), n))
    tstate = to_port_state(jstate)
    actions = np.random.default_rng(5).integers(0, 6, (50, n)).astype(np.int32)
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(50):
        noise = jax_step_noise(jenv, jstate.key)
        jstate, jr, jd = step(jstate, jnp.asarray(actions[t]))
        tstate, tr, td = tenv.apply_step(tstate, torch.from_numpy(actions[t]), noise)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"reward {t}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done {t}")
        np.testing.assert_allclose(tstate.q.numpy(), np.asarray(jstate.q), atol=1e-4)
        np.testing.assert_allclose(tstate.tip.numpy(), np.asarray(jstate.tip), atol=1e-4)
    np.testing.assert_array_equal(tstate.n_contacts.numpy(), np.asarray(jstate.n_contacts))


def test_vecenv_autoreset_episode_stats_match():
    """Short episodes (max_steps 6) so every env auto-resets inside the run:
    done, the fresh first observation, episode_return and episode_length
    follow the reference's VecEnv (srl_tpu/core/env.py:170-221)."""
    kwargs = dict(srl_model="ground_truth", max_steps=6, shape_reward=True)
    jenv, tenv = jk.KukaButtonEnv(**kwargs), tk.KukaButtonEnv(**kwargs)
    n = 4
    jvec, tvec = JaxVecEnv(jenv, n), VecEnv(tenv, n)
    jv, jobs = jit_reset(jvec.reset)(jax.random.PRNGKey(7))
    # The port's reset from the reference's keys (VecEnv.reset splits once).
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, n)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5)
    step = jit_reset(jvec.step)
    actions = np.random.default_rng(8).integers(0, 6, (16, n)).astype(np.int32)
    n_done = 0
    for t in range(16):
        step_noise = jax_step_noise(jenv, jv.env_state.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, n))
        jv, jtr = step(jv, jnp.asarray(actions[t]))
        tv, ttr = tvec.step(tv, torch.from_numpy(actions[t]), step_noise=step_noise,
                            reset_noise=reset_noise)
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_allclose(ttr.reward.numpy(), np.asarray(jtr.reward), atol=1e-5)
        np.testing.assert_allclose(ttr.obs.numpy(), np.asarray(jtr.obs), atol=1e-4)
        np.testing.assert_allclose(ttr.episode_return.numpy(),
                                   np.asarray(jtr.episode_return), atol=1e-4)
        np.testing.assert_array_equal(ttr.episode_length.numpy(),
                                      np.asarray(jtr.episode_length))
        n_done += int(np.asarray(jtr.done).sum())
    assert n_done >= n

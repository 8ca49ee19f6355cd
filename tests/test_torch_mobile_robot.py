"""srl_tpu_torch.envs.mobile_robot and core.env.VecEnv against srl_tpu on the
CPU, for the four MobileRobot variants.

The port's ``apply_reset`` / ``apply_step`` are fed the uniforms and normals
that the reference drew from its keys (``jax_reset_noise`` /
``jax_step_noise`` repeat the key splits of srl_tpu/envs/mobile_robot.py:
143-147, 163-169 and 197-198). With ``noise_std=0`` positions, rewards,
dones, episode statistics and observations (``srl_state``) are bit-equal
over more than one episode (auto-reset at step 251). With noise, rewards and
dones are equal and positions agree to 1e-6: the normals fed to the port
come from a separately compiled draw, whose last bit may differ from the
one XLA computes inside the reference's fused step.

Batches are of 8 envs: XLA's CPU code contracts the reference's ``norm``
(its ``dx*dx + dy*dy``) into a fused multiply-add only in the scalar loop
it runs for a remainder of fewer than 4 elements, and the port rounds as
written, as XLA's vector loop does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch import bridge
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs import mobile_robot as tm
from srl_tpu_torch.envs.registry import make_env

from .oracle_mobile_robot import OracleMobileRobot

torch.set_num_threads(1)

N = 8
VARIANTS = {
    "2d": ("MobileRobotEnv", {}),
    "2d_continuous": ("MobileRobotEnv", dict(is_discrete=False)),
    "2d_random_shaped": ("MobileRobotEnv", dict(random_target=True, shape_reward=True)),
    "1d": ("MobileRobot1DEnv", {}),
    "1d_random": ("MobileRobot1DEnv", dict(random_target=True)),
    "2target": ("MobileRobot2TargetEnv", {}),
    "2target_random": ("MobileRobot2TargetEnv", dict(random_target=True)),
    "line": ("MobileRobotLineTargetEnv", {}),
    "line_random_shaped": ("MobileRobotLineTargetEnv",
                           dict(random_target=True, shape_reward=True)),
}


def make_pair(variant, **extra):
    name, kwargs = VARIANTS[variant]
    kwargs = {**kwargs, **extra}
    return getattr(jm, name)(**kwargs), getattr(tm, name)(**kwargs)


def jax_reset_noise(env, keys) -> dict:
    """The random numbers ``env.reset(key)`` draws, for a batch of keys."""
    return {k: torch.as_tensor(np.array(v)) for k, v in _reset_draws(env)(keys).items()}


@functools.lru_cache(maxsize=None)
def _reset_draws(env):
    def one(key):
        _, k_robot, k_targets = jax.random.split(key, 3)
        out = {"robot_u": jax.random.uniform(k_robot, (2,), minval=-jm.MAX_X / 3,
                                             maxval=jm.MAX_X / 3)}
        if env.random_target:
            margin = 0.1 * jm.MAX_X
            out["target_u"] = jax.random.uniform(
                k_targets, (env.n_targets, 2), minval=jm.MIN_X + margin,
                maxval=jm.MAX_X - margin)
        return out

    return jax.jit(jax.vmap(one))


def jax_step_noise(env, state_keys) -> dict:
    """The normal ``env.step`` draws from each env's ``state.key``."""
    return {"dv": torch.as_tensor(np.array(_step_draws(env)(state_keys)))}


@functools.lru_cache(maxsize=None)
def _step_draws(env):
    def one(key):
        _, k_noise = jax.random.split(key)
        return jax.random.normal(k_noise, ())

    return jax.jit(jax.vmap(one))


def to_port_state(jstate):
    arrays = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    return bridge.state_from_numpy(tm.MobileRobotState, arrays)


def actions_for(env, n_steps, seed):
    """Random actions, with envs 0 and 1 pushed into the walls (bumps)."""
    rng = np.random.default_rng(seed)
    if env.is_discrete:
        acts = rng.integers(0, env.action_space.n, (n_steps, N)).astype(np.int32)
        acts[:, 0] = 0  # -x
        acts[:, 1] = env.action_space.n - 1  # +y (+x in 1D)
    else:
        acts = rng.uniform(-1.5, 1.5, (n_steps, N, 2)).astype(np.float32)
        acts[:, 0] = [-1.0, -0.3]
        acts[:, 1] = [0.4, 1.2]
    return acts


def assert_states_equal(tstate, jstate):
    ref = to_port_state(jstate)
    for f in dataclasses.fields(tstate):
        np.testing.assert_array_equal(getattr(tstate, f.name).numpy(),
                                      getattr(ref, f.name).numpy(), err_msg=f.name)


def test_make_env_knows_the_mobile_robot_ids():
    for name, cls in (("MobileRobotGymEnv-v0", tm.MobileRobotEnv),
                      ("MobileRobot1DGymEnv-v0", tm.MobileRobot1DEnv),
                      ("MobileRobot2TargetGymEnv-v0", tm.MobileRobot2TargetEnv),
                      ("MobileRobotLineTargetGymEnv-v0", tm.MobileRobotLineTargetEnv)):
        env = make_env(name, srl_model="ground_truth")
        assert type(env) is cls
    with pytest.raises(KeyError, match="MobileRobotGymEnv-v0"):
        make_env("NoSuchEnv-v0")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reset_matches(variant):
    jenv, tenv = make_pair(variant)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    assert_states_equal(tenv.apply_reset(jax_reset_noise(jenv, keys)), jstate)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vecenv_matches_through_an_auto_reset(variant):
    """260 steps, so every env's first episode ends (at step 251) and the
    auto-reset starts the next from the reference's draws."""
    jenv, tenv = make_pair(variant, max_steps=250)
    jvec, tvec = JaxVecEnv(jenv, N), VecEnv(tenv, N)
    key = jax.random.PRNGKey(7)
    jv, jobs = jax.jit(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, N)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    step = jax.jit(jvec.step)
    acts = actions_for(tenv, 260, seed=8)
    n_done = n_bumped = 0
    for t in range(260):
        step_noise = jax_step_noise(jenv, jv.env_state.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, jnp.asarray(acts[t]))
        tv, ttr = tvec.step(tv, torch.from_numpy(acts[t]), step_noise=step_noise,
                            reset_noise=reset_noise)
        for name in ("obs", "reward", "done", "episode_return", "episode_length"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)),
                                          err_msg=f"{name} at step {t}")
        assert_states_equal(tv.env_state, jv.env_state)
        n_done += int(np.asarray(jtr.done).sum())
        n_bumped += int(np.asarray(jv.env_state.has_bumped).sum())
    assert n_done >= N and n_bumped > 0


@pytest.mark.parametrize("variant", ["2d", "2d_continuous", "2target_random"])
def test_noisy_steps_match(variant):
    jenv, tenv = make_pair(variant, noise_std=0.05)
    jstate = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), N))
    tstate = to_port_state(jstate)
    step = jax.jit(jax.vmap(jenv.step))
    acts = actions_for(tenv, 60, seed=9)
    for t in range(60):
        noise = jax_step_noise(jenv, jstate.key)
        jstate, jr, jd = step(jstate, jnp.asarray(acts[t]))
        tstate, tr, td = tenv.apply_step(tstate, torch.from_numpy(acts[t]), noise)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"reward {t}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"done {t}")
        np.testing.assert_allclose(tstate.robot_pos.numpy(), np.asarray(jstate.robot_pos),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["2d", "1d", "2target", "line"])
def test_placed_states_match(variant):
    """Robots placed on a target, against a wall margin and next to the
    second target: reached rewards, bumps with full rollback and the
    two-target progression (current_target 0 -> 1, then kept)."""
    jenv, tenv = make_pair(variant)
    jstate = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(5), N))
    targets = np.asarray(jstate.targets)
    pos = np.array([[3.5, 3.0], [0.43, 2.0], [3.57, 1.0], [2.0, 0.21], [2.0, 3.79],
                    [0.4, 3.0], [3.62, 2.9], [1.0, 1.0]], np.float32)
    pos[0] = targets[0, 0] + [0.05, 0.0]
    if jenv.n_targets > 1:
        pos[5] = targets[5, 1] + [0.0, 0.05]
    if jenv.dim == 1:
        pos[:, 1] = 0.0
    jstate = jstate.replace(robot_pos=jnp.asarray(pos))
    tstate = to_port_state(jstate)
    step = jax.jit(jax.vmap(jenv.step))
    acts = np.array([[0, 0, 1, 2, 3, 1, 1, 0], [1, 0, 1, 2, 3, 0, 0, 1],
                     [0, 0, 0, 0, 0, 0, 0, 0]], np.int32) % jenv.action_space.n
    for a in acts:
        noise = jax_step_noise(jenv, jstate.key)
        jstate, jr, jd = step(jstate, jnp.asarray(a))
        tstate, tr, td = tenv.apply_step(tstate, torch.from_numpy(a), noise)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_states_equal(tstate, jstate)
        for fn in ("target_pos", "ground_truth", "srl_state"):
            np.testing.assert_array_equal(getattr(tenv, fn)(tstate).numpy(),
                                          np.asarray(jax.vmap(getattr(jenv, fn))(jstate)),
                                          err_msg=fn)
    assert (np.asarray(jr) == -1.0).any()
    if jenv.n_targets > 1:
        assert int(tstate.current_target[0]) == 1


@pytest.mark.parametrize(
    "variant,oracle_kwargs",
    [("2d", dict(dim=2)), ("1d", dict(dim=1)),
     ("2target", dict(n_targets=2, max_steps=1500)), ("line", dict(line_target=True)),
     ("2d_continuous", dict(dim=2, is_discrete=False)),
     ("2d_random_shaped", dict(dim=2, shape_reward=True))],
)
def test_trajectory_matches_numpy_oracle(variant, oracle_kwargs):
    """The reference's own golden model (tests/oracle_mobile_robot.py), one
    env over 300 steps from the same start, held as tests/test_mobile_robot.py
    holds the reference: discrete positions and all dones equal; continuous
    positions within 5e-7 (the port, like XLA, fuses ``prev + act * dv``
    into one multiply-add, the oracle rounds twice); rewards within 1e-6
    (the oracle's ``np.linalg.norm`` may round the shaped reward's sum of
    squares differently)."""
    _, tenv = make_pair(variant)
    tstate = tenv.reset(torch.Generator().manual_seed(42), 1)
    oracle = OracleMobileRobot(**oracle_kwargs)
    oracle.set_state(tstate.robot_pos[0].numpy(), tstate.targets[0].numpy())
    rng = np.random.RandomState(0)
    if tenv.is_discrete:
        acts = rng.randint(0, tenv.action_space.n, size=300)
    else:
        acts = rng.uniform(-1.2, 1.2, size=(300, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    for t, a in enumerate(acts):
        pos, reward, done = oracle.step(a)
        tstate, tr, td = tenv.step(tstate, torch.as_tensor(np.asarray(a))[None], gen)
        np.testing.assert_allclose(tstate.robot_pos[0].numpy(), pos, err_msg=f"step {t}",
                                   atol=0 if tenv.is_discrete else 5e-7, rtol=0)
        assert abs(float(tr[0]) - float(reward)) <= 1e-6 and bool(td[0]) == done


def test_spaces_and_target_shapes():
    n = 3
    gen = torch.Generator().manual_seed(0)
    for variant, tp_dim, obs_dim in (("2d", 2, 2), ("1d", 1, 1), ("2target", 2, 2),
                                     ("line", 1, 2)):
        _, tenv = make_pair(variant)
        state = tenv.reset(gen, n)
        assert tenv.target_pos(state).shape == (n, tp_dim)
        assert tenv.observe(state).shape == (n, obs_dim) == (n,) + tenv.observation_space.shape
    pix = tm.MobileRobotEnv(srl_model="raw_pixels", fpv=True)
    assert pix.observation_space.shape == (224, 224, 6)
    assert tm.MobileRobot1DEnv().action_space.n == 2
    with pytest.raises(ValueError, match="discrete"):
        tm.MobileRobot2TargetEnv(is_discrete=False)

"""srl_tpu_torch.envs.omnirobot against srl_tpu on the CPU.

The port's ``apply_reset`` / ``apply_step`` are fed the uniforms and normals
that the reference drew from its keys (``jax_reset_noise`` /
``jax_step_noise`` repeat srl_tpu/envs/omnirobot.py:121-129 and the render
noise's ``fold_in(state.key, step_count)``, l.231-233). Positions, rewards,
dones, contact counts and observations are bit-equal: discrete and
continuous moves, wall bumps, reaches, the truncation after 251 steps and
the auto-reset, ``shape_reward`` (the distance's square root is taken in
float64, correctly rounded as XLA's). Frames are bit-equal to the jitted
reference without render noise. With render noise they are held to over
99.99% of the pixels equal: the fed normals come from a separately compiled
draw, whose last bit may differ from the one XLA computes inside the
reference's render (measured: all equal). Batches are of 8 envs (see
tests/test_torch_mobile_robot.py on XLA's loop shapes).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs import omnirobot as jo
from srl_tpu_torch import bridge
from srl_tpu_torch.core import numerics
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs import omnirobot as to
from tests.test_golden_trajectories import GOLDEN

torch.set_num_threads(1)

N = 8


def render_normals(key, count):
    """The render noise of a reference state with ``key`` at ``count``."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, count))
    return jnp.concatenate([jax.random.normal(k1, (2,)), jax.random.normal(k2, (1,))])


def as_torch(tree) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def jax_reset_noise(env, keys) -> dict:
    """The random numbers ``env.reset(key)`` draws, and the render noise of
    the state it returns, for a batch of keys."""
    return as_torch(_reset_draws(env)(keys))


@functools.lru_cache(maxsize=None)
def _reset_draws(env):
    def one(key):
        key, k_robot, k_target = jax.random.split(key, 3)
        out = {"robot_pos": jax.random.uniform(k_robot, (2,), minval=jo.INIT_MIN,
                                               maxval=jo.INIT_MAX)}
        if env.random_target:
            out["target_pos"] = jax.random.uniform(k_target, (2,), minval=jo.TARGET_MIN,
                                                   maxval=jo.TARGET_MAX)
        if env.noise:
            out["render"] = render_normals(key, 0)
        return out

    return jax.jit(jax.vmap(one))


def jax_step_noise(env, state) -> dict:
    """The render noise of the states ``env.step`` returns from ``state``."""
    if not env.noise:
        return {}
    return as_torch({"render": _step_draws()(state.key, state.step_count)})


@functools.lru_cache(maxsize=None)
def _step_draws():
    return jax.jit(jax.vmap(lambda key, count: render_normals(jax.random.split(key)[0],
                                                              count + 1)))


def to_port_state(env, jstate):
    arrays = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    noise = (np.asarray(_state_render_noise()(jstate.key, jstate.step_count))
             if env.noise else None)
    return bridge.omnirobot_state_from_numpy(arrays, render_noise=noise)


@functools.lru_cache(maxsize=None)
def _state_render_noise():
    return jax.jit(jax.vmap(render_normals))


def assert_states_equal(tstate, ref):
    for f in dataclasses.fields(tstate):
        np.testing.assert_array_equal(getattr(tstate, f.name).numpy(),
                                      getattr(ref, f.name).numpy(), err_msg=f.name)


def make_pair(**kwargs):
    return jo.OmniRobotEnv(**kwargs), to.OmniRobotEnv(**kwargs)


@pytest.mark.parametrize("kwargs", [dict(srl_model="ground_truth"),
                                    dict(srl_model="ground_truth", random_target=False),
                                    dict(noise=False)])
def test_reset_matches(kwargs):
    jenv, tenv = make_pair(**kwargs)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    assert_states_equal(tenv.apply_reset(jax_reset_noise(jenv, keys)),
                        to_port_state(jenv, jstate))


def actions_for(env, n_steps, seed):
    """Random actions, with envs 0 and 1 driven into walls (bumps)."""
    rng = np.random.default_rng(seed)
    if env.is_discrete:
        acts = rng.integers(0, 4, (n_steps, N)).astype(np.int32)
        acts[:, 0], acts[:, 1] = 0, 3
    else:
        acts = rng.uniform(-0.1, 0.1, (n_steps, N, 2)).astype(np.float32)
        acts[:, 0] = [0.1, 0.05]
    return acts


@pytest.mark.parametrize("kwargs", [dict(), dict(is_discrete=False),
                                    dict(shape_reward=True, random_target=False)])
def test_vecenv_matches_through_an_auto_reset(kwargs):
    """260 steps from ground truth: every first episode ends after 251
    steps and the auto-reset starts the next from the reference's draws."""
    jenv, tenv = make_pair(srl_model="ground_truth", **kwargs)
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
        step_noise = jax_step_noise(jenv, jv.env_state)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, jnp.asarray(acts[t]))
        tv, ttr = tvec.step(tv, torch.from_numpy(acts[t]), step_noise=step_noise,
                            reset_noise=reset_noise)
        for name in ("obs", "reward", "done", "episode_return", "episode_length"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)),
                                          err_msg=f"{name} at step {t}")
        assert_states_equal(tv.env_state, to_port_state(jenv, jv.env_state))
        n_done += int(np.asarray(jtr.done).sum())
        n_bumped += int((np.asarray(jtr.reward) == -1.0).sum())
    assert n_done == N
    if not tenv.shape_reward:
        assert n_bumped > 0


def test_placed_states_reach_bump_and_truncate():
    """Robots on their target (reward 1, n_contacts counting up), against
    each wall (-1, no move), and one step before the truncation."""
    jenv, tenv = make_pair(srl_model="ground_truth")
    jstate = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(5), N))
    target = np.asarray(jstate.target_pos)
    pos = np.array([[0.0, 0.0], [0.8, 0.0], [-0.8, 0.0], [0.0, 0.8], [0.0, -0.8],
                    [0.3, 0.3], [0.74, 0.749], [0.1, 0.1]], np.float32)
    pos[0] = target[0] + [0.05, 0.0]
    pos[5] = target[5] + [0.0, 0.1]
    counts = np.zeros(N, np.int32)
    counts[7] = 250
    jstate = jstate.replace(robot_pos=jnp.asarray(pos), step_count=jnp.asarray(counts))
    tstate = to_port_state(jenv, jstate)
    step = jax.jit(jax.vmap(jenv.step))
    for a in ([2, 0, 1, 2, 3, 3, 2, 0], [3, 0, 1, 2, 3, 2, 0, 1]):
        a = np.asarray(a, np.int32)
        tstate, tr, td = tenv.apply_step(tstate, torch.from_numpy(a),
                                         jax_step_noise(jenv, jstate))
        jstate, jr, jd = step(jstate, jnp.asarray(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_states_equal(tstate, to_port_state(jenv, jstate))
        for fn in ("ground_truth", "target_pos", "srl_state", "actionPolicyTowardTarget"):
            np.testing.assert_array_equal(
                getattr(tenv, fn)(tstate).numpy(),
                np.asarray(jax.vmap(getattr(jenv, fn))(jstate)), err_msg=fn)
    rewards = tr.numpy()
    assert rewards[0] == 1.0 and int(tstate.n_contacts[0]) == 2
    assert (rewards[1:5] == -1.0).all() and bool(td[7]) and not bool(td[:7].any())


def test_continuous_steps_and_expert_match():
    jenv, tenv = make_pair(srl_model="ground_truth", is_discrete=False)
    jstate = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(6), N))
    tstate = to_port_state(jenv, jstate)
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(40):
        a = np.asarray(tenv.actionPolicyTowardTarget(tstate))
        if t % 2:
            a = actions_for(tenv, 1, seed=t)[0]
        tstate, tr, td = tenv.apply_step(tstate, torch.from_numpy(a),
                                         jax_step_noise(jenv, jstate))
        jstate, jr, jd = step(jstate, jnp.asarray(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert_states_equal(tstate, to_port_state(jenv, jstate))
    assert (tr.numpy() == 1.0).any()


def test_ringbox_sample_support():
    gen = torch.Generator().manual_seed(0)
    space = to.OmniRobotEnv(is_discrete=False).action_space
    s = space.sample(gen, 20000).numpy()
    assert s.shape == (20000, 2) and (np.abs(s) <= 0.1 + 1e-6).all()
    assert 0.45 < (s > 0).mean() < 0.55
    ring = to.RingBox(0.02, 0.1, -0.1, -0.02, (2,))
    r = ring.sample(gen, 20000).numpy()
    assert (np.abs(r) >= 0.02).all() and (np.abs(r) <= 0.1).all()
    assert 0.45 < (r > 0).mean() < 0.55
    ref = jo.RingBox(0.02, 0.1, -0.1, -0.02, (2,))
    jr = np.asarray(jax.vmap(ref.sample)(jax.random.split(jax.random.PRNGKey(0), 20000)))
    assert (np.abs(jr) >= 0.02).all() and abs((jr > 0).mean() - (r > 0).mean()) < 0.03


def random_states(jenv, seed, n=N):
    """Reference states with robots, headings and targets anywhere, border
    included."""
    rng = np.random.default_rng(seed)
    jstate = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), n))
    f32 = lambda *shape: jnp.asarray(rng.uniform(-0.95, 0.95, shape).astype(np.float32))
    return jstate.replace(robot_pos=f32(n, 2), target_pos=f32(n, 2),
                          robot_yaw=jnp.asarray(rng.uniform(-3, 3, n).astype(np.float32)),
                          step_count=jnp.asarray(rng.integers(0, 250, n).astype(np.int32)))


@pytest.mark.parametrize("noise", [False, True])
def test_render_matches(noise):
    jenv, tenv = make_pair(srl_model="raw_pixels", noise=noise)
    for seed in (0, 1):
        jstate = random_states(jenv, seed)
        ref = np.asarray(jax.jit(jax.vmap(jenv.render_pixels))(jstate))
        out = tenv.observe(to_port_state(jenv, jstate)).numpy()
        assert out.shape == (N, 224, 224, 3) and out.dtype == np.uint8
        if noise:
            assert (out == ref).all(-1).mean() > 0.9999
        else:
            np.testing.assert_array_equal(out, ref)
    red = (out[..., 0] > 180) & (out[..., 1] < 80)
    assert red.sum() > 20 * N


def test_pixel_vecenv_matches_with_render_noise():
    jenv, tenv = make_pair(srl_model="raw_pixels")
    jvec, tvec = JaxVecEnv(jenv, N), VecEnv(tenv, N)
    key = jax.random.PRNGKey(11)
    jv, jobs = jax.jit(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, N)))
    step = jax.jit(jvec.step)
    acts = actions_for(tenv, 6, seed=3)
    for t in range(6):
        step_noise = jax_step_noise(jenv, jv.env_state)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, jnp.asarray(acts[t]))
        tv, ttr = tvec.step(tv, torch.from_numpy(acts[t]), step_noise=step_noise,
                            reset_noise=reset_noise)
        np.testing.assert_array_equal(ttr.reward.numpy(), np.asarray(jtr.reward))
        assert (ttr.obs.numpy() == np.asarray(jtr.obs)).all(-1).mean() > 0.9999


def test_golden_fingerprint():
    """tests/test_golden_trajectories.py's "omni" pin, the port fed the
    reference's draws and actions: reward total within 1e-3 and the final
    ground truth within 2e-5, the reference's own tolerances."""
    jenv, tenv = make_pair(srl_model="ground_truth")
    vec = VecEnv(tenv, 4)
    _, sub = jax.random.split(jax.random.PRNGKey(42))
    vstate, _ = vec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, 4)))
    k = jax.random.PRNGKey(7)
    rews = []
    for _ in range(50):
        k, sub = jax.random.split(k)
        a = np.array(jax.random.randint(sub, (4,), 0, 4))
        vstate, tr = vec.step(vstate, torch.from_numpy(a),
                              step_noise={"render": torch.zeros(4, 3)})
        rews.append(tr.reward.numpy())
    want_rew, want_gt = GOLDEN["omni"]
    assert abs(float(np.sum(rews)) - want_rew) < 1e-3
    gt = tenv.ground_truth(vstate.env_state).numpy().ravel()[:8].astype(np.float64)
    np.testing.assert_allclose(gt, want_gt, atol=2e-5)


def test_spaces():
    env = to.OmniRobotEnv()
    assert env.observation_space.shape == (224, 224, 3) and env.action_space.n == 4
    assert to.OmniRobotEnv(srl_model="ground_truth").observation_space.shape == (2,)
    assert isinstance(to.OmniRobotEnv(is_discrete=False).action_space, to.RingBox)
    with pytest.raises(ValueError, match="action_repeat"):
        to.OmniRobotEnv(action_repeat=2)


def test_linspace_grid_is_the_jitted_reference():
    for start, stop, num in ((1.0, -1.0, 224), (-1.0, 1.0, 224), (30.0, -30.0, 224),
                             (-30.0, 30.0, 56)):
        ref = np.asarray(jax.jit(lambda: jnp.linspace(start, stop, num))())
        np.testing.assert_array_equal(numerics.linspace(start, stop, num), ref)

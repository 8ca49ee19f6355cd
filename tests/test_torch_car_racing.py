"""srl_tpu_torch.envs.car_racing against srl_tpu on the CPU.

The port's ``apply_reset`` is fed the angle offsets and radii that the
reference drew from its keys (srl_tpu/envs/car_racing.py:78-86). Its
arithmetic is the reference's as written, with the roundings XLA's CPU code
gives where they could be matched: the jitted ``linspace`` grids
(bit-equal), ``/ 3`` as a multiplication by float32(1/3), the
interpolation's and the tile reward's fused multiply-adds. XLA's own sin,
cos, tan and atan2 are approximations that differ from PyTorch's by an ulp
or more, and XLA fuses some of the smoothing's products depending on how it
splits the passes into loops, so the stated tolerances are:

* the track within 1e-4 (a few ulps of coordinates up to 150; measured
  4.6e-5), the start heading within 1e-5 rad (atan2, measured 2.2e-6);
* one step from the same state: rewards (``shape_reward``'s within 1e-8,
  3 ulps: XLA fuses its sum of squares differently for other batch sizes),
  dones and visited tiles equal,
  position and velocity within 1e-5, yaw, yaw rate and wheel angle within
  1e-6;
* frames: over 99.9% of the pixels equal (the track band is a threshold on
  a bilinear upsample, ``F.interpolate`` against ``jax.image.resize``;
  measured all equal);
* the reference's "car" golden fingerprint: the reward total within 1e-3
  (the reference's tolerance) and the final ground truth within 5e-5 (the
  reference holds 2e-5 against 5-digit constants; 50 steps from a heading
  3 ulps off move the car by 3 ulps of its 110-unit coordinates).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs import car_racing as jc
from srl_tpu_torch import bridge
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs import car_racing as tc
from tests.test_golden_trajectories import GOLDEN

torch.set_num_threads(1)

N = 8


def jax_reset_noise(keys) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in _reset_draws()(keys).items()}


@functools.lru_cache(maxsize=None)
def _reset_draws():
    def one(key):
        _, k_track = jax.random.split(key)
        k_angle, k_rad = jax.random.split(k_track)
        return {"angle_u": jax.random.uniform(k_angle, (12,), minval=0.0,
                                              maxval=2 * jnp.pi / 12),
                "rad_u": jax.random.uniform(k_rad, (12,), minval=jc.TRACK_RAD / 3,
                                            maxval=jc.TRACK_RAD)}

    return jax.jit(jax.vmap(one))


def to_port_state(jstate):
    return bridge.car_racing_state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)})


def make_pair(**kwargs):
    return jc.CarRacingEnv(**kwargs), tc.CarRacingEnv(**kwargs)


@functools.lru_cache(maxsize=None)
def jit_step(jenv):
    return jax.jit(jax.vmap(jenv.step))


def reset_pair(jenv, seed, n=N):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.jit(jax.vmap(jenv.reset))(keys), keys


def test_track_from_the_drawn_values():
    jenv, tenv = make_pair(srl_model="ground_truth")
    jstate, keys = reset_pair(jenv, 0, 32)
    tstate = tenv.apply_reset(jax_reset_noise(keys))
    np.testing.assert_allclose(tstate.track.numpy(), np.asarray(jstate.track), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tstate.yaw.numpy(), np.asarray(jstate.yaw), atol=1e-5, rtol=0)
    ref = to_port_state(jstate)
    for f in ("pos", "vel", "yaw_rate", "wheel_angle", "visited", "total_reward",
              "step_count", "terminated"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), getattr(ref, f).numpy(),
                                   atol=1e-4, rtol=0, err_msg=f)
    track = tstate.track.numpy()
    gaps = np.linalg.norm(np.roll(track, -1, 1) - track, axis=-1)
    assert track.shape == (32, tc.N_TILES, 2) and gaps.max() < 6.0
    assert np.abs(track).max() < tc.PLAYFIELD * 0.9


def assert_step_matches(tenv, tstate, a, jenv, jstate):
    """One step from the same state on both sides; returns the new states."""
    jstate, jr, jd = jit_step(jenv)(jstate, jnp.asarray(a))
    tstate, tr, td = tenv.apply_step(tstate, torch.as_tensor(a), {})
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-8 if tenv.shape_reward else 0)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ref = to_port_state(jstate)
    np.testing.assert_array_equal(tstate.visited.numpy(), ref.visited.numpy())
    for f, tol in (("pos", 1e-5), ("vel", 1e-5), ("yaw", 1e-6), ("yaw_rate", 1e-6),
                   ("wheel_angle", 1e-6)):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), getattr(ref, f).numpy(),
                                   atol=tol, rtol=0, err_msg=f)
    return tr, td, jstate


@pytest.mark.parametrize("kwargs", [dict(), dict(is_discrete=False), dict(shape_reward=True)])
def test_one_step_parity_over_a_batch(kwargs):
    """80 steps; each port step starts from the reference's state (crossed
    through the bridge), so the roundings do not accumulate."""
    jenv, tenv = make_pair(srl_model="ground_truth", **kwargs)
    jstate, _ = reset_pair(jenv, 1)
    rng = np.random.default_rng(0)
    total = 0.0
    for t in range(80):
        if tenv.is_discrete:
            a = rng.integers(0, 4, N).astype(np.int32)
            a[:4] = 2  # full throttle
        else:
            a = rng.uniform([-1, 0, 0], [1, 1, 1], (N, 3)).astype(np.float32)
            a[:4] = [0.0, 1.0, 0.0]
        tr, _, jstate = assert_step_matches(tenv, to_port_state(jstate), a, jenv, jstate)
        total += float(tr[:4].sum())
        for fn in ("ground_truth", "target_pos"):
            np.testing.assert_allclose(getattr(tenv, fn)(to_port_state(jstate)).numpy(),
                                       np.asarray(jax.vmap(getattr(jenv, fn))(jstate)),
                                       atol=1e-5, rtol=0, err_msg=fn)
    if not tenv.shape_reward:
        assert total > 0  # tiles were visited


def test_tile_reward_totals_1000():
    """The car teleported over every tile in turn: 1000 in tile rewards,
    each step's reward equal to the reference's."""
    jenv, tenv = make_pair(srl_model="ground_truth")
    jstate, _ = reset_pair(jenv, 2, 1)
    tstate = to_port_state(jstate)
    track = tstate.track.numpy()[0]
    tile_total = 0.0
    for i in range(tc.N_TILES):
        tstate = dataclasses.replace(tstate, pos=torch.as_tensor(track[i])[None])
        jstate = jstate.replace(pos=jnp.asarray(track[i])[None])
        tr, td, jstate = assert_step_matches(tenv, tstate, np.array([3], np.int32), jenv,
                                             jstate)
        tstate = to_port_state(jstate)
        tile_total += float(tr[0]) + 0.1
        if bool(td[0]):
            break
    np.testing.assert_allclose(tile_total, tc.TILE_REWARD_TOTAL, atol=1e-3)
    assert bool(tstate.visited.all()) and bool(td[0])


def test_out_of_field_penalty_and_off_track_step():
    jenv, tenv = make_pair(srl_model="ground_truth")
    jstate, _ = reset_pair(jenv, 3, 2)
    pos = np.array([[tc.PLAYFIELD + 10.0, 0.0], [tc.PLAYFIELD * 0.95, tc.PLAYFIELD * 0.95]],
                   np.float32)
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.zeros((2, 2)))
    tr, td, _ = assert_step_matches(tenv, to_port_state(jstate), np.array([3, 3], np.int32),
                                    jenv, jstate)
    assert float(tr[0]) == -100.0 and bool(td[0])
    np.testing.assert_allclose(float(tr[1]), -0.1, atol=1e-6)
    assert not bool(td[1])


def test_render_agreement():
    jenv, tenv = make_pair(srl_model="raw_pixels")
    jstate, _ = reset_pair(jenv, 4)
    step = jit_step(jenv)
    rng = np.random.default_rng(1)
    for t in range(30):
        jstate, _, _ = step(jstate, jnp.asarray(rng.integers(0, 4, N).astype(np.int32)))
    ref = np.asarray(jax.jit(jax.vmap(jenv.render_pixels))(jstate))
    out = tenv.observe(to_port_state(jstate)).numpy()
    assert out.shape == (N, 224, 224, 3) and out.dtype == np.uint8
    assert (out == ref).all(-1).mean() > 0.999
    grey = (np.abs(out[..., 0].astype(int) - 102) < 15) & (np.abs(out[..., 1].astype(int) - 102) < 15)
    assert grey.sum() > 500 * N


def test_pixel_vecenv_resets_as_the_reference():
    jenv, tenv = make_pair(srl_model="raw_pixels")
    key = jax.random.PRNGKey(5)
    _, jobs = jax.jit(JaxVecEnv(jenv, 2).reset)(key)
    _, sub = jax.random.split(key)
    _, obs = VecEnv(tenv, 2).reset(None, noise=jax_reset_noise(jax.random.split(sub, 2)))
    assert (obs.numpy() == np.asarray(jobs)).all(-1).mean() > 0.999


def test_golden_fingerprint():
    """tests/test_golden_trajectories.py's "car" pin, the port fed the
    reference's draws and actions."""
    tenv = tc.CarRacingEnv(srl_model="ground_truth")
    vec = VecEnv(tenv, 4)
    _, sub = jax.random.split(jax.random.PRNGKey(42))
    vstate, _ = vec.reset(None, noise=jax_reset_noise(jax.random.split(sub, 4)))
    k = jax.random.PRNGKey(7)
    rews = []
    for _ in range(50):
        k, sub = jax.random.split(k)
        a = np.array(jax.random.randint(sub, (4,), 0, 4))
        vstate, tr = vec.step(vstate, torch.from_numpy(a), step_noise={})
        rews.append(tr.reward.numpy())
    want_rew, want_gt = GOLDEN["car"]
    assert abs(float(np.sum(rews)) - want_rew) < 1e-3
    gt = tenv.ground_truth(vstate.env_state).numpy().ravel()[:8].astype(np.float64)
    np.testing.assert_allclose(gt, want_gt, atol=5e-5)


def test_spaces_and_noise_draws():
    env = tc.CarRacingEnv()
    assert env.observation_space.shape == (224, 224, 3) and env.action_space.n == 4
    assert tc.CarRacingEnv(srl_model="ground_truth").observation_space.shape == (5,)
    assert tc.CarRacingEnv(is_discrete=False).action_space.shape == (3,)
    noise = env.draw_reset_noise(torch.Generator().manual_seed(0), 64)
    a, r = noise["angle_u"].numpy(), noise["rad_u"].numpy()
    assert a.shape == r.shape == (64, 12)
    assert (a >= 0).all() and (a < 2 * np.pi / 12).all()
    assert (r >= tc.TRACK_RAD / 3).all() and (r <= tc.TRACK_RAD).all()

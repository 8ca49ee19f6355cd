"""srl_tpu_torch.core.frame_stack against srl_tpu.core.frame_stack on the CPU.

Both stack MobileRobot observations under their VecEnv with auto-reset, fed
the same reset and step draws (tests/test_torch_mobile_robot.py): the
stacked observations are bit-equal, vector and pixel alike, through
auto-resets, which restart a stack from zero frames with the last slot set
to the new episode's first observation. The stacked channel ``c * k + j``
is frame ``j``'s channel ``c`` (interleaved, as the reference orders it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.core.frame_stack import FrameStack as JFrameStack
from srl_tpu.envs import mobile_robot as jm
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.envs import mobile_robot as tm

from .test_torch_mobile_robot import jax_reset_noise, jax_step_noise

torch.set_num_threads(1)


def run_both(kwargs, k, n, n_steps, seed):
    """Step reference and port stacks side by side; yields (t, port
    transition, reference transition, port vstate)."""
    jenv = JFrameStack(jm.MobileRobotEnv(**kwargs), k)
    tenv = FrameStack(tm.MobileRobotEnv(**kwargs), k)
    jvec, tvec = JaxVecEnv(jenv, n), VecEnv(tenv, n)
    key = jax.random.PRNGKey(seed)
    jv, jobs = jax.jit(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv.env, jax.random.split(sub, n)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    step = jax.jit(jvec.step)
    acts = np.random.default_rng(seed).integers(0, 4, (n_steps, n)).astype(np.int32)
    for t in range(n_steps):
        step_noise = jax_step_noise(jenv.env, jv.env_state.inner.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv.env, jax.random.split(sub, n))
        jv, jtr = step(jv, jnp.asarray(acts[t]))
        tv, ttr = tvec.step(tv, torch.from_numpy(acts[t]), step_noise=step_noise,
                            reset_noise=reset_noise)
        yield t, ttr, jtr, tv, jv


def test_vector_stack_matches_through_an_auto_reset():
    n_done = 0
    for t, ttr, jtr, tv, jv in run_both(dict(srl_model="ground_truth"), 4, 8, 260, 1):
        np.testing.assert_array_equal(ttr.obs.numpy(), np.asarray(jtr.obs), err_msg=str(t))
        np.testing.assert_array_equal(ttr.reward.numpy(), np.asarray(jtr.reward))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_array_equal(tv.env_state.frames.numpy(),
                                      np.asarray(jv.env_state.frames))
        n_done += int(ttr.done.sum())
    assert ttr.obs.shape == (8, 8) and n_done >= 8


def test_pixel_stack_matches_and_interleaves_channels():
    kwargs = dict(srl_model="raw_pixels", render_shape=(16, 24), max_steps=5,
                  random_target=True)
    k = 3
    for t, ttr, jtr, tv, _ in run_both(kwargs, k, 4, 14, 2):
        obs = ttr.obs.numpy()
        np.testing.assert_array_equal(obs, np.asarray(jtr.obs), err_msg=str(t))
        frames = tv.env_state.frames.numpy()  # [N, k, H, W, 3]
        for c in range(3):
            for j in range(k):
                np.testing.assert_array_equal(obs[..., c * k + j], frames[:, j, ..., c])
        done = ttr.done.numpy()
        if done.any():  # a fresh stack: zeros, then the first observation
            assert (frames[done, :-1] == 0).all() and frames[done, -1].any()
    assert obs.shape == (4, 16, 24, 9) and obs.dtype == np.uint8


def test_observation_space_matches():
    for kwargs in (dict(srl_model="ground_truth"),
                   dict(srl_model="raw_pixels", fpv=True)):
        js = JFrameStack(jm.MobileRobotEnv(**kwargs), 4).observation_space
        ts = FrameStack(tm.MobileRobotEnv(**kwargs), 4).observation_space
        assert ts.shape == js.shape and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)

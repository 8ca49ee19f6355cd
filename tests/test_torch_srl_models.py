"""srl_tpu_torch.srl.models against srl_tpu.srl.models on the CPU: the two
packages read each other's checkpoints, and ``SRLEncodedEnv`` serves the
same states.

Tolerances: encoder states within 1e-2 of their largest magnitude (bf16
convs, tests/test_torch_srl_nets.py); the PCA projection to 1e-5
relative (float32 matmul); rewards, dones and episode statistics of the
encoded MobileRobot VecEnv bit-equal (the env and the compositor are
exact, tests/test_torch_mobile_robot.py). MobileRobot batches are of 8
(XLA's loop-shape rounding, ROADMAP Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.srl import models as jmodels
from srl_tpu.srl.trainer import SRLTrainer as JTrainer
from srl_tpu.srl.trainer import fit_pca as jfit_pca
from srl_tpu.srl.trainer import save_pca as jsave_pca
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv as TMobile
from srl_tpu_torch.srl import models as tmodels
from srl_tpu_torch.srl import trainer as ttrainer
from tests.test_torch_mobile_robot import jax_reset_noise, jax_step_noise

torch.set_num_threads(1)

N = 8
TOL = 1e-2


def assert_close_to_scale(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * max(np.abs(ref).max(), 1e-6)


def frames(n, hw, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + hw + (c,)).astype(np.uint8)


def reference_checkpoint(tmp_path, hw, losses=("autoencoder",), state_dim=4):
    """The reference trainer's initial encoder, saved by its ``save``."""
    trainer = JTrainer(state_dim=state_dim, losses=list(losses), obs_shape=hw + (3,))
    data = {"observations": frames(4, hw), "actions": np.zeros(4, np.int32),
            "rewards": np.zeros(4, np.float32), "episode_starts": np.arange(4) == 0,
            "ground_truth_states": np.zeros((4, 2), np.float32)}
    trainer.fit(data, epochs=0)
    return trainer.save(str(tmp_path / "reference"))


@pytest.fixture(scope="module")
def ref_ckpt_48(tmp_path_factory):
    return reference_checkpoint(tmp_path_factory.mktemp("srl48"), (48, 48))


def test_port_loads_reference_checkpoint(ref_ckpt_48):
    ref = jmodels.loadSRLModel(ref_ckpt_48)
    port = tmodels.loadSRLModel(ref_ckpt_48, device="cpu")
    assert isinstance(port, tmodels.SRLNeuralNetwork) and port.state_dim == 4
    obs = frames(4, (48, 48), seed=1)
    assert_close_to_scale(port.getState(obs), ref.getState(obs))
    single = port.getState(obs[0])
    assert single.shape == (4,)
    assert_close_to_scale(single, ref.getState(obs[0]))
    # A 6-channel observation is read through its first view.
    six = np.concatenate([obs, frames(4, (48, 48), seed=2)], -1)
    assert_close_to_scale(port.getStates(six), ref.getStates(six))
    assert not port.getState(obs).requires_grad


@pytest.mark.parametrize("losses", [("autoencoder",), ("vae", "inverse")])
def test_reference_loads_port_checkpoint(tmp_path, losses):
    trainer = ttrainer.SRLTrainer(state_dim=5, losses=list(losses), obs_shape=(32, 32, 3),
                                  device="cpu")
    path = trainer.save(str(tmp_path / "port"))
    ref = jmodels.loadSRLModel(path)
    assert ref.state_dim == 5 and tuple(ref.losses) == losses
    obs = frames(3, (32, 32), seed=3)
    assert_close_to_scale(trainer.encode(obs), ref.getState(obs))
    port = tmodels.loadSRLModel(path, device="cpu")
    np.testing.assert_array_equal(port.getState(obs).numpy(), trainer.encode(obs))


def test_pca_checkpoints_load_both_ways(tmp_path):
    obs = frames(12, (8, 8), seed=4)
    ref_path = jsave_pca(jfit_pca(obs, 3), str(tmp_path / "ref" / "pca"))
    port_path = ttrainer.save_pca(ttrainer.fit_pca(obs, 3, device="cpu"),
                                  str(tmp_path / "port" / "pca"))
    for path in (ref_path, port_path):
        ref = jmodels.loadSRLModel(path)
        port = tmodels.loadSRLModel(path, device="cpu")
        assert isinstance(port, tmodels.SRLPCA) and port.state_dim == 3
        np.testing.assert_allclose(port.getState(obs).numpy(), np.asarray(ref.getState(obs)),
                                   rtol=1e-5, atol=1e-5)
        assert port.getState(obs[0]).shape == (3,)


def test_get_srl_dim(ref_ckpt_48):
    assert tmodels.getSRLDim(ref_ckpt_48) == jmodels.getSRLDim(ref_ckpt_48) == 4
    assert tmodels.getSRLDim(env=TKuka()) == jmodels.getSRLDim(env=JKuka()) == 3


def test_encoded_mobile_robot_vecenv_matches_reference(ref_ckpt_48):
    kwargs = dict(srl_model="raw_pixels", render_shape=(48, 48), random_target=True,
                  max_steps=5)
    jenv, tenv = JMobile(**kwargs), TMobile(**kwargs)
    jwrapped = jmodels.SRLEncodedEnv(jenv, jmodels.loadSRLModel(ref_ckpt_48))
    twrapped = tmodels.SRLEncodedEnv(tenv, tmodels.loadSRLModel(ref_ckpt_48, device="cpu"))
    jvec, tvec = JaxVecEnv(jwrapped, N), VecEnv(twrapped, N)

    key = jax.random.PRNGKey(0)
    jv, jobs = jax.jit(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, N)))
    assert tobs.shape == (N, 4) and tobs.dtype == torch.float32
    assert_close_to_scale(tobs, jobs)
    step = jax.jit(jvec.step)
    rng = np.random.RandomState(5)
    resets = 0
    for _ in range(8):  # one auto-reset, at step 6
        action = jnp.asarray(rng.randint(0, 4, N), jnp.int32)
        step_noise = jax_step_noise(jenv, jv.env_state.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, action)
        tv, ttr = tvec.step(tv, torch.from_numpy(np.array(action)), step_noise=step_noise,
                            reset_noise=reset_noise)
        assert_close_to_scale(ttr.obs, jtr.obs)
        for name in ("reward", "done", "episode_length"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)), err_msg=name)
        resets += int(ttr.done.sum())
    assert resets == N


def test_encoded_kuka_observation_is_the_reference_encoder_of_its_pixels(tmp_path):
    """render -> encode on Kuka at 224x224 (traced at 32x32, render scale 7),
    against the reference's encoder on the same pixels; and VecEnv's
    observations are the encoder's states, never raw pixels."""
    path = reference_checkpoint(tmp_path, (224, 224), state_dim=3)
    env = TKuka(srl_model="raw_pixels", render_scale=7)
    wrapped = tmodels.SRLEncodedEnv(env, tmodels.loadSRLModel(path, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    states = env.reset(gen, 2)
    pixels = env.render_pixels(states)
    assert pixels.shape == (2, 224, 224, 3)
    assert_close_to_scale(wrapped.observe(states),
                          jmodels.loadSRLModel(path).getState(pixels.numpy()))

    vec = VecEnv(wrapped, 3)
    vstate, obs = vec.reset(gen)
    assert obs.shape == (3, 3)
    _, tr = vec.step(vstate, torch.zeros(3, dtype=torch.int64), gen)
    assert tr.obs.shape == (3, 3) and torch.isfinite(tr.obs).all()


class _MixedFamily:
    is_mixed_family = True


def test_encoded_env_surface(ref_ckpt_48):
    env = TMobile(srl_model="raw_pixels", render_shape=(48, 48))
    model = tmodels.loadSRLModel(ref_ckpt_48, device="cpu")
    wrapped = tmodels.SRLEncodedEnv(env, model)
    assert wrapped.observation_space.shape == (4,)
    assert wrapped.srl_model == "srl_encoded" and wrapped.is_mixed_family is False
    # Everything but observations comes from the wrapped env ...
    assert wrapped.render_shape == (48, 48) and wrapped.ground_truth_dim_() == 2
    assert wrapped.action_space == env.action_space
    # ... and nothing named observe* is forwarded: the encoder is never skipped.
    assert getattr(wrapped, "observe_batched", None) is None
    env.observe_batched = lambda states: pytest.fail("raw observation forwarded")
    assert getattr(wrapped, "observe_batched", None) is None
    vec = VecEnv(wrapped, 4)
    _, obs = vec.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (4, 4)
    # PPO2 normalizes encoded observations, as the reference does.
    assert PPO2(env=wrapped, num_envs=4, device="cpu").normalize_obs is True
    with pytest.raises(ValueError, match="cannot wrap a MixedEnv"):
        tmodels.SRLEncodedEnv(_MixedFamily(), model)
    with pytest.raises(ValueError, match="No path"):
        tmodels.loadSRLModel(None, device="cpu")

"""srl_tpu_torch.core.mixed_env against srl_tpu.core.mixed_env on the CPU,
mirroring tests/test_mixed_env.py: the facade, the action tables, the
alignment arithmetic, ``VecEnv``'s dispatch, and ``MixedVecEnv``'s
transitions against the reference's on the same fed noise.

The mixed batch is Kuka at render scale 2 (traced at 112x112, upsampled to
224x224) and Omnirobot (224x224), 2 envs each. The reference's VecEnv
renders Kuka with XLA on the CPU, the port with its twin of the Pallas
kernel, so Kuka frames meet slice 1's agreement metric (over 99.5% of the
values equal, under 0.5% off by more than 2); Omnirobot frames, every
reward, done and episode statistic are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srl_tpu.core import mixed_env as jmixed
from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.envs.omnirobot import OmniRobotEnv as JOmni
from srl_tpu.envs.registry import registered_env as jregistered
from srl_tpu_torch import bridge
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.mixed_env import MixedEnv, MixedVecEnv, default_align
from srl_tpu_torch.envs import KukaButtonEnv, MobileRobotEnv, OmniRobotEnv
from srl_tpu_torch.envs.registry import PlottingType, make_env, registered_env
from tests import test_torch_kuka_env as kuka_noise
from tests import test_torch_omnirobot as omni_noise
from tests.test_torch_slice import assert_frames_agree

torch.set_num_threads(1)


def mixed_pixels(oob_action="modulo", render_scale=2):
    return MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=render_scale),
                     OmniRobotEnv(srl_model="raw_pixels")], oob_action=oob_action)


def test_registry_holds_the_reference_entries():
    """Every id maps to (class, PlottingType) with the reference's plotting
    type, Omnirobot and CarRacing included."""
    assert set(registered_env.keys()) == set(jregistered.keys())
    for env_id in registered_env.keys():
        cls, plot = registered_env[env_id]
        assert cls.name == env_id and isinstance(plot, PlottingType)
        assert plot.name == jregistered[env_id][1].name
    assert isinstance(make_env("OmnirobotEnv-v0"), OmniRobotEnv)
    with pytest.raises(KeyError, match="CarRacingGymEnv-v0"):
        make_env("NoSuchEnv-v0")


def test_mixed_env_facade():
    env = mixed_pixels()
    assert env.observation_space.shape == (224, 224, 3) and env.action_space.n == 6
    assert env.srl_model == "raw_pixels" and env.is_discrete and env.max_steps == 1000
    assert env._tables[0] is None
    np.testing.assert_array_equal(env._tables[1], [0, 1, 2, 3, 0, 1])
    assert env.split_counts(8) == [4, 4]
    assert env.split_counts(12, align=4) == [8, 4]


@pytest.mark.parametrize("choice", ["modulo", "clip", "tables"])
def test_action_tables_match_the_reference(choice):
    kwargs = ({"action_tables": [None, [0, 1, 2, 3, 2, 3]]} if choice == "tables"
              else {"oob_action": choice})
    port = MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=2),
                     OmniRobotEnv(srl_model="raw_pixels")], **kwargs)
    ref = jmixed.MixedEnv([JKuka(srl_model="raw_pixels", render_scale=2),
                           JOmni(srl_model="raw_pixels")], **kwargs)
    assert port._tables[0] is None and ref._tables[0] is None
    np.testing.assert_array_equal(port._tables[1], ref._tables[1])
    if choice == "clip":
        assert port._tables[1].tolist() == [0, 1, 2, 3, 3, 3]


def test_differing_action_counts_require_an_explicit_choice():
    with pytest.raises(ValueError, match="differing discrete action"):
        mixed_pixels(oob_action="raise")
    with pytest.raises(ValueError, match="shared obs space"):
        MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=2, coarse_obs=True),
                  OmniRobotEnv(srl_model="raw_pixels")], oob_action="modulo")
    with pytest.raises(ValueError, match="action table"):
        MixedEnv([KukaButtonEnv(srl_model="raw_pixels"), OmniRobotEnv(srl_model="raw_pixels")],
                 action_tables=[None, [0, 1, 2, 3, 4, 5]])


@pytest.mark.parametrize("num_envs,n_families,n_devices", [
    (48, 2, 8), (48, 2, 1), (50, 2, 8), (16, 3, 8), (8, 16, 8), (12, 2, 4), (4, 2, 8)])
def test_alignment_arithmetic_matches_the_reference(num_envs, n_families, n_devices):
    align = default_align(num_envs, n_families, n_devices)
    assert align == jmixed.default_align(num_envs, n_families, n_devices)
    env = mixed_pixels()
    if n_families == 2 and num_envs >= 2 * align:
        counts = env.split_counts(num_envs, align)
        assert counts == jmixed.MixedEnv.split_counts(env, num_envs, align)
        assert all(c % align == 0 for c in counts) and sum(counts) == num_envs


def test_vecenv_dispatches_and_aligns():
    env = mixed_pixels()
    vec = VecEnv(env, 4)
    assert isinstance(vec, MixedVecEnv) and vec.counts == [2, 2] and vec.align == 1
    # The port has no device mesh: one device, no alignment by default;
    # an explicit align keeps every shard of 6 inside one family.
    vec = VecEnv(env, 48, align=6)
    assert vec.counts == [24, 24]
    for d in range(8):
        lo, hi = d * 6, (d + 1) * 6
        assert any(vec._offsets[i] <= lo and hi <= vec._offsets[i + 1] for i in range(2))
    assert VecEnv(env, 48, align=12).counts == [24, 24]
    assert type(VecEnv(OmniRobotEnv(), 2)) is VecEnv
    with pytest.raises(TypeError, match="MixedEnv facade"):
        MixedVecEnv(OmniRobotEnv(), 2)


def family_reset_noise(families, keys):
    return [kuka_noise.jax_reset_noise(families[0], keys[0]),
            omni_noise.jax_reset_noise(families[1], keys[1])]


def test_mixed_vecenv_matches_the_reference():
    jfams = [JKuka(srl_model="raw_pixels", render_scale=2), JOmni(srl_model="raw_pixels")]
    jenv = jmixed.MixedEnv(jfams, oob_action="modulo")
    jvec = JaxVecEnv(jenv, 4)
    assert isinstance(jvec, jmixed.MixedVecEnv) and jvec.counts == [2, 2]
    tvec = VecEnv(mixed_pixels(), 4)

    key = jax.random.PRNGKey(0)
    jv, jobs = kuka_noise.jit_reset(jvec.reset)(key)
    subs = [jax.random.split(jax.random.split(k)[1], 2)
            for k in jax.random.split(key, 2)]
    tv, tobs = tvec.reset(None, noise=family_reset_noise(jfams, subs))
    assert tobs.shape == (4, 224, 224, 3) and tobs.dtype == torch.uint8
    assert_frames_agree(tobs[:2], jobs[:2])
    np.testing.assert_array_equal(tobs[2:].numpy(), np.asarray(jobs[2:]))

    step = kuka_noise.jit_reset(jvec.step)
    actions = np.array([[0, 5, 1, 5], [2, 3, 4, 0], [5, 4, 3, 2], [1, 1, 5, 4]], np.int32)
    for t, a in enumerate(actions):
        step_noise = [kuka_noise.jax_step_noise(jfams[0], jv[0].env_state.key),
                      omni_noise.jax_step_noise(jfams[1], jv[1].env_state)]
        reset_noise = family_reset_noise(
            jfams, [jax.random.split(jax.random.split(v.key)[1], 2) for v in jv])
        jv, jtr = step(jv, jnp.asarray(a))
        tv, ttr = tvec.step(tv, torch.from_numpy(a), step_noise=step_noise,
                            reset_noise=reset_noise)
        for name in ("reward", "done", "episode_return", "episode_length"):
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)), err_msg=name)
        assert_frames_agree(ttr.obs[:2], jtr.obs[:2])
        np.testing.assert_array_equal(ttr.obs[2:].numpy(), np.asarray(jtr.obs[2:]))
        np.testing.assert_array_equal(tv[1].env_state.robot_pos.numpy(),
                                      np.asarray(jv[1].env_state.robot_pos))
        np.testing.assert_allclose(tv[0].env_state.q.numpy(), np.asarray(jv[0].env_state.q),
                                   atol=1e-4, rtol=0)
    assert isinstance(tv, tuple) and len(tv) == 2
    # The reference's mixed state crosses the bridge into the port's.
    fields = lambda st: {f.name: np.asarray(getattr(st, f.name))
                         for f in dataclasses.fields(st)}
    crossed = bridge.mixed_state_from_numpy(
        [{"env_state": fields(v.env_state), "ep_return": v.ep_return,
          "ep_length": v.ep_length} for v in jv],
        [bridge.kuka_state_from_numpy, bridge.omnirobot_state_from_numpy])
    for mine, theirs in zip(tv, crossed):
        np.testing.assert_array_equal(mine.ep_length.numpy(), theirs.ep_length.numpy())
        np.testing.assert_array_equal(mine.ep_return.numpy(), theirs.ep_return.numpy())
    np.testing.assert_array_equal(crossed[1].env_state.robot_pos.numpy(),
                                  tv[1].env_state.robot_pos.numpy())
    np.testing.assert_allclose(crossed[0].env_state.q.numpy(), tv[0].env_state.q.numpy(),
                               atol=1e-4, rtol=0)


def test_mixed_ground_truth_states_share_the_observation():
    env = MixedEnv([MobileRobotEnv(srl_model="ground_truth"),
                    OmniRobotEnv(srl_model="ground_truth")])
    assert env.observation_space.shape == (2,) and env._tables == [None, None]
    vec = VecEnv(env, 8)
    gen = torch.Generator().manual_seed(0)
    vstate, obs = vec.reset(gen)
    vstate, tr = vec.step(vstate, env.action_space.sample(gen, 8), gen)
    assert tr.obs.shape == (8, 2) and tr.reward.shape == (8,)


@pytest.fixture(scope="module")
def srl_config(tmp_path_factory):
    """An (untrained) autoencoder checkpoint for 224x224 frames, and an
    srl_models.yaml naming it for KukaButtonGymEnv-v0."""
    from srl_tpu_torch.srl.trainer import SRLTrainer

    root = tmp_path_factory.mktemp("srl")
    trainer = SRLTrainer(state_dim=2, losses=["autoencoder"], obs_shape=(224, 224, 3),
                         device="cpu")
    path = trainer.save(str(root / "ae"))
    config = root / "srl_models.yaml"
    config.write_text(f"KukaButtonGymEnv-v0:\n  log_folder: {root}/\n"
                      "  autoencoder: ae/srl_model.pkl\n")
    return path, str(config)


def test_srl_encoder_wraps_each_family(srl_config):
    """A learned SRL model over a mixed batch encodes every family:
    SRLEncodedEnv refuses the MixedEnv itself, and build_env wraps each
    family before building the MixedEnv."""
    from srl_tpu_torch.experiments import train
    from srl_tpu_torch.srl.models import SRLEncodedEnv, loadSRLModel

    path, config = srl_config
    with pytest.raises(ValueError, match="(?i)wrap each family"):
        SRLEncodedEnv(mixed_pixels(), loadSRLModel(path, device="cpu"))
    args = train.parse_args(["--env", "KukaButtonGymEnv-v0", "--mixed-envs",
                             "KukaButtonGymEnv-v0", "OmnirobotEnv-v0", "--srl-model",
                             "autoencoder", "--srl-config-file", config, "--render-scale",
                             "7", "--device", "cpu"])
    env = train.build_env(args, "cpu")
    assert env.is_mixed_family and all(isinstance(f, SRLEncodedEnv) for f in env.families)
    assert env.observation_space.shape == (2,) and env.srl_model == "srl_encoded"
    vec = VecEnv(env, 4)
    gen = torch.Generator().manual_seed(0)
    vstate, obs = vec.reset(gen)
    vstate, tr = vec.step(vstate, torch.tensor([0, 5, 4, 5]), gen)
    assert obs.shape == tr.obs.shape == (4, 2) and torch.isfinite(tr.obs).all()

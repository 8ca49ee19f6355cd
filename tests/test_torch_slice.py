"""The slice as a whole, port against reference on the CPU: PPO2 on
KukaButtonGymEnv-v0 from raw pixels at render_scale 2 with coarse
observations (112x112 traced frames, the upsample folded into conv1), the
Nature CNN, 4 envs, 8 steps.

Both sides start from the same state (the reference's reset, crossed through
the bridge) and the same parameters, and step with the actions the reference
sampled and the env noise it drew. The reference renders through its XLA
renderer on the CPU (srl_tpu/core/env.py:148-154 picks it), the port through
its twin of the Pallas kernel, so frames meet the render agreement of
tests/test_pallas_render.py (over 99.5% equal, under 0.5% off by more than
2). Rewards and dones are equal. The policy runs in bfloat16 on both sides:
values and log-probs agree within 2e-2 of their scale. One port update of
the reference's batch then gives finite losses within the same bfloat16
tolerance of the reference's update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from srl_tpu.agents import common as jcommon
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu_torch import bridge
from srl_tpu_torch.agents import ppo as tppo
from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka
from tests.test_torch_kuka_env import jax_reset_noise, jax_step_noise, jit_reset
from tests.test_torch_ppo import jax_update_epochs

torch.set_num_threads(1)

N, T = 4, 8
BF16_TOL = 2e-2


def assert_frames_agree(out: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    diff = np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32))
    assert (diff == 0).mean() > 0.995 and (diff > 2).mean() < 0.005


def assert_close_to_scale(out: torch.Tensor, ref):
    ref = np.asarray(ref)
    err = np.abs(out.detach().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_slice_matches_reference():
    kwargs = dict(srl_model="raw_pixels", render_scale=2, coarse_obs=True)
    jenv, tenv = JKuka(**kwargs), TKuka(**kwargs)
    jagent = JPPO2(env=jenv, num_envs=N)
    jagent._tx = jagent._make_optimizer(1)
    tagent = tppo.PPO2(env=tenv, num_envs=N, device="cpu")
    tagent.n_updates = 1
    jvec, tvec = JaxVecEnv(jenv, N), tagent.vec_env

    key = jax.random.PRNGKey(0)
    jv, jobs = jit_reset(jvec.reset)(key)
    _, sub = jax.random.split(key)
    tv, tobs = tvec.reset(None, noise=jax_reset_noise(jenv, jax.random.split(sub, N)))
    assert tobs.shape == (N, 112, 112, 3) and tobs.dtype == torch.uint8
    assert_frames_agree(tobs, jobs)

    params = jax.jit(jagent.policy.init)(jax.random.PRNGKey(1), jobs)
    tparams = bridge.flax_to_state_dict(jax.tree.map(np.asarray, params), "cnn")
    apply = jax.jit(jagent.policy.apply)
    step = jit_reset(jvec.step)
    steps = []
    for t in range(T):
        jd, jval = apply(params, jobs)
        action = jd.sample(jax.random.PRNGKey(100 + t))
        jlogp = jd.log_prob(action)
        with torch.no_grad():
            td, tval = tagent.apply(tparams, tobs)
        taction = torch.from_numpy(np.array(action))
        assert_close_to_scale(tval, jval)
        assert_close_to_scale(td.log_prob(taction), jlogp)
        steps.append((jobs, action, jlogp, jval))

        step_noise = jax_step_noise(jenv, jv.env_state.key)
        _, sub = jax.random.split(jv.key)
        reset_noise = jax_reset_noise(jenv, jax.random.split(sub, N))
        jv, jtr = step(jv, action)
        tv, ttr = tvec.step(tv, taction, step_noise=step_noise, reset_noise=reset_noise)
        np.testing.assert_array_equal(ttr.reward.numpy(), np.asarray(jtr.reward))
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        assert_frames_agree(ttr.obs, jtr.obs)
        steps[-1] += (jtr.reward, jtr.done)
        jobs, tobs = jtr.obs, ttr.obs

    # One update of the reference's batch on both sides, same permutations.
    obs, actions, logps, values, rewards, dones = (jnp.stack(x) for x in zip(*steps))
    _, last_value = apply(params, jobs)
    adv, ret = jcommon.compute_gae(rewards, values, dones, last_value, 0.99, 0.95)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    jdata = tuple(flat(x) for x in (obs, actions, logps, values, adv, ret))
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))
                      for k in jax.random.split(jax.random.PRNGKey(2), 4)])
    _, _, jmetrics = jax_update_epochs(jagent, params, jagent._tx.init(params), jdata,
                                       perms)
    tdata = tuple(torch.tensor(np.asarray(x)) for x in jdata)
    _, _, metrics = tagent.update_epochs(tparams, tppo.adam_init(tparams), tdata,
                                         torch.from_numpy(perms).long())
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # The policy-gradient terms are advantage-normalized (scale 1); the value
    # loss and the entropy are compared relative to their own size.
    assert abs(float(metrics["pg_loss"]) - float(jmetrics["pg_loss"])) <= BF16_TOL
    for k in ("vf_loss", "entropy"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= BF16_TOL * abs(
            float(jmetrics[k])), k

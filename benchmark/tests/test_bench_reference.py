"""The reference against the program at a tiny size on the CPU: the env
dynamics, auto-reset and renders bit for bit, the network within bfloat16's
rounding, GAE and Adam within float32's, the observation normalizer bit for
bit."""
import dataclasses

import pytest
import torch

import cell as driver
import manifest
from reference import ppo
from reference import vec_env as ref_env

CPU = torch.device("cpu")
SMALL = {"num_envs": 4, "n_steps": 8, "nminibatches": 2, "noptepochs": 2}


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("name", ["mobile224.ppo2.e256", "kuka112.ppo2.e1024"])
def test_env_and_render_match_the_program(name):
    cell = manifest.load_cell(name)
    agent = driver.build(cell, CPU, SMALL)
    vec, env = agent.vec_env, agent.vec_env.env
    ref = ref_env.make_env(cell.config["env_id"], cell.config["env_options"])
    # Short episodes, so that the auto-reset runs.
    env.max_steps = ref.max_steps = 6
    env_id = cell.config["env_id"]
    gen = torch.Generator()
    gen.manual_seed(7)
    noise = env.draw_reset_noise(gen, 4)
    vstate, obs = vec.reset(gen, noise)
    for k, v in _fields(ref.apply_reset(noise)).items():
        assert torch.equal(v, getattr(vstate.env_state, k)), k
    resets = 0
    for _ in range(16):
        action = torch.randint(0, cell.config["n_actions"], (4,), generator=gen)
        step_noise, reset_noise = env.draw_step_noise(gen, 4), env.draw_reset_noise(gen, 4)
        before = vstate
        vstate, tr = vec.step(vstate, action, step_noise=step_noise, reset_noise=reset_noise)
        new, r, d, ret, length = ref_env.step(
            ref, ref_env.state_of(env_id, _fields(before.env_state)), before.ep_return,
            before.ep_length, action, step_noise, reset_noise)
        for k, v in _fields(new).items():
            assert torch.equal(v, getattr(vstate.env_state, k)), k
        assert torch.equal(r, tr.reward) and torch.equal(d, tr.done)
        assert torch.equal(ret, vstate.ep_return) and torch.equal(length, vstate.ep_length)
        assert torch.equal(tr.obs, ref.observe(new))
        resets += int(d.sum())
    assert resets > 0


@pytest.mark.parametrize("name", ["mobile224.ppo2.e256", "kuka112.ppo2.e1024"])
def test_network_matches_the_programs_bfloat16_policy(name):
    cell = manifest.load_cell(name)
    agent = driver.build(cell, CPU, SMALL)
    params = driver.weights(cell, agent, 3, CPU)
    gen = torch.Generator()
    gen.manual_seed(3)
    frames = agent.vec_env.reset(gen)[1]
    dist, value = agent.apply(params, frames)
    logits, ref_value = cell.network.forward(params, frames, cell.config)
    # bfloat16 keeps 8 significant bits: each fc512 feature is off by a few
    # parts in a thousand, and a head sums 512 of them with weights of about
    # 1/sqrt(512), so its output is off by about 0.005 whatever its size.
    assert torch.allclose(dist.logits, logits, atol=0.01)
    assert torch.allclose(value, ref_value, atol=0.01)
    fp8, _ = cell.network.forward(params, frames, cell.config, "fp8")
    assert (fp8 - logits).abs().max() > (dist.logits - logits).abs().max()


def test_gae_and_adam_match_the_program():
    from srl_tpu_torch.agents.common import compute_gae
    from srl_tpu_torch.core.optim import adam_init, adam_update_

    gen = torch.Generator()
    gen.manual_seed(5)
    r, v = torch.randn(16, 8, generator=gen), torch.randn(16, 8, generator=gen)
    d = torch.rand(16, 8, generator=gen) < 0.1
    last = torch.randn(8, generator=gen)
    adv, ret = compute_gae(r, v, d, last, 0.99, 0.95)
    ref_adv, ref_ret = ppo.gae(r, v, d, last, 0.99, 0.95)
    assert torch.allclose(adv, ref_adv, atol=1e-5) and torch.allclose(ret, ref_ret, atol=1e-5)
    params = {"w": torch.randn(5, 3, generator=gen)}
    grads = {"w": torch.randn(5, 3, generator=gen)}
    state, ref_state = adam_init(params), {"count": 0, "mu": {"w": torch.zeros(5, 3)},
                                           "nu": {"w": torch.zeros(5, 3)}}
    prog = {"w": params["w"].clone()}
    ref = dict(params)
    for _ in range(3):
        adam_update_(prog, grads, state, 2.5e-4, 1e-5)
        ref = ppo.adam_step(ref, grads, ref_state, 2.5e-4, 1e-5)
    assert torch.allclose(prog["w"], ref["w"], atol=1e-7)


def test_normalizer_follows_the_program():
    from srl_tpu_torch.core.normalize import RunningNorm

    from reference import normalize

    gen = torch.Generator()
    gen.manual_seed(9)
    obs = torch.randn(9, 6, 3, generator=gen) * 4.0 + 1.5
    norm, want = RunningNorm.create((3,)), []
    for t in range(8):
        norm = norm.update(obs[t])
        want.append(norm.normalize(obs[t]))
    want.append(norm.normalize(obs[8]))
    # The same float32 operations in the same order, on the CPU.
    assert torch.equal(normalize.follow(obs), torch.stack(want))

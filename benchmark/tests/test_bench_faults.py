"""The comparison catches what it is there to catch, at a tiny size on the
CPU (the harness's look for a card skipped): the float8 control, and each
fault of ``faults.py`` planted under a whole run. Episodes are cut to
``MAX_STEPS`` on both sides, so that the updates after the window hold
episode ends."""
import pytest
import torch

import cell as driver
import faults
import judge
import manifest
import run
from reference import vec_env as ref_env

CPU = torch.device("cpu")
SMALL = {"num_envs": 4, "n_steps": 8, "nminibatches": 2, "noptepochs": 2}
MAX_STEPS = 12
# The number that each fault has to push over its limit.
CATCHES = {"frozen": "update_gap", "half_batch": "mb_logp_gap", "action": "action_gap",
           "frame": "frame_gap", "reward": "env_gap", "advantage": "gae_gap",
           "target": "frame_gap", "reset": "env_gap", "skip_minibatch": "schedule_gap",
           "one_epoch": "schedule_gap", "half_perm": "schedule_gap"}


def _run_with(name, fault, monkeypatch, seed=2147483659):
    cell = manifest.load_cell(name)
    build, make_env = driver.build, ref_env.make_env

    def short_env(*args):
        env = make_env(*args)
        env.max_steps = MAX_STEPS
        return env

    def broken_build(c, device, overrides=None):
        agent = build(c, device, overrides)
        agent.vec_env.env.max_steps = MAX_STEPS
        if fault:
            stack.append(faults.FAULTS[fault](agent))
            stack[-1].__enter__()
        return agent

    stack = []
    monkeypatch.setattr(driver, "build", broken_build)
    monkeypatch.setattr(ref_env, "make_env", short_env)
    try:
        return run.run_cell(cell, seed, 0.2, False, CPU, SMALL)
    finally:
        for ctx in stack:
            ctx.__exit__(None, None, None)


@pytest.mark.parametrize("name", ["mobile224.ppo2.e256", "kuka112.ppo2.e1024"])
def test_a_sound_run_is_correct_and_checks_episode_ends(name, monkeypatch):
    result = _run_with(name, None, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert result["readings"]["resets_checked"] > 0
    assert result["readings"]["schedule_gap"] == 0.0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    result = _run_with("mobile224.ppo2.e256", fault, monkeypatch)
    assert result["correct"] is False
    check = result["checks"][CATCHES[fault]]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("name", ["mobile224.ppo2.e256", "kuka112.ppo2.e1024"])
def test_the_float8_control_is_not_correct(name):
    cell = manifest.load_cell(name)
    agent = driver.build(cell, CPU, SMALL)
    seed = 4294967311
    params0 = driver.weights(cell, agent, seed, CPU)
    _, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"])
    values = judge.judge(rec, cell, params0, control=True)
    assert judge.verdict(values, cell.limits) is False

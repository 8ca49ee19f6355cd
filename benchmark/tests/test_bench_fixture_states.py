"""Another PPO2 network, added to a copy of the benchmark as new files and
entries only (``fixtures/mlp_states``): the toolbox's quickstart, PPO2
with the MLP policy on MobileRobot ground-truth states under PPO2's running
observation normalizer. The harness finds its reference, counts and limits
by name; a sound run is correct, and the float8 control and each fault the
cell can have are not."""
import pytest
import torch

import bench_copy
import cell as driver
import faults
import judge
import manifest
import run

CPU = torch.device("cpu")
CELL = "mobile_gt.ppo2.e4"
# The number that each fault has to push over its limit.
CATCHES = {"frozen": "update_gap", "action": "action_gap", "reward": "env_gap",
           "advantage": "gae_gap", "stale_norm": "logp_gap", "observation": "frame_gap"}


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return bench_copy.bench_copy(tmp_path_factory.mktemp("bench"), "mlp_states")


def _run(repo, monkeypatch, fault=None, trace=False, seed=2147483659):
    cell = manifest.load_cell(CELL, repo)
    build, stack = driver.build, []

    def broken_build(c, device, overrides=None):
        agent = build(c, device, overrides)
        if fault:
            stack.append(faults.kinds(c, False)[fault](agent))
            stack[-1].__enter__()
        return agent

    monkeypatch.setattr(driver, "build", broken_build)
    try:
        return run.run_cell(cell, seed, 0.0, trace, CPU)
    finally:
        for ctx in stack:
            ctx.__exit__(None, None, None)


def test_the_network_is_found_by_name(repo, monkeypatch):
    cell = manifest.load_cell(CELL, repo)
    assert cell.network.__file__ == str(repo / "benchmark/reference/mlp.py")
    assert cell.handin is None and cell.network.FRAMES is False
    kinds = faults.kinds(cell, False)
    assert not set(kinds) & set(faults.FRAME_FAULTS)
    assert {"observation", "stale_norm"} <= set(kinds)
    monkeypatch.setattr(run, "BENCH", repo / "benchmark")
    assert run.reference_imports() == []


def test_a_sound_run_is_correct(repo, monkeypatch):
    result = _run(repo, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert result["readings"]["resets_checked"] > 0
    assert result["readings"]["schedule_gap"] == 0.0


def test_a_traced_run_counts_the_networks_flops(repo, monkeypatch):
    result = _run(repo, monkeypatch, trace=True, seed=4294967311)
    assert result["correct"] is True, result["checks"]
    cell = manifest.load_cell(CELL, repo)
    flops = manifest.counts("mlp", repo).update_flops(cell.config, cell.traffic)
    # 36 rollout forwards and 2 epochs of 32 rows, forward and backward, of
    # 2 * (2 * 64 + 64 * 64 + 64 * 5) FLOPs.
    assert flops == (36 + 2 * 32 * 3) * 2 * (2 * 64 + 64 * 64 + 64 * 5)
    assert result["metrics"]["train_mfu.mobile_gt"]["value"] > 0
    assert result["metrics"]["epochs_s.mobile_gt"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(CATCHES))
def test_a_fault_makes_the_run_incorrect(fault, repo, monkeypatch):
    result = _run(repo, monkeypatch, fault)
    assert result["correct"] is False
    check = result["checks"][CATCHES[fault]]
    assert check["value"] > check["limit"]


def test_the_float8_control_is_not_correct(repo):
    cell = manifest.load_cell(CELL, repo)
    agent = driver.build(cell, CPU)
    seed = 4294967311
    params0 = driver.weights(cell, agent, seed, CPU)
    _, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"])
    values = judge.judge(rec, cell, params0, control=True)
    assert judge.verdict(values, cell.limits) is False

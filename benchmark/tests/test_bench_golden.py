"""The Nature CNN cells' readings at a small size on the CPU, bit for bit
those that the harness gave before the network became a part of the
configuration (``golden_nature_cnn.json``, recorded from the parent commit
of that change): the yardstick did not move. Each run's window is one
update (``--seconds 0``), so the update after it, and its readings, are
the same on every run; episodes are cut to ``MAX_STEPS`` on both sides.
The values are those of PyTorch's CPU kernels at ``THREADS`` threads: a
machine whose kernels round otherwise (another instruction set, another
PyTorch) records them anew from that commit."""
import json
from pathlib import Path

import pytest
import torch

import cell as driver
import judge
import manifest
import run
from reference import vec_env as ref_env

CPU = torch.device("cpu")
SMALL = {"num_envs": 4, "n_steps": 8, "nminibatches": 2, "noptepochs": 2}
MAX_STEPS = 12
THREADS = 4
GOLDEN = json.loads(Path(__file__).with_name("golden_nature_cnn.json").read_text())
CELLS = ("mobile224.ppo2.e256", "kuka112.ppo2.e1024")


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _short(monkeypatch):
    build, make_env = driver.build, ref_env.make_env

    def short_env(*args):
        env = make_env(*args)
        env.max_steps = MAX_STEPS
        return env

    def short_build(c, device, overrides=None):
        agent = build(c, device, overrides)
        agent.vec_env.env.max_steps = MAX_STEPS
        return agent

    monkeypatch.setattr(driver, "build", short_build)
    monkeypatch.setattr(ref_env, "make_env", short_env)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", GOLDEN["seeds"])
def test_a_runs_readings_are_the_parents_bit_for_bit(name, seed, monkeypatch, threads):
    _short(monkeypatch)
    result = run.run_cell(manifest.load_cell(name), seed, 0.0, False, CPU, SMALL)
    assert result["correct"] is True
    assert result["readings"] == GOLDEN["readings"][f"{name}/{seed}"]


@pytest.mark.parametrize("name", CELLS)
def test_the_controls_readings_are_the_parents_bit_for_bit(name, threads):
    cell = manifest.load_cell(name)
    seed = GOLDEN["control_seed"]
    agent = driver.build(cell, CPU, SMALL)
    params0 = driver.weights(cell, agent, seed, CPU)
    _, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"])
    values = judge.judge(rec, cell, params0, control=True)
    assert values == GOLDEN["readings"][f"{name}/{seed}/control"]

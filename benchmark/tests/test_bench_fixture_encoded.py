"""A frozen stage served in the env step, added to a copy of the benchmark
as new files and entries only (``fixtures/pca_states``): MobileRobot
frames rendered by the program, encoded by the toolbox's PCA baseline (an
``SRLPCA`` in ``SRLEncodedEnv``, built by ``handin/pca_mlp.py`` from a
seeded mean and components), then PPO2's normalizer and the MLP policy.
The harness hands the frozen leaves to the program's env and judges only
the policy's as gradients; a sound run is correct, and a fault planted in
the frozen stage is caught by ``frame_gap``."""
import pytest
import torch

import bench_copy
import cell as driver
import judge
import manifest
import run
from patching import Patches

CPU = torch.device("cpu")
CELL = "mobile_pca.ppo2.e4"


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return bench_copy.bench_copy(tmp_path_factory.mktemp("bench"), "pca_states")


def scaled_components():
    """The program's PCA projects with its components scaled by 1.5."""
    from srl_tpu_torch.srl.models import SRLPCA

    def make(orig):
        def get_state(model, obs):
            components = model.components
            model.components = components * 1.5
            try:
                return orig(model, obs)
            finally:
                model.components = components
        return get_state
    return Patches().set(SRLPCA, "getState", make)


def test_the_frozen_leaves_reach_the_programs_env(repo):
    cell = manifest.load_cell(CELL, repo)
    agent = driver.build(cell, CPU)
    params0 = driver.weights(cell, agent, 2147483659, CPU)
    model = cell.handin.MODELS[agent.env]
    assert torch.equal(model.mean, params0["srl.mean"])
    assert torch.equal(model.components, params0["srl.components"])
    # The policy's leaves are the program's parameters; the PCA's are not.
    assert set(agent.policy.state_dict()) == {k for k in params0 if not k.startswith("srl.")}


def test_a_sound_traced_run_is_correct(repo):
    cell = manifest.load_cell(CELL, repo)
    result = run.run_cell(cell, 2147483659, 0.0, True, CPU)
    assert result["correct"] is True, result["checks"]
    assert result["readings"]["resets_checked"] > 0
    # The PCA of 32 frames of 224 x 224 x 3 to 3 states leads the update's
    # FLOPs (``counts/pca_mlp.py``).
    flops = manifest.counts("pca_mlp", repo).update_flops(cell.config, cell.traffic)
    assert flops > 32 * 2 * 224 * 224 * 3 * 3
    assert result["metrics"]["train_mfu.mobile_pca"]["value"] > 0


def test_a_fault_in_the_frozen_stage_fails_frame_gap(repo):
    with scaled_components():
        result = run.run_cell(manifest.load_cell(CELL, repo), 3100000000, 0.0, False, CPU)
    assert result["correct"] is False
    check = result["checks"]["frame_gap"]
    assert check["value"] > check["limit"]


def test_the_float8_control_is_not_correct(repo):
    cell = manifest.load_cell(CELL, repo)
    agent = driver.build(cell, CPU)
    seed = 4294967311
    params0 = driver.weights(cell, agent, seed, CPU)
    _, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"])
    values = judge.judge(rec, cell, params0, control=True)
    assert judge.verdict(values, cell.limits) is False

"""The run of a mesh cell (``ranks.py``): four gloo ranks on the CPU at a
small size, end to end through ``run.run_mesh`` (the rank script is
``rank_small.py``: short episodes, and a fault or a kill from the
environment), and the launcher's rules for a rank that ends or falls
silent."""
import json
import sys
import time
import types
from pathlib import Path

import pytest

import calibrate
import judge
import manifest
import ranks
import run

CELL = "kuka112.ppo2.dp4.e4096"
SMALL = {"num_envs": 16, "n_steps": 8, "nminibatches": 2, "noptepochs": 2}
OPTIONS = {"device": "cpu", "overrides": SMALL}
HELPER = str(Path(__file__).with_name("rank_small.py"))
# The number that each fault has to push over its limit on the mesh: the
# mesh's own, and those of step 3 of the rules that the cell can have.
CATCHES = {"no_allreduce": "grad_norm_gap", "drop_rank": "grad_norm_gap",
           "reward_last_rank": "env_gap", "frame_last_rank": "frame_gap",
           "frozen": "update_gap", "half_batch": "mb_logp_gap",
           "skip_minibatch": "schedule_gap"}


def _run(monkeypatch, seconds=0.2, trace=0, seed=2147483659, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cell = manifest.load_cell(CELL)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return run.run_mesh(cell, args, OPTIONS, HELPER)


def test_four_gloo_ranks_run_the_cell_and_print_one_result(monkeypatch, capsys):
    rc, result = _run(monkeypatch)
    assert rc == 0
    assert result["correct"] is True, result["checks"]
    assert result["readings"]["resets_checked"] > 0
    assert result["readings"]["schedule_gap"] == 0.0
    cell = manifest.load_cell(CELL)
    capsys.readouterr()
    assert run.emit(result, cell, False, "cpu", "unknown") == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["correct"] is True and line["device"]["count"] == 4
    assert set(line["metrics"]) == {"env_steps_per_s.dp4", "setup_s"}
    assert list(line)[-1] == "checks"


def test_a_traced_run_reads_the_mesh_of_every_rank(monkeypatch):
    rc, result = _run(monkeypatch, trace=1)
    assert rc == 0 and result["correct"] is True, result and result["checks"]
    metrics = result["metrics"]
    assert metrics["mesh_wait_s.dp4"]["value"] > 0
    # 16 envs, 8 steps: the gradient of 2 x 2 minibatches, one flag a step.
    assert metrics["mesh_bytes_per_update.dp4"]["value"] > 4 * 4 * 18_000_000
    assert metrics["rollout_s.dp4"]["value"] > 0
    # gloo runs no NCCL kernel: nothing to read.
    assert "collective_device_s.dp4" not in metrics


@pytest.mark.parametrize("fault", sorted(CATCHES))
def test_a_fault_on_the_mesh_makes_the_run_incorrect(fault, monkeypatch):
    rc, result = _run(monkeypatch, SMALL_RANK_FAULT=fault)
    assert rc == 0
    assert result["correct"] is False
    check = result["checks"][CATCHES[fault]]
    assert check["value"] > check["limit"]


def test_a_killed_rank_ends_the_run_with_no_result(monkeypatch):
    t0 = time.monotonic()
    rc, result = _run(monkeypatch, seconds=60, SMALL_RANK_KILL="3:3")
    assert rc != 0 and result is None
    assert time.monotonic() - t0 < ranks.COLLECTIVE_S


BLOCKED = """import argparse, sys, time
sys.path.insert(0, {bench!r})
import ranks
p = argparse.ArgumentParser()
ranks.add_rank_args(p)
args = p.parse_args()
comm = ranks.Ranks(args.store, args.rank, 2, timeout_s=3)
if args.rank == 1:
    time.sleep(600)
comm.barrier()
print(ranks.RESULT + ' {{}}', flush=True)
"""


def test_a_rank_blocked_before_a_collective_ends_the_run(tmp_path):
    # Rank 1 never reaches the barrier: rank 0's collective gives up after
    # its timeout and ends its rank, and the launcher stops rank 1.
    script = tmp_path / "blocked.py"
    script.write_text(BLOCKED.format(bench=str(manifest.BENCH_DIR)))
    t0 = time.monotonic()
    rc, result = ranks.launch(str(script), [], 2)
    assert rc != 0 and result is None
    assert time.monotonic() - t0 < 60


def test_the_float8_control_is_not_correct_over_four_ranks(capsys):
    assert calibrate.main(["--workload", CELL, "--control-seeds", "4294967311",
                           "--options", json.dumps(OPTIONS)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    control = [x for x in lines if x.get("kind") == "control"]
    assert len(control) == 1
    values = {k: control[0][k] for k in judge.NUMBERS}
    assert judge.verdict(values, manifest.load_cell(CELL).limits) is False

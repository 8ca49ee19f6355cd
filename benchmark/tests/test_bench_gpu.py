"""A short run of each cell on its cards (skips without them): ``python -m
pytest benchmark/tests -m gpu`` on a machine with the cards."""
import json
import subprocess
import sys

import pytest

import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mobile224.ppo2.e256", "kuka112.ppo2.e1024"])
def test_a_short_run_prints_a_correct_result(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "run.py"), "--workload", name,
                          "--seed", "2147483911", "--seconds", "2", "--trace", "0"],
                         cwd=manifest.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in manifest.load_cell(name).end_to_end}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"


@pytest.mark.gpu
def test_a_short_run_on_four_cards_prints_a_correct_result():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    name = "kuka112.ppo2.dp4.e4096"
    out = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "run.py"), "--workload", name,
                          "--seed", "2147483911", "--seconds", "2", "--trace", "1"],
                         cwd=manifest.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in manifest.load_cell(name).per_layer}
    assert line["device"]["count"] == 4 and line["breakdown"]["device_ops"]

"""The import guard: whole top-level names, and the reference's imports."""
import sys
import types

import run


def test_program_name_passes_and_jax_names_fail(monkeypatch):
    import srl_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    for name in ("jax", "jaxlib", "flax", "srl_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "srl_tpu.envs", types.ModuleType("srl_tpu.envs"))
    assert run.loaded_forbidden() == ["srl_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.loaded_forbidden() == ["jaxlib", "srl_tpu"]


def test_reference_imports_nothing_of_the_program_or_jax():
    assert run.reference_imports() == []


def test_reference_scan_catches_a_program_import(tmp_path, monkeypatch):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text(
        "import torch\nfrom srl_tpu_torch.ops import render2d\nimport jax.numpy as jnp\n")
    monkeypatch.setattr(run, "BENCH", tmp_path)
    assert run.reference_imports() == ["bad.py: srl_tpu_torch.ops", "bad.py: jax.numpy"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        return
    assert run.main(["--workload", "mobile224.ppo2.e256", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

"""The harness finds a cell, a configuration, a traffic mix, limits and a
per-layer metric by name, from files and entries alone."""
import json
import shutil
import types

import judge
import manifest


def test_every_cell_of_the_manifest_loads():
    bench = json.loads((manifest.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["env_id"]
        assert cell.traffic["num_envs"] % cell.traffic["dp"] == 0
        assert set(cell.limits) == set(judge.NUMBERS)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]).read)
            assert m["moves"] in names


def test_a_pending_cell_loads_from_its_cell_file():
    bench = json.loads((manifest.REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    pending = sorted(p.stem for p in (manifest.BENCH_DIR / "cells").glob("*.json")
                     if "pending" in json.loads(p.read_text()))
    assert pending == ["kuka112.ppo2.dp4.e4096"]
    for name in pending:
        assert name not in listed
        cell = manifest.load_cell(name)
        assert cell.chips == 4 and cell.traffic["dp"] == 4
        assert set(cell.limits) == set(judge.NUMBERS)
        names = {m["name"] for m in cell.end_to_end}
        assert names == {"env_steps_per_s.dp4", "setup_s"}
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]).read)
            assert m["moves"] in names and m["workloads"] == [name]
    # The cells of the manifest report none of a pending cell's metrics.
    for name in listed:
        assert not any(m["name"].endswith(".dp4") for m in manifest.load_cell(name).per_layer)


def test_new_config_cell_and_metric_from_files_alone(tmp_path):
    repo = tmp_path / "repo"
    shutil.copytree(manifest.BENCH_DIR, repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((manifest.REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((repo / "benchmark/configs/ppo2_cnn_mobile224.json").read_text())
    cfg["env_options"]["random_target"] = True
    (repo / "benchmark/configs/ppo2_cnn_mobile224_rt.json").write_text(json.dumps(cfg))
    (repo / "benchmark/traffic/ppo2.e64.json").write_text(json.dumps(
        {"num_envs": 64, "n_steps": 128, "nminibatches": 4, "noptepochs": 4, "dp": 1, "tp": 1}))
    limits = json.loads((repo / "benchmark/cells/mobile224.ppo2.e256.json").read_text())
    (repo / "benchmark/cells/mobile224rt.ppo2.e64.json").write_text(json.dumps(limits))
    (repo / "benchmark/metrics/updates_in_window.py").write_text(
        "def read(ctx):\n    return ctx.updates\n")
    bench["configs"].append({"name": "ppo2_cnn_mobile224_rt", "source": "x",
                             "file": "benchmark/configs/ppo2_cnn_mobile224_rt.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mobile224rt.ppo2.e64", "config": "ppo2_cnn_mobile224_rt",
                               "traffic": "ppo2.e64", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "updates_in_window", "unit": "updates",
                               "better": "higher", "source": "host_clock", "layer": "x",
                               "moves": "env_steps_per_s",
                               "workloads": ["mobile224rt.ppo2.e64"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("mobile224rt.ppo2.e64", repo)
    assert cell.config["env_options"]["random_target"] is True
    assert cell.traffic["num_envs"] == 64
    assert [m["name"] for m in cell.per_layer] == ["updates_in_window"]
    reader = manifest.metric_reader("updates_in_window", repo)
    assert reader.read(types.SimpleNamespace(updates=7)) == 7
    # The cells already there do not report the new metric.
    old = manifest.load_cell("mobile224.ppo2.e256", repo)
    assert "updates_in_window" not in [m["name"] for m in old.per_layer]


def test_new_networks_from_files_alone(tmp_path):
    # Two PPO2 networks besides the Nature CNN (the MLP on ground-truth
    # states; a frozen PCA in the env, then the MLP), each a configuration,
    # a traffic mix, a cell, readers, a reference, counts and a hand-in:
    # files and entries added, none of the benchmark's edited.
    import bench_copy

    repo = bench_copy.bench_copy(tmp_path, "mlp_states", "pca_states")
    for path in manifest.BENCH_DIR.rglob("*"):
        rel = path.relative_to(manifest.BENCH_DIR)
        if path.is_file() and rel.parts[0] != "tests" and "__pycache__" not in rel.parts:
            assert (repo / "benchmark" / rel).read_bytes() == path.read_bytes(), rel
    old = json.loads((manifest.REPO / "BENCHMARK.json").read_text())
    new = json.loads((repo / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[key][:len(old[key])] == old[key]
    for name, net, handin in (("mobile_gt.ppo2.e4", "mlp", False),
                              ("mobile_pca.ppo2.e4", "pca_mlp", True)):
        cell = manifest.load_cell(name, repo)
        assert cell.config["network"] == net
        assert cell.network.__file__ == str(repo / "benchmark" / "reference" / f"{net}.py")
        assert (cell.handin is not None) is handin
        shapes = cell.network.param_shapes(cell.config)
        assert [k for k in shapes if cell.network.trained(k)][-2:] == ["pi.weight", "pi.bias"]
        assert manifest.counts(net, repo).update_flops(cell.config, cell.traffic) > 0
        assert set(cell.limits) == set(judge.NUMBERS)
        assert {m["name"] for m in cell.end_to_end} == {f"env_steps_per_s.{name.split('.')[0]}",
                                                        "setup_s"}
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"], repo).read)
    # The Nature CNN cells are as they were.
    old_cell = manifest.load_cell("mobile224.ppo2.e256", repo)
    assert old_cell.config["network"] == "nature_cnn" and old_cell.handin is None

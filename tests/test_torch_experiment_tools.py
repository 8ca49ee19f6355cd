"""The port's learning-curve, aggregation, pipeline, hyperparameter-search
and live-curve tools against the reference's, on the CPU.

On the same monitor files the visualize helpers, ``aggregate_plots``'
``{method}.npz`` and ``gather_results``' ``results.csv`` are bit-equal to
the reference's, and the figures (``learning_curve.png``,
``aggregated_curves.png``, ``comparison.png``) are the same bytes: the same
matplotlib calls on the same numbers. Welch's p-values agree within 1e-12.
With a stub ``eval_fn``, Hyperband and TPE give the reference's trials and
best for the same seed (the same RandomState draws in the same order). The
pipeline trains its grid in process; ``validate_srl_models`` raises the
reference's exception wherever the reference raises. ``read_run_data``
equals the reference's, the live server serves the reference's page and
its ``data.json``, a busy port gives ``False``, and the training CLI
without ``--no-vis`` serves its curves and writes the PNG the reference
draws of the same run.
"""
import http.client
import json
import os
import shutil

import numpy as np
import pytest
import torch

from srl_tpu.experiments import hyperparam_search as jhp
from srl_tpu.experiments import live_vis as jlive
from srl_tpu.experiments import pipeline as jpipeline
from srl_tpu.experiments import visualize as jvis
from srl_tpu.replay import aggregate_plots as jagg
from srl_tpu.replay import compare_plots as jcmp
from srl_tpu.replay import gather_results as jgather
from srl_tpu.utils.monitor import load_results as jload_results
from srl_tpu_torch.experiments import hyperparam_search, live_vis, pipeline, train, visualize
from srl_tpu_torch.replay import aggregate_plots, compare_plots, gather_results, plots
from srl_tpu_torch.utils.monitor import MonitorWriter, load_results

torch.set_num_threads(1)


def write_run(run_dir, seed, n_files=1, n_episodes=60):
    """Monitor files of random episodes (rewards, lengths, wall times) and a
    metrics.jsonl line every 10 episodes."""
    rng = np.random.default_rng(seed)
    for rank in range(n_files):
        mon = MonitorWriter(run_dir, env_id="MobileRobotGymEnv-v0", rank=rank)
        for i in range(n_episodes):
            mon.write_episode(rng.normal(seed, 1.0), int(rng.integers(50, 251)),
                              t=float(i + rng.random()))
        mon.close()
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        for u in range(n_episodes // 10):
            f.write(json.dumps({"update": u, "num_timesteps": 1000 * (u + 1),
                                "mean_reward": float(rng.normal()), "fps": 123.4}) + "\n")
        f.write('{"update": 99, "num_t')  # a line being written


@pytest.fixture(scope="module")
def env_logs(tmp_path_factory):
    """logs/{env}/{method}/{algo}/{run}/: 3 runs of ground_truth, 2 of
    raw_pixels (one with two monitor files), and a method with no episode."""
    root = tmp_path_factory.mktemp("logs") / "MobileRobotGymEnv-v0"
    for method, algo, seeds in (("ground_truth", "ppo2", (0, 1, 2)),
                                ("raw_pixels", "a2c", (3, 4))):
        for s in seeds:
            write_run(str(root / method / algo / f"run{s}"), s, n_files=1 + (s == 4))
    (root / "autoencoder" / "ppo2" / "empty").mkdir(parents=True)
    return str(root)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_visualize_helpers_equal_the_reference(env_logs):
    run = os.path.join(env_logs, "raw_pixels", "a2c", "run4")
    results = load_results(run)
    t, r = visualize.episodes_with_timesteps(results)
    jt, jr = jvis.episodes_with_timesteps(jload_results(run))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(r, jr)
    assert len(r) == 120
    for window in (1, 7, 40, 500):
        np.testing.assert_array_equal(visualize.smooth_moving_average(r, window),
                                      jvis.smooth_moving_average(r, window))
    for size in (3, 5, 200):
        np.testing.assert_array_equal(visualize.median_filter(r, size),
                                      jvis.median_filter(r, size))
    for n in (7, 500):
        for a, b in zip(visualize.downsample(t, r, n), jvis.downsample(t, r, n)):
            np.testing.assert_array_equal(a, b)
    assert visualize.episodes_with_timesteps([])[0].size == 0


def test_plots_draw_the_reference_png(env_logs, tmp_path):
    run = os.path.join(env_logs, "ground_truth", "ppo2", "run0")
    copy = str(tmp_path / "run0")
    shutil.copytree(run, copy)
    out = plots.main(["--log-dir", run, "--episode-window", "10"])
    ref = jvis.plot_log_dir(copy, title="run0", episode_window=10)
    assert read_bytes(out) == read_bytes(ref)
    assert visualize.plot_log_dir(os.path.join(env_logs, "autoencoder", "ppo2", "empty")) is None


def test_aggregate_compare_and_gather_equal_the_reference(env_logs, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    aggregate_plots.main(["--log-dir", env_logs, "--episode-window", "10", "--output", port])
    jagg.main(["--log-dir", env_logs, "--episode-window", "10", "--output", ref])
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port)) == [
        "aggregated_curves.png", "ground_truth.npz", "raw_pixels.npz"]
    for name in names:
        assert read_bytes(os.path.join(port, name)) == read_bytes(os.path.join(ref, name)), name
    agg = aggregate_plots.aggregate_method(os.path.join(env_logs, "ground_truth"), "ppo2", 10)
    assert agg["n_runs"] == 3 and agg["timesteps"].shape == (200,)

    compare_plots.main(["-i", port, "--title", "t"])
    jcmp.main(["-i", ref, "--title", "t"])
    assert read_bytes(os.path.join(port, "comparison.png")) == read_bytes(
        os.path.join(ref, "comparison.png"))

    budgets = ["2000", "6000", "40000"]
    out, tests = gather_results.main(["--log-dir", env_logs, "--timesteps", *budgets,
                                      "--episode-window", "10", "--output", port + ".csv"])
    jgather.main(["--log-dir", env_logs, "--timesteps", *budgets, "--episode-window", "10",
                  "--output", ref + ".csv"])
    assert read_bytes(out) == read_bytes(ref + ".csv")
    with open(out) as f:
        assert f.readline().startswith("method,2000,2000_n,")
    assert set(tests) == {("ground_truth", "raw_pixels")}
    for m in ("ground_truth", "raw_pixels"):
        np.testing.assert_array_equal(
            gather_results.rewards_at_budget(os.path.join(env_logs, m), 6000, 10),
            jgather.rewards_at_budget(os.path.join(env_logs, m), 6000, 10))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_welch_t_test_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(0, 1, 5 + seed), rng.normal(0.5 * seed, 2, 7)
    t, p = gather_results.welch_t_test(a, b)
    jt, jp = jgather.welch_t_test(a, b)
    assert abs(p - jp) <= 1e-12 and abs(t - jt) <= 1e-12
    assert gather_results.welch_t_test(np.ones(3), np.ones(4)) == (0.0, 1.0)


SPACE = {"learning_rate": (float, (1e-4, 1e-2)), "n_steps": (int, (8, 128)),
         "policy": ((list, str), ["mlp", "cnn"])}


def stub_score(params, budget):
    return -abs(np.log10(params["learning_rate"]) + 3) - abs(params["n_steps"] - 64) / 64 \
        + 0.1 * (params["policy"] == "mlp") + 0.01 * budget


def test_hyperband_gives_the_reference_trials():
    port = hyperparam_search.Hyperband(SPACE, stub_score, max_iter=9, seed=7)
    ref = jhp.Hyperband(SPACE, stub_score, max_iter=9, seed=7)
    assert port.run() == ref.run()
    assert port.history == ref.history and len(port.history) > 10


def test_tpe_gives_the_reference_trials():
    port = hyperparam_search.TPE(SPACE, stub_score, max_evals=12, seed=5)
    ref = jhp.TPE(SPACE, stub_score, max_evals=12, seed=5)
    assert port.run(1) == ref.run(1)
    assert port.history == ref.history


def test_pipeline_trains_its_grid(tmp_path):
    runs = pipeline.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                          "--num-iteration", "2", "--seed", "3", "--num-timesteps", "500",
                          "--log-dir", str(tmp_path), "--device", "cpu", "--num-envs", "4"])
    assert len(runs) == 2 and all(r.startswith(str(tmp_path)) for r in runs)
    seeds = []
    for r in runs:
        with open(os.path.join(r, "args.json")) as f:
            args = json.load(f)
        assert args["num_envs"] == 4 and args["no_vis"] and args["device"] == "cpu"
        seeds.append(args["seed"])
        assert os.path.isfile(os.path.join(r, "ppo2_final_model.pkl"))
    assert seeds == [3, 4]
    with pytest.raises(ChildProcessError, match="MobileRobotGymEnv-v0/ground_truth seed 0"):
        pipeline.run_grid(["MobileRobotGymEnv-v0"], ["ground_truth"], num_iteration=1,
                          log_dir=str(tmp_path), device="cpu",
                          extra_args=["--load-rl-model-path", str(tmp_path / "none.pkl")])


YAML = """MobileRobotGymEnv-v0:
  log_folder: srl_logs/mobile/
  autoencoder: ae/srl_model.pkl
KukaButtonGymEnv-v0:
  log_folder: srl_logs/kuka/
"""


@pytest.mark.parametrize("models, envs", [
    (["ground_truth", "autoencoder"], ["MobileRobotGymEnv-v0"]),
    (["raw_pixels"], ["KukaButtonGymEnv-v0", "MobileRobotGymEnv-v0"]),
    (["ground_truth"], ["NoSuchEnv-v0"]),
    (["no_such_model"], ["MobileRobotGymEnv-v0"]),
    (["autoencoder"], ["KukaButtonGymEnv-v0"]),
    (["autoencoder"], ["OmnirobotEnv-v0"]),
    (["vae"], ["MobileRobotGymEnv-v0"]),
    (["autoencoder"], ["MobileRobotGymEnv-v0"]),
])
@pytest.mark.parametrize("config", ["srl_models.yaml", "missing.yaml"])
def test_validate_srl_models_raises_where_the_reference_raises(models, envs, config, tmp_path):
    (tmp_path / "srl_models.yaml").write_text(YAML)
    path = str(tmp_path / config)
    outcomes = []
    for validate in (pipeline.validate_srl_models, jpipeline.validate_srl_models):
        try:
            validate(models, envs, path)
            outcomes.append(None)
        except Exception as e:  # the exception's type is what is compared
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_live_vis_serves_the_reference_page_and_data(env_logs):
    run = os.path.join(env_logs, "raw_pixels", "a2c", "run4")
    data = live_vis.read_run_data(run, window=7)
    assert data == jlive.read_run_data(run, window=7)
    assert len(data["episodes"]) == 120 and len(data["metrics_mean_reward"]) == 6

    server = live_vis.LiveVisServer(run, port=0, window=7)
    assert server.start() and server.port > 0
    try:
        status, ctype, page = get(server.port, "/")
        assert status == 200 and ctype.startswith("text/html") and page == jlive._PAGE.encode()
        status, ctype, body = get(server.port, "/data.json")
        assert status == 200 and ctype == "application/json" and json.loads(body) == data
        assert get(server.port, "/nothing")[0] == 404
        assert live_vis.LiveVisServer(run, port=server.port).start() is False
        assert jlive.LiveVisServer(run, port=server.port).start() is False
    finally:
        server.stop()


def test_training_cli_serves_curves_and_writes_the_reference_png(tmp_path, capsys):
    log_dir = train.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                          "--num-envs", "4", "--num-timesteps", "2000", "--port", "0",
                          "--device", "cpu", "--log-dir", str(tmp_path / "logs")])
    assert "Live curves: http://localhost:" in capsys.readouterr().out
    png = os.path.join(log_dir, "learning_curve.png")
    copy = str(tmp_path / "copy")
    shutil.copytree(log_dir, copy, ignore=shutil.ignore_patterns("*.png"))
    ref = jvis.plot_log_dir(copy, title="MobileRobotGymEnv-v0 (ground_truth, ppo2)")
    assert len(load_results(log_dir)[0]["r"]) == 8
    assert read_bytes(png) == read_bytes(ref)

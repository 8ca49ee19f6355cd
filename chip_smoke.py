#!/usr/bin/env python3
"""Smoke run of the PyTorch port (srl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. build the CUDA ray tracer (srl_tpu_torch/csrc/render3d.cu) from the
   checkout with nvcc;
2. hold the kernel against its plain PyTorch twin on the card for every
   render configuration of the slice (agreement: over 99.5% of the values
   equal and under 0.5% off by more than 2);
3. time the kernel and the twin per render call at the main path's shape
   (256 envs, 112x112 coarse trace) with CUDA events;
4. drive the main path through the training CLI, PPO2 on
   KukaButtonGymEnv-v0 from raw pixels (256 envs, render scale 2, coarse
   observations, 3 updates of 256 x 128 steps), with the launch counts set
   to 0 just before and read just after, and check the run's outputs.

The line before the last is a JSON object with each kernel's numbers, the
last ``{"ok": true, "device": {...}}``. Needs the card and the rest of the
repository; imports nothing of JAX.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (env class, kwargs, N): the render configurations of the slice.
RENDER_CASES = [
    ("KukaButtonEnv", dict(render_scale=1), 64),
    ("KukaButtonEnv", dict(render_scale=2, coarse_obs=True), 256),
    ("KukaRandButtonEnv", dict(render_scale=1), 64),
    ("Kuka2ButtonEnv", dict(render_scale=1), 64),
    ("KukaButtonEnv", dict(render_scale=2, multi_view=True), 64),
]
MAIN_ARGS = ["--env", "KukaButtonGymEnv-v0", "--srl-model", "raw_pixels",
             "--algo", "ppo2", "--num-envs", "256", "--render-scale", "2",
             "--coarse-obs", "--num-timesteps", "90000", "--no-vis"]


def log(msg: str) -> None:
    print(msg, flush=True)


def render_flops_per_pixel(cfg) -> int:
    """Float32 operations of csrc/render3d.cu that depend on the ray, per
    traced pixel and view: a button cylinder 25, a capsule body 28, a sphere
    11, the shade 16 (sqrt and division count 1 each; per-env scalars and the
    normals of hits, which depend on the data, are not counted, so the bound
    is a lower bound)."""
    n_spheres = cfg.n_pts + (cfg.n_distract + 1 if cfg.n_distract else 0)
    return 25 * 2 * cfg.n_buttons + 28 * (cfg.n_pts - 1) + 11 * n_spheres + 16


def render_bound_ms(cfg, scene) -> tuple:
    n, views = scene.shape[0], len(cfg.views)
    pixels = cfg.trace_h * cfg.trace_w
    flops = render_flops_per_pixel(cfg) * n * pixels * views
    out_bytes = n * pixels * cfg.up * cfg.up * 3 * views
    in_bytes = scene.numel() * 4 + views * 10 * pixels * 4  # scene, rays, bg
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (out_bytes + in_bytes) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "srl_tpu_torch")):
        print("chip_smoke: srl_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from srl_tpu_torch.envs import kuka
    from srl_tpu_torch.experiments import train
    from srl_tpu_torch.ops import cuda_build, render3d

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 1. Build.
    t0 = time.perf_counter()
    path = cuda_build.build("render3d")
    info = cuda_build.BUILD_INFO["render3d"]
    log(f"[build] {os.path.relpath(path, REPO)}: nvcc {info['seconds']:.1f} s"
        + (" (found built)" if not info["log"] else "")
        + f", {time.perf_counter() - t0:.1f} s in all")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 2. Kernel against the twin.
    max_err = 0
    main_inputs = None
    for name, kwargs, n in RENDER_CASES:
        env = getattr(kuka, name)(srl_model="raw_pixels", **kwargs)
        gen = torch.Generator(device=dev).manual_seed(0)
        states = env.reset(gen, n)
        for _ in range(10):  # move the arm off its rest pose
            states, _, _ = env.step(states, env.action_space.sample(gen, n), gen)
        cfg, scene = render3d._scene_table(env, states)
        eyes, rays, bg = render3d.camera_tensors(cfg, dev)
        out = render3d.render_kuka_cuda(cfg, scene, eyes, rays, bg)
        plain = render3d.render_kuka_plain(cfg, scene, eyes, rays, bg)
        torch.cuda.synchronize()
        if out.shape != plain.shape:
            raise AssertionError(f"{name} {kwargs}: {tuple(out.shape)} vs {tuple(plain.shape)}")
        diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
        equal = (diff == 0).double().mean().item()
        off = (diff > 2).double().mean().item()
        max_err = max(max_err, int(diff.max()))
        log(f"[compare] {name} {kwargs} N={n} {tuple(out.shape)}: {equal:.6f} equal, "
            f"{off:.6f} off by more than 2, max |diff| {int(diff.max())}")
        if not (equal > 0.995 and off < 0.005):
            raise AssertionError(f"render3d kernel disagrees with the twin for {name} {kwargs}")
        if kwargs == dict(render_scale=2, coarse_obs=True):
            main_inputs = (cfg, scene, eyes, rays, bg)

    # 3. Time kernel and twin at the main path's shape.
    cfg, scene, eyes, rays, bg = main_inputs
    kernel_ms = time_ms(lambda: render3d.render_kuka_cuda(cfg, scene, eyes, rays, bg), 200)
    plain_ms = time_ms(lambda: render3d.render_kuka_plain(cfg, scene, eyes, rays, bg), 5, 1)
    bound_ms, bound_by = render_bound_ms(cfg, scene)
    log(f"[time] render3d N={scene.shape[0]} trace {cfg.trace_h}x{cfg.trace_w}: kernel "
        f"{kernel_ms:.4f} ms, twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {render_flops_per_pixel(cfg)} flop/pixel); no single PyTorch "
        f"call computes this function, so library_ms is null")

    # 4. The main path.
    with tempfile.TemporaryDirectory() as tmp:
        render3d.launches = 0
        t0 = time.perf_counter()
        log_dir = train.main(MAIN_ARGS + ["--log-dir", tmp, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = render3d.launches
        for f in ("args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
                  "ppo2_final_model.pkl"):
            if not os.path.isfile(os.path.join(log_dir, f)):
                raise AssertionError(f"run dir lacks {f}")
        with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
            entries = [json.loads(line) for line in fh]
    if len(entries) != 3:
        raise AssertionError(f"expected 3 PPO updates, got {len(entries)}")
    for e in entries:
        for k in ("pg_loss", "vf_loss", "entropy", "approx_kl", "explained_variance"):
            if not math.isfinite(e[k]):
                raise AssertionError(f"update {e['update']}: {k} = {e[k]}")
    if launches <= 0:
        raise AssertionError("the main path never launched the render3d kernel")
    steps = entries[-1]["num_timesteps"]
    log(f"[main] 3 PPO2 updates, {steps} env steps in {seconds:.1f} s: "
        f"{steps / seconds:.0f} env-steps/s end to end (last update's running "
        f"rate {entries[-1]['fps']:.0f}) on {card}; render3d launches {launches}; losses "
        f"finite: " + ", ".join(f"pg {e['pg_loss']:.4g} vf {e['vf_loss']:.4g}"
                                for e in entries))

    print(json.dumps({"kernels": [{
        "name": "render3d",
        "route": "cuda",
        "source": "srl_tpu_torch/csrc/render3d.cu",
        "replaces": "srl_tpu/ops/pallas_render3d.py:480",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

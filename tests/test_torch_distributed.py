"""Two real processes of srl_tpu_torch.parallel.dp_ppo, joined by gloo over
127.0.0.1, against the same job in one process (the counterpart of
tests/test_distributed.py's "mobile" case: MobileRobot ground truth, 8 envs,
8 steps, 2 minibatches, 1 epoch, one update).

Each process goes through ``distributed.initialize()`` from the variables
``torchrun`` sets, with a 60 s timeout on the rendezvous and every
collective; the port comes from binding port 0 on 127.0.0.1. The processes
are started with ``subprocess.Popen``, given 120 s, and killed in a
``finally``. Nothing here sets up a process group in the test process.

Both ranks report the same pg_loss and parameters; their env rows step the
one-process run's bit for bit (rewards, dones, observations, through an
auto-reset); pg_loss and the parameters agree with the one-process update
within the reference's 1e-4 and 1e-3.
"""
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from srl_tpu_torch.parallel import dp_ppo

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV_ARGS = ["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth"]
JOB_ARGS = ["--device", "cpu", "--num-envs", "8", "--n-steps", "8", "--nminibatches", "2",
            "--noptepochs", "1", "--updates", "1", "--fingerprint-steps", "260"]
WORKER_TIMEOUT = 120.0  # seconds both processes may take together


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_two(out_dir) -> list:
    """Both ranks' (stdout, stderr); each process is gone on return. A port
    that another process took between ``free_port`` and the rendezvous is
    retried with a new one."""
    for _ in range(3):
        outs, codes = run_two(out_dir, free_port())
        if not any("EADDRINUSE" in err for _, err in outs):
            break
    for code, (out, err) in zip(codes, outs):
        assert code == 0, f"a rank failed:\nSTDOUT:\n{out}\nSTDERR:\n{err}"
    return outs


def run_two(out_dir, port: int):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "srl_tpu_torch.parallel.dp_ppo", *ENV_ARGS, *JOB_ARGS,
           "--timeout", "60", "--out", str(out_dir)]
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(cmd, cwd=REPO, env={**env, "RANK": str(rank)},
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        deadline = time.monotonic() + WORKER_TIMEOUT
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, [p.returncode for p in procs]


def test_two_processes_match_one(tmp_path):
    launch_two(tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert [(r["rank"], r["dp"], r["rows"]) for r in ranks] == [(0, 2, 4), (1, 2, 4)]
    assert ranks[0]["pg_loss"] == ranks[1]["pg_loss"]
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    assert all(c > 0 for r in ranks for c in r["collective_s"])

    args, env_argv = dp_ppo.build_parser().parse_known_args(ENV_ARGS + JOB_ARGS)
    one = dp_ppo.run(args, env_argv)
    for name, want in one["fingerprints"].items():
        got = torch.cat([r["fingerprints"][name] for r in ranks], 1)
        assert torch.equal(got, want), name
    assert one["fingerprints"]["done"].any()  # through an auto-reset
    np.testing.assert_allclose(ranks[0]["pg_loss"], one["pg_loss"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["params"].numpy(), one["params"].numpy(), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(ranks[0]["param_sq"], one["param_sq"], rtol=1e-5)

"""A rank of a small run of a mesh cell on the CPU, for the tests: the
program's and the reference's episodes cut to ``MAX_STEPS`` (so that the
update after the window holds episode ends), then ``run.py``'s rank. The
environment may plant a fault on every rank (``SMALL_RANK_FAULT``, a name of
``faults.FAULTS`` or ``faults.MESH_FAULTS``) or kill one rank at its n-th
update (``SMALL_RANK_KILL=<rank>:<n>``)."""
import os
import signal
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for path in (BENCH.parent, BENCH):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import torch  # noqa: E402

import cell as driver  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402
from reference import vec_env as ref_env  # noqa: E402

MAX_STEPS = 12


def killed_at(agent, n: int) -> None:
    """The process kills itself at ``agent``'s ``n``-th update."""
    orig = agent.train_iteration
    calls = []

    def train_iteration(*args, **kwargs):
        calls.append(1)
        if len(calls) == n:
            os.kill(os.getpid(), signal.SIGKILL)
        return orig(*args, **kwargs)

    agent.train_iteration = train_iteration


def main() -> int:
    torch.set_num_threads(1)
    build, make_env = driver.build, ref_env.make_env
    fault = os.environ.get("SMALL_RANK_FAULT")
    kill = os.environ.get("SMALL_RANK_KILL")

    def short_env(*args):
        env = make_env(*args)
        env.max_steps = MAX_STEPS
        return env

    def small_build(c, device, overrides=None):
        agent = build(c, device, overrides)
        agent.vec_env.env.max_steps = MAX_STEPS
        if fault:
            faults.FAULTS.get(fault, faults.MESH_FAULTS.get(fault))(agent).__enter__()
        if kill and kill.split(":")[0] == os.environ["RANK"]:
            killed_at(agent, int(kill.split(":")[1]))
        return agent

    driver.build = small_build
    ref_env.make_env = short_env
    return run.main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())

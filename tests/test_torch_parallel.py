"""srl_tpu_torch.parallel (the data-parallel layer on torch.distributed)
against srl_tpu.parallel and against the port's one-process runs, on the CPU.

The ranks of a mesh are built in this process: one gloo backend per rank on
a shared ``HashStore`` (no TCP port, no ``init_process_group``), and one per
rank and dp or tp sub-group on a ``PrefixStore`` of the same store, one
thread per rank, joined with a timeout (``run_ranks``). The cases follow
tests/test_sharding.py and test_distributed_wiring:

* MobileRobot trajectories (32 envs, 64 steps, actions ``(arange(N) + i) %
  4``) are bit-equal for dp 1, 2, 4 and 8 and to the one-process run; fed
  the noise the reference drew, they are bit-equal to the reference's
  rollout on a ``make_mesh(dp)`` mesh;
* the mixed Kuka + Omnirobot fleet aligns its families to the dp shard as
  the reference's does (64 envs over 8), and a meshed step of it is the
  one-process step's rows;
* the normalizer's all-reduced update equals the one-process update of the
  concatenated batch; the agents whose state the reference's
  ``shard_ppo_state`` cannot lay out (ACKTR, RecurrentACKTR, DQN, SAC,
  DDPG) are refused a mesh, and the entry points do not fall back to the
  CPU.

PPO2's update and curves over dp are tests/test_torch_parallel_ppo.py, over
dp x tp tests/test_torch_tensor_parallel.py; the other agents' are
tests/test_torch_parallel_agents.py and _parallel_recurrent.py.
"""
import dataclasses
import datetime
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from srl_tpu.core.env import VecEnv as JaxVecEnv
from srl_tpu.core.env import VecEnvState as JaxVecEnvState
from srl_tpu.envs import mobile_robot as jm
from srl_tpu.parallel import distributed as jdist
from srl_tpu.parallel import mesh as jmesh
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.core.env import VecEnv, take_rows
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.envs import mobile_robot as tm
from srl_tpu_torch.parallel import distributed as dist
from srl_tpu_torch.parallel import make_mesh, shard_batch, shard_ppo_state

from .test_torch_mobile_robot import jax_reset_noise, jax_step_noise

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0  # seconds: a rank's collectives and the join of its thread
# Building a policy draws its initial weights from the process-wide generator
# (``init_params`` seeds it under ``fork_rng``): ranks that are threads of one
# process build their agents one at a time.
BUILD = threading.Lock()


def run_ranks(n: int, fn, tp: int = 1) -> list:
    """``fn(mesh)`` on each of ``n`` ranks of a dp x tp mesh, each rank a
    thread with its own gloo backends (the world and, for dp and tp both
    above 1, its dp and tp groups); returns the ranks' results in rank
    order, or raises the first failure."""
    store = tdist.HashStore()
    timeout = datetime.timedelta(seconds=RANK_TIMEOUT)
    results, errors = [None] * n, []

    def rank_main(rank):
        def new_group(ranks):
            if rank not in ranks:
                return None
            return tdist.ProcessGroupGloo(tdist.PrefixStore(f"sub{ranks}", store),
                                          ranks.index(rank), len(ranks), timeout)

        try:
            group = tdist.ProcessGroupGloo(tdist.PrefixStore("mesh", store), rank, n, timeout)
            results[rank] = fn(dist.make_global_mesh(tp=tp, group=group, new_group=new_group))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((time.monotonic(), rank, e))

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + RANK_TIMEOUT + 10
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errors:
        raise min(errors, key=lambda e: e[0])[2]
    return results


# ---- the wiring (test_distributed_wiring) ---------------------------------

def test_wiring_matches_the_reference(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert dist.initialize() is False and not tdist.is_initialized()
    shapes = run_ranks(8, lambda mesh: (mesh.shape, dist.make_global_mesh(group=mesh.group).shape,
                                        (mesh.dp_index, mesh.tp_index)), tp=2)
    assert all(s[:2] == ({"dp": 4, "tp": 2}, {"dp": 8, "tp": 1}) for s in shapes)
    assert [s[2] for s in shapes] == [(r // 2, r % 2) for r in range(8)]
    with pytest.raises(ValueError, match="needs new_group= to make its dp and tp sub-groups"):
        run_ranks(8, lambda mesh: dist.make_global_mesh(tp=2, group=mesh.group))
    slices = [dist.local_env_slice(8192, process_id=p, process_count=4) for p in range(4)]
    assert slices == [jdist.local_env_slice(8192, process_id=p, process_count=4)
                      for p in range(4)]
    assert slices[0] == (0, 2048) and slices[-1] == (6144, 8192)
    assert dist.local_env_slice(10) == (0, 10)
    with pytest.raises(AssertionError) as port:
        dist.local_env_slice(100, process_id=0, process_count=3)
    with pytest.raises(AssertionError) as ref:
        jdist.local_env_slice(100, process_id=0, process_count=3)
    assert str(port.value) == str(ref.value)
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(2\) != devices\(8\)"):
        run_ranks(8, lambda mesh: make_mesh(dp=3, tp=2, group=mesh.group))


def test_shard_batch_keeps_the_rows_the_reference_shards():
    tree = {"env": torch.arange(8.0).reshape(8, 1), "odd": torch.arange(6.0),
            "one": torch.ones(1), "scalar": torch.tensor(3.0), "steps": 5}
    jtree = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}
    jsharded = jmesh.shard_batch({k: v for k, v in jtree.items() if k != "steps"},
                                 jmesh.make_mesh(n_devices=4))
    out = run_ranks(4, lambda mesh: shard_batch(tree, mesh))
    for rank, leaves in enumerate(out):
        assert leaves["steps"] == 5
        for k, leaf in jsharded.items():
            shard = [s for s in leaf.addressable_shards if s.device.id == rank][0]
            np.testing.assert_array_equal(leaves[k].numpy(), np.asarray(shard.data), err_msg=k)


# ---- env trajectories across dp sizes (test_sharding.py:39-65) ---------------

N_TRAJ, T_TRAJ = 32, 64


def traj_actions(i: int) -> torch.Tensor:
    return (torch.arange(N_TRAJ) + i) % 4


def port_rollout(mesh=None, noise=None):
    """Rewards, dones and positions [T, rows] of the port's rollout from
    seed 0, or from ``noise`` = (reset noise, [(step, reset noise)] per
    step); with ``mesh``, of the rank's rows."""
    vec = VecEnv(tm.MobileRobotEnv(), N_TRAJ)
    gen = torch.Generator().manual_seed(0)
    vstate, _ = vec.reset(gen, noise=None if noise is None else noise[0])
    lo, hi = (0, N_TRAJ) if mesh is None else mesh.env_slice(N_TRAJ)
    if mesh is not None:
        vstate = shard_batch(vstate, mesh)
    out = []
    for i in range(T_TRAJ):
        step_noise, reset_noise = (None, None) if noise is None else noise[1][i]
        vstate, tr = vec.step(vstate, traj_actions(i)[lo:hi], gen, step_noise=step_noise,
                              reset_noise=reset_noise, mesh=mesh)
        out.append((tr.reward, tr.done, vstate.env_state.robot_pos))
    return [torch.stack(x) for x in zip(*out)]


def gathered(per_rank) -> list:
    return [torch.cat(parts, 1) for parts in zip(*per_rank)]


@pytest.fixture(scope="module")
def one_process_rollout():
    return port_rollout()


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_trajectories_bit_exact_across_dp(dp, one_process_rollout):
    for got, want in zip(gathered(run_ranks(dp, port_rollout)), one_process_rollout):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dp", [2, 8])
def test_trajectories_match_the_reference_mesh_rollout(dp):
    """The reference's VecEnv on a ``make_mesh(dp)`` mesh (shard_batch of the
    env batch, as tests/test_sharding.py shards it), stepped one jitted step
    at a time so that its draws can be read off each step's keys."""
    jenv = jm.MobileRobotEnv()
    jvec = JaxVecEnv(jenv, N_TRAJ)
    key = jax.random.PRNGKey(0)
    jv, _ = jvec.reset(key)
    _, sub = jax.random.split(key)
    reset0 = jax_reset_noise(jenv, jax.random.split(sub, N_TRAJ))
    jmesh_dp = jmesh.make_mesh(n_devices=dp, tp=1)
    jv = JaxVecEnvState(env_state=jmesh.shard_batch(jv.env_state, jmesh_dp),
                        ep_return=jmesh.shard_batch(jv.ep_return, jmesh_dp),
                        ep_length=jmesh.shard_batch(jv.ep_length, jmesh_dp), key=jv.key)
    step = jax.jit(jvec.step)
    draws, ref = [], []
    for i in range(T_TRAJ):
        _, sub = jax.random.split(jv.key)
        draws.append((jax_step_noise(jenv, jv.env_state.key),
                      jax_reset_noise(jenv, jax.random.split(sub, N_TRAJ))))
        jv, jtr = step(jv, jnp.mod(jnp.arange(N_TRAJ) + i, 4))
        ref.append((np.asarray(jtr.reward), np.asarray(jtr.done),
                    np.asarray(jv.env_state.robot_pos)))
    assert len(jv.env_state.robot_pos.sharding.device_set) == dp
    got = gathered(run_ranks(dp, lambda mesh: port_rollout(mesh, (reset0, draws))))
    for name, g, want in zip(("reward", "done", "robot_pos"), got, zip(*ref)):
        np.testing.assert_array_equal(g.numpy(), np.stack(want), err_msg=name)


# ---- the mixed fleet (test_sharding.py:157-211) ------------------------------

def test_mixed_fleet_aligns_each_shard_to_one_family(monkeypatch):
    """64 Kuka + Omnirobot pixel envs over 8 shards: the alignment, counts
    and offsets of the reference's MixedVecEnv (which reads the 8 devices of
    the test platform), each shard inside one family; the port reads the
    ranks of the default process group (here a stand-in world of 8)."""
    from srl_tpu.core.mixed_env import MixedEnv as JMixed
    from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
    from srl_tpu.envs.omnirobot import OmniRobotEnv as JOmni
    from srl_tpu_torch.core.mixed_env import MixedEnv, default_align
    from srl_tpu_torch.envs import KukaButtonEnv, OmniRobotEnv

    assert jax.device_count() == 8
    ref = JaxVecEnv(JMixed([JKuka(srl_model="raw_pixels", render_scale=2),
                            JOmni(srl_model="raw_pixels")], oob_action="modulo"), 64)
    mixed = MixedEnv([KukaButtonEnv(srl_model="raw_pixels", render_scale=2),
                      OmniRobotEnv(srl_model="raw_pixels")], oob_action="modulo")
    assert default_align(64, 2) == 1  # no process group: one device
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 8)
    assert default_align(64, 2) == default_align(64, 2, 8) == 8
    port = VecEnv(mixed, 64)
    assert (port.align, port.counts) == (ref.align, ref.counts) == (8, [32, 32])
    assert port._offsets == np.asarray(ref._offsets).tolist()
    for d in range(8):
        lo, hi = d * 8, (d + 1) * 8
        assert any(port._offsets[i] <= lo and hi <= port._offsets[i + 1] for i in range(2))


@pytest.mark.parametrize("num_envs,dp", [(16, 4), (12, 4)])
def test_mixed_fleet_meshed_step_is_the_one_process_rows(num_envs, dp):
    """A MobileRobot + Omnirobot ground-truth fleet (2-d states each) for
    256 steps, past both families' first auto-reset (step 251): aligned (16 envs, each
    rank in one family) and straddling (12 envs, rank 1 holds rows of both)."""
    from srl_tpu_torch.core.mixed_env import MixedEnv
    from srl_tpu_torch.envs import OmniRobotEnv

    def run(mesh=None):
        vec = VecEnv(MixedEnv([tm.MobileRobotEnv(), OmniRobotEnv(srl_model="ground_truth")]),
                     num_envs, align=1)
        gen = torch.Generator().manual_seed(5)
        vstate, obs = vec.reset(gen)
        lo, hi = (0, num_envs) if mesh is None else mesh.env_slice(num_envs)
        vstate, obs = take_rows(vstate, lo, hi), obs[lo:hi]
        steps = []
        for i in range(256):
            actions = ((torch.arange(num_envs) * 3 + i) % 4)[lo:hi]
            vstate, tr = vec.step(vstate, actions, gen, mesh=mesh)
            steps.append((tr.obs, tr.reward, tr.done, tr.episode_length))
        return [obs] + [torch.stack(x, 1) for x in zip(*steps)]

    want = run()
    assert want[3].any()  # episodes ended
    for got, ref in zip(zip(*run_ranks(dp, run)), want):
        assert torch.equal(torch.cat(got), ref)


# ---- the normalizer -----------------------------------------------------------

def test_normalizer_update_over_ranks_is_the_concatenated_update():
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.normal(3.0, 2.0, (5, 3)).astype(np.float32))
               for _ in range(4)]
    start = RunningNorm.create((3,)).update(torch.from_numpy(
        rng.normal(size=(7, 3)).astype(np.float32)))
    want = start.update(torch.cat(batches))
    for got in run_ranks(4, lambda mesh: start.update(batches[mesh.dp_index], mesh)):
        for f in dataclasses.fields(want):
            np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                       getattr(want, f.name).numpy(), rtol=2e-6, atol=1e-7,
                                       err_msg=f.name)


# ---- what the port refuses ---------------------------------------------------

def refused_agent(name):
    """An agent whose state the reference's shard_ppo_state cannot lay out
    (it has no ``opt_state``, ``update_idx`` or ``params``)."""
    from srl_tpu_torch.agents.acktr import ACKTR, RecurrentACKTR
    from srl_tpu_torch.agents.ddpg import DDPG
    from srl_tpu_torch.agents.dqn import DQN
    from srl_tpu_torch.agents.sac import SAC

    cls = {"acktr": ACKTR, "recurrent_acktr": RecurrentACKTR, "dqn": DQN, "sac": SAC,
           "ddpg": DDPG}[name]
    env = tm.MobileRobotEnv(is_discrete=name not in ("sac", "ddpg"))
    return cls(env=env, num_envs=4, device="cpu")


REFUSED = {"acktr": "opt_state", "recurrent_acktr": "opt_state", "dqn": "update_idx",
           "sac": "params", "ddpg": "params"}


@pytest.mark.parametrize("name", list(REFUSED))
def test_agents_the_reference_cannot_lay_out_are_refused(name):
    agent = refused_agent(name)
    state = agent.init_state(torch.Generator().manual_seed(0))

    def refused(mesh):  # one rank: nothing to serialize
        with pytest.raises(ValueError, match=f"cannot lay out a {type(state).__name__}: it "
                                             f"has no .*{REFUSED[name]}.* the reference's "
                                             f"shard_ppo_state fails on such a state"):
            shard_ppo_state(state, mesh)
        return True

    assert run_ranks(1, refused) == [True]


def test_a_state_on_a_mesh_is_not_laid_out_again():
    def refused(mesh):
        state = PPO2(env=tm.MobileRobotEnv(), num_envs=4, device="cpu").init_state(
            torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="laid out on a mesh already"):
            shard_ppo_state(shard_ppo_state(state, mesh), mesh)
        return True

    assert run_ranks(1, refused) == [True]


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from srl_tpu_torch.parallel import dp_ppo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp_ppo.main(["--env", "MobileRobotGymEnv-v0", "--srl-model", "ground_truth",
                     "--num-envs", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.initialize("127.0.0.1:1", 2, 0)  # refused before any rendezvous
    assert not tdist.is_initialized()

"""The tracer inside the port (``srl_tpu_torch/utils/trace.py``): spans,
self time, counters, per-update records, the detail buffer and its Chrome
JSON, its clock against ``torch.profiler``'s, and that it adds nothing to a
profiler's trace; PPO2's update traced on a CPU env; the benchmark's five
readers of the records; the mesh's collectives as spans."""
import collections
import datetime
import json
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch
import torch.distributed as tdist
from torch.profiler import ProfilerActivity, profile

from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.envs import mobile_robot as mr
from srl_tpu_torch.parallel.mesh import make_mesh
from srl_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
READERS = ("sync_wait_s", "env_dynamics_host_s", "env_observe_host_s",
           "reset_steps_per_update", "host_syncs_per_step")


@pytest.fixture(autouse=True)
def fresh_tracer():
    was = trace.detail()
    trace.disable()
    trace.reset()
    yield
    trace.reset()
    if was:
        trace.enable()
    else:
        trace.disable()


def spin(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_spans_nest_and_self_time_is_the_duration_less_the_children():
    trace.enable()
    with trace.update(7):
        with trace.span("outer"):
            spin(0.002)
            with trace.span("inner"):
                spin(0.003)
            with trace.span("inner"):
                spin(0.001)
    rec, = trace.records()
    assert rec["update"] == 7
    assert rec["calls"] == {"inner": 2, "outer": 1, "update": 1}
    sec, own = rec["seconds"], rec["self"]
    assert sec["inner"] >= 0.004 and sec["outer"] >= sec["inner"] + 0.002
    assert own["inner"] == pytest.approx(sec["inner"], abs=1e-9)
    assert own["outer"] == pytest.approx(sec["outer"] - sec["inner"], abs=1e-9)
    assert own["update"] == pytest.approx(sec["update"] - sec["outer"], abs=1e-9)
    # The kept spans: each child inside its parent, and the same self time.
    kept = {s["id"]: s for s in trace.spans()}
    by_name = collections.defaultdict(list)
    for s in kept.values():
        by_name[s["name"]].append(s)
    (upd,), (outer,) = by_name["update"], by_name["outer"]
    assert upd["parent"] == 0 and outer["parent"] == upd["id"]
    for s in by_name["inner"]:
        assert s["parent"] == outer["id"] and s["update"] == 7
        assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= outer["end_ns"]
    children = sum(s["end_ns"] - s["start_ns"] for s in by_name["inner"])
    assert (outer["end_ns"] - outer["start_ns"] - children) / 1e9 == pytest.approx(
        own["outer"], abs=2e-6)


def test_counters_records_and_totals():
    trace.count("outside", 3)
    with trace.span("setup"):
        pass
    for u in range(3):
        with trace.update(u):
            trace.count("steps", 2)
            with trace.sync("done"):
                pass
    recs = trace.records()
    assert [r["update"] for r in recs] == [0, 1, 2]
    assert all(r["counts"] == {"steps": 2, "host_syncs": 1} for r in recs)
    assert all(r["calls"]["sync.done"] == 1 for r in recs)
    # Set-up goes to the totals alone; the totals also sum the closed updates.
    tot = trace.totals()
    assert tot["counts"] == {"outside": 3, "steps": 6, "host_syncs": 3}
    assert tot["calls"]["setup"] == 1 and tot["calls"]["update"] == 3
    assert trace.counter("steps") == 6 and trace.counter("never") == 0
    trace.reset("steps")
    assert trace.counter("steps") == 0 and trace.counter("outside") == 3
    assert len(trace.records()) == 3  # a named reset leaves the records


def test_records_keep_the_last_1024_updates():
    for u in range(trace.MAX_RECORDS + 6):
        with trace.update(u):
            trace.count("n")
    recs = trace.records()
    assert len(recs) == trace.MAX_RECORDS == 1024
    assert recs[0]["update"] == 6 and recs[-1]["update"] == trace.MAX_RECORDS + 5
    assert trace.counter("n") == trace.MAX_RECORDS + 6


def test_no_span_is_kept_without_detail():
    with trace.update(0):
        with trace.span("a"):
            pass
    assert trace.spans() == [] and trace.records()[0]["calls"]["a"] == 1


def test_detail_buffer_drops_the_oldest_and_counts_them(monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "_spans", collections.deque(maxlen=5))
    trace.enable(tmp_path / "t.json")
    with trace.update(3):
        for i in range(7):
            with trace.span(f"s{i}"):
                pass
    # 8 spans closed (seven and the update) into 5 places.
    assert trace.dropped() == 3
    assert [s["name"] for s in trace.spans()] == ["s3", "s4", "s5", "s6", "update"]
    path = trace.dump()
    doc = json.loads(Path(path).read_text())
    assert doc["otherData"]["dropped"] == 3
    events = doc["traceEvents"]
    assert [e["name"] for e in events] == ["s3", "s4", "s5", "s6", "update"]
    upd = events[-1]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert all(e["args"]["parent"] == upd["args"]["id"] for e in events[:-1])
    assert all(e["args"]["update"] == 3 for e in events)
    assert upd["args"]["parent"] == 0
    # Microseconds from the base, which is Unix-epoch nanoseconds.
    base = doc["baseTimeNanoseconds"]
    assert abs(base - time.time_ns()) < 3600 * 10**9
    first = trace.spans()[0]
    assert events[0]["ts"] == pytest.approx((first["start_ns"] - base) / 1e3)


def test_dump_without_a_path_is_refused(monkeypatch):
    monkeypatch.setattr(trace, "_path", None)
    with pytest.raises(ValueError, match="no path"):
        trace.dump()


def test_a_profiler_op_inside_a_span_lies_inside_its_dumped_interval():
    trace.enable()
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("matmul"):
            spin(0.003)
            a @ a
            spin(0.003)
    span, = [s for s in trace.spans() if s["name"] == "matmul"]
    results = prof.profiler.kineto_results
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm
    for e in mm:
        start = results.trace_start_ns() + round(e.time_range.start * 1000)
        assert span["start_ns"] <= start <= span["end_ns"]


def test_the_program_adds_nothing_to_a_profiler_trace():
    trace.enable()
    env = mr.MobileRobotEnv()
    agent = PPO2(env=env, num_envs=4, config=PPOConfig(n_steps=4, nminibatches=2,
                                                        noptepochs=1), device="cpu")
    gen = agent._start(0)
    state = agent.init_state(gen, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        agent.train_iteration(state, gen)
    names = {s["name"] for s in trace.spans()}
    assert {"update", "rollout", "env.step", "epochs"} <= names
    events = prof.events()
    assert events and not any(e.name in names for e in events)
    assert not any(e.name.startswith(("sync.", "env.", "rollout", "epochs")) for e in events)
    assert all(e.device_type != torch.autograd.DeviceType.CUDA for e in events)


@pytest.mark.parametrize("detail", [False, True])
def test_a_ppo2_update_on_a_cpu_env_makes_one_full_record(detail, monkeypatch):
    env = mr.MobileRobotEnv()
    env.max_steps = 5  # episodes end inside the update
    cfg = PPOConfig(n_steps=16, nminibatches=2, noptepochs=3)
    agent = PPO2(env=env, num_envs=4, config=cfg, device="cpu")
    gen = agent._start(0)
    state = agent.init_state(gen, 0)
    step, ends = agent.vec_env.step, []

    def counted(*args, **kwargs):
        vs, tr = step(*args, **kwargs)
        ends.append(int(tr.done.sum()))
        return vs, tr

    monkeypatch.setattr(agent.vec_env, "step", counted)
    trace.reset()
    if detail:
        trace.enable()
    state, _ = agent.train_iteration(state, gen)
    rec, = trace.records()
    assert rec["update"] == 0 and state.update_idx == 1
    calls, counts = rec["calls"], rec["counts"]
    for name in ("update", "rollout", "gae", "epochs"):
        assert calls[name] == 1
    for name in ("rollout.policy", "env.step", "env.dynamics", "sync.done", "env.observe"):
        assert calls[name] == cfg.n_steps
    assert calls["epochs.minibatch"] == cfg.nminibatches * cfg.noptepochs
    assert counts["host_syncs"] == sum(n for k, n in calls.items() if k.startswith("sync."))
    assert counts["reset_steps"] == calls["env.reset"] == sum(1 for n in ends if n) > 0
    # How many envs ended is read in detail mode only (one kernel more).
    assert counts.get("envs_reset") == (sum(ends) if detail else None)
    sec, own = rec["seconds"], rec["self"]
    kids = ("env.dynamics", "sync.done", "env.reset", "env.observe")
    assert own["env.step"] == pytest.approx(sec["env.step"] - sum(sec[k] for k in kids),
                                            abs=1e-6)
    assert sec["rollout"] <= sec["update"]
    assert sec["rollout.policy"] + sec["env.step"] <= sec["rollout"]


def _ctx(updates, n_steps=8):
    return types.SimpleNamespace(updates=updates,
                                 cell=types.SimpleNamespace(traffic={"n_steps": n_steps}))


def _record(u, dyn, obs, syncs, resets, host_syncs):
    return {"update": u, "seconds": {"env.dynamics": dyn, "env.observe": obs,
                                     "sync.done": syncs[0], "sync.h2d": syncs[1], "rollout": 9.0},
            "self": {}, "calls": {}, "counts": {"reset_steps": resets,
                                                "host_syncs": host_syncs}}


@pytest.fixture
def readers():
    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        import manifest

        yield {name: manifest.metric_reader(name) for name in
               READERS + tuple(f"{r}.kuka" for r in READERS)}
    finally:
        sys.path.remove(str(REPO / "benchmark"))


def test_the_five_readers_take_the_window_updates_only(readers, monkeypatch):
    recs = [_record(0, 100.0, 100.0, (100.0, 0.0), 100, 1000),  # set-up's first
            _record(1, 100.0, 100.0, (100.0, 0.0), 100, 1000),  # the profiled one
            _record(2, 1.0, 0.5, (0.25, 0.5), 2, 16),
            _record(3, 3.0, 1.5, (0.75, 1.0), 0, 32),
            _record(4, 100.0, 100.0, (100.0, 0.0), 100, 1000)]  # the check's
    monkeypatch.setattr(trace, "records", lambda: recs)
    want = {"sync_wait_s": 1.25, "env_dynamics_host_s": 2.0, "env_observe_host_s": 1.0,
            "reset_steps_per_update": 1.0, "host_syncs_per_step": 3.0}
    for name, value in want.items():
        assert readers[name].read(_ctx(2)) == pytest.approx(value), name
        assert readers[f"{name}.kuka"].read(_ctx(2)) == pytest.approx(value), name
    # One window update: update 2 alone.
    assert readers["env_dynamics_host_s"].read(_ctx(1)) == pytest.approx(1.0)
    assert readers["host_syncs_per_step"].read(_ctx(1)) == pytest.approx(2.0)


def test_the_readers_read_nothing_where_the_window_has_no_record(readers, monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: [_record(0, 1.0, 1.0, (1.0, 1.0), 1, 1)])
    for name, reader in readers.items():
        assert reader.read(_ctx(3)) is None, name
    # A program without the tracer: nothing, and no error.
    import srl_tpu_torch.utils

    monkeypatch.setattr(trace, "records", lambda: [_record(2, 1.0, 1.0, (1.0, 1.0), 1, 1)])
    monkeypatch.delattr(srl_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "srl_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from srl_tpu_torch.utils import trace as _  # noqa: F401
    for name, reader in readers.items():
        assert reader.read(_ctx(3)) is None, name


def test_ranks_in_threads_keep_their_own_records_and_exact_totals():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n = 16, 2000
    try:
        def work(rank):
            with trace.update(rank):
                for _ in range(50):
                    with trace.span("step"):
                        trace.count("mine")
            for _ in range(n):
                trace.count("shared")

        threads = [threading.Thread(target=work, args=(r,)) for r in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = trace.records()
    assert sorted(r["update"] for r in recs) == list(range(n_threads))
    assert all(r["counts"] == {"mine": 50} and r["calls"]["step"] == 50 for r in recs)
    assert trace.counter("shared") == n_threads * n
    assert trace.counter("mine") == n_threads * 50


def test_mesh_collectives_are_spans_and_counted_without_a_sync():
    store = tdist.HashStore()
    group = tdist.ProcessGroupGloo(tdist.PrefixStore("trace", store), 0, 1,
                                   datetime.timedelta(seconds=30))
    mesh = make_mesh(group=group)
    x = torch.ones(5)
    mesh.all_reduce_(x)
    mesh.all_gather(torch.ones(3))
    assert mesh.any(torch.tensor([False, True]))
    tot = trace.totals()
    assert tot["calls"]["mesh.all_reduce"] == tot["calls"]["mesh.all_gather"] == 1
    assert tot["calls"]["mesh.any"] == tot["calls"]["sync.mesh.any"] == 1
    assert tot["counts"]["mesh.collectives"] == 3
    assert tot["counts"]["mesh.bytes"] == 5 * 4 + 3 * 4 + 4
    assert tot["counts"]["host_syncs"] == 1
    assert not hasattr(mesh, "seconds")

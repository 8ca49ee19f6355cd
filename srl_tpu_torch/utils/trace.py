"""Spans and counters inside the program: where an update's host time goes.

* ``span(name)`` times a host interval (``with trace.span("env.step"):``);
  ``count(name, n=1)`` adds to a counter.
* ``sync(site)`` wraps a blocking device-to-host read: a span named
  ``sync.<site>`` that also adds one to the counter ``host_syncs``.
* ``update(idx)`` is the root span of one training update (``PPO2.
  train_iteration``, keyed by the state's ``update_idx``). The spans and
  counts inside it add up in a **per-update record**, closed with it:
  ``{"update": idx, "seconds": {name: inclusive s}, "self": {name: s less
  the direct children's}, "calls": {name: n}, "counts": {name: n}}``.
  ``records()`` holds the last ``MAX_RECORDS``. ``totals()`` holds the
  process's sums of every span and count: those outside any update (set-up,
  another agent's loop) as they close, an update's when its record closes.

Always on, aggregates only: two ``perf_counter_ns`` reads and a few dict
adds a span, an int add a count, no synchronisation and no thread. That is
also the tracer's "off": it is what any run measures.

**Detail**, opt-in (the environment variable ``SRL_TRACE=<path>``, read once
at import, or ``enable(path)``): every span is also kept as (name, start,
end, its id, its parent's id, its update) in a buffer of the last
``MAX_SPANS`` (``dropped`` counts those let go), written as Chrome
trace-event JSON by ``dump()`` or at process exit. Start and end are in the
clock ``torch.profiler`` stamps its events in, Unix-epoch nanoseconds
(``perf_counter_ns`` converted through one anchor pair), so a program trace
and a profiler trace of one run line up. Detail mode also synchronises the
card around ``parallel.mesh.Mesh``'s collectives, so their spans time the
collective and not its enqueue, and ``core/env.VecEnv.step`` reads how many
envs ended (``envs_reset``; one kernel more a step). The tracer emits no ``record_function``,
NVTX or CUDA event: a profiler's trace holds nothing of it.

State is per thread where it nests (the open spans and update), so ranks run
as threads of one process keep their own records."""
from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time

MAX_RECORDS = 1024
MAX_SPANS = 200_000

_clock = time.perf_counter_ns


class _Thread(threading.local):
    def __init__(self):
        # Open spans, innermost last: [name, start ns, children's ns, id].
        self.stack = []
        self.record = None  # the open update: (its index, its _Sums)


class _Sums:
    """By name: [inclusive ns, self ns, calls] of spans, and counts."""

    __slots__ = ("spans", "counts")

    def __init__(self):
        self.spans, self.counts = {}, {}

    def add_span(self, name, ns, self_ns):
        e = self.spans.get(name)
        if e is None:
            e = self.spans[name] = [0, 0, 0]
        e[0] += ns
        e[1] += self_ns
        e[2] += 1

    def fold(self, other: "_Sums"):
        for name, (ns, self_ns, calls) in other.spans.items():
            e = self.spans.setdefault(name, [0, 0, 0])
            e[0] += ns
            e[1] += self_ns
            e[2] += calls
        for name, n in other.counts.items():
            self.counts[name] = self.counts.get(name, 0) + n

    def as_dict(self) -> dict:
        spans = self.spans.items()
        return {"seconds": {k: e[0] / 1e9 for k, e in spans},
                "self": {k: e[1] / 1e9 for k, e in spans},
                "calls": {k: e[2] for k, e in spans}, "counts": dict(self.counts)}


_local = _Thread()
_lock = threading.Lock()  # guards _totals, which every thread adds to
_totals = _Sums()
_records = collections.deque(maxlen=MAX_RECORDS)
_spans = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_detail = False
_path = None
_dropped = 0
_anchor = (0, 0)  # (perf_counter_ns, time_ns) read together


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _local.stack.append([self.name, _clock(), 0, next(_ids) if _detail else 0])

    def __exit__(self, *exc):
        end = _clock()
        t = _local
        stack = t.stack
        name, start, children, sid = stack.pop()
        ns = end - start
        if stack:
            stack[-1][2] += ns
        rec = t.record
        if rec is not None:
            e = rec[1].spans.get(name)
            if e is None:
                e = rec[1].spans[name] = [0, 0, 0]
            e[0] += ns
            e[1] += ns - children
            e[2] += 1
        else:
            with _lock:
                _totals.add_span(name, ns, ns - children)
        if _detail:
            _keep(name, start, end, sid, stack[-1][3] if stack else 0,
                  None if rec is None else rec[0])
        return False


def _keep(*span):
    global _dropped
    if len(_spans) == _spans.maxlen:
        _dropped += 1
    _spans.append(span + (threading.get_ident(),))


class _Sync(_Span):
    __slots__ = ()

    def __enter__(self):
        count("host_syncs")
        super().__enter__()


class _Update(_Span):
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        super().__init__("update")
        self.idx = int(idx)

    def __enter__(self):
        _local.record = (self.idx, _Sums())
        super().__enter__()

    def __exit__(self, *exc):
        super().__exit__()
        idx, sums = _local.record
        _local.record = None
        _records.append({"update": idx, **sums.as_dict()})
        with _lock:
            _totals.fold(sums)
        return False


_SPANS = {}


def span(name: str) -> _Span:
    """A context manager that times a host interval under ``name``."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    return s


def sync(site: str) -> _Sync:
    """A context manager around a blocking device-to-host read: the span
    ``sync.<site>``, and one more ``host_syncs``."""
    key = "sync." + site
    s = _SPANS.get(key)
    if s is None:
        s = _SPANS[key] = _Sync(key)
    return s


def update(idx: int) -> _Update:
    """The root span of training update ``idx``: its spans and counts make
    one per-update record."""
    return _Update(idx)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _local.record
    if rec is not None:
        counts = rec[1].counts
        counts[name] = counts.get(name, 0) + n
    else:
        with _lock:
            _totals.counts[name] = _totals.counts.get(name, 0) + n


def records() -> list:
    """The last ``MAX_RECORDS`` per-update records, oldest first."""
    return list(_records)


def totals() -> dict:
    """The process's sums: ``{"seconds", "self", "calls", "counts"}`` by
    name (an update's once it has closed)."""
    with _lock:
        return _totals.as_dict()


def counter(name: str) -> int:
    """The total of one counter (0 if it never counted)."""
    with _lock:
        return _totals.counts.get(name, 0)


def reset(*names: str) -> None:
    """Forget the named counters and spans in the totals; with no name,
    forget everything: totals, records, detail spans, ``dropped``."""
    global _totals, _dropped
    with _lock:
        if names:
            for k in names:
                _totals.spans.pop(k, None)
                _totals.counts.pop(k, None)
            return
        _totals = _Sums()
        _records.clear()
        _spans.clear()
        _dropped = 0


def detail() -> bool:
    """Whether detail mode is on."""
    return _detail


def enable(path=None) -> None:
    """Detail on: keep every span from now on; ``path``, where ``dump()``
    and the process's exit write them (a path given before stays)."""
    global _detail, _path, _anchor
    if path is not None:
        if _path is None:
            atexit.register(_dump_at_exit)
        _path = str(path)
    if not _detail:
        a = _clock()
        wall = time.time_ns()
        _anchor = ((a + _clock()) // 2, wall)
        _detail = True


def disable() -> None:
    """Detail off (the spans kept so far stay, for ``dump``)."""
    global _detail
    _detail = False


def dropped() -> int:
    """Spans let go from the full detail buffer since the last reset."""
    return _dropped


def _unix_ns(t: int) -> int:
    """A ``perf_counter_ns`` reading in Unix-epoch nanoseconds."""
    return _anchor[1] + (t - _anchor[0])


def spans() -> list:
    """The kept spans, oldest first: dicts of ``name``, ``start_ns`` and
    ``end_ns`` (Unix epoch), ``id``, ``parent`` (0: none), ``update``
    (None: outside any) and ``thread``."""
    return [{"name": n, "start_ns": _unix_ns(a), "end_ns": _unix_ns(b), "id": i, "parent": p,
             "update": u, "thread": th} for n, a, b, i, p, u, th in list(_spans)]


def dump(path=None) -> str:
    """Write the kept spans to ``path`` (by default the one ``enable`` or
    ``SRL_TRACE`` gave) as Chrome trace-event JSON: complete events, ``ts``
    and ``dur`` in microseconds from ``baseTimeNanoseconds`` (Unix epoch,
    as in ``torch.profiler``'s export), the ids in ``args``; returns the
    path."""
    path = path or _path
    if path is None:
        raise ValueError("trace.dump: no path given, and neither enable(path) nor "
                         "SRL_TRACE named one")
    kept = spans()
    base = (min((s["start_ns"] for s in kept), default=0) // 10**9) * 10**9
    pid = os.getpid()
    events = [{"name": s["name"], "ph": "X", "cat": "srl_tpu_torch", "pid": pid,
               "tid": s["thread"], "ts": (s["start_ns"] - base) / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "args": {"id": s["id"], "parent": s["parent"], "update": s["update"]}}
              for s in kept]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                   "otherData": {"dropped": _dropped, "clock": "unix_ns"}}, f)
    return str(path)


def _dump_at_exit():
    if _path is not None and _spans:
        dump()


if os.environ.get("SRL_TRACE"):
    enable(os.environ["SRL_TRACE"])

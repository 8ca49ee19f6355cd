"""The traced run's instruments, all in the benchmark's own files: spans
around the program's layers, taken by wrapping the module attributes that
the window's call reaches (synchronised at both ends), and ``torch.profiler``
over one update, reduced to device busy time, kernel launches in the
rollout, device time by kernel and the longest idle gaps."""
from __future__ import annotations

import importlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from patching import Patches


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans(Patches):
    """Installed, it times each call of the named attributes: ``targets``
    maps a span name to (module name or ``"agent"``, attribute name)."""

    def __init__(self, agent, targets: dict, device):
        super().__init__()
        self.agent, self.targets, self.device = agent, targets, device
        self.seconds = {name: [] for name in targets}

    def __enter__(self):
        for name, (owner_name, attr) in self.targets.items():
            owner = self.agent if owner_name == "agent" else importlib.import_module(owner_name)
            self.set(owner, attr, lambda orig, name=name: self._timed(name, orig))
        return self

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            with record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
            sync(self.device)
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return call


# The kinds of device activity that are work on the card. The profiler also
# puts ranges of the host's annotations on the device's timeline (the
# benchmark's ``bench.*`` spans, NCCL's ``nccl:<op>``): those are not work.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _is_device(e) -> bool:
    """A device operation: a kernel, a copy or a memset, by the profiler's kind
    of activity (by its flag of a user annotation where the profiler gives no
    kind)."""
    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", None)
    if isinstance(kind, str) and kind:
        return kind in DEVICE_KINDS
    return not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench.")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiled_update(run_update, device) -> dict:
    """Profile one update (``run_update()``): its length in the trace, the
    device's busy time (the union of device operations), device time and calls by
    kernel, kernel launches inside each ``bench.*`` span, the longest idle
    gaps named by the innermost host operation that was running, the top
    device operations, and by stream (the profiler's device resource) the
    union of its operations and their names."""
    sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("bench.update"):
            run_update()
        sync(device)
    events = prof.events()
    dev = [(e.time_range.start, e.time_range.end, e.name,
            getattr(e, "device_resource_id", None)) for e in events if _is_device(e)]
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    upd = next(e for e in host if e.name == "bench.update")
    lo, hi = upd.time_range.start, upd.time_range.end
    on_stream = {}
    for a, b, n, stream in dev:
        if b > lo and a < hi:
            on_stream.setdefault(str(stream), []).append((max(a, lo), min(b, hi), n))
    streams = {sid: {"busy_s": _union((a, b) for a, b, _ in ops) / 1e6,
                     "names": sorted({n for _, _, n in ops})}
               for sid, ops in on_stream.items()}
    dev = [(max(a, lo), min(b, hi), n) for a, b, n, _ in dev if b > lo and a < hi]
    busy_us = _union((a, b) for a, b, _ in dev)
    by_kernel = {}
    for a, b, n in dev:
        c, us = by_kernel.get(n, (0, 0.0))
        by_kernel[n] = (c + 1, us + (b - a))
    spans = {}
    for e in host:
        if e.name.startswith("bench.") and e.name != "bench.update":
            s, t = e.time_range.start, e.time_range.end
            launches = sum(1 for a, _, n in dev if s <= a <= t and _is_kernel(n))
            spans.setdefault(e.name[6:], []).append({"start_us": s, "end_us": t,
                                                     "launches": launches})
    gaps = _idle_gaps(sorted(dev), lo, hi, host)
    top = sorted(by_kernel.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "kernels": {n: {"calls": c, "seconds": us / 1e6} for n, (c, us) in by_kernel.items()},
        "spans": spans,
        "device_ops": [[n[:160], us / 1e6] for n, (_, us) in top],
        "idle_gaps": gaps,
        "streams": streams,
    }


def _idle_gaps(dev, lo, hi, host, k: int = 10) -> list:
    """The ``k`` longest stretches of [lo, hi] with no device operation,
    each named by the innermost host operation running at its middle."""
    gaps, end = [], lo
    for a, b, _ in dev:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((hi - end, end, hi))
    gaps = sorted(gaps, reverse=True)[:k]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = max(inner, key=lambda e: e.time_range.start).name if inner else "host"
        named.append([name[:160], length / 1e6])
    return named

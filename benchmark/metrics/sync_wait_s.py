"""Host seconds an update spends blocked on the device: the program's own
``sync.*`` spans (``srl_tpu_torch/utils/trace``: the ``done`` read, the
host-to-device copies that wait for the stream), summed in each per-update
record of the traced window, averaged over its updates.

The window's records (``window``, read by the other program readers too)
are those whose ``update`` lies in [2, 2 + ctx.updates): set-up's first
update is 0 and the profiled update 1, in the order ``run.py`` runs them;
the check's updates come after. None where the program keeps no records (a
program without the tracer)."""
import statistics


def window(ctx) -> list:
    try:
        from srl_tpu_torch.utils import trace
    except ImportError:
        return []
    return [r for r in trace.records() if 2 <= r["update"] < 2 + ctx.updates]


def mean(ctx, value):
    """The mean of ``value(record)`` over the window's records, or None."""
    records = window(ctx)
    return statistics.fmean(value(r) for r in records) if records else None


def read(ctx):
    return mean(ctx, lambda r: sum(s for k, s in r["seconds"].items() if k.startswith("sync.")))

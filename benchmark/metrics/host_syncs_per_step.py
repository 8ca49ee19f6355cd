"""Blocking host syncs of an update over its env steps: the program's
counter ``host_syncs`` (each ``sync`` span) in each per-update record of the
traced window over the traffic's ``n_steps``, averaged (the window as
``metrics/sync_wait_s.py`` reads it)."""
import manifest


def read(ctx):
    n_steps = ctx.cell.traffic["n_steps"]
    return manifest.metric_reader("sync_wait_s").mean(
        ctx, lambda r: r["counts"].get("host_syncs", 0) / n_steps)

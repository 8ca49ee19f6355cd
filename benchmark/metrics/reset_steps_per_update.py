"""Env steps of an update that ran the auto-reset pass (some episode
ended): the program's counter ``reset_steps``, averaged over the per-update
records of the traced window (the window as ``metrics/sync_wait_s.py``
reads it)."""
import manifest


def read(ctx):
    return manifest.metric_reader("sync_wait_s").mean(
        ctx, lambda r: r["counts"].get("reset_steps", 0))

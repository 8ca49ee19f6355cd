"""Host seconds an update spends in the env step's dynamics: the program's
``env.dynamics`` span (step noise and ``apply_step``, ``core/env.VecEnv.
step``), summed in each per-update record of the traced window and averaged
(the window as ``metrics/sync_wait_s.py`` reads it)."""
import manifest


def read(ctx):
    return manifest.metric_reader("sync_wait_s").mean(
        ctx, lambda r: r["seconds"].get("env.dynamics", 0.0))

"""``sync_wait_s``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/sync_wait_s.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("sync_wait_s").read(ctx)

"""``reset_steps_per_update``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/reset_steps_per_update.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("reset_steps_per_update").read(ctx)

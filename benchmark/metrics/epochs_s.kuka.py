"""``epochs_s``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/epochs_s.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("epochs_s").read(ctx)

"""``device_idle_share``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/device_idle_share.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("device_idle_share").read(ctx)

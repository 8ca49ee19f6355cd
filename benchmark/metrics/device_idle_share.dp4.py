"""``device_idle_share``, in the cells whose rate is ``env_steps_per_s.dp4``: the same
reader (``metrics/device_idle_share.py``), on the mean over the ranks of
each card's busy time and length of its profiled update (the ``busy_s`` and
``window_s`` of the result's ``device``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("device_idle_share").read(ctx)

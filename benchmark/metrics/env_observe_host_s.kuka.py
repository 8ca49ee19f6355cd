"""``env_observe_host_s``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/env_observe_host_s.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("env_observe_host_s").read(ctx)

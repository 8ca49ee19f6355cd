"""``host_syncs_per_step``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/host_syncs_per_step.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("host_syncs_per_step").read(ctx)

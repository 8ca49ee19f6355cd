"""``rollout_s``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/rollout_s.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("rollout_s").read(ctx)

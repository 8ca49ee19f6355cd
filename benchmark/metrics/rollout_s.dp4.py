"""``rollout_s``, in the cells whose rate is ``env_steps_per_s.dp4``: the same
reader (``metrics/rollout_s.py``), on rank 0's readings."""
import manifest


def read(ctx):
    return manifest.metric_reader("rollout_s").read(ctx)

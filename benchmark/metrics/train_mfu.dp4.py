"""``train_mfu``, in the cells whose rate is ``env_steps_per_s.dp4``: the same
reader (``metrics/train_mfu.py``), on rank 0's readings."""
import manifest


def read(ctx):
    return manifest.metric_reader("train_mfu").read(ctx)

"""``train_mfu``, in the cells whose rate is ``env_steps_per_s.kuka``: the same
reader (``metrics/train_mfu.py``)."""
import manifest


def read(ctx):
    return manifest.metric_reader("train_mfu").read(ctx)

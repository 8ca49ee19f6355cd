"""``train_mfu`` in the cell of ``mobile_pca``."""
import manifest


def read(ctx):
    return manifest.metric_reader("train_mfu").read(ctx)

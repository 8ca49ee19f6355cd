"""``epochs_s`` in the cell of ``mobile_pca``."""
import manifest


def read(ctx):
    return manifest.metric_reader("epochs_s").read(ctx)

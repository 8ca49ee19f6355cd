"""``peak_mem_gib``, in the cells whose rate is ``env_steps_per_s.dp4``: the same
reader (``metrics/peak_mem_gib.py``), on the peak of the fullest card."""
import manifest


def read(ctx):
    return manifest.metric_reader("peak_mem_gib").read(ctx)

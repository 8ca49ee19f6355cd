"""Seconds of an update's minibatch epochs (``update_epochs``): the mean
of the benchmark's span around each call in the traced window."""
import statistics


def read(ctx):
    s = ctx.spans.get("epochs")
    return statistics.fmean(s) if s else None

"""Seconds of an update's rollout (``collect_rollout``): the mean of the
benchmark's span around each call in the traced window."""
import statistics


def read(ctx):
    s = ctx.spans.get("rollout")
    return statistics.fmean(s) if s else None

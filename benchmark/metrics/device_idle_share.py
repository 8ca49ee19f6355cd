"""The share of the profiled update's (each run's second) wall time in
which no operation ran on the device."""


def read(ctx):
    if not ctx.profile or ctx.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / ctx.profile["window_s"])

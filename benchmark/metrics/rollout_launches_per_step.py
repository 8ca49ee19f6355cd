"""Kernel launches in the profiled update's rollout over its env steps:
the device kernels that start inside the rollout's span, which is
synchronised at both ends. The profiled update is each run's second: the
launches of a step follow how many of its episodes reset, which follows the
update's index."""


def read(ctx):
    spans = ctx.profile["spans"].get("rollout") if ctx.profile else None
    if not spans:
        return None
    return sum(s["launches"] for s in spans) / (len(spans) * ctx.cell.traffic["n_steps"])

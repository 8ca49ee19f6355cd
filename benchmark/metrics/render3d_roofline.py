"""The Kuka ray tracer's share of its roofline: the bound of its bytes at
the cell's envs and traced frame (``counts/render3d.py``) over its mean
device time per call in the profiled update."""
import re

import manifest
import peaks

# The kernel's name in the trace, demangled or not.
KERNEL = re.compile(r"\brender3d_kernel\b")


def read(ctx):
    calls = [v for k, v in ctx.profile["kernels"].items() if KERNEL.search(k)] \
        if ctx.profile else []
    if not calls:
        return None
    n = sum(c["calls"] for c in calls)
    mean_s = sum(c["seconds"] for c in calls) / n
    h, w, ch = ctx.cell.config["frame"]
    nb = ctx.cell.config["env_options"].get("n_buttons", 1)
    count = manifest.counts("render3d")
    envs = ctx.cell.traffic["num_envs"] // ctx.cell.traffic["dp"]
    bound = peaks.roofline_seconds(count.bytes_moved(envs, h, w, nb, ch),
                                   count.flops(envs, h, w, nb, ch))
    return 100.0 * bound / mean_s

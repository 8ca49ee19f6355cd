"""Device seconds of the collectives in rank 0's profiled update: the union
of the operations on each stream that ran an NCCL kernel (NCCL launches its
kernels on streams of its own), summed over those streams. An NCCL kernel
starts when its rank launches it and ends when every rank's data has
passed, so this holds the wait for the last rank to join as well as the
transfer. None where no NCCL kernel ran (a gloo mesh).

NCCL's kernels by name (the profiler's ``nccl:<op>`` ranges are not
kernels); the streams they ran on hold the rest."""

KERNELS = ("ncclDevKernel", "ncclKernel")


def read(ctx):
    if not ctx.profile:
        return None
    streams = [s for s in ctx.profile.get("streams", {}).values()
               if any(n.startswith(KERNELS) for n in s["names"])]
    return sum(s["busy_s"] for s in streams) if streams else None

"""The model step's share of the chip's bfloat16 peak: the model FLOPs of
every update in the traced window (``counts/<network>.py``) over its
seconds and the peak of each chip it ran on."""
import peaks


def read(ctx):
    if not ctx.updates or not ctx.flops_per_update:
        return None
    rate = ctx.flops_per_update * ctx.updates / ctx.window_s
    return 100.0 * rate / peaks.BF16_FLOPS

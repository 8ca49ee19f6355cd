"""The port's operators. The render kernels count their launches in the
tracer (``utils/trace``: ``render3d.launches``, ``render2d.launches``)."""
from srl_tpu_torch.utils import trace

KERNELS = ("render3d", "render2d")


def launches() -> dict:
    """Each render kernel's launches since they were last reset."""
    return {k: trace.counter(f"{k}.launches") for k in KERNELS}


def reset_launches() -> None:
    trace.reset(*(f"{k}.launches" for k in KERNELS))

"""The port's operators. The kernels count their launches in the tracer
(``utils/trace``: ``render3d.launches``, ``render2d.launches``,
``conv1.launches`` for conv1's forward and ``conv1_wgrad.launches`` for its
weight gradient)."""
from srl_tpu_torch.utils import trace

KERNELS = ("render3d", "render2d", "conv1", "conv1_wgrad")


def launches() -> dict:
    """Each kernel's launches since they were last reset."""
    return {k: trace.counter(f"{k}.launches") for k in KERNELS}


def reset_launches() -> None:
    trace.reset(*(f"{k}.launches" for k in KERNELS))

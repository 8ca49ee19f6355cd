"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"`` and never fall back to the CPU on their
own: a caller that wants the CPU (the tests) asks for it.
"""
from __future__ import annotations

import torch

from srl_tpu_torch.utils import trace


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev


def host_tensor(data, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)`` of host data,
    traced as a host sync (``sync.h2d``, ``utils/trace``): on a card, a copy
    from pageable host memory returns only once the stream has drained
    (``cudaStreamSynchronize``), which blocks the host as a read does."""
    with trace.sync("h2d"):
        return torch.as_tensor(data, dtype=dtype, device=device)

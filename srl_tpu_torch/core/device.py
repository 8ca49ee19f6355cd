"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"`` and never fall back to the CPU on their
own: a caller that wants the CPU (the tests) asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev

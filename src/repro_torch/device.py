"""Device resolution for the port's entry points.

``device=None`` means the card.  Without CUDA that is an error, not a quiet
switch to the CPU: the CPU is taken only when the caller asks for it, as the
tests do with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)

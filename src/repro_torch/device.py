"""The port's device rule: ``None`` means the CUDA card, and a CUDA device
without CUDA raises; nothing moves to the CPU unasked."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA device by default and none is available; "
            "pass device='cpu' to run the plain-torch path"
        )
    return dev

"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, and ``None`` means the CUDA card.
Nothing falls back to the CPU on its own: a caller who wants the CPU says
``device="cpu"``, and asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; the port runs on the card by "
            "default. Pass device=\"cpu\" to run on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither 'cuda' nor 'cpu'")
    return dev

"""The kernel ops the models dispatch to under ``kernel_impls``, plus the
launch counters a run reads to show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _rmsnorm


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    return _flash.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {"rmsnorm": _rmsnorm.launches, "flash_attention": _flash.launches}


def reset_launch_counts() -> None:
    _rmsnorm.launches = 0
    _flash.launches = 0

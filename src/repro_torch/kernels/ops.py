"""The kernel ops the models dispatch to under ``kernel_impls``, plus the
launch counters a run reads to show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rmsnorm as _rmsnorm


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    return _flash.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables, context_lens, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    return _paged.paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                                  scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {"rmsnorm": _rmsnorm.launches, "flash_attention": _flash.launches,
            "paged_attention": _paged.launches}


def reset_launch_counts() -> None:
    _rmsnorm.launches = 0
    _flash.launches = 0
    _paged.launches = 0

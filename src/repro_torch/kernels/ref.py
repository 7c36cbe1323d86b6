"""Plain PyTorch versions of the port's kernels.

Each is the specification its CUDA kernel must match, with the same semantics
as ``repro/kernels/ref.py`` (finite ``NEG_INF`` masks included). A kernel
wrapper uses these for tensors on the CPU; on the card they are what
``chip_smoke.py`` holds each kernel against.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,). fp32 math, result in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D) with H % KV == 0. Returns (B,H,Sq,D)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kv, g, sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)

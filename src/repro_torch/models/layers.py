"""Shared building blocks: RMSNorm with its residual-add and gated Mamba2
forms, SwiGLU MLP, rotary embeddings, token embedding and the vocabulary
head — the port of ``repro.models.layers``.

Params are nested dicts of tensors with the same keys and shapes as in
``repro``; every function takes and returns tensors, with the same dtype
casts at the same places so float32 results agree with the JAX twin.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kernel_impl


# --- norms ------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """RMSNorm; pass ``cfg`` to honour its ``kernel_impls['rmsnorm']``
    policy (the CUDA row kernel on serving paths)."""
    if cfg is not None and kernel_impl(cfg, "rmsnorm") == "kernel":
        from repro_torch.kernels.ops import rmsnorm_op
        return rmsnorm_op(x, weight.float(), eps=eps)
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def add_rms_norm(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, eps: float,
                 cfg: Optional[ModelConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): the residual add s = x + h and its RMSNorm y. Under
    ``kernel_impls['rmsnorm'] == 'kernel'`` one launch of the kernel's
    residual form; otherwise ``x + h`` and :func:`rms_norm`, as before."""
    if cfg is not None and kernel_impl(cfg, "rmsnorm") == "kernel":
        from repro_torch.kernels.ops import add_rmsnorm_op
        return add_rmsnorm_op(x, h, weight.float(), eps=eps)
    s = x + h
    return s, rms_norm(s, weight, eps, cfg)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float, cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Mamba2 RMSNormGated: norm(x * silu(gate)) * weight. Under the kernel
    policy one launch of the kernel's gated form, which reads a strided
    ``gate`` in place; otherwise through :func:`rms_norm`."""
    if cfg is not None and kernel_impl(cfg, "rmsnorm") == "kernel":
        from repro_torch.kernels.ops import gated_rmsnorm_op
        return gated_rmsnorm_op(x, gate.to(x.dtype), weight.float(), eps=eps)
    return rms_norm(x * F.silu(gate.to(x.dtype)), weight, eps, cfg)


# --- SwiGLU MLP -------------------------------------------------------------
def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act={cfg.act!r}: only the SwiGLU MLP is ported; the gelu MLP "
            f"comes with the forward/loss_fn slice")
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    gate = x @ p["w_gate"].to(dt)
    return (F.silu(gate) * up) @ p["w_down"].to(dt)


# --- rotary embeddings ------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int. Split-half convention."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].float() * inv  # (B,S,dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- embeddings -------------------------------------------------------------
def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tokens"].to(cfg.compute_dtype)[tokens]


def logits_from_hidden(head_w: torch.Tensor, hidden: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """hidden (B,S,D) -> logits (B,S,Vpad) fp32 with padded columns masked."""
    logits = (hidden @ head_w.to(hidden.dtype)).float()
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9  # in place: logits is a fresh tensor
    return logits

"""Shared building blocks: RMSNorm with its residual-add and gated Mamba2
forms, LayerNorm, the SwiGLU and gelu MLPs, rotary embeddings, token
embedding and the vocabulary head — the port of ``repro.models.layers``.

Params are nested dicts of tensors with the same keys and shapes as in
``repro``; every function takes and returns tensors, with the same dtype
casts at the same places so float32 results agree with the JAX twin.

Under a tensor-parallel group ``tp`` (``distributed.tensor_parallel``) each
rank holds its shard: the MLP is column-parallel in ``w_gate``/``w_up`` and
row-parallel in ``w_down`` (a float32 sum over the group follows), the embedding
and the head are vocab-parallel (a masked local lookup and a sum; the local
columns of the logits and a gather), Mamba2's gated norm sums its rows'
squares over the group, and :func:`cross_entropy` takes the loss from the
rank's columns of the logits without gathering the vocabulary. A tensor
that every rank holds alike enters the split work through
``tensor_parallel.copy_in``, so a backward sums the ranks' gradients of it.
``tp=None`` is the one-device path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kernel_impl
from repro_torch.distributed.tensor_parallel import (all_max, all_sum, copy_in, gather_last,
                                                      row_parallel, tp_size)


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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with bias (hubert-style encoders), statistics in fp32."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * weight.to(dt) + bias.to(dt)


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
                   eps: float, cfg: Optional[ModelConfig] = None, tp=None) -> torch.Tensor:
    """Mamba2 RMSNormGated: norm(x * silu(gate)) * weight. Under the kernel
    policy one launch of the kernel's gated form, which reads a strided
    ``gate`` in place; otherwise through :func:`rms_norm`.

    Under ``tp`` each rank holds its heads' channels of the row, so the
    mean square needs the whole row: each rank's float32 sum of squares of
    ``x * silu(gate)``, summed over the group, divided by the whole width.
    Under the kernel policy that is the kernel's two gated passes (the sums,
    then the norm from the summed sums) around one float32 sum of a value a
    row; otherwise the same steps in plain torch, rounded as
    :func:`rms_norm` rounds."""
    kernel = cfg is not None and kernel_impl(cfg, "rmsnorm") == "kernel"
    if tp_size(tp) == 1:
        if kernel:
            from repro_torch.kernels.ops import gated_rmsnorm_op
            return gated_rmsnorm_op(x, gate.to(x.dtype), weight.float(), eps=eps)
        return rms_norm(x * F.silu(gate.to(x.dtype)), weight, eps, cfg)
    d = x.shape[-1] * tp.size
    if kernel:
        from repro_torch.kernels.ops import gated_rmsnorm_scale_op, gated_rmsnorm_ssq_op
        gate = gate.to(x.dtype)
        ssq = all_sum(gated_rmsnorm_ssq_op(x, gate), tp)
        return gated_rmsnorm_scale_op(x, gate, weight.float(), ssq, d, eps=eps)
    dt = x.dtype
    g = (x * F.silu(gate.to(dt))).float()
    # the summed squares feed every rank's channels: the sum's backward
    # sums the ranks' gradients of it too
    ssq = copy_in(all_sum(g.square().sum(dim=-1, keepdim=True), tp), tp)
    return (g * torch.rsqrt(ssq / d + eps)).to(dt) * weight.to(dt)


def _shard(cfg: ModelConfig, x: torch.Tensor, *axes) -> torch.Tensor:
    """Activation constraint, active only in shard_activations mode."""
    if not cfg.shard_activations:
        return x
    from repro_torch.distributed.sharding import maybe_shard
    return maybe_shard(x, *axes)


# --- dense / SwiGLU MLP -----------------------------------------------------
def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or the plain gelu MLP (``act="gelu"``, the
    tanh approximation, as ``jax.nn.gelu``'s default). Under ``tp`` the
    rank's columns of ``d_ff``, then the sum of the row-parallel
    ``w_down``'s partial products over the group."""
    dt = x.dtype
    x = copy_in(_shard(cfg, x, ("pod", "data"), None, None), tp)
    up = x @ p["w_up"].to(dt)
    if cfg.act == "silu":
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    h = _shard(cfg, h, ("pod", "data"), None, "model")
    return _shard(cfg, row_parallel(h, p["w_down"].to(dt), tp), ("pod", "data"), None, None)


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
def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Token embeddings. Under ``tp`` each rank holds a contiguous slice of
    the vocabulary's rows: it looks up the tokens that fall in it, zeros
    the rest, and the sum over the group gives every token its row."""
    table = p["tokens"].to(cfg.compute_dtype)
    if tp_size(tp) == 1:
        return table[tokens]
    local = tokens - tp.rank * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return all_sum(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                    device=rows.device)), tp)


def local_logits(head_w: torch.Tensor, hidden: torch.Tensor, tp=None) -> torch.Tensor:
    """hidden (B,S,D) -> the logits of the columns ``head_w`` holds, fp32,
    unmasked: under ``tp`` the rank's vocabulary columns."""
    return (copy_in(hidden, tp) @ head_w.to(hidden.dtype)).float()


def logits_from_hidden(head_w: torch.Tensor, hidden: torch.Tensor,
                       cfg: ModelConfig, tp=None) -> torch.Tensor:
    """hidden (B,S,D) -> logits (B,S,Vpad) fp32 with padded columns masked.
    Under ``tp`` ``head_w`` holds the rank's vocabulary columns: their
    logits, gathered over the group by rank, then the mask."""
    logits = _shard(cfg, gather_last(local_logits(head_w, hidden, tp), tp),
                    ("pod", "data"), None, "model")
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9  # in place: logits is a fresh tensor
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                  tp=None, count: Optional[int] = None) -> torch.Tensor:
    """The mean negative log-likelihood of ``labels`` (B,S) under
    ``logits`` (B,S,V) fp32; with ``count`` the sum over ``count`` instead
    (a grid's rank: its labels' share of the global batch's mean, whose
    count it passes). With no group (or a group of one) ``logits``
    is the whole masked vocabulary and this is ``repro``'s CE: a
    ``log_softmax``, then the labels' entries by a gather or, under
    ``shard_activations``, by ``repro``'s partition-friendly masked
    reduction over the vocabulary.

    Under ``tp`` ``logits`` holds the rank's columns of the padded
    vocabulary (:func:`local_logits`), unmasked, and the vocabulary is
    never gathered: the padded columns get ``repro``'s ``-1e9`` on whichever
    rank holds them; each rank takes its rows' maximum and the ranks the
    maximum of those (no gradient: the log-sum-exp does not depend on it);
    each rank sums ``exp`` over its columns and the ranks sum those at
    float32; the label's logit comes from the rank whose columns hold it
    (by the same gather or masked reduction) and the ranks sum it. The
    sums are the "reduce" of ``tensor_parallel``, so the gradient of each
    rank's logits is its columns of ``softmax - onehot``."""
    if tp_size(tp) == 1:
        logp = torch.log_softmax(logits, dim=-1)
        return _mean(-_pick(logp, labels, cfg), count)
    width = logits.shape[-1]
    first = tp.rank * width
    cols = first + torch.arange(width, device=logits.device)
    logits = torch.where(cols < cfg.vocab_size, logits,
                         torch.full((), -1e9, dtype=logits.dtype, device=logits.device))
    m = all_max(logits.amax(dim=-1, keepdim=True), tp)
    sum_exp = all_sum(torch.exp(logits - m).sum(dim=-1), tp)
    local = labels - first
    inside = (local >= 0) & (local < width)
    picked = torch.where(inside, _pick(logits, local.clamp(0, width - 1), cfg),
                         torch.zeros((), dtype=logits.dtype, device=logits.device))
    label_logit = all_sum(picked, tp)
    return _mean(torch.log(sum_exp) + m[..., 0] - label_logit, count)


def _mean(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    return x.mean() if count is None else x.sum() / count


def _pick(x: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x[..., idx]`` for (B,S) ``idx``: a gather, or under
    ``shard_activations`` ``repro``'s masked reduction over the last dim
    (it stays sharded on batch and vocabulary there)."""
    if cfg.shard_activations:
        onehot = torch.arange(x.shape[-1], device=x.device) == idx[..., None]
        return torch.where(onehot, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(-1)
    return x.gather(-1, idx[..., None].long())[..., 0]

"""Attention variants — the port of ``repro.models.attention``: GQA
(optional QKV bias and sliding window) and MLA (DeepSeek multi-head latent
attention: a compressed latent cache, decoded with the up-projections
absorbed).

GQA full-sequence paths take ``repro``'s precedence: the flash-attention
kernel under ``kernel_impls['attention'] == 'kernel'``, then
``attn_impl="chunked"`` (:func:`chunked_mha`, the online-softmax twin of
flash that never materialises the S^2 scores), then ``shard_activations``
(the head-parallel core :func:`_mha_core`), else the einsum reference.
Dense-cache decode attention is the plain einsum over the cache, as in
``repro``; paged decode (:func:`paged_gqa_decode`) always goes through the
paged-attention kernel, as in ``repro``. MLA has no kernel in ``repro``
(``supported_kernel_sites`` leaves its attention site out), so its products
stay plain PyTorch here too. Under ``shard_activations`` every site calls
:func:`repro_torch.distributed.sharding.maybe_shard` with ``repro``'s axes.

Under a tensor-parallel group ``tp`` the GQA paths take the rank's config
(``distributed.tensor_parallel.tp_local``: its query and KV heads) and its
shard of the weights: the projections and the attention core run at the
local head counts (the flash kernel at the per-rank shape, e.g. q (B, 8,
S, 128) with one KV head for qwen2.5-3b on 2 ranks), and the row-parallel
``wo`` is followed by a float32 sum over the group
(``distributed.tensor_parallel.row_parallel``). MLA's prefill and decode do
the same at the rank's heads: each rank computes the latent ``c_kv`` and
the rope'd key whole (``w_dkv`` and ``w_krope`` are whole) and writes the
same entries into its own whole latent cache, while the query, the
absorbed ``w_uk``, the scores, ``w_uv`` and the context run at its heads
and ``wo`` is row-parallel. The full-sequence forward (:func:`attention`,
the path of ``forward`` and ``loss_fn``) runs the same split; the input of
the rank's projections, and MLA's latent and rope'd key before its
head-split products, pass ``tensor_parallel.copy_in``, so a backward sums
the ranks' gradients of them.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kernel_impl
from repro_torch.distributed.tensor_parallel import copy_in, row_parallel
from repro_torch.models.layers import apply_rope

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free

BATCH_AXES = ("pod", "data")


def _shard(cfg: ModelConfig, x: torch.Tensor, *axes) -> torch.Tensor:
    """Activation constraint, active only in shard_activations mode."""
    if not cfg.shard_activations:
        return x
    from repro_torch.distributed.sharding import maybe_shard
    return maybe_shard(x, *axes)


# --- masks ------------------------------------------------------------------
def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) boolean allow-mask from broadcastable position vectors."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    return m


# --- GQA full-sequence ------------------------------------------------------
def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    b, s, _ = x.shape
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Flash-kernel twin of the einsum core. q: (B,S,H,Dh), k/v: (B,S,KV,Dh)
    post-RoPE; the kernel maps query heads to kv heads itself (GQA) and reads
    these layouts through their strides. Returns (B,S,H*Dh)."""
    from repro_torch.kernels.ops import flash_attention_op
    b, s, h, d = q.shape
    out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=cfg.is_autoregressive, window=cfg.sliding_window)
    return out.transpose(1, 2).reshape(b, s, h * d)


def chunked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """Memory-efficient (online-softmax) attention in plain PyTorch, the twin
    of the flash kernel: q and kv go in blocks with running (m, l, acc)
    statistics in fp32, so the S^2 score matrix is never materialised.
    Causal and sliding-window masks apply per block. Every block is
    computed, as in ``repro`` (its ``lax.scan`` cannot skip the masked upper
    triangle), so the numbers and the counted FLOPs equal ``repro``'s. The
    two Python loops are ``repro``'s two scans; ``cfg.unroll`` (a scan's
    unrolling for XLA's cost model) changes nothing here, since a Python
    loop runs, and is counted, block by block.

    q, k, v: (B,S,H,D) post-RoPE, KV already repeated to H. Returns
    (B,S,H*D)."""
    b, s, h, d = q.shape
    cq = min(chunk_q, s)
    ck = min(chunk_k, s)
    pad_q = (-s) % cq
    pad_k = (-s) % ck
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    dt = q.dtype
    scale = d ** -0.5
    causal = cfg.is_autoregressive
    window = cfg.sliding_window
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)
    blocks = []
    for iq in range(nq):
        qc = _shard(cfg, q[:, iq * cq:(iq + 1) * cq], BATCH_AXES, None, "model", None)
        q_pos = iq * cq + ar_q
        m = torch.full((b, h, cq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, cq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            kc, vc = k[:, ik * ck:(ik + 1) * ck], v[:, ik * ck:(ik + 1) * ck]
            sc = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
            sc = _shard(cfg, sc, BATCH_AXES, "model", None, None)
            k_pos = ik * ck + ar_k
            mask = (k_pos < s)[None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            sc = sc.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(dt), vc).float()
            m = m_new
        out = (acc / l.clamp_min(1e-30)).to(dt)           # (b,h,cq,d)
        blocks.append(out.transpose(1, 2))                # (b,cq,h,d)
    out = torch.cat(blocks, dim=1).reshape(b, nq * cq, h * d)
    return out[:, :s]


def _mha_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Head-parallel attention core: q, k, v all (B,S,H,Dh), H over "model"
    in shard_activations mode (the classic TP layout; GQA KV heads repeated
    to H). Returns (B,S,H*Dh)."""
    dt = q.dtype
    b, sq = q.shape[0], q.shape[1]
    q = _shard(cfg, q, BATCH_AXES, None, "model", None)
    k = _shard(cfg, k, BATCH_AXES, None, "model", None)
    v = _shard(cfg, v, BATCH_AXES, None, "model", None)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    scores = _shard(cfg, scores, BATCH_AXES, "model", None, None)
    mask = _attn_mask(positions, positions, causal=cfg.is_autoregressive,
                      window=cfg.sliding_window)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhqs,bshd->bqhd", w, v).reshape(b, sq, -1)


def _full_seq_core(q, k, v, positions, cfg: ModelConfig) -> torch.Tensor:
    """The full-sequence GQA core by ``repro``'s precedence: the flash
    kernel, then ``chunked``, then the head-parallel core under
    ``shard_activations``, else the einsum reference. Returns (B,S,H*Dh)."""
    if kernel_impl(cfg, "attention") == "kernel":
        return _flash_mha(q, k, v, cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    if cfg.attn_impl == "chunked":
        return chunked_mha(q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2), cfg)
    if cfg.shard_activations:
        return _mha_core(q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2),
                         positions, cfg)
    return _einsum_mha(q, k, v, positions, cfg)


def _einsum_mha(q, k, v, positions, cfg: ModelConfig) -> torch.Tensor:
    """Reference GQA core, scores materialised. Returns (B,S,H*Dh)."""
    b, s = q.shape[0], q.shape[1]
    dt = q.dtype
    g = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, s, cfg.n_kv_heads, g, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh, k).float() * scale
    mask = _attn_mask(positions, positions, causal=cfg.is_autoregressive,
                      window=cfg.sliding_window)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim)


def gqa_attention(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Full-sequence attention. x: (B,S,D); under ``tp`` the rank's heads
    (``cfg`` the rank's, ``tensor_parallel.tp_local``) and a row-parallel
    ``wo``."""
    q, k, v = _project_qkv(p, copy_in(x, tp), cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return row_parallel(_full_seq_core(q, k, v, positions, cfg), p["wo"].to(x.dtype), tp)


def gqa_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, tp=None):
    """Full-seq attention that also returns (k, v) for the cache. x: (B,S,D).
    With a sliding window only the last ``sliding_window`` positions of K/V
    are returned (the ring the decode path addresses)."""
    q, k, v = _project_qkv(p, copy_in(x, tp), cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = row_parallel(_full_seq_core(q, k, v, positions, cfg), p["wo"].to(x.dtype), tp)
    if cfg.sliding_window:
        k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
    return out, k, v


# --- GQA decode (KV cache) ---------------------------------------------------
def init_kv_cache_shape(cfg: ModelConfig, batch: int, seq_len: int):
    """Per-layer cache shape (no allocation): (B, S_cache, KV, Dh), or the
    MLA latent cache (B, S, kv_lora_rank + qk_rope_dim)."""
    s_cache = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    if cfg.use_mla:
        return (batch, s_cache, cfg.kv_cache_head_dim)
    return (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)


def _positions(pos, b: int, dev: torch.device):
    """(per_row, pos_t, positions (B,1)) from a scalar or (B,) position. A
    0-d tensor stays on its device (no host read: the dry run passes one on
    ``meta``)."""
    if isinstance(pos, (np.ndarray, torch.Tensor)) and np.ndim(pos) > 0:
        pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        return True, pos_t, pos_t[:, None]
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=dev, dtype=torch.int64)
        return False, pos_t, pos_t.expand(b, 1)
    pos_i = int(pos)
    return (False, torch.tensor(pos_i, dtype=torch.int64, device=dev),
            torch.full((b, 1), pos_i, dtype=torch.int64, device=dev))


def _write_rows(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache[i, slot[i]] = new[i] in place for every row whose slot is in
    bounds; a row out of bounds is dropped, as JAX's ``mode="drop"`` does
    (negative slots wrap first, as in JAX), instead of raising. The dropped
    row writes its own old value back at a clamped index, so no host sync is
    needed."""
    b, s_cache = cache.shape[0], cache.shape[1]
    slot = torch.where(slot < 0, slot + s_cache, slot)
    ok = (slot >= 0) & (slot < s_cache)
    idx = slot.clamp(0, s_cache - 1)
    rows = torch.arange(b, device=cache.device)
    old = cache[rows, idx]
    ok = ok.reshape((b,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(ok, new.to(cache.dtype), old)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos, pos_t: torch.Tensor,
                ring: bool) -> None:
    """cache[:, slot] = new[:, 0] in place for a scalar position, the slot
    clamped into the cache as ``dynamic_update_slice`` clamps (taken modulo
    the cache first for a ring). A 0-d tensor position stays on its device."""
    s_cache = cache.shape[1]
    if isinstance(pos, torch.Tensor):
        slot = (pos_t % s_cache if ring else pos_t).clamp(0, s_cache - 1)
        cache.index_copy_(1, slot.reshape(1), new.to(cache.dtype))
        return
    slot = int(pos) % s_cache if ring else int(pos)
    cache[:, min(max(slot, 0), s_cache - 1)] = new[:, 0].to(cache.dtype)


def gqa_decode(p, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: Union[int, np.ndarray, torch.Tensor], cfg: ModelConfig, tp=None):
    """One-token decode. x: (B,1,D); caches: (B,Sc,KV,Dh); pos: a scalar
    current position, or a (B,) vector giving each row its own position.
    Returns (out, k_cache, v_cache). The caches are updated in place (saves
    a copy of every layer's cache per token); for SWA they are rings of
    width ``sliding_window``."""
    b = x.shape[0]
    dt = x.dtype
    dev = x.device
    per_row, pos_t, positions = _positions(pos, b, dev)
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    s_cache = k_cache.shape[1]
    if per_row:
        slot = pos_t % s_cache if cfg.sliding_window else pos_t  # floor-mod
        _write_rows(k_cache, k[:, 0], slot)
        _write_rows(v_cache, v[:, 0], slot)
    else:
        _write_slot(k_cache, k, pos, pos_t, bool(cfg.sliding_window))
        _write_slot(v_cache, v, pos, pos_t, bool(cfg.sliding_window))
    k_cache = _shard(cfg, k_cache, BATCH_AXES, "model", None, None)
    v_cache = _shard(cfg, v_cache, BATCH_AXES, "model", None, None)
    # positions held in each cache slot, per batch row when pos is a vector
    idx = torch.arange(s_cache, device=dev)
    row_pos = pos_t[:, None] if per_row else pos_t
    if cfg.sliding_window:
        # ring: slot i holds position p with p % Sc == i and p <= pos; slots
        # for positions < 0 were never written -> masked out
        k_pos = row_pos - torch.remainder(torch.remainder(row_pos, s_cache) - idx, s_cache)
    else:
        k_pos = idx.expand(b, s_cache) if per_row else idx
    valid = ((k_pos <= row_pos) & (k_pos >= 0)).expand(b, s_cache)
    g = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh, k_cache.to(dt)).float() * scale
    scores = _shard(cfg, scores, BATCH_AXES, None, None, None, "model")
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.to(dt))
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return row_parallel(out, p["wo"].to(dt), tp), k_cache, v_cache


def paged_gqa_decode(p, x: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     tables: torch.Tensor, pos: torch.Tensor, bids: torch.Tensor,
                     offs: torch.Tensor, cfg: ModelConfig):
    """One-token decode against a block-paged KV pool (single layer), through
    the paged-attention kernel. x: (B,1,D); k_pool/v_pool: (NB,BS,KV,Dh)
    physical blocks; tables: (B,MAXB) per-row block tables; pos: (B,)
    position of the incoming token; bids/offs: (B,) physical slot (block id,
    in-block offset) where this token's K/V lands, reserved by the block
    allocator, so the kernel sees ``pos + 1`` valid positions. Index tensors
    lie on x's device. Returns (out, k_pool, v_pool); the pools are updated
    in place (saves a copy of both pools per layer and token). Inactive rows
    all write to the same null slot: which of them lands there is undefined,
    and that slot is always masked."""
    from repro_torch.kernels.ops import paged_attention_op
    b = x.shape[0]
    dt = x.dtype
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    k_pool[bids, offs] = k[:, 0].to(k_pool.dtype)
    v_pool[bids, offs] = v[:, 0].to(v_pool.dtype)
    out = paged_attention_op(q[:, 0], k_pool, v_pool, tables, pos + 1)  # (B,H,Dh)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(dt)
    return out @ p["wo"].to(dt), k_pool, v_pool


# --- MLA ---------------------------------------------------------------------
def _mla_q(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """(q_nope, q_rope): (B,S,H,nope) and the rope'd (B,S,H,rope)."""
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """(c_kv (B,S,r), k_rope (B,S,rope)): the compressed KV and the shared
    rope'd key of every position."""
    dt = x.dtype
    c_kv = x @ p["w_dkv"].to(dt)
    k_rope = x @ p["w_krope"].to(dt)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]


def _mla_full(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, tp=None):
    """Full-sequence MLA, decompressed formulation: (out (B,S,D), c_kv,
    k_rope). Always causal, as in ``repro``."""
    b, s, _ = x.shape
    dt = x.dtype
    q_nope, q_rope = _mla_q(p, copy_in(x, tp), positions, cfg)
    c_kv, k_rope = _mla_latent(p, x, positions, cfg)      # whole weights, whole on every rank
    c, kr = copy_in(c_kv, tp), copy_in(k_rope, tp)
    k_nope = (c @ p["w_uk"].to(dt)).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim)
    v = (c @ p["w_uv"].to(dt)).reshape(b, s, cfg.n_heads, cfg.v_head_dim)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope = _shard(cfg, q_nope, BATCH_AXES, None, "model", None)
    k_nope = _shard(cfg, k_nope, BATCH_AXES, None, "model", None)
    v = _shard(cfg, v, BATCH_AXES, None, "model", None)
    scores = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, kr)).float() * scale
    scores = _shard(cfg, scores, BATCH_AXES, "model", None, None)
    mask = _attn_mask(positions, positions, causal=True, window=None)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqs,bshd->bqhd", w, v).reshape(b, s, cfg.n_heads * cfg.v_head_dim)
    return row_parallel(out, p["wo"].to(dt), tp), c_kv, k_rope


def mla_attention(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Full-sequence MLA (forward / scoring). x: (B,S,D)."""
    return _mla_full(p, x, positions, cfg, tp)[0]


def mla_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, tp=None):
    """Full-sequence MLA that also returns the latent cache entries
    (B,S,r+rope): c_kv ++ rope'd k_rope."""
    out, c_kv, k_rope = _mla_full(p, x, positions, cfg, tp)
    return out, torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(p, x: torch.Tensor, c_cache: torch.Tensor, pos, cfg: ModelConfig, tp=None):
    """Absorbed-matrix MLA decode over the latent cache (B,S,r+rope). ``pos``
    is a scalar or a (B,) per-row position; each row's entry is written at
    its own position in place (a row out of bounds is dropped, as JAX's
    ``mode="drop"``). W_uk is absorbed into the query and W_uv into the
    output, so scores and context stay in the r-wide latent space.
    Returns (out, c_cache)."""
    b = x.shape[0]
    dt = x.dtype
    r = cfg.kv_lora_rank
    per_row, pos_t, positions = _positions(pos, b, x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)            # (B,1,H,*)
    c_kv, k_rope = _mla_latent(p, x, positions, cfg)
    entry = torch.cat([c_kv, k_rope], dim=-1)                 # (B,1,r+rope)
    s_cache = c_cache.shape[1]
    if per_row:
        _write_rows(c_cache, entry[:, 0], pos_t)
    else:
        _write_slot(c_cache, entry, pos, pos_t, False)
    c_cache = _shard(cfg, c_cache, BATCH_AXES, "model", None)
    cache_c = c_cache[..., :r].to(dt)                         # (B,S,r)
    cache_rope = c_cache[..., r:].to(dt)                      # (B,S,rope)
    w_uk = p["w_uk"].to(dt).reshape(r, cfg.n_heads, cfg.qk_nope_dim)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)      # (B,1,H,r)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, cache_c)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, cache_rope)).float() * scale
    scores = _shard(cfg, scores, BATCH_AXES, None, None, "model")
    row_pos = pos_t[:, None] if per_row else pos_t
    valid = (torch.arange(s_cache, device=x.device) <= row_pos).expand(b, s_cache)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, cache_c)          # (B,1,H,r)
    w_uv = p["w_uv"].to(dt).reshape(r, cfg.n_heads, cfg.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv).reshape(b, 1, cfg.n_heads * cfg.v_head_dim)
    return row_parallel(out, p["wo"].to(dt), tp), c_cache


def attention(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """Full-sequence attention of either kind (the forward path); under
    ``tp`` at the rank's heads, ``cfg`` the rank's."""
    if cfg.use_mla:
        return mla_attention(p, x, positions, cfg, tp)
    return gqa_attention(p, x, positions, cfg, tp)

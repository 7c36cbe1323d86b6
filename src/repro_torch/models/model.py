"""Top-level model API: init / prefill / decode / cache — the port of the
serving half of ``repro.models.model``. ``forward`` and ``loss_fn`` come
with a later slice.

Batch conventions follow ``repro``: prefill takes ``{"tokens": (B,S)}`` and
returns (last-position logits (B,Vpad) fp32, cache); decode takes a (B,1)
token, the cache and a scalar or (B,) position.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.attention import init_kv_cache_shape, paged_gqa_decode
from repro_torch.models.layers import embed_tokens, logits_from_hidden


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: its shape and how ``repro`` initialises it."""
    shape: Tuple[int, ...]
    init: str           # normal (truncated at +-2 scale) | zeros | ones (norm weight) | full
    scale: float = 0.0
    cast: bool = True   # False: every use reads it at param_dtype (router, SSM scalars)
    value: float = 0.0  # the constant of a ``full`` leaf


def _normal(shape, scale: float, cast: bool = True) -> ParamSpec:
    return ParamSpec(tuple(shape), "normal", scale, cast)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``repro.models.model.init_params``: same keys,
    shapes (stacked layer axes first) and scales."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} comes with the forward/loss_fn slice")
    transformer.require_ported(cfg)
    d = cfg.d_model
    stack: Dict[str, Any] = {}
    for seg in transformer.segments_for(cfg):
        n = seg.n
        if seg.kind == "dense":
            stack[seg.name] = _dense_specs(cfg, (n,))
        elif seg.kind == "moe":
            stack[seg.name] = {**_attn_block_specs(cfg, (n,)), "moe": _moe_specs(cfg, n)}
        elif seg.kind == "ssm":
            stack[seg.name] = _mamba_specs(cfg, (n,))
        else:  # hybrid_group: attn_every mamba blocks per group + ONE shared block
            stack[seg.name] = {"mamba": _mamba_specs(cfg, (n, cfg.attn_every)),
                               "shared": _dense_specs(cfg, ())}
    specs: Dict[str, Any] = {
        "embed": {"tokens": _normal((cfg.vocab_padded, d), 0.02)},
        "stack": stack,
        "final_norm": {"w": ParamSpec((d,), "ones")},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _normal((d, cfg.vocab_padded), d ** -0.5)
    return specs


def _attn_block_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """The two pre-norms and the GQA attention of a dense or moe block."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {
        "wq": _normal(lead + (d, h * dh), d ** -0.5),
        "wk": _normal(lead + (d, kv * dh), d ** -0.5),
        "wv": _normal(lead + (d, kv * dh), d ** -0.5),
        "wo": _normal(lead + (h * dh, d), (h * dh) ** -0.5),
    }
    if cfg.qkv_bias:
        attn["bq"] = ParamSpec(lead + (h * dh,), "zeros")
        attn["bk"] = ParamSpec(lead + (kv * dh,), "zeros")
        attn["bv"] = ParamSpec(lead + (kv * dh,), "zeros")
    return {"ln1": {"w": ParamSpec(lead + (d,), "ones")}, "attn": attn,
            "ln2": {"w": ParamSpec(lead + (d,), "ones")}}


def _dense_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """``repro.models.transformer._init_dense_block``'s leaves."""
    d, f = cfg.d_model, cfg.d_ff
    return {**_attn_block_specs(cfg, lead), "mlp": {
        "w_up": _normal(lead + (d, f), d ** -0.5),
        "w_down": _normal(lead + (f, d), f ** -0.5),
        "w_gate": _normal(lead + (d, f), d ** -0.5),
    }}


def _mamba_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """A pre-norm and ``repro.models.ssm.init_mamba``'s leaves. The SSM
    scalars and the conv stay at ``param_dtype`` (``cast=False``): ``repro``
    reads ``A_log``, ``dt_bias``, ``D_skip`` and (at decode) the conv in
    fp32, and casts the conv to the compute dtype only at its prefill use."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    d_in_proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + h  # [z, xBC, dt]
    return {"ln": {"w": ParamSpec(lead + (d,), "ones")}, "mixer": {
        "in_proj": _normal(lead + (d, d_in_proj), d ** -0.5),
        "conv_w": _normal(lead + (cfg.conv_dim, cfg.d_conv), cfg.d_conv ** -0.5, cast=False),
        "conv_b": ParamSpec(lead + (cfg.conv_dim,), "zeros", cast=False),
        "A_log": ParamSpec(lead + (h,), "zeros", cast=False),      # A = -exp(A_log) = -1
        "dt_bias": ParamSpec(lead + (h,), "full", cast=False, value=-2.0),  # softplus ~ 0.13
        "D_skip": ParamSpec(lead + (h,), "ones", cast=False),
        "norm_w": ParamSpec(lead + (di,), "ones"),
        "out_proj": _normal(lead + (di, d), di ** -0.5),
    }}


def _moe_specs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    """``repro.models.moe.init_moe``'s leaves for ``n`` stacked layers."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    p: Dict[str, Any] = {
        "router": ParamSpec((n, d, e), "normal", s_in, cast=False),
        "w_gate": ParamSpec((n, e, d, f), "normal", s_in),
        "w_up": ParamSpec((n, e, d, f), "normal", s_in),
        "w_down": ParamSpec((n, e, f, d), "normal", s_out),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": ParamSpec((n, d, fs), "normal", s_in),
            "w_up": ParamSpec((n, d, fs), "normal", s_in),
            "w_down": ParamSpec((n, fs, d), "normal", fs ** -0.5),
        }
    return p


def _map_specs(fn, specs, *trees):
    if isinstance(specs, ParamSpec):
        return fn(specs, *trees)
    return {k: _map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with ``repro``'s tree, shapes and scales (truncated
    normal at +-2 scale, zero biases, unit norms), drawn from ``generator``
    on ``device``. Not ``repro``'s random stream: for parity, load JAX's
    parameters with :func:`repro_torch.models.weights.params_from_numpy`.

    The truncated normal is drawn by rejection (``normal_``, then redraws of
    the entries outside +-2), not through ``erfinv_``: on the CPU ``erfinv_``
    runs in MKL, whose float32 bits change with the code path MKL picks at
    run time, so the same seed could give other weights in another process
    state. This way the values depend on the generator alone."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}: "
                         f"make the generator with torch.Generator(device={dev.type!r})")
    pd = cfg.param_torch_dtype

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=pd, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=pd, device=dev)
        if spec.init == "full":
            return torch.full(spec.shape, spec.value, dtype=pd, device=dev)
        t = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        t.normal_(generator=generator)
        out = t.abs() > 2.0
        while bool(out.any()):
            t[out] = torch.empty(int(out.sum()), device=dev).normal_(generator=generator)
            out = t.abs() > 2.0
        return t.mul_(spec.scale).to(pd)
    return _map_specs(make, param_specs(cfg))


def cast_params(params, cfg: ModelConfig) -> Dict[str, Any]:
    """Compute-dtype copy of every matrix and bias, made once at load. Every
    use casts to the compute dtype first (as ``p["wq"].astype(dt)`` does in
    ``repro``), so this changes no number; the casts at use are then no-ops.
    Norm weights stay at ``param_dtype`` (the rmsnorm kernel reads them in
    fp32), and so do the MoE router (``route`` reads it in fp32) and the SSM
    scalars and conv (read in fp32, the conv cast at its prefill use). Leaves
    already in the compute dtype are kept, not copied."""
    dt = cfg.compute_dtype
    return _map_specs(lambda spec, t: t if spec.init == "ones" or not spec.cast
                      else t.to(dt), param_specs(cfg), params)


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].T
    return params["lm_head"]


def prefill(params, batch: Dict[str, Any], cfg: ModelConfig):
    """Forward + cache. Returns (last-position logits (B,Vpad) fp32, cache)."""
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x, h, cache = transformer.stack_prefill(params["stack"], x, positions, cfg)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    logits = logits_from_hidden(_head_weight(params, cfg), x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, token: torch.Tensor, cache, pos, cfg: ModelConfig):
    """One decode step. token: (B,1); pos: scalar or (B,) per-row positions.
    Returns (logits (B,Vpad) fp32, cache), the cache updated in place."""
    x = embed_tokens(params["embed"], token, cfg)
    x, h, cache = transformer.stack_decode(params["stack"], x, cache, pos, cfg)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    logits = logits_from_hidden(_head_weight(params, cfg), x, cfg)
    return logits[:, 0], cache


def paged_decode_step(params, token: torch.Tensor, k_pools: torch.Tensor,
                      v_pools: torch.Tensor, tables, pos, bids, offs, cfg: ModelConfig):
    """One decode step against block-paged KV pools, through the
    paged-attention kernel (the ``attn="kernel"`` path of
    :class:`repro_torch.serving.engine.PagedContinuousEngine`). Only defined
    for single-segment GQA models (``serving.kvcache.paged_compatible``).

    token: (B,1); k_pools/v_pools: (L,NB,BS,KV,Dh); tables: (B,MAXB); pos:
    (B,) incoming-token positions; bids/offs: (B,) physical write slots
    (numpy or tensors). Returns (logits (B,Vpad) fp32, k_pools, v_pools),
    the pools updated in place. The index tensors cross to the device once
    per step, before the layer loop, and nothing in the loop waits for the
    device."""
    segs = transformer.segments_for(cfg)
    if len(segs) != 1 or segs[0].kind != "dense":
        raise ValueError(f"paged decode needs one dense segment; {cfg.arch_id} has "
                         f"{[s.kind for s in segs]}")
    dev = k_pools.device
    tables = torch.as_tensor(tables, device=dev).to(torch.int32)
    pos, bids, offs = (torch.as_tensor(t, device=dev).long() for t in (pos, bids, offs))
    x = embed_tokens(params["embed"], token, cfg)
    stack = params["stack"][segs[0].name]
    h = None  # the residual stream is x + h, as in transformer.stack_decode
    for i in range(segs[0].n):
        lp = transformer._layer(stack, i)
        x, h, _, _ = transformer._dense_block(
            lp, x, h, lambda y: paged_gqa_decode(lp["attn"], y, k_pools[i], v_pools[i], tables,
                                                 pos, bids, offs, cfg), cfg)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    logits = logits_from_hidden(_head_weight(params, cfg), x, cfg)
    return logits[:, 0], k_pools, v_pools


# --- cache construction ---------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    """Decode-cache tree of ``meta`` tensors (shape and dtype, no storage):
    K/V per attention layer, the SSM state (fp32) and conv window per
    mamba layer, with ``repro``'s stacked lead axes."""
    def meta(shape, dtype=None):
        return torch.empty(shape, dtype=dtype or cfg.compute_dtype, device="meta")

    ssm_state = (batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    conv = (batch, cfg.d_conv - 1, cfg.conv_dim)
    transformer.require_ported(cfg)
    out: Dict[str, Any] = {}
    for seg in transformer.segments_for(cfg):
        if seg.kind in ("dense", "moe"):
            kv = (seg.n,) + init_kv_cache_shape(cfg, batch, seq_len)
            out[seg.name] = {"k": meta(kv), "v": meta(kv)}
        elif seg.kind == "ssm":
            out[seg.name] = {"state": meta((seg.n,) + ssm_state, torch.float32),
                             "conv": meta((seg.n,) + conv)}
        else:  # hybrid_group
            lead = (seg.n, cfg.attn_every)
            kv = (seg.n,) + init_kv_cache_shape(cfg, batch, seq_len)
            out[seg.name] = {"state": meta(lead + ssm_state, torch.float32),
                             "conv": meta(lead + conv), "k": meta(kv), "v": meta(kv)}
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero-filled decode cache on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_spec(cfg, batch, seq_len))


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

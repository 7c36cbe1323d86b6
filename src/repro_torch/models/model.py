"""Top-level model API: init / forward / loss / prefill / decode / cache —
the port of ``repro.models.model``.

Batch conventions follow ``repro`` (tensors on the model's device):
  forward, loss : {"tokens": (B,S), "labels": (B,S)}                    [LM]
                  {"tokens": (B,S-F), "vision_embeds": (B,F,D),
                   "labels": (B,S-F)}                                   [vlm]
                  {"frames": (B,S,D), "labels": (B,S)}                  [audio]
  prefill       : the same inputs minus labels -> (last-position logits
                  (B,Vpad) fp32, cache)
  decode        : a (B,1) token, the cache and a scalar or (B,) position

``forward``, ``loss_fn``, ``prefill``, ``decode_step``, ``cache_spec`` and
``init_cache`` take a tensor-parallel group ``tp``
(``distributed.tensor_parallel``; None: one device): each rank passes its
shard of the parameters (``distributed.sharding.local_shard``, or
``weights.params_from_numpy`` or ``init_params`` with ``tp``) and of the
cache, runs the same call, and gets the whole logits; ``loss_fn`` takes
its cross-entropy from the rank's vocabulary columns
(``layers.cross_entropy``), and a backward through it gives each rank the
gradient of its shard (``training.train_step``).

``forward`` and ``loss_fn`` also take a grid (``distributed.data_parallel``)
as ``tp``: each rank passes its 2-D shards and its rows of the global batch
(``data_parallel.batch_rows``); the leaves are gathered over ``"data"`` where
they are used (a stacked leaf a layer at a time, inside its remat unit), the
logits are the rank's rows', and the loss and its statistics are the
global batch's on every rank (each rank's cross-entropy its rows' sum over
the global count, summed over ``(pod, data)``; the MoE load-balance
statistics and capacity over the global batch's tokens). Serving
(``prefill``, the decodes) runs on the ``"model"`` axis alone.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.tensor_parallel import all_sum, dp_size, ssm_local, tp_local, tp_size
from repro_torch.models import transformer
from repro_torch.models.attention import init_kv_cache_shape, paged_gqa_decode
from repro_torch.models.layers import (cross_entropy, embed_tokens, local_logits,
                                       logits_from_hidden)


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
    shapes (stacked layer axes first) and scales. The audio frontend feeds
    frame embeddings, so it has no token ``embed``."""
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
    specs: Dict[str, Any] = {}
    if cfg.frontend != "audio":
        specs["embed"] = {"tokens": _normal((cfg.vocab_padded, d), 0.02)}
    specs["stack"] = stack
    specs["final_norm"] = _norm_specs(cfg, ())
    if not cfg.tie_embeddings:
        specs["lm_head"] = _normal((d, cfg.vocab_padded), d ** -0.5)
    return specs


def _norm_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """A norm's leaves: the weight, and LayerNorm's bias for gelu archs."""
    p = {"w": ParamSpec(lead + (cfg.d_model,), "ones")}
    if cfg.act == "gelu":
        p["b"] = ParamSpec(lead + (cfg.d_model,), "zeros")
    return p


def _mla_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """``repro.models.attention.init_attention``'s MLA leaves, and under
    ``mla_latent_norm`` the latent's norm weight ``kv_norm`` (r,), which
    ``repro`` does not have."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    norm = {"kv_norm": ParamSpec(lead + (r,), "ones")} if cfg.mla_latent_norm else {}
    return {
        "wq": _normal(lead + (d, cfg.q_dim), d ** -0.5),
        "w_dkv": _normal(lead + (d, r), d ** -0.5),
        "w_krope": _normal(lead + (d, cfg.qk_rope_dim), d ** -0.5),
        "w_uk": _normal(lead + (r, h * cfg.qk_nope_dim), r ** -0.5),
        "w_uv": _normal(lead + (r, h * cfg.v_head_dim), r ** -0.5),
        "wo": _normal(lead + (h * cfg.v_head_dim, d), (h * cfg.v_head_dim) ** -0.5),
        **norm,
    }


def _attn_block_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """The two pre-norms and the attention (GQA or MLA) of a dense or moe
    block."""
    if cfg.use_mla:
        return {"ln1": _norm_specs(cfg, lead), "attn": _mla_specs(cfg, lead),
                "ln2": _norm_specs(cfg, lead)}
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
    return {"ln1": _norm_specs(cfg, lead), "attn": attn, "ln2": _norm_specs(cfg, lead)}


def _dense_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """``repro.models.transformer._init_dense_block``'s leaves (the gelu
    MLP has no gate)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"w_up": _normal(lead + (d, f), d ** -0.5),
           "w_down": _normal(lead + (f, d), f ** -0.5)}
    if cfg.act == "silu":
        mlp["w_gate"] = _normal(lead + (d, f), d ** -0.5)
    return {**_attn_block_specs(cfg, lead), "mlp": mlp}


def _mamba_specs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    """A pre-norm and ``repro.models.ssm.init_mamba``'s leaves, at the
    widths of ``ssm_local`` with no group: the whole tree, which
    ``init_params`` draws (a rank keeps its ``sharding.local_shard``). The
    SSM scalars and the conv stay at ``param_dtype`` (``cast=False``):
    ``repro`` reads ``A_log``, ``dt_bias``, ``D_skip`` and (at decode) the
    conv in fp32, and casts the conv to the compute dtype only at its
    prefill use."""
    loc = ssm_local(cfg)
    d, di, h = cfg.d_model, loc.d_inner, loc.n_heads
    d_in_proj = 2 * di + 2 * loc.n_groups * cfg.ssm_state + h  # [z, xBC, dt]
    return {"ln": _norm_specs(cfg, lead), "mixer": {
        "in_proj": _normal(lead + (d, d_in_proj), d ** -0.5),
        "conv_w": _normal(lead + (loc.conv_dim, cfg.d_conv), cfg.d_conv ** -0.5, cast=False),
        "conv_b": ParamSpec(lead + (loc.conv_dim,), "zeros", cast=False),
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
                device: DeviceLike = None, tp=None) -> Dict[str, Any]:
    """Random parameters with ``repro``'s tree, shapes and scales (truncated
    normal at +-2 scale, zero biases, unit norms), drawn from ``generator``
    on ``device``. Not ``repro``'s random stream: for parity, load JAX's
    parameters with :func:`repro_torch.models.weights.params_from_numpy`.

    The truncated normal is drawn by rejection (``normal_``, then redraws of
    the entries outside +-2, :func:`_redraw_outside`), not through
    ``erfinv_``: on the CPU ``erfinv_`` runs in MKL, whose float32 bits
    change with the code path MKL picks at run time, so the same seed could
    give other weights in another process state. This way the values depend
    on the generator alone.

    Under a tensor-parallel group ``tp`` (``distributed.tensor_parallel``)
    only this rank's shard of each leaf is kept
    (``distributed.sharding.local_shard``): every leaf is still drawn whole,
    in the same order from the same stream, and cut and cast before the
    next one is drawn, so the values are those of the whole tree's shards
    and a rank's peak is its shards plus one whole leaf at float32."""
    from repro_torch.distributed.sharding import local_shard  # it imports this module
    tp_local(cfg, tp)   # an architecture tensor parallelism does not cover raises
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}: "
                         f"make the generator with torch.Generator(device={dev.type!r})")
    pd = cfg.param_torch_dtype

    def make(spec: ParamSpec, names: Tuple[str, ...]) -> torch.Tensor:
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=pd, device=dev)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=pd, device=dev)
        elif spec.init == "full":
            t = torch.full(spec.shape, spec.value, dtype=pd, device=dev)
        else:
            t = torch.empty(spec.shape, dtype=torch.float32, device=dev)
            t.normal_(generator=generator)
            _redraw_outside(t, generator)
            t.mul_(spec.scale)
        return local_shard(t, names, cfg, tp, dtype=pd)
    return _map_named_specs(make, param_specs(cfg))


def params_meta(cfg: ModelConfig) -> Dict[str, Any]:
    """The whole parameter tree as ``meta`` tensors at ``param_dtype``
    (shapes and dtypes, no storage): a template to restore a checkpoint
    into, sharded or not (``init_opt_state`` of it, the optimizer's)."""
    return _map_specs(lambda spec: torch.empty(spec.shape, dtype=cfg.param_torch_dtype,
                                               device="meta"), param_specs(cfg))


def _map_named_specs(fn, specs, names: Tuple[str, ...] = ()):
    """``fn(spec, path)`` over a spec tree, in its order."""
    if isinstance(specs, ParamSpec):
        return fn(specs, names)
    return {k: _map_named_specs(fn, v, names + (k,)) for k, v in specs.items()}


# elements of one slice in :func:`_redraw_outside`
_SLICE = 1 << 26


def _redraw_outside(t: torch.Tensor, generator: torch.Generator) -> None:
    """Redraw the entries of ``t`` (contiguous fp32) outside +-2 until none
    is left: each round draws as many normals as there are such entries
    and writes them to those entries in row-major order, which is what
    ``t[t.abs() > 2] = draw`` does. The mask, its counts and the writes go
    slice by slice, so no temporary is as large as ``t``: over a whole
    stacked expert leaf (4.8 G elements for deepseek-v2-lite-16b) the sum
    of the mask alone takes an int64 copy of it, 38 GB."""
    flat = t.view(-1)
    out = torch.empty(flat.shape, dtype=torch.bool, device=t.device)
    slices = [slice(lo, lo + _SLICE) for lo in range(0, flat.numel(), _SLICE)]
    while True:
        for sl in slices:
            torch.gt(flat[sl].abs(), 2.0, out=out[sl])
        counts = torch.stack([torch.count_nonzero(out[sl]) for sl in slices]).tolist()
        if sum(counts) == 0:
            return
        draw = torch.empty(sum(counts), device=t.device).normal_(generator=generator)
        at = 0
        for sl, k in zip(slices, counts):
            if k:
                flat[sl][out[sl]] = draw[at:at + k]
                at += k


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


def _embed_inputs(params, batch: Dict[str, Any], cfg: ModelConfig, tp=None):
    """(hidden (B,S,D), positions (B,S)): token embeddings (vocab-parallel
    under ``tp``), the audio frames, or the vision patches followed by the
    text's embeddings."""
    if cfg.frontend == "audio":
        x = batch["frames"].to(cfg.compute_dtype)
    elif cfg.frontend == "vision":
        tok = embed_tokens(params["embed"], batch["tokens"], cfg, tp)
        x = torch.cat([batch["vision_embeds"].to(cfg.compute_dtype), tok], dim=1)
    else:
        x = embed_tokens(params["embed"], batch["tokens"], cfg, tp)
    b, s = x.shape[0], x.shape[1]
    if cfg.shard_activations:
        from repro_torch.distributed.sharding import maybe_shard
        x = maybe_shard(x, ("pod", "data"), None, None)
    return x, torch.arange(s, device=x.device).expand(b, s)


def _gathered(params, cfg: ModelConfig, tp=None):
    """``params`` with the leaves outside the stack made whole on a grid's
    ``"data"`` axis (the stack's go a layer at a time, :func:`_hidden`);
    ``params`` itself without one."""
    if tp is None or tp.data_size == 1:
        return params
    from repro_torch.distributed.data_parallel import gather_tree
    return {k: v if k == "stack" else gather_tree(v, (k,), cfg, tp) for k, v in params.items()}


def _hidden(params, batch: Dict[str, Any], cfg: ModelConfig, tp=None):
    """(the final norm's output on the positions that get logits, aux): the
    text positions only under the vision frontend. ``params`` are
    :func:`_gathered`'s."""
    local = tp_local(cfg, tp)   # raises first for a config that does not split
    gather = None
    if tp is not None and tp.data_size > 1:
        from repro_torch.distributed.data_parallel import gather_tree
        gather = functools.partial(gather_tree, cfg=cfg, grid=tp)
    x, positions = _embed_inputs(params, batch, cfg, tp)
    x, h, aux = transformer.stack_forward(params["stack"], x, positions, local, tp, gather)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    if cfg.frontend == "vision":
        x = x[:, batch["vision_embeds"].shape[1]:]
    return x, aux


def forward(params, batch: Dict[str, Any], cfg: ModelConfig, tp=None):
    """Full-sequence forward -> (logits (B,S,Vpad) fp32, aux), the logits
    on the text positions only under the vision frontend; ``aux["lb_loss"]``
    is the MoE load-balance loss summed over layers. Under ``tp`` the
    whole logits, gathered as ``prefill`` gathers them, on every rank (of
    the rank's rows under a grid)."""
    params = _gathered(params, cfg, tp)
    x, aux = _hidden(params, batch, cfg, tp)
    return logits_from_hidden(_head_weight(params, cfg), x, cfg, tp), aux


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig, lb_coef: float = 0.01, tp=None):
    """Mean next-token (or, encoder-only, frame-label) cross-entropy plus
    ``lb_coef`` times the MoE load-balance loss. Returns (loss, metrics
    {"ce", "lb_loss", "loss"}). Under ``tp`` the cross-entropy comes from
    each rank's vocabulary columns, never gathered
    (``layers.cross_entropy``); every rank returns the same values. Under a
    grid ``batch`` is the rank's rows and every value is the global
    batch's: the rank's cross-entropy is its labels' sum over the global
    count, and the sum of those over ``(pod, data)`` (``all_sum``, whose
    backward is the identity, so each rank back-propagates its own
    tokens' share)."""
    labels = batch["labels"]
    params = _gathered(params, cfg, tp)
    x, aux = _hidden(params, batch, cfg, tp)
    if tp_size(tp) == 1:
        logits = logits_from_hidden(_head_weight(params, cfg), x, cfg)
    else:
        logits = local_logits(_head_weight(params, cfg), x, tp)
    if cfg.is_autoregressive:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    n_dp = dp_size(tp)
    ce = cross_entropy(logits, labels, cfg, tp, None if n_dp == 1 else labels.numel() * n_dp)
    if n_dp > 1:
        ce = all_sum(ce, tp.batch)
    total = ce + lb_coef * aux["lb_loss"]
    return total, {"ce": ce, "lb_loss": aux["lb_loss"], "loss": total}


def _model_axis_only(tp, what: str) -> None:
    if dp_size(tp) > 1:
        raise ValueError(f"{what} runs on a group's \"model\" axis alone, not on a grid with "
                         f"(pod, data) {tp.dims[:2]}: serve from a TPGroup")


def prefill(params, batch: Dict[str, Any], cfg: ModelConfig, tp=None):
    """Forward + cache. Returns (last-position logits (B,Vpad) fp32, cache);
    under ``tp`` the rank's cache shard and the whole logits."""
    _model_axis_only(tp, "prefill")
    local = tp_local(cfg, tp)   # raises first for an architecture tp does not cover
    x, positions = _embed_inputs(params, batch, cfg, tp)
    x, h, cache = transformer.stack_prefill(params["stack"], x, positions, local, tp)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    logits = logits_from_hidden(_head_weight(params, cfg), x[:, -1:], cfg, tp)
    return logits[:, 0], cache


def decode_pieces(params, cache, pos, cfg: ModelConfig, tp=None):
    """:func:`decode_step` cut at each MoE layer's feed-forward (the stack's
    :func:`transformer.decode_pieces`, the embedding put before its first
    piece and the final norm and head after its last): (pieces, moes), one
    more piece than MoE layers. ``pieces[0]`` takes the (B,1) token, every
    later piece ``(x, h)``, h the output of the MoE layer before it; a piece
    below the last returns ``(x, y)``, y the input of its MoE layer
    ``moes[k]``, and the last returns ``(logits (B,Vpad) fp32,)``. A stack
    with no moe segment is one piece. :func:`run_pieces` composes them."""
    _model_axis_only(tp, "decode_step")
    local = tp_local(cfg, tp)
    stack, moes = transformer.decode_pieces(params["stack"], cache, pos, local, tp)
    last = len(stack) - 1

    def piece(k, *args):
        if k == 0:
            x, h = embed_tokens(params["embed"], args[0], cfg, tp), None
        else:
            x, h = args
        x, y = stack[k](x, h)
        if k < last:
            return x, y
        _, x = transformer._add_norm(x, y, params["final_norm"], cfg)
        return (logits_from_hidden(_head_weight(params, cfg), x, cfg, tp)[:, 0],)
    return [functools.partial(piece, k) for k in range(last + 1)], moes


def run_pieces(pieces, moes, token: torch.Tensor) -> torch.Tensor:
    """The logits of :func:`decode_pieces`' pieces and MoE layers run in
    order."""
    out = pieces[0](token)
    for moe, piece in zip(moes, pieces[1:]):
        x, y = out
        out = piece(x, moe(y))
    return out[0]


def decode_step(params, token: torch.Tensor, cache, pos, cfg: ModelConfig, tp=None):
    """One decode step. token: (B,1); pos: scalar or (B,) per-row positions.
    Returns (logits (B,Vpad) fp32, cache), the cache updated in place.
    Eager (its span counts ``graphed`` 0): the engines' CUDA graphs of the
    same pieces are :class:`repro_torch.models.decode_graphs.DecodeGraphs`."""
    with spans.span("model.decode_step"):
        spans.count(graphed=0)
        return run_pieces(*decode_pieces(params, cache, pos, cfg, tp), token), cache


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
    with spans.span("model.decode_step"):
        spans.count(graphed=0)
        segs = transformer.segments_for(cfg)
        if len(segs) != 1 or segs[0].kind != "dense":
            raise ValueError(f"paged decode needs one dense segment; {cfg.arch_id} has "
                             f"{[s.kind for s in segs]}")
        dev = k_pools.device
        tables = torch.as_tensor(tables, device=dev).to(torch.int32)
        pos, bids, offs = (torch.as_tensor(t, device=dev).long() for t in (pos, bids, offs))
        x = embed_tokens(params["embed"], token, cfg)
        stack = params["stack"][segs[0].name]
        h = None  # the residual stream is x + h, as in transformer.decode_pieces
        for i in range(segs[0].n):
            lp = transformer._layer(stack, i)
            x, h, *_ = transformer._dense_block(
                lp, x, h, lambda y: paged_gqa_decode(lp["attn"], y, k_pools[i], v_pools[i], tables,
                                                     pos, bids, offs, cfg), cfg)
        _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
        logits = logits_from_hidden(_head_weight(params, cfg), x, cfg)
        return logits[:, 0], k_pools, v_pools


# --- cache construction ---------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, tp=None) -> Dict[str, Any]:
    """Decode-cache tree of ``meta`` tensors (shape and dtype, no storage):
    K/V per attention layer (the latent ``c`` under MLA), the SSM state
    (fp32) and conv window per mamba layer, with ``repro``'s stacked lead
    axes; under ``tp`` the rank's KV heads, SSM heads and conv channels
    (``tensor_parallel.ssm_local``)."""
    cfg = tp_local(cfg, tp)
    loc = ssm_local(cfg, tp)

    def meta(shape, dtype=None):
        return torch.empty(shape, dtype=dtype or cfg.compute_dtype, device="meta")

    ssm_state = (batch, loc.n_heads, cfg.ssm_headdim, cfg.ssm_state)
    conv = (batch, cfg.d_conv - 1, loc.conv_dim)
    out: Dict[str, Any] = {}
    for seg in transformer.segments_for(cfg):
        if seg.kind in ("dense", "moe"):
            kv = (seg.n,) + init_kv_cache_shape(cfg, batch, seq_len)
            out[seg.name] = {"c": meta(kv)} if cfg.use_mla else {"k": meta(kv), "v": meta(kv)}
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
               device: DeviceLike = None, tp=None) -> Dict[str, Any]:
    """Zero-filled decode cache on ``device`` (the rank's shard under
    ``tp``)."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_spec(cfg, batch, seq_len, tp))


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

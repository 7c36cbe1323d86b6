"""Stack composition — the port of ``repro.models.transformer``.

A trunk is an ordered list of segments of stacked layers. ``repro`` walks the
stacked layer axis with ``lax.scan``; here a Python loop walks it. Families:

  dense/vlm/audio : [dense x L]
  moe             : [dense x first_dense] + [moe x (L - first_dense)]
  ssm             : [mamba x L]
  hybrid (zamba2) : [group x (L // attn_every)], each group = attn_every
                    mamba blocks + ONE shared attention+MLP block whose
                    params are common to all groups

Each segment runs in three modes: forward (full sequence, no cache),
prefill (forward + cache emission) and decode (one token against the
cache). Dense and moe blocks attend with GQA or, under ``use_mla``, MLA
(a latent cache ``{"c": ...}`` in place of ``{"k", "v"}``).

The forward, prefill and decode take a tensor-parallel group ``tp`` (None:
one device) with the rank's config (``distributed.tensor_parallel.tp_local``)
and its shard of the weights (and of the cache); every rank runs the same
loop and a
dense or moe block's attention (GQA or MLA) and its MLP or MoE meet at a
sum over the group each; a mamba block's gated norm and ``out_proj`` meet
at one each (zamba2's shared block is a dense block).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import add_rms_norm, apply_mlp, layer_norm, rms_norm


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str  # dense | moe | ssm | hybrid_group
    n: int     # number of stacked layers


def segments_for(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm", "audio"):
        return [Segment("dense", "dense", cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment("dense0", "dense", cfg.first_dense_layers))
        segs.append(Segment("moe", "moe", cfg.n_layers - cfg.first_dense_layers))
        return segs
    if cfg.family == "ssm":
        return [Segment("ssm", "ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"hybrid: n_layers={cfg.n_layers} is not a "
                             f"multiple of attn_every={cfg.attn_every}")
        return [Segment("hybrid", "hybrid_group", cfg.n_layers // cfg.attn_every)]
    raise ValueError(f"unknown family {cfg.family!r}")


def _add_norm(x: torch.Tensor, h: Optional[torch.Tensor], p,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + h, its norm): the residual add of the previous block's delta
    ``h`` folded into the next norm (one launch of the rmsnorm kernel's
    residual form under ``auto``). ``h`` is None before the first norm of
    the stack, which follows the embedding and no add: (x, norm(x)). gelu
    archs (hubert) norm with LayerNorm, which has no kernel: the add, then
    :func:`layer_norm`, as ``repro`` computes it."""
    if cfg.act == "gelu":
        s = x if h is None else x + h
        return s, layer_norm(s, p["w"], p["b"], cfg.norm_eps)
    if h is None:
        return x, rms_norm(x, p["w"], cfg.norm_eps, cfg)
    return add_rms_norm(x, h, p["w"], cfg.norm_eps, cfg)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked-parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _layers(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers of a stacked-parameter tree, each leaf split once
    with ``unbind`` (views, no copies). The same values as :func:`_layer`,
    but a backward writes each stacked leaf's gradient with one ``stack``;
    through ``v[i]`` it zero-fills a whole stacked leaf for every layer and
    sums the ``n`` of them, ``n`` times the traffic of the leaf."""
    parts = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# Every block takes the residual stream as (x, h): the stream is x + h, with
# h the previous block's delta not yet added (None at the stack's start),
# and returns its own (x, delta). The add happens in the next norm, and the
# stack's last delta goes into the final norm.
def _attn_half(p, x: torch.Tensor, h: Optional[torch.Tensor], attend, cfg: ModelConfig):
    """The attention half of a dense or moe block: ``attend`` maps the
    normed input to (attention output, *rest). Returns (x, the
    feed-forward's normed input, *rest)."""
    x, y = _add_norm(x, h, p["ln1"], cfg)
    a, *rest = attend(y)
    x, y = _add_norm(x, a, p["ln2"], cfg)
    return (x, y, *rest)


def _ff_half(p, y: torch.Tensor, cfg: ModelConfig, tp=None):
    """The feed-forward half of a dense or moe block on its normed input:
    (delta, the MoE load-balance loss or None). The MLP of a dense layer,
    the MoE of a moe layer (prefill and decode run it too, as ``repro``'s
    bodies do); under ``tp`` the MLP and the MoE are tensor-parallel."""
    if "mlp" in p:
        return apply_mlp(p["mlp"], y, cfg, tp), None
    out, aux = moe_mod.apply_moe(p["moe"], y, cfg, tp=tp)
    return out, aux["lb_loss"]


def _dense_block(p, x: torch.Tensor, h: Optional[torch.Tensor], attend, cfg: ModelConfig,
                 tp=None):
    """A dense or moe block, :func:`_attn_half` then :func:`_ff_half`.
    Returns (x, feed-forward delta, the MoE load-balance loss or None,
    *rest)."""
    x, y, *rest = _attn_half(p, x, h, attend, cfg)
    delta, lb = _ff_half(p, y, cfg, tp)
    return (x, delta, lb, *rest)


def _dense_prefill(p, x: torch.Tensor, h: Optional[torch.Tensor], positions: torch.Tensor,
                   cfg: ModelConfig, tp=None):
    """A dense or moe block at prefill: (x, delta, lb, k, v), or (x, delta,
    lb, latent) under MLA."""
    if cfg.use_mla:
        def attend(y):
            return attn_mod.mla_prefill(p["attn"], y, positions, cfg, tp)
    else:
        def attend(y):
            return attn_mod.gqa_prefill(p["attn"], y, positions, cfg, tp)
    return _dense_block(p, x, h, attend, cfg, tp)


def _ssm_prefill(p, x: torch.Tensor, h: Optional[torch.Tensor], cfg: ModelConfig, tp=None):
    """A mamba block (pre-norm + mixer) at prefill: (x, delta, state, conv
    tail); under ``tp`` the rank's heads of the state and channels of the
    tail."""
    x, y = _add_norm(x, h, p["ln"], cfg)
    delta, state, tail = ssm_mod.mamba_block(p["mixer"], y, cfg, tp=tp)
    return x, delta, state, tail


def _dense_forward(p, x: torch.Tensor, h: Optional[torch.Tensor], positions: torch.Tensor,
                   cfg: ModelConfig, tp=None):
    """A dense or moe block of the full-sequence forward: (x, delta, lb)."""
    return _dense_block(
        p, x, h, lambda y: (attn_mod.attention(p["attn"], y, positions, cfg, tp),), cfg, tp)


# the products whose outputs ``"dots_saveable"`` keeps for the backward, as
# ATen ops (what the selective-checkpoint policy sees): JAX's dots_saveable
# keeps every dot_general, which the port's matmuls and einsums lower to
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``repro``'s ``_remat``: ``"none"`` runs ``fn`` as it is, ``"full"``
    keeps only its inputs and recomputes the rest in the backward,
    ``"dots_saveable"`` keeps the outputs of the products and recomputes the
    rest. Anything else raises ``ValueError``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots_saveable":
        context_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    raise ValueError(cfg.remat)


def _no_gather(tree, prefix):
    return tree


def stack_forward(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                  tp=None, gather=None):
    """Full-sequence forward, no cache. Returns (x, h, aux): the hidden
    state x + h as in :func:`stack_prefill`, and ``aux["lb_loss"]``, the
    MoE load-balance loss summed over the moe layers (0 without any; the
    same on every rank of ``tp``, since every rank routes every token).

    ``cfg.remat`` wraps each unit ``repro`` wraps (:func:`_remat`): every
    dense, moe and ssm layer, and every hybrid group (its ``attn_every``
    mamba layers and the shared block). A unit maps (x, h) to (x, h, lb),
    so the residual delta carried to the next norm stays inside it. Under
    ``tp`` a unit's collectives sit inside it, so ``"full"`` repeats them
    in the backward's recompute, every rank in the same order.

    ``gather(tree, path)`` (under a grid's ``"data"`` axis,
    ``data_parallel.gather_tree``) makes a layer's shards whole on
    ``"data"``, inside its unit, each mamba layer of a hybrid group on its
    own; the hybrid's shared block once, before the groups."""
    gather = gather or _no_gather

    def dense(path, lp, x, h):
        return _dense_forward(gather(lp, path), x, h, positions, cfg, tp)

    def ssm(path, lp, x, h):
        x, h, _, _ = _ssm_prefill(gather(lp, path), x, h, cfg, tp)
        return x, h, None

    def group(path, gp, shared, x, h):
        for lp in _layers(gp, cfg.attn_every):
            x, h, _, _ = _ssm_prefill(gather(lp, path), x, h, cfg, tp)
        return _dense_forward(shared, x, h, positions, cfg, tp)

    h = None
    lbs = []
    for seg in segments_for(cfg):
        p = params[seg.name]
        if seg.kind in ("dense", "moe", "ssm"):
            unit = _remat(functools.partial(ssm if seg.kind == "ssm" else dense,
                                            ("stack", seg.name)), cfg)
            for lp in _layers(p, seg.n):
                x, h, lb = unit(lp, x, h)
                if lb is not None:
                    lbs.append(lb)
        else:  # hybrid_group
            unit = _remat(functools.partial(group, ("stack", seg.name, "mamba")), cfg)
            shared = gather(p["shared"], ("stack", seg.name, "shared"))
            for gp in _layers(p["mamba"], seg.n):
                x, h, _ = unit(gp, shared, x, h)
    lb = (torch.stack(lbs).sum() if lbs
          else torch.zeros((), dtype=torch.float32, device=x.device))
    return x, h, {"lb_loss": lb}


def stack_prefill(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, tp=None):
    """Returns (x, h, cache dict): the hidden state is x + h, h the last
    block's delta, which the final norm adds. Cache leaves carry the stacked
    layer axes first, as in ``repro``."""
    cache: Dict[str, Any] = {}
    h = None
    for seg in segments_for(cfg):
        p = params[seg.name]
        if seg.kind in ("dense", "moe"):
            entries = []
            for i in range(seg.n):
                x, h, _, *kv = _dense_prefill(_layer(p, i), x, h, positions, cfg, tp)
                entries.append(kv)
            keys = ("c",) if cfg.use_mla else ("k", "v")
            cache[seg.name] = {key: torch.stack([e[j] for e in entries])
                               for j, key in enumerate(keys)}
        elif seg.kind == "ssm":
            states, tails = [], []
            for i in range(seg.n):
                x, h, st, tail = _ssm_prefill(_layer(p, i), x, h, cfg, tp)
                states.append(st)
                tails.append(tail)
            cache[seg.name] = {"state": torch.stack(states), "conv": torch.stack(tails)}
        else:  # hybrid_group
            states, tails, ks, vs = [], [], [], []
            for i in range(seg.n):
                group = _layer(p["mamba"], i)
                sts, tls = [], []
                for j in range(cfg.attn_every):
                    x, h, st, tail = _ssm_prefill(_layer(group, j), x, h, cfg, tp)
                    sts.append(st)
                    tls.append(tail)
                x, h, _, k, v = _dense_prefill(p["shared"], x, h, positions, cfg, tp)
                states.append(torch.stack(sts))
                tails.append(torch.stack(tls))
                ks.append(k)
                vs.append(v)
            cache[seg.name] = {"state": torch.stack(states), "conv": torch.stack(tails),
                               "k": torch.stack(ks), "v": torch.stack(vs)}
    return x, h, cache


def _decode_attend(p, c, pos, cfg: ModelConfig, tp=None):
    """A dense or moe block's decode attention on one layer's cache leaves
    ``c``, which it writes the token's K/V (or its latent entry under MLA)
    into, in place."""
    if cfg.use_mla:
        return lambda y: attn_mod.mla_decode(p["attn"], y, c["c"], pos, cfg, tp)
    return lambda y: attn_mod.gqa_decode(p["attn"], y, c["k"], c["v"], pos, cfg, tp)


def _attn_decode(p, c, pos, cfg: ModelConfig, tp, x: torch.Tensor, h: Optional[torch.Tensor]):
    """The attention half of a block at decode: (x, the feed-forward's
    normed input)."""
    x, y, *_ = _attn_half(p, x, h, _decode_attend(p, c, pos, cfg, tp), cfg)
    return x, y


def _dense_decode(p, c, pos, cfg: ModelConfig, tp, x: torch.Tensor, h: Optional[torch.Tensor]):
    """A dense or moe block at decode: (x, delta)."""
    x, y = _attn_decode(p, c, pos, cfg, tp, x, h)
    return x, _ff_half(p, y, cfg, tp)[0]


def _ssm_decode(p, state: torch.Tensor, conv: torch.Tensor, cfg: ModelConfig, tp,
                x: torch.Tensor, h: Optional[torch.Tensor]):
    """A mamba block at decode: (x, delta). ``state`` and ``conv`` (one
    layer's rows of the cache) are overwritten in place once the step is
    computed: the new conv window is a slice of a fresh ``cat``, so nothing
    reads a half-written window."""
    x, y = _add_norm(x, h, p["ln"], cfg)
    delta, new_state, new_conv = ssm_mod.mamba_decode(p["mixer"], y, state, conv, cfg, tp)
    state.copy_(new_state)
    conv.copy_(new_conv)
    return x, delta


def _chain(fns):
    def run(x, h):
        for fn in fns:
            x, h = fn(x, h)
        return x, h
    return run


def decode_pieces(params, cache, pos, cfg: ModelConfig, tp=None):
    """The one-token decode cut at each moe layer's feed-forward: (pieces,
    ffs), one more piece than feed-forwards. Every piece maps the residual
    stream (x, h) to (x, y): for ``pieces[k]`` below the last, y is the
    normed input of ``ffs[k]``, which maps it to the next piece's h; for
    the last, y is the stack's last delta. Each works on the layers'
    parameters and cache leaves as views, and on ``pos`` as given, so a
    piece holds the addresses it reads and writes (the cache in place)."""
    pieces, ffs = [[]], []
    for seg in segments_for(cfg):
        p, c = params[seg.name], cache[seg.name]
        for i in range(seg.n):
            if seg.kind == "dense":
                pieces[-1].append(functools.partial(_dense_decode, _layer(p, i), _layer(c, i),
                                                    pos, cfg, tp))
            elif seg.kind == "moe":
                lp = _layer(p, i)
                pieces[-1].append(functools.partial(_attn_decode, lp, _layer(c, i), pos, cfg, tp))
                ffs.append(lambda y, lp=lp: _ff_half(lp, y, cfg, tp)[0])
                pieces.append([])
            elif seg.kind == "ssm":
                pieces[-1].append(functools.partial(_ssm_decode, _layer(p, i), c["state"][i],
                                                    c["conv"][i], cfg, tp))
            else:  # hybrid_group
                group = _layer(p["mamba"], i)
                for j in range(cfg.attn_every):
                    pieces[-1].append(functools.partial(
                        _ssm_decode, _layer(group, j), c["state"][i, j], c["conv"][i, j], cfg, tp))
                pieces[-1].append(functools.partial(_dense_decode, p["shared"], _layer(c, i), pos,
                                                    cfg, tp))
    return [_chain(fns) for fns in pieces], ffs

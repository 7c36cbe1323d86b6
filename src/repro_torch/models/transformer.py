"""Stack composition — the port of ``repro.models.transformer``.

A trunk is an ordered list of segments of stacked layers. ``repro`` walks the
stacked layer axis with ``lax.scan``; here a Python loop walks it. Families:

  dense           : [dense x L]
  moe             : [dense x first_dense] + [moe x (L - first_dense)]
  ssm             : [mamba x L]
  hybrid (zamba2) : [group x (L // attn_every)], each group = attn_every
                    mamba blocks + ONE shared attention+MLP block whose
                    params are common to all groups

MLA attention raises and names the slice that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import add_rms_norm, apply_mlp, rms_norm


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


def require_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: MLA attention."""
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet: it comes with the MLA slice")


def _add_norm(x: torch.Tensor, h: Optional[torch.Tensor], p,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + h, its norm): the residual add of the previous block's delta
    ``h`` folded into the next norm (one launch of the rmsnorm kernel's
    residual form under ``auto``). ``h`` is None before the first norm of
    the stack, which follows the embedding and no add: (x, norm(x))."""
    if cfg.act == "gelu":
        raise NotImplementedError(
            "LayerNorm (gelu archs) comes with the forward/loss_fn slice")
    if h is None:
        return x, rms_norm(x, p["w"], cfg.norm_eps, cfg)
    return add_rms_norm(x, h, p["w"], cfg.norm_eps, cfg)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked-parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# Every block takes the residual stream as (x, h): the stream is x + h, with
# h the previous block's delta not yet added (None at the stack's start),
# and returns its own (x, delta). The add happens in the next norm, and the
# stack's last delta goes into the final norm.
def _dense_block(p, x: torch.Tensor, h: Optional[torch.Tensor], attend, cfg: ModelConfig):
    """A dense or moe block: ``attend`` maps the normed input to (attention
    output, *rest). Returns (x, feed-forward delta, *rest)."""
    x, y = _add_norm(x, h, p["ln1"], cfg)
    a, *rest = attend(y)
    x, y = _add_norm(x, a, p["ln2"], cfg)
    return (x, _ffn(p, y, cfg), *rest)


def _ffn(p, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The feed-forward delta of a layer on its normed input ``y``: the MLP
    of a dense layer, the MoE of a moe layer (prefill runs it too, as
    ``repro``'s bodies do)."""
    if "mlp" in p:
        return apply_mlp(p["mlp"], y, cfg)
    return moe_mod.apply_moe(p["moe"], y, cfg)[0]


def _dense_prefill(p, x: torch.Tensor, h: Optional[torch.Tensor], positions: torch.Tensor,
                   cfg: ModelConfig):
    """A dense or moe block at prefill: (x, delta, k, v)."""
    return _dense_block(p, x, h, lambda y: attn_mod.gqa_prefill(p["attn"], y, positions, cfg),
                        cfg)


def _ssm_prefill(p, x: torch.Tensor, h: Optional[torch.Tensor], cfg: ModelConfig):
    """A mamba block (pre-norm + mixer) at prefill: (x, delta, state, conv tail)."""
    x, y = _add_norm(x, h, p["ln"], cfg)
    delta, state, tail = ssm_mod.mamba_block(p["mixer"], y, cfg)
    return x, delta, state, tail


def stack_prefill(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Returns (x, h, cache dict): the hidden state is x + h, h the last
    block's delta, which the final norm adds. Cache leaves carry the stacked
    layer axes first, as in ``repro``."""
    require_ported(cfg)
    cache: Dict[str, Any] = {}
    h = None
    for seg in segments_for(cfg):
        p = params[seg.name]
        if seg.kind in ("dense", "moe"):
            ks, vs = [], []
            for i in range(seg.n):
                x, h, k, v = _dense_prefill(_layer(p, i), x, h, positions, cfg)
                ks.append(k)
                vs.append(v)
            cache[seg.name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        elif seg.kind == "ssm":
            states, tails = [], []
            for i in range(seg.n):
                x, h, st, tail = _ssm_prefill(_layer(p, i), x, h, cfg)
                states.append(st)
                tails.append(tail)
            cache[seg.name] = {"state": torch.stack(states), "conv": torch.stack(tails)}
        else:  # hybrid_group
            states, tails, ks, vs = [], [], [], []
            for i in range(seg.n):
                group = _layer(p["mamba"], i)
                sts, tls = [], []
                for j in range(cfg.attn_every):
                    x, h, st, tail = _ssm_prefill(_layer(group, j), x, h, cfg)
                    sts.append(st)
                    tls.append(tail)
                x, h, k, v = _dense_prefill(p["shared"], x, h, positions, cfg)
                states.append(torch.stack(sts))
                tails.append(torch.stack(tls))
                ks.append(k)
                vs.append(v)
            cache[seg.name] = {"state": torch.stack(states), "conv": torch.stack(tails),
                               "k": torch.stack(ks), "v": torch.stack(vs)}
    return x, h, cache


def _dense_decode(p, x: torch.Tensor, h: Optional[torch.Tensor], k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos, cfg: ModelConfig):
    """A dense or moe block at decode: (x, delta); writes the token's K/V in
    place."""
    x, delta, _, _ = _dense_block(
        p, x, h, lambda y: attn_mod.gqa_decode(p["attn"], y, k_cache, v_cache, pos, cfg), cfg)
    return x, delta


def _ssm_decode(p, x: torch.Tensor, h: Optional[torch.Tensor], state: torch.Tensor,
                conv: torch.Tensor, cfg: ModelConfig):
    """A mamba block at decode: (x, delta). ``state`` and ``conv`` (one
    layer's rows of the cache) are overwritten in place once the step is
    computed: the new conv window is a slice of a fresh ``cat``, so nothing
    reads a half-written window."""
    x, y = _add_norm(x, h, p["ln"], cfg)
    delta, new_state, new_conv = ssm_mod.mamba_decode(p["mixer"], y, state, conv, cfg)
    state.copy_(new_state)
    conv.copy_(new_conv)
    return x, delta


def stack_decode(params, x: torch.Tensor, cache, pos, cfg: ModelConfig):
    """One-token decode. x: (B,1,D); pos: scalar or (B,) per-row positions.
    Returns (x, h, cache), the hidden state x + h as in
    :func:`stack_prefill`; the cache is updated in place (saves a copy of
    the whole cache per token) and the same tree is returned."""
    require_ported(cfg)
    h = None
    for seg in segments_for(cfg):
        p, c = params[seg.name], cache[seg.name]
        if seg.kind in ("dense", "moe"):
            for i in range(seg.n):
                x, h = _dense_decode(_layer(p, i), x, h, c["k"][i], c["v"][i], pos, cfg)
        elif seg.kind == "ssm":
            for i in range(seg.n):
                x, h = _ssm_decode(_layer(p, i), x, h, c["state"][i], c["conv"][i], cfg)
        else:  # hybrid_group
            for i in range(seg.n):
                group = _layer(p["mamba"], i)
                for j in range(cfg.attn_every):
                    x, h = _ssm_decode(_layer(group, j), x, h, c["state"][i, j],
                                       c["conv"][i, j], cfg)
                x, h = _dense_decode(p["shared"], x, h, c["k"][i], c["v"][i], pos, cfg)
    return x, h, cache

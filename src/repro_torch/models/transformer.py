"""Stack composition — the port of ``repro.models.transformer``.

A trunk is an ordered list of segments of stacked layers. ``repro`` walks the
stacked layer axis with ``lax.scan``; here a Python loop walks it. The dense
and moe segments (GQA attention) are ported; MLA attention and the ssm and
hybrid_group segments raise and name the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp, rms_norm

_LATER_SEGMENTS = {
    "mla": "the MLA slice",  # MLA attention, in a dense or a moe segment
    "ssm": "the SSM/hybrid + ssd slice",
    "hybrid_group": "the SSM/hybrid + ssd slice",
}


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


def require_ported(seg: Segment, cfg: ModelConfig) -> None:
    """Raise for a segment the port does not run yet: ssm and hybrid
    groups, and any segment with MLA attention."""
    if cfg.use_mla:
        raise NotImplementedError(
            f"MLA attention is not ported yet: it comes with {_LATER_SEGMENTS['mla']}")
    if seg.kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"segment kind {seg.kind!r} is not ported yet: it comes with "
            f"{_LATER_SEGMENTS.get(seg.kind, 'a later slice')}")


def _norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "gelu":
        raise NotImplementedError(
            "LayerNorm (gelu archs) comes with the forward/loss_fn slice")
    return rms_norm(x, p["w"], cfg.norm_eps, cfg)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked-parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def stack_prefill(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Returns (hidden, cache dict). Cache leaves carry the stacked layer
    axis first, as in ``repro``."""
    cache: Dict[str, Any] = {}
    for seg in segments_for(cfg):
        require_ported(seg, cfg)
        ks, vs = [], []
        for i in range(seg.n):
            lp = _layer(params[seg.name], i)
            h, k, v = attn_mod.gqa_prefill(lp["attn"], _norm(x, lp["ln1"], cfg),
                                           positions, cfg)
            x = _ffn(lp, x + h, cfg)
            ks.append(k)
            vs.append(v)
        cache[seg.name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache


def _ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Residual feed-forward half of a layer: the MLP of a dense layer, the
    MoE of a moe layer (prefill runs it too, as ``repro``'s bodies do)."""
    if "mlp" in p:
        return x + apply_mlp(p["mlp"], _norm(x, p["ln2"], cfg), cfg)
    h, _ = moe_mod.apply_moe(p["moe"], _norm(x, p["ln2"], cfg), cfg)
    return x + h


def stack_decode(params, x: torch.Tensor, cache, pos, cfg: ModelConfig):
    """One-token decode. x: (B,1,D); pos: scalar or (B,) per-row positions.
    Returns (hidden, cache); the cache is updated in place (saves a copy of
    the whole cache per token) and the same tree is returned."""
    for seg in segments_for(cfg):
        require_ported(seg, cfg)
        c = cache[seg.name]
        for i in range(seg.n):
            lp = _layer(params[seg.name], i)
            a, _, _ = attn_mod.gqa_decode(lp["attn"], _norm(x, lp["ln1"], cfg),
                                          c["k"][i], c["v"][i], pos, cfg)
            x = _ffn(lp, x + a, cfg)
    return x, cache

"""Mixtral's decoder in plain float32: grouped-query attention with rotary
embeddings (and a sliding window where the configuration states one), and
a sparse MoE FFN of SwiGLU experts whose router's top-k weights are
renormalised, pre-norm RMSNorm blocks, an untied head.

Hyperparameters are the configuration file's (Hugging Face names)."""
from __future__ import annotations

from typing import Dict, List

import torch

from harvest_bench.reference.common import causal_attention, decoder_logits, rope, routed_experts


def _attention(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    s = y.shape[0]
    h, kv, dh = hp["num_attention_heads"], hp["num_key_value_heads"], hp["head_dim"]
    a = p["attn"]
    q = rope(prec.mm(y, a["wq"]).reshape(s, h, dh), hp["rope_theta"])
    k = rope(prec.mm(y, a["wk"]).reshape(s, kv, dh), hp["rope_theta"])
    v = prec.mm(y, a["wv"]).reshape(s, kv, dh)
    g = h // kv
    att = causal_attention(q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1),
                           dh ** -0.5, hp.get("sliding_window"))
    return prec.mm(att, a["wo"])


def _ffn(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    return routed_experts(y, p["moe"], hp["num_experts_per_tok"], True, prec)


def logits(weights: Dict, hp: Dict, seqs: List[List[int]], n_last: List[int], prec):
    return decoder_logits(weights, hp, seqs, n_last, prec, _attention, _ffn, ["moe"])

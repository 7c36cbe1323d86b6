"""DeepSeek-V2's decoder in plain float32: multi-head latent attention
without a query LoRA (the keys and values decompressed from the
``kv_lora_rank``-wide latent, a rotary key shared by the heads), the first
``first_k_dense_replace`` layers a dense SwiGLU MLP and the rest a MoE of
``n_routed_experts`` SwiGLU experts (top ``num_experts_per_tok`` of a
softmax router, renormalised where ``norm_topk_prob``) plus
``n_shared_experts`` shared experts as one MLP, pre-norm RMSNorm blocks, an
untied head.

Hyperparameters are the configuration file's (Hugging Face names) as run.
``rope_scaling`` of type ``yarn`` scales the rotary frequencies
(:func:`rope_frequencies`) and multiplies the softmax scale by
``yarn_mscale(factor, mscale_all_dim)`` squared, as the published
``modeling_deepseek.py`` does. The latent's RMSNorm (``kv_a_layernorm``)
is not modelled: a file that states it is refused."""
from __future__ import annotations

from typing import Dict, List

import torch

from harvest_bench.reference.common import (causal_attention, decoder_logits, rope,
                                            routed_experts, swiglu, yarn_mscale)


def _attention(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    a = p["attn"]
    s = y.shape[0]
    h = hp["num_attention_heads"]
    nope, rot, dv = hp["qk_nope_head_dim"], hp["qk_rope_head_dim"], hp["v_head_dim"]
    theta, scaling = hp["rope_theta"], hp.get("rope_scaling")
    q = prec.mm(y, a["wq"]).reshape(s, h, nope + rot)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta, scaling)], dim=-1)
    c_kv = prec.mm(y, a["w_dkv"])
    k_rope = rope(prec.mm(y, a["w_krope"])[:, None, :], theta, scaling)
    k_nope = prec.mm(c_kv, a["w_uk"]).reshape(s, h, nope)
    v = prec.mm(c_kv, a["w_uv"]).reshape(s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(s, h, rot)], dim=-1)
    scale = (nope + rot) ** -0.5
    if scaling and scaling.get("mscale_all_dim"):
        scale *= yarn_mscale(scaling["factor"], scaling["mscale_all_dim"]) ** 2
    return prec.mm(causal_attention(q, k, v, scale), a["wo"])


def _ffn(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    if "mlp" in p:
        m = p["mlp"]
        return swiglu(y, m["w_gate"], m["w_up"], m["w_down"], prec)
    moe = p["moe"]
    out = routed_experts(y, moe, hp["num_experts_per_tok"], hp["norm_topk_prob"], prec)
    if hp["n_shared_experts"]:
        sh = moe["shared"]
        out = out + swiglu(y, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
    return out


def logits(weights: Dict, hp: Dict, seqs: List[List[int]], n_last: List[int], prec):
    if hp.get("kv_a_layernorm"):
        raise ValueError("the reference has no norm of the compressed latent (kv_a_layernorm)")
    segments = [s for s in ("dense0", "moe") if s in weights["stack"]]
    return decoder_logits(weights, hp, seqs, n_last, prec, _attention, _ffn, segments)

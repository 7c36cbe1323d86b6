"""DeepSeek-V2-Lite's decoder as published, in plain float32.

Multi-head latent attention without a query LoRA: the query's heads from
``wq``; the ``kv_lora_rank``-wide latent from ``w_dkv``, RMS-normed
(``kv_a_layernorm``, its weight the tree's ``attn.kv_norm``) before the
keys' nope part (``w_uk``) and the values (``w_uv``) are decompressed from
it; one rotary key from ``w_krope`` shared by the heads. The rotary dims
take YaRN's ``rope_scaling`` (:func:`rope_frequencies`: scaled frequencies
and the cos/sin amplitude ``mscale / mscale_all_dim``), and the softmax
scale ``(qk_nope_head_dim + qk_rope_head_dim)^-0.5`` is multiplied by
``yarn_mscale(factor, mscale_all_dim)`` squared. The first
``first_k_dense_replace`` layers have a dense SwiGLU MLP; the rest a MoE:
a softmax router over ``n_routed_experts``, the top ``num_experts_per_tok``
weights kept as the softmax gives them (``norm_topk_prob`` false), each
expert a SwiGLU, plus the ``n_shared_experts`` shared experts as one SwiGLU
of ``n_shared_experts * moe_intermediate_size``. Pre-norm RMSNorm blocks,
a final norm and an untied head.

Hyperparameters are the configuration file's (Hugging Face names) as run;
the file must state ``rope_scaling`` and ``norm_topk_prob`` false.

One departure from the published ``modeling_deepseek.py`` remains: the
rotary embedding rotates the two halves of the rope dims as pairs
(``x[i]`` with ``x[i + D/2]``) where the published code interleaves them.
On random weights that is a fixed permutation of the rope columns of ``wq``
and ``w_krope``, so it is the same model in distribution.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from harvest_bench.reference.common import (causal_attention, decoder_logits, rms_norm, rope,
                                            routed_experts, swiglu, yarn_mscale)


def _attention(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    a = p["attn"]
    s = y.shape[0]
    h = hp["num_attention_heads"]
    nope, rot, dv = hp["qk_nope_head_dim"], hp["qk_rope_head_dim"], hp["v_head_dim"]
    theta, scaling = hp["rope_theta"], hp["rope_scaling"]
    q = prec.mm(y, a["wq"]).reshape(s, h, nope + rot)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta, scaling)], dim=-1)
    c_kv = rms_norm(prec.mm(y, a["w_dkv"]), a["kv_norm"], hp["rms_norm_eps"])
    k_rope = rope(prec.mm(y, a["w_krope"])[:, None, :], theta, scaling)
    k_nope = prec.mm(c_kv, a["w_uk"]).reshape(s, h, nope)
    v = prec.mm(c_kv, a["w_uv"]).reshape(s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(s, h, rot)], dim=-1)
    scale = (nope + rot) ** -0.5
    if scaling.get("mscale_all_dim"):
        scale *= yarn_mscale(scaling["factor"], scaling["mscale_all_dim"]) ** 2
    return prec.mm(causal_attention(q, k, v, scale), a["wo"])


def _ffn(p: Dict, y: torch.Tensor, hp: Dict, prec) -> torch.Tensor:
    if "mlp" in p:
        m = p["mlp"]
        return swiglu(y, m["w_gate"], m["w_up"], m["w_down"], prec)
    moe = p["moe"]
    out = routed_experts(y, moe, hp["num_experts_per_tok"], False, prec)
    sh = moe["shared"]
    return out + swiglu(y, sh["w_gate"], sh["w_up"], sh["w_down"], prec)


def logits(weights: Dict, hp: Dict, seqs: List[List[int]], n_last: List[int], prec):
    if hp["norm_topk_prob"] or not hp["rope_scaling"]:
        raise ValueError("DeepSeek-V2-Lite as published: rope_scaling set and "
                         "norm_topk_prob false")
    segments = [s for s in ("dense0", "moe") if s in weights["stack"]]
    return decoder_logits(weights, hp, seqs, n_last, prec, _attention, _ffn, segments)

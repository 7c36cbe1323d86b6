"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 64 routed experts top-6 +
2 shared experts, dense layer 0. [arXiv:2405.04434; hf]

Note: the assignment note "2 shared+160 routed" mixes in full-V2's expert
count; we implement the primary spec line (64e top-6) which matches the HF
lite config, plus the 2 shared experts.

The presets keep ``repro``'s math, which departs from the published model
in three places: no YaRN ``rope_scaling`` (the rotary frequencies at
``rope_theta`` unscaled, no softmax temperature), no RMSNorm of the
compressed latent, and the top-6 router weights renormalised to sum to
one. The published settings (``rope_scaling``, ``norm_topk_prob=False``,
``mla_latent_norm=True``) are ``ModelConfig`` fields that the benchmark's
configuration file (``harvest_bench/configs/deepseek-v2-lite.json``) turns
on through its ``port.replace``.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,        # unused under MLA; kept for bookkeeping
    d_ff=10944,          # dense layer-0 FFN width (HF lite config)
    moe_d_ff=1408,
    vocab_size=102400,
    rope_theta=1e4,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
)

SMOKE = ModelConfig(
    arch_id="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    moe_d_ff=32,
    vocab_size=128,
    use_mla=True,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    first_dense_layers=1,
    moe_impl="ragged",  # dropless (decode==forward consistency on CPU tests)
)

"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,       # per-expert FFN width
    moe_d_ff=16384,
    vocab_size=32768,
    rope_theta=1e6,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
)

SMOKE = ModelConfig(
    arch_id="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=128,
    n_experts=4,
    top_k=2,
    sliding_window=16,
    moe_impl="ragged",  # dropless (decode==forward consistency on CPU tests)
)

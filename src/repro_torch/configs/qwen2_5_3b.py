"""qwen2.5-3b [dense] — GQA kv=2, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="qwen2.5-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    qkv_bias=True,
    tie_embeddings=True,
)

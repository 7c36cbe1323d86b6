"""internlm2-1.8b [dense] — GQA."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    act="silu",
)

SMOKE = ModelConfig(
    arch_id="internlm2-1.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    rope_theta=1e6,
)

"""stablelm-12b [dense] — GQA kv=8. [hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    arch_id="stablelm-12b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=112,
    vocab_size=128,
)

"""qwen1.5-4b [dense] — MHA (kv=heads), QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    rope_theta=1e6,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="qwen1.5-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    qkv_bias=True,
)

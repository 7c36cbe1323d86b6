"""zamba2-2.7b [hybrid] — Mamba2 trunk + ONE shared attention+MLP block applied
every 6 SSM layers (9 applications over 54 layers). [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
)

SMOKE = ModelConfig(
    arch_id="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_chunk=32,
    attn_every=2,
)

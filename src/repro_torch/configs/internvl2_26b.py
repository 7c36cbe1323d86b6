"""internvl2-26b [vlm] — InternViT frontend is a STUB (precomputed patch
embeddings prepended); backbone is the InternLM2-20B-class trunk.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    frontend="vision",
    frontend_seq=256,  # patch embeddings per image tile
)

SMOKE = ModelConfig(
    arch_id="internvl2-26b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    frontend="vision",
    frontend_seq=8,
)

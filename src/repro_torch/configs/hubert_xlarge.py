"""hubert-xlarge [audio] — encoder-only; conv feature frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings. [arXiv:2106.07447]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    encoder_only=True,
    frontend="audio",
)

SMOKE = ModelConfig(
    arch_id="hubert-xlarge-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    act="gelu",
    encoder_only=True,
    frontend="audio",
)

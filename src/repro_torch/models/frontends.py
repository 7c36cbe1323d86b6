"""Modality frontend stubs — the port of ``repro.models.frontends``.

The audio and vision entries specify the transformer backbone only; the
frontend supplies precomputed embeddings. These helpers draw random
frame and patch embeddings (bf16, as in ``repro``) and token labels for
smoke runs, from an explicit ``torch.Generator`` on ``device``. They are
not ``repro``'s random stream: for parity, give both packages the same
numpy batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _normal(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device).to(torch.bfloat16)


def audio_frames(generator: torch.Generator, cfg: ModelConfig, batch: int, seq_len: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """Precomputed conv-feature frame embeddings (stub for the HuBERT conv
    feature encoder): (B, S, D) bf16."""
    return _normal(generator, (batch, seq_len, cfg.d_model), resolve_device(device))


def vision_patches(generator: torch.Generator, cfg: ModelConfig, batch: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """Precomputed InternViT patch embeddings already projected to the LLM
    width (stub for the ViT + MLP projector): (B, F, D) bf16."""
    return _normal(generator, (batch, cfg.frontend_seq, cfg.d_model), resolve_device(device))


def make_batch(generator: torch.Generator, cfg: ModelConfig, batch: int, seq_len: int,
               with_labels: bool = True, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The family's batch for ``forward``/``loss_fn``: frames (audio),
    patches and ``seq_len - frontend_seq`` text tokens (vision), or tokens;
    labels in ``[0, vocab_size)``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, batch on {dev}")

    def tokens(n: int) -> torch.Tensor:
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=generator, device=dev)

    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        out["frames"] = audio_frames(generator, cfg, batch, seq_len, dev)
        n = seq_len
    elif cfg.frontend == "vision":
        n = seq_len - cfg.frontend_seq
        if n <= 0:
            raise ValueError(f"seq_len {seq_len} leaves no text after "
                             f"{cfg.frontend_seq} patches")
        out["vision_embeds"] = vision_patches(generator, cfg, batch, dev)
        out["tokens"] = tokens(n)
    else:
        n = seq_len
        out["tokens"] = tokens(n)
    if with_labels:
        out["labels"] = tokens(n)
    return out

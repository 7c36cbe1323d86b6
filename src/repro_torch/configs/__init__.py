"""Registry of the architectures this slice of the port serves."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig,
    kernel_impl,
    supported_kernel_sites,
    torch_dtype,
    with_kernel_impls,
)

_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

# architectures of ``repro`` that a later slice of the port brings
_LATER = {
    "hubert-xlarge": "the forward/loss_fn slice (encoder-only, gelu)",
    "internvl2-26b": "the forward/loss_fn slice (vision frontend)",
    "deepseek-v2-lite-16b": "the MLA slice",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it comes with "
            f"{_LATER[arch_id]}; ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.FULL


__all__ = [
    "ModelConfig",
    "get_config",
    "kernel_impl",
    "supported_kernel_sites",
    "torch_dtype",
    "with_kernel_impls",
]

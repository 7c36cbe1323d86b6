"""Registry of the ten architectures of ``repro.configs`` (+ shapes)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    cell_is_runnable,
    kernel_impl,
    supported_kernel_sites,
    torch_dtype,
    with_kernel_impls,
)

_MODULES = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS = tuple(sorted(_MODULES))


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.FULL


def all_cells():
    """Yield (arch_id, shape, runnable, skip_reason) for the 40 assigned cells."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES:
            ok, why = cell_is_runnable(cfg, shape)
            yield arch_id, shape, ok, why


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "ShapeConfig",
    "all_cells",
    "cell_is_runnable",
    "get_config",
    "kernel_impl",
    "supported_kernel_sites",
    "torch_dtype",
    "with_kernel_impls",
]

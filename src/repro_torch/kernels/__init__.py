"""Hand-written CUDA kernels, their plain PyTorch versions and the ops the
models dispatch to. Exports resolve lazily (PEP 562); no kernel is built at
import: the first launch on a CUDA tensor builds them.
"""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "add_rmsnorm_op": "repro_torch.kernels.ops",
    "add_rmsnorm_ref": "repro_torch.kernels.ref",
    "flash_attention_op": "repro_torch.kernels.ops",
    "flash_attention_ref": "repro_torch.kernels.ref",
    "gated_rmsnorm_op": "repro_torch.kernels.ops",
    "gated_rmsnorm_ref": "repro_torch.kernels.ref",
    "launch_counts": "repro_torch.kernels.ops",
    "mla_prefill_attention_op": "repro_torch.kernels.ops",
    "mla_prefill_attention_ref": "repro_torch.kernels.ref",
    "moe_gmm_capacity": "repro_torch.kernels.ops",
    "moe_gmm_form_counts": "repro_torch.kernels.ops",
    "moe_gmm_op": "repro_torch.kernels.ops",
    "moe_gmm_ref": "repro_torch.kernels.ref",
    "moe_gmm_schedule_ref": "repro_torch.kernels.ref",
    "moe_gmm_tiles_ref": "repro_torch.kernels.ref",
    "pad_group_sizes": "repro_torch.kernels.ops",
    "paged_attention_op": "repro_torch.kernels.ops",
    "paged_attention_ref": "repro_torch.kernels.ref",
    "paged_attention_split_ref": "repro_torch.kernels.ref",
    "reset_launch_counts": "repro_torch.kernels.ops",
    "rmsnorm_form_counts": "repro_torch.kernels.ops",
    "rmsnorm_op": "repro_torch.kernels.ops",
    "rmsnorm_ref": "repro_torch.kernels.ref",
    "ssd_chunk_ref": "repro_torch.kernels.ref",
    "ssd_op": "repro_torch.kernels.ops",
    "ssd_ref": "repro_torch.kernels.ref",
    "tile_experts_for_capacity": "repro_torch.kernels.ops",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

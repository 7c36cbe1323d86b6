"""PyTorch / CUDA port of ``repro``: the model zoo and serving engines on
the card, and the HPC-Whisk platform (``core``, ``faas``, ``platform``)
whose serving executors host them.

Module names mirror ``repro`` so each counterpart is easy to find. The port
imports ``torch`` and numpy only: never ``jax`` and never a ``repro.*``
module (it keeps its own copies of the JAX-free pieces it needs).

Exports resolve lazily (PEP 562), in the style of ``repro.serving``.
"""
from __future__ import annotations

import importlib
from typing import Any

# public name -> defining submodule (resolved on first attribute access)
_EXPORTS = {
    "BatchedServingExecutor": "repro_torch.platform.executors",
    "BlockAllocator": "repro_torch.serving.kvcache",
    "ContinuousEngine": "repro_torch.serving.engine",
    "GenRequest": "repro_torch.serving.batching",
    "ModelConfig": "repro_torch.configs.base",
    "OutOfBlocks": "repro_torch.serving.kvcache",
    "PagedContinuousEngine": "repro_torch.serving.engine",
    "PagedKVCache": "repro_torch.serving.kvcache",
    "Platform": "repro_torch.platform.runtime",
    "ScenarioConfig": "repro_torch.platform.scenario",
    "ServingEngine": "repro_torch.serving.engine",
    "SlotBatcher": "repro_torch.serving.batching",
    "cast_params": "repro_torch.models.model",
    "decode_step": "repro_torch.models.model",
    "forward": "repro_torch.models.model",
    "get_config": "repro_torch.configs",
    "init_cache": "repro_torch.models.model",
    "init_params": "repro_torch.models.model",
    "loss_fn": "repro_torch.models.model",
    "make_batch": "repro_torch.models.frontends",
    "paged_compatible": "repro_torch.serving.kvcache",
    "paged_decode_step": "repro_torch.models.model",
    "params_from_numpy": "repro_torch.models.weights",
    "prefill": "repro_torch.models.model",
    "resolve_device": "repro_torch.device",
    "with_kernel_impls": "repro_torch.configs.base",
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

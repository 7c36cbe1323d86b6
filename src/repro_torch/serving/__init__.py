"""Serving runtime of the port: sequential and continuous-batching engines
over a dense or a block-paged KV cache. Exports resolve lazily (PEP 562), as in
``repro.serving``.
"""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "BlockAllocator": "repro_torch.serving.kvcache",
    "ContinuousEngine": "repro_torch.serving.engine",
    "GenRequest": "repro_torch.serving.batching",
    "OutOfBlocks": "repro_torch.serving.kvcache",
    "PagedContinuousEngine": "repro_torch.serving.engine",
    "PagedKVCache": "repro_torch.serving.kvcache",
    "ServingEngine": "repro_torch.serving.engine",
    "SlotBatchState": "repro_torch.serving.slot_state",
    "SlotBatcher": "repro_torch.serving.batching",
    "find_batch_axes": "repro_torch.serving.slot_state",
    "graft_slot": "repro_torch.serving.slot_state",
    "paged_compatible": "repro_torch.serving.kvcache",
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

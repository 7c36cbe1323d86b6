"""Input pipeline: the port's copy of ``repro.data``. Lazy export (PEP 562),
as in ``repro``: importing ``repro_torch.data`` loads no submodule."""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "DataPipeline": "repro_torch.data.pipeline",
}

__all__ = ["DataPipeline"]


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

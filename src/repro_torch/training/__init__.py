"""Training loop pieces (optimizer + train step): the port of ``repro.training``.
Lazy exports (PEP 562), as in ``repro``."""
from __future__ import annotations

import importlib
from typing import Any

_EXPORTS = {
    "OptimizerConfig": "repro_torch.training.optimizer",
    "init_opt_state": "repro_torch.training.optimizer",
    "make_train_step": "repro_torch.training.train_step",
}

__all__ = ["OptimizerConfig", "init_opt_state", "make_train_step"]


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

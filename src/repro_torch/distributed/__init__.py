"""Distributed substrate: sharding path rules + elastic sharded serving —
the port of ``repro.distributed``.

This layer stays usable without the simulator (layering: it imports no
core/faas/platform code), and its exports resolve lazily (PEP 562) so
importing ``repro_torch.distributed`` never pays the torch import.
``repro``'s ``maybe_shard`` comes with the sharded-activation path
(ROADMAP.md, section 1).
"""
from __future__ import annotations

import importlib
from typing import Any

# public name -> defining submodule (resolved on first attribute access)
_EXPORTS = {
    "ElasticReplica": "repro_torch.distributed.elastic_serving",
    "MigrationProtocol": "repro_torch.distributed.elastic_serving",
    "MigrationRecord": "repro_torch.distributed.elastic_serving",
    "cache_shardings": "repro_torch.distributed.sharding",
    "input_shardings": "repro_torch.distributed.sharding",
    "param_shardings": "repro_torch.distributed.sharding",
    "serving_mesh": "repro_torch.distributed.elastic_serving",
}

__all__ = [
    "ElasticReplica",
    "MigrationProtocol",
    "MigrationRecord",
    "cache_shardings",
    "input_shardings",
    "param_shardings",
    "serving_mesh",
]


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

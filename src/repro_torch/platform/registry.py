"""String-keyed component registry for the platform seams.

Every pluggable component registers under ``(kind, name)`` with a decorator:

    @register("router", "least-loaded")
    class LeastLoadedRouter: ...

    @register("scaler", "adaptive")
    def build_adaptive(platform, **params): ...

A registered entry is either a class (instantiated with the scenario's
``*_params``) or a factory function taking the :class:`Platform` under
construction plus params — factories are for components that need live
wiring (the scaler needs the sim/slurm/controller; the suite-based workload
source needs the suite registry).

Scenario configs refer to components purely by these string keys, so a JSON
scenario file can select any registered policy without touching code.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

KINDS = ("router", "scaler", "admission", "workload", "executor", "suite",
         "reliability")

_REGISTRY: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}


def register(kind: str, name: str) -> Callable[[Any], Any]:
    """Class/factory decorator: ``@register("router", "hash")``."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown component kind {kind!r}; kinds: {KINDS}")

    def deco(obj: Any) -> Any:
        existing = _REGISTRY[kind].get(name)
        if existing is not None and existing is not obj:
            raise KeyError(f"duplicate registration {kind}/{name}")
        _REGISTRY[kind][name] = obj
        return obj

    return deco


def resolve(kind: str, name: str) -> Any:
    """Look up a registered class/factory; raises with the available names so
    a typo in a scenario file fails loudly and helpfully."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown component kind {kind!r}; kinds: {KINDS}")
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(f"no {kind} registered under {name!r}; "
                       f"available: {available(kind)}") from None


def available(kind: str) -> List[str]:
    return sorted(_REGISTRY[kind])

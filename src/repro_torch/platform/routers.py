"""Router registrations. The implementations live in
:mod:`repro_torch.core.routing` (the controller's default must not depend on the
platform layer); this module binds them to registry keys and is the home for
future platform-only routing policies."""
from __future__ import annotations

from repro_torch.core.routing import (DeadlineAwareRouter, HashRouter,
                                      LeastLoadedRouter, LocalityRouter)
from repro_torch.platform.registry import register

register("router", "hash")(HashRouter)
register("router", "least-loaded")(LeastLoadedRouter)
register("router", "locality")(LocalityRouter)
register("router", "deadline-aware")(DeadlineAwareRouter)

__all__ = ["DeadlineAwareRouter", "HashRouter", "LeastLoadedRouter",
           "LocalityRouter"]

"""Scaler registrations: pilot-job supply policies behind the
:class:`repro_torch.platform.interfaces.Scaler` seam.

Both bundled scalers self-schedule their control loop on construction (their
first events must land in the same simulator order the pre-seam runtime
produced, keeping seeded runs bit-for-bit reproducible), so the factories
simply construct them fully wired.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core.pilot import JobManager
from repro_torch.faas.autoscaler import AdaptiveJobManager
from repro_torch.platform.registry import register

if TYPE_CHECKING:
    from repro_torch.platform.runtime import Platform


@register("scaler", "static")
def build_static(platform: "Platform", **params) -> JobManager:
    """The paper's open-loop supply (Sec. III-D-b): fib keeps 10 queued jobs
    per fixed length; var keeps a bag of 100 flexible-length jobs."""
    sc = platform.scenario
    return JobManager(platform.sim, platform.slurm,
                      model=sc.scheduling.model, horizon=sc.duration,
                      **params)


@register("scaler", "adaptive")
def build_adaptive(platform: "Platform", **params) -> AdaptiveJobManager:
    """Closed-loop supply: scales the fib length mix from observed 503s,
    queue depth, and recent idle-window lengths; expedites Slurm passes
    under pressure."""
    sc = platform.scenario
    if sc.scheduling.model != "fib":
        raise ValueError(f"scaler 'adaptive' drives the fib length mix; got "
                         f"scheduling.model={sc.scheduling.model!r}")
    return AdaptiveJobManager(platform.sim, platform.slurm,
                              platform.controller, horizon=sc.duration,
                              metrics=platform.metrics, **params)


__all__ = ["JobManager", "AdaptiveJobManager", "build_static",
           "build_adaptive"]

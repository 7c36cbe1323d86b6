"""Admission-policy registrations behind the
:class:`repro_torch.platform.interfaces.AdmissionPolicy` seam. ``none`` disables
pre-routing admission (the paper's controller: 503 only when no invoker is
healthy); ``slo`` installs the per-tenant token-bucket + per-function
concurrency-cap controller from :mod:`repro_torch.faas.admission`."""
from __future__ import annotations

from typing import Optional, TYPE_CHECKING

from repro_torch.faas.admission import AdmissionController
from repro_torch.platform.registry import register

if TYPE_CHECKING:
    from repro_torch.platform.runtime import Platform


@register("admission", "none")
def build_none(platform: "Platform", **params) -> None:
    return None


@register("admission", "slo")
def build_slo(platform: "Platform", **params) -> Optional[AdmissionController]:
    return AdmissionController(platform.slos, **params)


__all__ = ["AdmissionController", "build_none", "build_slo"]

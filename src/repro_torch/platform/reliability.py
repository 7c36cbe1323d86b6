"""Reliability-policy registrations behind the controller's retry hook.
``none`` keeps the paper's semantics (a preemption death is final); ``retry``
installs :class:`repro_torch.faas.reliability.RetryPolicy` — budgeted retries with
exponential backoff and optional hedging — parameterised by the scenario's
``reliability`` section."""
from __future__ import annotations

from typing import Optional, TYPE_CHECKING

from repro_torch.faas.reliability import RetryPolicy
from repro_torch.platform.registry import register

if TYPE_CHECKING:
    from repro_torch.platform.runtime import Platform


@register("reliability", "none")
def build_none(platform: "Platform", **params) -> None:
    return None


@register("reliability", "retry")
def build_retry(platform: "Platform", **params) -> Optional[RetryPolicy]:
    rs = platform.scenario.reliability
    kw = dict(max_retries=rs.max_retries,
              retry_budgets=dict(rs.retry_budgets),
              backoff_base=rs.backoff_base,
              backoff_factor=rs.backoff_factor,
              backoff_max=rs.backoff_max,
              retry_on=tuple(rs.retry_on),
              hedge_delay=rs.hedge_delay,
              max_hedges=rs.max_hedges)
    kw.update(params)
    return RetryPolicy(platform.sim, platform.metrics, **kw)


__all__ = ["RetryPolicy", "build_none", "build_retry"]

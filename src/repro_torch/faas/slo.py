"""Per-tenant SLO classes and per-class reporting.

Three service classes cover the platform's contract space:

  - ``latency``     : interactive; tight p95 target, generous admission,
                      small per-function concurrency (isolation).
  - ``best_effort`` : default; throttled before it can starve latency tenants.
  - ``batch``       : throughput-oriented; large bursts allowed, loose
                      latency target, interruption-friendly.

An :class:`SLOClass` carries the admission-control parameters (token-bucket
rate/burst, per-function concurrency cap) consumed by
``repro_torch.faas.admission.AdmissionController``, plus the latency target used in
reports. Tenants map onto classes via ``FunctionClass.slo_class``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOClass:
    name: str
    target_p95_s: Optional[float]       # None = no latency objective
    admit_rate: float                   # token-bucket refill (requests/s)
    admit_burst: float                  # token-bucket capacity
    max_fn_concurrency: Optional[int]   # in-flight cap per function name
    priority: int                       # lower = shed first under pressure

    def token_bucket_args(self):
        return self.admit_rate, self.admit_burst


def default_slos(scale: float = 1.0) -> Dict[str, SLOClass]:
    """Admission envelope sized for the default ~10 QPS suite; ``scale``
    stretches the rate limits with the workload."""
    return {
        "latency": SLOClass("latency", target_p95_s=1.0,
                            admit_rate=20.0 * scale, admit_burst=40.0 * scale,
                            max_fn_concurrency=8, priority=2),
        "best_effort": SLOClass("best_effort", target_p95_s=5.0,
                                admit_rate=8.0 * scale,
                                admit_burst=24.0 * scale,
                                max_fn_concurrency=16, priority=1),
        "batch": SLOClass("batch", target_p95_s=None,
                          admit_rate=4.0 * scale, admit_burst=300.0 * scale,
                          max_fn_concurrency=None, priority=0),
    }


@dataclasses.dataclass
class ClassReport:
    slo_class: str
    n_submitted: int
    n_rejected: int          # 503 (no invoker or admission)
    n_throttled: int         # of rejected: admission-control decisions
    n_success: int
    n_timeout: int
    n_failed: int
    p50_s: float
    p95_s: float
    target_p95_s: Optional[float]

    @property
    def reject_share(self) -> float:
        return self.n_rejected / max(self.n_submitted, 1)

    @property
    def slo_met(self) -> Optional[bool]:
        # no successes => the 0.0 placeholder percentiles are meaningless;
        # don't report a dead class as compliant
        if self.target_p95_s is None or self.n_success == 0:
            return None
        return self.p95_s <= self.target_p95_s

    def row(self) -> str:
        tgt = f"{self.target_p95_s:.1f}s" if self.target_p95_s else "-"
        met = {True: "MET", False: "MISS", None: "n/a"}[self.slo_met]
        return (f"{self.slo_class:>12s} n={self.n_submitted:6d} "
                f"503={self.reject_share:6.2%} (throttled {self.n_throttled:5d}) "
                f"ok={self.n_success:6d} timeout={self.n_timeout:4d} "
                f"p50={self.p50_s*1e3:7.1f}ms p95={self.p95_s*1e3:8.1f}ms "
                f"target={tgt:>5s} [{met}]")


def per_class_report(requests: Iterable,
                     slos: Optional[Dict[str, SLOClass]] = None
                     ) -> List[ClassReport]:
    """Aggregate request outcomes per SLO class (p50/p95 over successes)."""
    groups: Dict[str, List] = {}
    for r in requests:
        groups.setdefault(getattr(r, "slo_class", "best_effort"),
                          []).append(r)
    out = []
    for name in sorted(groups):
        rs = groups[name]
        done = [r.response_time for r in rs if r.outcome == "success"]
        rts = np.array(done) if done else np.array([0.0])
        slo = (slos or {}).get(name)
        out.append(ClassReport(
            slo_class=name,
            n_submitted=len(rs),
            n_rejected=sum(1 for r in rs if r.outcome == "503"),
            n_throttled=sum(1 for r in rs if r.outcome == "503"
                            and getattr(r, "reject_reason", "")
                            not in ("", "no_invoker")),
            n_success=len(done),
            n_timeout=sum(1 for r in rs if r.outcome == "timeout"),
            n_failed=sum(1 for r in rs if r.outcome == "failed"),
            p50_s=float(np.percentile(rts, 50)),
            p95_s=float(np.percentile(rts, 95)),
            target_p95_s=slo.target_p95_s if slo else None,
        ))
    return out

"""SLO-aware admission control for the Controller request path.

The paper's controller has exactly one rejection mode: 503 when the healthy
invoker set is empty. With multiple tenants that is not enough — a burst from
one best-effort tenant can bury the per-invoker topics and blow the latency
class's SLO even though invokers exist. This module adds the standard two
guards in front of routing:

  - per-SLO-class **token buckets** (lazy refill on the sim clock), so each
    class has a contracted admission envelope, and
  - per-function **concurrency caps**, so one hot function cannot occupy
    every container slot in the fleet.

Rejections surface as 503 with a machine-readable ``reject_reason``
(``throttled:<class>`` / ``fn_concurrency``) so benchmarks can separate
admission decisions from genuine no-capacity 503s.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.faas.slo import SLOClass, default_slos


class TokenBucket:
    """Classic token bucket with lazy refill — O(1) per decision, no timer
    events on the simulator."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last = 0.0

    def _refill(self, now: float):
        if now > self._t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
            self._t_last = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def level(self, now: float) -> float:
        self._refill(now)
        return self.tokens


class AdmissionController:
    """Token-bucket + per-function-concurrency admission.

    The Controller calls :meth:`check` before routing and :meth:`release`
    exactly once when a request reaches a terminal outcome (success, timeout,
    failed) — in-flight accounting must stay conserved through the fast-lane
    hand-off, so it is keyed on the request id, not on dispatch.
    """

    def __init__(self, slos: Optional[Dict[str, SLOClass]] = None,
                 default_fn_concurrency: Optional[int] = 32):
        self.slos = slos or default_slos()
        self.default_fn_concurrency = default_fn_concurrency
        # one bucket per (slo_class, tenant): each tenant gets the class's
        # admission envelope, so a bursty tenant cannot drain a class-wide
        # bucket and starve well-behaved tenants in the same class
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}
        self._inflight_fn: Dict[str, int] = {}
        self._admitted_ids: set = set()
        self.n_throttled = 0
        self.n_fn_capped = 0

    def _slo(self, req) -> Optional[SLOClass]:
        return self.slos.get(getattr(req, "slo_class", "best_effort"))

    def check(self, req, now: float) -> Tuple[bool, str]:
        """Admit or reject. Returns ``(admitted, reason)``; on admission the
        request's in-flight slot is taken immediately."""
        slo = self._slo(req)
        # concurrency cap first: a cap rejection must not burn a bucket token,
        # or one pinned hot function drains its tenant's whole class envelope.
        # A class that declares max_fn_concurrency=None is uncapped (the batch
        # contract); the default cap only guards requests with no known class.
        cap = (slo.max_fn_concurrency if slo is not None
               else self.default_fn_concurrency)
        if cap is not None and self._inflight_fn.get(req.fn, 0) >= cap:
            self.n_fn_capped += 1
            return False, "fn_concurrency"
        if slo is not None:
            key = (slo.name, getattr(req, "tenant", "default"))
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(
                    *slo.token_bucket_args())
            if not bucket.try_take(now):
                self.n_throttled += 1
                return False, f"throttled:{slo.name}"
        self._inflight_fn[req.fn] = self._inflight_fn.get(req.fn, 0) + 1
        self._admitted_ids.add(req.id)
        return True, "admitted"

    def release(self, req):
        """Free the concurrency slot when the request terminates."""
        if req.id not in self._admitted_ids:
            return
        self._admitted_ids.discard(req.id)
        n = self._inflight_fn.get(req.fn, 0)
        if n <= 1:
            self._inflight_fn.pop(req.fn, None)
        else:
            self._inflight_fn[req.fn] = n - 1

    def inflight(self, fn: str) -> int:
        return self._inflight_fn.get(fn, 0)

    def inflight_total(self) -> int:
        return len(self._admitted_ids)

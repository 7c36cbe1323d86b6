"""Modified-OpenWhisk controller: policy-pluggable routing to a *dynamic* set
of invokers, per-invoker topics, the global fast-lane topic, continuous health
states, and 503 when no invoker is healthy (paper Sec. II, III-C, III-E).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, TYPE_CHECKING

from repro_torch.core.events import Simulator
from repro_torch.core.queues import Request, Topic
from repro_torch.core.routing import HashRouter

if TYPE_CHECKING:
    from repro_torch.core.invoker import Invoker


class Controller:
    """Routes invocations; maintains the dynamic invoker list.

    Standard OpenWhisk assumes the invoker set never shrinks; the paper's
    modification — which we implement — is (1) explicit register/deregister
    driven by the pilot-job lifecycle, (2) continuous worker-status messages
    (state transitions here), and (3) the fast-lane hand-off on SIGTERM.

    Placement policy is delegated to an injected ``router`` (the paper's
    behaviour, :class:`repro_torch.core.routing.HashRouter`, is the default); the
    controller keeps the mechanism: topics, health bookkeeping, admission,
    timeouts, and the fast-lane hand-off.
    """

    def __init__(self, sim: Simulator, queue_depth_soft_limit: int = 64,
                 admission=None, metrics=None, router=None, reliability=None):
        self.sim = sim
        self.fast_lane = Topic("fast-lane")
        self.topics: Dict[int, Topic] = {}
        self.invokers: Dict[int, "Invoker"] = {}
        self._healthy_order: List[int] = []   # sorted ids of healthy invokers
        self.queue_depth_soft_limit = queue_depth_soft_limit
        self.router = router if router is not None else HashRouter()
        # optional platform-layer plugins (repro_torch.faas): SLO-aware admission
        # control in front of routing, a metrics registry to publish into,
        # and a reliability policy (retry/hedging under preemption) that may
        # absorb would-be-terminal outcomes and re-place the work
        self.admission = admission
        self.metrics = metrics
        self.reliability = reliability
        if reliability is not None:
            # the policy needs the controller for resubmission; wiring it
            # here keeps construction one step (bind is idempotent)
            reliability.bind(self)
        self.completed: List[Request] = []
        self.rejected_503: List[Request] = []
        self.n_submitted = 0
        # request-path metric handles, memoised per label set: the registry
        # lookup (label sort + dict key build) is pure overhead at QPS scale
        self._mcache: Dict[tuple, object] = {}

    def _metric(self, kind: str, name: str, **labels):
        key = (kind, name, tuple(sorted(labels.items())))
        m = self._mcache.get(key)
        if m is None:
            m = getattr(self.metrics, kind)(name, **labels)
            self._mcache[key] = m
        return m

    @property
    def healthy_order(self) -> List[int]:
        """Sorted ids of currently-healthy invokers (read-only router surface)."""
        return self._healthy_order

    # --- invoker lifecycle ------------------------------------------------
    # _healthy_order is maintained incrementally: state changes only flow
    # through register / mark_unavailable / deregister, so an O(log n) sorted
    # insert/remove keeps it identical to re-sorting the healthy ids — without
    # rescanning the invoker table on every lifecycle transition.
    def _order_remove(self, inv_id: int):
        i = bisect.bisect_left(self._healthy_order, inv_id)
        if i < len(self._healthy_order) and self._healthy_order[i] == inv_id:
            self._healthy_order.pop(i)

    def register(self, inv: "Invoker"):
        self.invokers[inv.id] = inv
        self.topics.setdefault(inv.id, Topic(f"invoker-{inv.id}"))
        if inv.state == "healthy":
            bisect.insort(self._healthy_order, inv.id)
        self.router.on_register(inv)

    def mark_unavailable(self, inv: "Invoker") -> int:
        """First SIGTERM action: no new requests; move unpulled to fast lane."""
        self._order_remove(inv.id)
        moved = 0
        topic = self.topics.get(inv.id)
        if topic:
            moved = topic.drain_into(self.fast_lane)
        self._kick_all()
        return moved

    def deregister(self, inv: "Invoker"):
        self.invokers.pop(inv.id, None)
        topic = self.topics.pop(inv.id, None)
        if topic and len(topic):
            topic.drain_into(self.fast_lane)
        self._order_remove(inv.id)
        self.router.on_deregister(inv)
        self._kick_all()

    # --- request path --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Route a request. Returns False (503) when no invoker is healthy or
        admission control rejects it."""
        self.n_submitted += 1
        if self.metrics is not None:
            self._metric("counter", "requests_total",
                         slo_class=req.slo_class).inc()
        # capacity check first: an outage must not drain admission buckets
        # (and must report as no_invoker, not throttled — the adaptive
        # supply manager keys its pressure signal on that distinction)
        if not self._healthy_order:
            return self._reject(req, "no_invoker")
        if self.admission is not None:
            ok, reason = self.admission.check(req, self.sim.now)
            if not ok:
                return self._reject(req, reason)
        req.t_invoked = self.sim.now
        chosen = self.router.route(req, self)
        if chosen is None or chosen not in self.topics:
            return self._reject(req, "no_invoker")
        self.topics[chosen].push(req)
        # reprolint: disable=RPL601 -- a timeout tied with any same-instant completion/drain is benign: outcome-deciding paths all go through complete(), which commits only the first terminal outcome per request — fuzz-invariant (test_tie_order.py)
        req.timeout_ev = self.sim.at(req.arrival + req.timeout,
                                     self._check_timeout, req)
        self.invokers[chosen].kick()
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.outcome = "503"
        req.reject_reason = reason
        if self.admission is not None:
            # a router may refuse placement AFTER admission admitted the
            # request — give back its in-flight slot (no-op when the request
            # was never admitted; release is id-guarded)
            self.admission.release(req)
        self.rejected_503.append(req)
        if self.metrics is not None:
            self._metric("counter", "rejected_503_total", reason=reason).inc()
        return False

    def requeue_fast(self, req: Request):
        """SIGTERM hand-off path for pulled-but-unfinished requests."""
        req.via_fast_lane = True
        req.attempts += 1
        self.fast_lane.push(req)
        self._kick_all()

    def resubmit(self, req: Request) -> bool:
        """Reliability-layer re-entry: place an absorbed (retried or hedged)
        request again. Bypasses admission — the request still holds its
        original in-flight slot — and does not count as a new submission."""
        if req.outcome is not None:
            return False
        chosen = self.router.route(req, self)
        if chosen is None or chosen not in self.topics:
            return False
        if req.id in self.invokers[chosen].running:
            # the router picked the worker already executing this request (a
            # hash router homes the hedge twin): no second execution would
            # start, so report the placement as failed rather than let the
            # caller count a phantom attempt
            return False
        req.attempts += 1
        self.topics[chosen].push(req)
        self.invokers[chosen].kick()
        return True

    def complete(self, req: Request, outcome: str = "success"):
        if req.outcome is not None:
            return
        # retry hook: the reliability policy may absorb a would-be-terminal
        # failure (preemption death) and schedule another attempt instead of
        # letting the outcome commit — the request stays logically in flight
        # (admission slot held, timeout event still armed as the backstop)
        if (self.reliability is not None
                and self.reliability.absorb(req, outcome)):
            return
        req.outcome = outcome
        req.t_completed = self.sim.now
        self.completed.append(req)
        self._on_terminal(req)

    def _check_timeout(self, req: Request):
        if req.outcome is None:
            req.outcome = "timeout"
            self.completed.append(req)
            self._on_terminal(req)

    # --- dispatch observation (reliability bookkeeping) -------------------
    def note_dispatch(self, req: Request, inv: "Invoker"):
        """An invoker started executing ``req`` (hedge timers key off this)."""
        if self.reliability is not None:
            self.reliability.on_dispatch(req, inv)

    def note_undispatch(self, req: Request, inv: "Invoker", elapsed: float,
                        reason: str):
        """``req`` left ``inv``'s in-flight set; ``elapsed`` seconds of
        execution are attributable to ``reason`` (requeue | preempt_kill |
        stale_finish | finish | duplicate_drop — hedge losers bypass this
        hook via ``Invoker.cancel_running``)."""
        if self.reliability is not None:
            self.reliability.on_undispatch(req, inv, elapsed, reason)

    def _on_terminal(self, req: Request):
        # the pending self-timeout is dead weight once the outcome is known;
        # cancelling it keeps the event heap proportional to in-flight work
        if req.timeout_ev is not None:
            self.sim.cancel(req.timeout_ev)
            req.timeout_ev = None
        if self.admission is not None:
            self.admission.release(req)
        if self.reliability is not None:
            self.reliability.on_terminal(req)
        if self.metrics is not None:
            self._metric("counter", "outcomes_total", outcome=req.outcome,
                         slo_class=req.slo_class).inc()
            if req.outcome == "success":
                self._metric("histogram", "response_time_s",
                             slo_class=req.slo_class).observe(
                    req.response_time)

    def _kick_all(self):
        # only the fast lane can hold work that any invoker may pull; an
        # invoker's own backlog is consumed by the event that created it
        # (submit kicks the chosen invoker, _finish kicks on freed capacity),
        # so with an empty fast lane this fan-out would be 100% no-op kicks
        if not self.fast_lane:
            return
        for i in self._healthy_order:
            self.invokers[i].kick()

    # --- metrics -----------------------------------------------------------------
    def healthy_count(self) -> int:
        return len(self._healthy_order)

    def outcome_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.completed:
            out[r.outcome] = out.get(r.outcome, 0) + 1
        out["503"] = len(self.rejected_503)
        return out

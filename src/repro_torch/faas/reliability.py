"""Reliability under preemption: retries, backoff, and request hedging.

The paper accepts that pilot workers die the moment Slurm reclaims their node
— requests caught in the drain/SIGKILL window simply "failed during
execution" (Sec. V-C). This module makes those outcomes first-class instead
of final: a :class:`RetryPolicy` plugged into the controller's terminal path
can *absorb* a preemption death and schedule another attempt, bounded by a
per-SLO-class retry budget, with exponential backoff realised as simulator
events. Optional hedging duplicates a straggling in-flight request onto a
second invoker and cancels the loser the moment either copy finishes.

Mechanics (all hooks live in :class:`repro_torch.core.controller.Controller`):

  - ``Controller.complete`` consults :meth:`RetryPolicy.absorb` before
    committing a retriable outcome. An absorbed request stays logically in
    flight: it keeps its admission slot and its original ``timeout_ev``,
    which remains the conservation backstop — whatever happens to the
    retries, the request terminates by ``arrival + timeout``.
  - ``Controller.note_dispatch`` / ``note_undispatch`` let the policy track
    where each attempt physically runs, arm hedge timers, and account
    wasted work (seconds of execution thrown away to preemption kills,
    SIGTERM restarts, post-terminal completions, and hedge cancellations).
  - ``Controller._on_terminal`` calls :meth:`RetryPolicy.on_terminal`, which
    cancels still-running twin attempts (freeing invoker capacity) and books
    goodput — successful request-seconds, the number the reliability
    benchmark optimises.

A retry that cannot be placed (no healthy invoker) after its budget is spent
commits the previously-dead ``"lost"`` outcome: the platform gave up on work
it had accepted, as opposed to ``"failed"`` (died during execution with no
budget left) and ``"timeout"`` (the client deadline passed first).
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Sequence, TYPE_CHECKING

from repro_torch.faas.metrics import MetricsRegistry

if TYPE_CHECKING:
    from repro_torch.core.controller import Controller
    from repro_torch.core.invoker import Invoker
    from repro_torch.core.queues import Request

# outcomes a retry may absorb; "timeout" is deliberately excluded — the
# client deadline has passed, re-running the work cannot help anyone
DEFAULT_RETRY_ON = ("failed",)


class NoReliability:
    """Explicit no-op policy (registry key ``none`` resolves to ``None`` at
    the platform layer; this class exists for direct-wiring call sites and
    tests that want the hook surface without behaviour)."""

    def bind(self, controller: "Controller") -> None:
        pass

    def absorb(self, req: "Request", outcome: str) -> bool:
        return False

    def on_dispatch(self, req: "Request", inv: "Invoker") -> None:
        pass

    def on_undispatch(self, req: "Request", inv: "Invoker", elapsed: float,
                      reason: str) -> None:
        pass

    def on_terminal(self, req: "Request") -> None:
        pass


class RetryPolicy:
    """Budgeted retries with exponential backoff, optional hedging.

    ``retry_budgets`` maps SLO-class names to retry counts; classes not
    listed fall back to ``max_retries``. ``hedge_delay`` (seconds after
    dispatch) arms speculative duplication for stragglers; ``None`` disables
    hedging. All bookkeeping is keyed on request ids, so one policy instance
    serves every invoker in the platform.
    """

    def __init__(self, sim, metrics: Optional[MetricsRegistry] = None, *,
                 max_retries: int = 2,
                 retry_budgets: Optional[Dict[str, int]] = None,
                 backoff_base: float = 0.5, backoff_factor: float = 2.0,
                 backoff_max: float = 30.0,
                 retry_on: Sequence[str] = DEFAULT_RETRY_ON,
                 hedge_delay: Optional[float] = None, max_hedges: int = 1):
        self.sim = sim
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.max_retries = int(max_retries)
        self.retry_budgets = dict(retry_budgets or {})
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.retry_on = tuple(retry_on)
        self.hedge_delay = hedge_delay
        self.max_hedges = int(max_hedges)
        self.controller: Optional["Controller"] = None
        # rid -> {invoker_id: Invoker} for attempts physically executing now
        self._placements: Dict[int, Dict[int, "Invoker"]] = {}
        # rid -> copies sitting in a topic that this policy knows will run
        # (hedge/retry resubmissions, SIGTERM requeues); the initial submit
        # is not counted — its dispatch decrements only if a count exists
        self._queued: Dict[int, int] = {}
        self._retries_used: Dict[int, int] = {}
        self._hedges_used: Dict[int, int] = {}
        # counter handles memoised per label set: the registry lookup (label
        # sort + key build) is pure overhead on the per-dispatch hot path
        self._ccache: Dict[tuple, object] = {}

    def bind(self, controller: "Controller") -> None:
        self.controller = controller

    # --- metric handles -----------------------------------------------------
    def _c(self, name: str, **labels):
        key = (name, tuple(sorted(labels.items())))
        c = self._ccache.get(key)
        if c is None:
            c = self._ccache[key] = self.metrics.counter(name, **labels)
        return c

    def budget(self, req: "Request") -> int:
        return self.retry_budgets.get(req.slo_class, self.max_retries)

    def _backoff(self, req: "Request", n_used: int) -> float:
        """Exponential backoff with mean-preserving +/-25% jitter, keyed to
        the request's stable identity (arrival, fn, attempt) — NOT a shared
        RNG stream and NOT ``hash()`` (string hashing is per-process).
        Production retry layers jitter their timers to decorrelate retries;
        here the jitter also keeps two requests that died in the same
        preemption from re-firing at the exact same instant, where only
        event tie order could decide who re-queues first."""
        base = min(self.backoff_max,
                   self.backoff_base * self.backoff_factor ** n_used)
        key = f"{req.arrival!r}:{req.fn}:{n_used}".encode()
        u = zlib.crc32(key) / 2 ** 32
        return base * (0.75 + 0.5 * u)

    # --- controller hooks ---------------------------------------------------
    def absorb(self, req: "Request", outcome: str) -> bool:
        """Decide whether a would-be-terminal ``outcome`` is absorbed into a
        retry (True) or committed by the controller (False)."""
        # survivor check first, independent of the retry configuration: a
        # twin still executing elsewhere — or enqueued and certain to run —
        # means the request is not dead; swallow this attempt's death and
        # let the survivor decide. (Only death outcomes qualify; a success
        # must always commit.)
        if outcome != "success" and (self._placements.get(req.id)
                                     or self._queued.get(req.id)):
            self._c("hedge_survivor_absorbed_total",
                    slo_class=req.slo_class).inc()
            return True
        if outcome not in self.retry_on:
            return False
        used = self._retries_used.get(req.id, 0)
        if used >= self.budget(req):
            self._c("retry_exhausted_total", slo_class=req.slo_class).inc()
            return False
        delay = self._backoff(req, used)
        if (self.sim.now + delay + req.exec_time
                >= req.arrival + req.timeout):
            # even a lower-bound re-execution (no queueing, no cold start)
            # could not finish inside the client deadline; committing the
            # honest failure now beats a guaranteed timeout
            self._c("retry_infeasible_total", slo_class=req.slo_class).inc()
            return False
        self._retries_used[req.id] = used + 1
        self._c("retries_total", slo_class=req.slo_class).inc()
        # reprolint: disable=RPL601 -- backoff carries identity-keyed jitter (see _backoff), so two retries never fire at the same instant; ties with completions hit complete()'s first-terminal-wins guard — fuzz-invariant
        self.sim.after(delay, self._retry, req)
        return True

    def _retry(self, req: "Request") -> None:
        if req.outcome is not None:     # timed out while backing off
            return
        if self.sim.now + req.exec_time >= req.arrival + req.timeout:
            # repeated placement failures pushed the backoff past the point
            # where even a zero-queue execution could beat the deadline;
            # surface the death (absorb declines it as infeasible/exhausted)
            self.controller.complete(req, "failed")
            return
        if self.controller.resubmit(req):
            self._queued[req.id] = self._queued.get(req.id, 0) + 1
            return
        # no healthy invoker to place on: back off again while budget lasts,
        # otherwise the platform has lost work it accepted
        used = self._retries_used.get(req.id, 0)
        if used < self.budget(req):
            self._retries_used[req.id] = used + 1
            self._c("retries_total", slo_class=req.slo_class).inc()
            self.sim.after(self._backoff(req, used), self._retry, req)
            return
        self._c("retry_exhausted_total", slo_class=req.slo_class).inc()
        self.controller.complete(req, "lost")

    def _queued_dec(self, rid: int) -> None:
        n_q = self._queued.get(rid, 0)
        if n_q > 1:
            self._queued[rid] = n_q - 1
        elif n_q:
            del self._queued[rid]

    def on_dispatch(self, req: "Request", inv: "Invoker") -> None:
        # every dispatch pops one queued copy; the initial submit was never
        # counted, so only decrement when a tracked copy exists
        self._queued_dec(req.id)
        self._placements.setdefault(req.id, {})[inv.id] = inv
        self._c("attempts_total", slo_class=req.slo_class).inc()
        if (self.hedge_delay is not None
                and self._hedges_used.get(req.id, 0) < self.max_hedges):
            # reprolint: disable=RPL601 -- hedge timers for different requests commute (per-request state, duplicate-drop guard on dispatch); a timer tied with its own attempt's terminal is settled by the outcome-is-None check — fuzz-invariant
            self.sim.after(self.hedge_delay, self._maybe_hedge, req, inv.id)

    def _maybe_hedge(self, req: "Request", armed_inv_id: int) -> None:
        if req.outcome is not None:
            return
        placements = self._placements.get(req.id)
        # hedge only the attempt this timer was armed for: it must still be
        # executing (a fresh retry/requeue attempt is not a straggler, even
        # if it happens to be running when a stale timer fires)
        if not placements or armed_inv_id not in placements:
            return
        if self._hedges_used.get(req.id, 0) >= self.max_hedges:
            return
        if len(placements) > 1:         # already duplicated
            return
        if self.controller.resubmit(req):
            # budget is consumed only by a successful duplication — a
            # momentary no-invoker outage must not forfeit hedging for good
            self._queued[req.id] = self._queued.get(req.id, 0) + 1
            self._hedges_used[req.id] = self._hedges_used.get(req.id, 0) + 1
            self._c("hedges_total", slo_class=req.slo_class).inc()

    def on_undispatch(self, req: "Request", inv: "Invoker", elapsed: float,
                      reason: str) -> None:
        if reason == "duplicate_drop":
            # a queued copy was consumed by the invoker already running the
            # request (no dispatch happened): only the queued count shrinks —
            # the real attempt on that invoker is still executing
            self._queued_dec(req.id)
            return
        placements = self._placements.get(req.id)
        if placements is not None:
            placements.pop(inv.id, None)
            if not placements:
                del self._placements[req.id]
        if reason == "requeue":
            # the controller pushes the interrupted copy onto the fast lane
            # immediately after this hook: it stays live, just queued
            self._queued[req.id] = self._queued.get(req.id, 0) + 1
        if reason != "finish" and elapsed > 0.0:
            self._c("wasted_seconds_total", reason=reason).inc(elapsed)

    def on_terminal(self, req: "Request") -> None:
        # cancel every attempt still physically executing: hedge losers when
        # the request succeeded, pointless work when it timed out or died
        placements = self._placements.pop(req.id, None)
        if placements:
            reason = ("hedge_cancel" if req.outcome == "success"
                      else "terminal_reap")
            for inv in list(placements.values()):
                elapsed = inv.cancel_running(req.id)
                if elapsed is not None and elapsed > 0.0:
                    self._c("wasted_seconds_total", reason=reason).inc(elapsed)
        self._queued.pop(req.id, None)
        self._retries_used.pop(req.id, None)
        self._hedges_used.pop(req.id, None)
        if req.outcome == "success":
            self._c("goodput_seconds_total",
                    slo_class=req.slo_class).inc(req.exec_time)
        self._c("terminals_total", outcome=req.outcome,
                slo_class=req.slo_class).inc()

    # --- derived summary ------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        m = self.metrics
        attempts = m.total("attempts_total")
        terminals = m.total("terminals_total")
        return {
            "attempts": attempts,
            "terminals": terminals,
            "retries": m.total("retries_total"),
            "hedges": m.total("hedges_total"),
            "retry_exhausted": m.total("retry_exhausted_total"),
            "goodput_s": m.total("goodput_seconds_total"),
            "wasted_s": m.total("wasted_seconds_total"),
            "amplification": attempts / terminals if terminals else 0.0,
        }


__all__ = ["RetryPolicy", "NoReliability", "DEFAULT_RETRY_ON"]

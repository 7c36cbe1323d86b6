"""Invoker (worker) lifecycle inside a pilot job: warm-up -> healthy pull loop
-> SIGTERM drain/hand-off -> exit (paper Sec. III-B/C).

States: warming -> healthy -> draining -> dead. Warm-up duration follows the
paper's measured distribution (median 12.48 s, p95 26.5 s, lognormal). The
invoker executes functions in warm "containers" (per-function LRU; cold start
~500 ms) with a bounded concurrency, pulling from the global fast lane before
its own topic.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Optional, Set, TYPE_CHECKING

import numpy as np

from repro_torch.core.events import Simulator
from repro_torch.core.queues import Request, Topic

if TYPE_CHECKING:
    from repro_torch.core.controller import Controller

_INV_IDS = itertools.count()

# lognormal matched to median 12.48 s, p95 26.5 s
WARMUP_MU = math.log(12.48)
WARMUP_SIGMA = math.log(26.5 / 12.48) / 1.645


class Invoker:
    def __init__(self, sim: Simulator, controller: "Controller", *,
                 node: int, sched_end: float, rng: np.random.Generator,
                 concurrency: int = 16, cold_start: float = 0.5,
                 overhead: float = 0.08, drain_margin: float = 15.0,
                 grace: float = 180.0, max_warm_containers: int = 32,
                 executor: Optional[Callable[[Request], float]] = None,
                 on_exit: Optional[Callable[["Invoker"], None]] = None,
                 on_sigterm: Optional[Callable[["Invoker", str], None]] = None,
                 warmup: Optional[float] = None):
        self.id = next(_INV_IDS)
        self.sim = sim
        self.controller = controller
        self.node = node
        self.sched_end = sched_end
        self.rng = rng
        self.concurrency = concurrency
        self.cold_start = cold_start
        self.overhead = overhead        # pull/dispatch overhead per request
        self.drain_margin = drain_margin
        self.grace = grace
        self.max_warm = max_warm_containers
        self.executor = executor        # maps request -> execution seconds
        self.on_exit = on_exit
        self.on_sigterm = on_sigterm    # pre-exit hook at grace start
        self.state = "warming"
        self._registered = False    # True between register() and deregister()
        self.warm_fns: Dict[str, float] = {}   # fn -> last use (LRU)
        self.running: Set[int] = set()         # request ids in flight
        # id -> (req, end_event, t_end, t_start)
        self._running_reqs: Dict[int, tuple] = {}
        self._running_by_fn: Dict[str, int] = {}   # fn -> in-flight count
        self.t_created = sim.now
        self.t_healthy: Optional[float] = None
        self.t_dead: Optional[float] = None
        self.n_executed = 0     # useful executions (request not yet terminal)
        self.n_wasted = 0       # executions of already-decided requests plus
                                # work killed mid-flight (preemption, hedging)
        # explicit warmup override skips the lognormal draw (gang logical
        # invokers form from already-warm members); the rng is this
        # invoker's own identity-keyed stream, so draws here never depend
        # on what the rest of the simulation drew first
        self.warmup = (float(rng.lognormal(WARMUP_MU, WARMUP_SIGMA))
                       if warmup is None else float(warmup))
        # reprolint: disable=RPL601 -- heals at a per-invoker lognormal offset (own identity-keyed rng); ties with other handlers only permute which same-instant pull drains the queue first, and the dispatched multiset is unchanged — fuzz-invariant
        sim.after(self.warmup, self._become_healthy)
        # proactive drain before own declared time limit (timeout SIGTERM).
        # Sub-second jitter de-aliases the drain from the integer grids the
        # rest of the day runs on (2 s arrivals, 15 s passes, 120 s slots):
        # sched_end - drain_margin would land exactly on those grids, and an
        # exact tie between "request arrives" and "worker starts draining"
        # is a sim artifact real systems never exhibit — a real drain has
        # network/process jitter. Ties of measure zero keep tie_break a pure
        # permutation of simultaneity that actually is simultaneity.
        self._drain_jitter = float(self.rng.random())
        # reprolint: disable=RPL601 -- the jitter above de-aliases this drain from the arrival/pass grids, so the flagged conflicts occur at ties of measure zero — fuzz-invariant (test_tie_order.py)
        self._deadline_ev = sim.at(
            max(sched_end - drain_margin - self._drain_jitter, sim.now),
            self.sigterm, "timeout")

    # --- lifecycle ------------------------------------------------------------
    def _become_healthy(self):
        if self.state != "warming":
            return
        self.state = "healthy"
        self.t_healthy = self.sim.now
        self._registered = True
        self.controller.register(self)
        self.kick()

    def sigterm(self, reason: str = "evict"):
        """Paper Sec. III-C: mark unavailable, hand off queued work, interrupt
        or finish the running invocations, deregister, exit."""
        if self.state in ("draining", "dead"):
            return
        self.state = "draining"
        self.sim.cancel(self._deadline_ev)
        # pre-exit migration hook: fires at grace start, BEFORE any
        # requeue/kill decision — an elastic gang uses the grace window to
        # move this member's state (shards, KV) somewhere that survives
        if self.on_sigterm is not None:
            self.on_sigterm(self, reason)
        # guard on registration, not on the warming state: gang members are
        # healthy without ever registering (their gang is the controller-
        # visible invoker), and healthy <=> registered for everyone else
        if self._registered:
            self.controller.mark_unavailable(self)
        # requeue running invocations that cannot finish within the grace.
        # SIGKILL fires at now + grace, so anything with remaining <= grace
        # can drain to completion in place; restarting it elsewhere would
        # throw away progress for nothing.
        for rid in list(self._running_reqs):
            req, ev, t_end, t_start = self._running_reqs[rid]
            remaining = t_end - self.sim.now
            if remaining > self.grace:
                if req.interruptible:
                    self.sim.cancel(ev)
                    self._drop(rid, req)
                    self._note_preempt(req, t_start, t_end)
                    self.controller.note_undispatch(
                        req, self, self.sim.now - t_start, "requeue")
                    self.controller.requeue_fast(req)
                # non-interruptible long calls ride until SIGKILL (-> failed)
        drain_time = 2.0 + float(self.rng.random())  # de-register + flush
        if self._running_reqs:
            # the exit must come STRICTLY after the last finish it promised
            # to wait for: at ``latest`` exactly, "work completes" and
            # "worker exits" would tie on the event heap and only tie order
            # would decide whether that work finished or died (the response
            # flush after the last completion is not instantaneous anyway)
            latest = max(t for (_, _, t, _) in self._running_reqs.values())
            exit_at = min(max(latest + 1e-6, self.sim.now + drain_time),
                          self.sim.now + self.grace)
        else:
            exit_at = self.sim.now + drain_time
        # reprolint: disable=RPL601 -- exit_at is strictly after the last finish this drain promised to wait for (epsilon above), so the finish-vs-exit conflict cannot tie; remaining ties hit the dead-state guard — fuzz-invariant
        self.sim.at(exit_at, self._exit)

    def sigkill(self):
        """Hard stop at the end of the grace period. Non-interruptible calls
        that are still running die here — the 'failed during execution'
        category of Sec. V-C."""
        self._exit()

    def _dispose_running(self):
        """Terminal cleanup of whatever is still in flight: interruptible work
        goes back through the fast lane, non-interruptible work dies with the
        worker, and every pending _finish event is cancelled so a dead invoker
        can never report a completion."""
        for rid in list(self._running_reqs):
            req, ev, t_end, t_start = self._running_reqs.pop(rid)
            self.sim.cancel(ev)
            self.running.discard(rid)
            self._fn_dec(req.fn)
            elapsed = self.sim.now - t_start
            if req.outcome is None and req.interruptible:
                self._note_preempt(req, t_start, t_end)
                self.controller.note_undispatch(req, self, elapsed, "requeue")
                self.controller.requeue_fast(req)
            else:
                self.n_wasted += 1
                self.controller.note_undispatch(
                    req, self, elapsed, "preempt_kill")
                if req.outcome is None:
                    self.controller.complete(req, "failed")

    def _exit(self):
        if self.state == "dead":
            return
        # the self-timeout drain path can leave non-interruptible calls whose
        # remaining time exceeds the grace still "running" here; they must be
        # disposed of exactly like a SIGKILL or their _finish events would
        # later fire success from a dead worker (zombie completions)
        self._dispose_running()
        self.state = "dead"
        self.t_dead = self.sim.now
        if self._registered:
            self._registered = False
            self.controller.deregister(self)
        if self.on_exit:
            self.on_exit(self)

    # --- pull loop ---------------------------------------------------------------
    def _pop(self) -> Optional[Request]:
        req = self.controller.fast_lane.pop()
        if req is None:
            topic = self.controller.topics.get(self.id)
            req = topic.pop() if topic else None
        return req

    def kick(self):
        """Pull work if capacity allows: fast lane first, then own topic.

        Batched-executor seam: an executor exposing ``run_batch`` receives
        every request admitted in this pull as ONE batch (continuous-batching
        serving aggregates concurrent in-flight decodes instead of
        serializing them); plain callables keep the per-request path.
        """
        if self.state != "healthy":
            return
        run_batch = getattr(self.executor, "run_batch", None)
        if run_batch is None:
            while len(self.running) < self.concurrency:
                req = self._pop()
                if req is None:
                    return
                if req.outcome is not None:   # e.g. already timed out
                    continue
                self._start(req)
            return
        batch: list = []
        seen = set()
        while len(self.running) + len(batch) < self.concurrency:
            req = self._pop()
            if req is None:
                break
            if req.outcome is not None:
                continue
            if req.id in self._running_reqs or req.id in seen:
                # hedged/requeued twin (see _start): consume without dispatch
                self.controller.note_undispatch(req, self, 0.0, "duplicate_drop")
                continue
            seen.add(req.id)
            batch.append(req)
        if not batch:
            return
        for req, exec_time in zip(batch, run_batch(batch)):
            self._start(req, exec_time)

    def _start(self, req: Request, exec_time: Optional[float] = None):
        if req.id in self._running_reqs:
            # a hedged/requeued twin of a request already executing here:
            # starting it twice would corrupt the in-flight tables — the
            # copy is consumed without a dispatch, which the reliability
            # layer needs to know for its live-copy accounting
            self.controller.note_undispatch(req, self, 0.0, "duplicate_drop")
            return
        if exec_time is None:
            exec_time = self.executor(req) if self.executor else req.exec_time
        cold = req.fn not in self.warm_fns
        if cold and len(self.warm_fns) >= self.max_warm:
            # evict the least-recently-used container, skipping functions
            # with in-flight requests — their containers demonstrably exist,
            # and evicting the bookkeeping would mis-bill the next call as a
            # cold start. If everything is busy, temporarily exceed max_warm.
            lru = min((fn for fn in self.warm_fns
                       if not self._running_by_fn.get(fn)),
                      key=self.warm_fns.get, default=None)
            if lru is not None:
                del self.warm_fns[lru]
        self.warm_fns[req.fn] = self.sim.now
        dur = self.overhead + (self.cold_start if cold else 0.0) + exec_time
        t_end = self.sim.now + dur
        # reprolint: disable=RPL601 -- same-instant finishes (a batch pulled together) commute: each frees one slot and pulls in queue order, so any finish order dispatches the same multiset; exit/kill ties are excluded by the drain epsilon — fuzz-invariant
        ev = self.sim.at(t_end, self._finish, req)
        self.running.add(req.id)
        self._running_reqs[req.id] = (req, ev, t_end, self.sim.now)
        self._running_by_fn[req.fn] = self._running_by_fn.get(req.fn, 0) + 1
        self.controller.note_dispatch(req, self)

    def _note_preempt(self, req: Request, t_start: float, t_end: float):
        """Preemption hand-off seam: a batched serving executor keeps the
        prefix of the decoded stream matching the virtual time this doomed
        invocation got, so the requeued request resumes instead of
        restarting (continuous-batching drain, beyond the paper's
        queued-work-only hand-off)."""
        hook = getattr(self.executor, "note_preempt", None)
        if hook is not None:
            hook(req, self.sim.now - t_start, t_end - t_start)

    def _fn_dec(self, fn: str):
        n = self._running_by_fn.get(fn, 0)
        if n <= 1:
            self._running_by_fn.pop(fn, None)
        else:
            self._running_by_fn[fn] = n - 1

    def _drop(self, rid: int, req: Request):
        """Remove a request from the in-flight tables (event NOT cancelled)."""
        del self._running_reqs[rid]
        self.running.discard(rid)
        self._fn_dec(req.fn)

    def cancel_running(self, rid: int) -> Optional[float]:
        """Abort an in-flight invocation (hedge loser, post-timeout reap).
        Returns the seconds of work thrown away, or None when the request is
        not running here. Frees the slot and pulls new work."""
        entry = self._running_reqs.get(rid)
        if entry is None:
            return None
        req, ev, _, t_start = entry
        self.sim.cancel(ev)
        self._drop(rid, req)
        self.n_wasted += 1
        elapsed = self.sim.now - t_start
        self.kick()
        return elapsed

    def _finish(self, req: Request):
        entry = self._running_reqs.pop(req.id, None)
        self.running.discard(req.id)
        if entry is not None:
            self._fn_dec(req.fn)
        # LRU stamp at completion, not just dispatch: a long call keeps its
        # container warm the whole time it runs, so recency is measured from
        # when the container was last *occupied*, not last handed work.
        if req.fn in self.warm_fns:
            self.warm_fns[req.fn] = self.sim.now
        if req.outcome is None:
            self.n_executed += 1
            self.controller.note_undispatch(req, self, 0.0, "finish")
            self.controller.complete(req, "success")
        else:
            # the request was already decided (timed out while running, or a
            # hedged twin won): the whole execution was wasted work
            self.n_wasted += 1
            dur = (self.sim.now - entry[3]) if entry is not None else 0.0
            self.controller.note_undispatch(req, self, dur, "stale_finish")
        self.kick()

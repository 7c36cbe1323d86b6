"""Slurm-side simulation: priority-tier/preemption semantics for pilot jobs
over the idle-window trace (paper Sec. III-A/D).

The prime workload is exogenous (the trace's idle windows: a node is available
between ``start`` and ``end``; the backfill plan *believes* ``predicted_end``).
Pilot jobs are placed by periodic scheduling passes, mimicking backfill:

  - fib: pick the LONGEST fixed-length queued job that fits the predicted
    remaining window (paper: higher length => higher priority in tier 0).
  - var: flexible job sized to clamp(predicted_remaining, time_min, time_max)
    — Slurm's --time-min/--time mechanism. Its scheduling passes are slower
    (``var`` queue processing cost; Sec. V-B2 explains the 68% vs 84% gap).

When the prime demand returns (window's actual end) a running pilot receives
SIGTERM and has a grace period before SIGKILL (PreemptMode=CANCEL, 3 min).
Coverage accounting clips pilot time at the actual window end: the grace tail
runs on the prime job's time, exactly like the <=3-minute delay the paper
accepts.

Cluster-scale hot paths (50k nodes, 24 h) are kept sub-linear in history:

  - a *vacancy index* (nodes currently idle AND invoker-free) so a scheduling
    pass visits candidates instead of every node that ever opened a window;
  - a length-bucketed job queue (per-length FIFO deques + a sorted length
    index) giving O(log L) picks and O(1) dequeues instead of O(queue) scans
    with ``list.remove``;
  - live-only invoker registries plus monotonic aggregate counters, so gauges
    and health bookkeeping never rescan the day's full job history.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import math
from typing import Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import Controller
from repro_torch.core.events import Simulator
from repro_torch.core.invoker import Invoker
from repro_torch.core.queues import Request
from repro_torch.core.trace import IdleWindow

_JOB_IDS = itertools.count()


@dataclasses.dataclass
class PilotJob:
    length_s: Optional[float]          # fixed length (fib) or None (var)
    time_min_s: float = 120.0
    time_max_s: float = 7200.0
    id: int = dataclasses.field(default_factory=lambda: next(_JOB_IDS))
    state: str = "queued"              # queued | running | done | cancelled


@dataclasses.dataclass
class _NodeState:
    order: int              # first-seen rank; preserves historical pass order
    window: Optional[IdleWindow] = None
    invoker: Optional[Invoker] = None
    job: Optional[PilotJob] = None
    pred_end: float = 0.0   # live backfill-plan estimate (refreshed over time)


class SlurmSim:
    def __init__(self, sim: Simulator, windows: Sequence[IdleWindow],
                 controller: Controller, rng: np.random.Generator, *,
                 sched_interval: float = 15.0, grace: float = 180.0,
                 slot_s: float = 120.0, executor=None,
                 pass_budget: Optional[int] = None, chain_on_exit: bool = True,
                 invoker_kwargs: Optional[dict] = None,
                 invoker_factory: Optional[Callable[..., Invoker]] = None):
        self.sim = sim
        self.controller = controller
        self.rng = rng
        # Event-time draws must not consume the shared stream: which event
        # pops first at a tied timestamp would then decide who gets which
        # draw, and tie_break="shuffle" would change the physics instead of
        # just the tie order. Every event-time draw instead comes from a
        # derived generator keyed to a stable identity (node, virtual time)
        # — see _derived_rng. One draw here seeds the whole derived family.
        self._draw_seed = int(rng.integers(2 ** 31))
        self.sched_interval = sched_interval
        self.grace = grace
        self.slot_s = slot_s
        self.executor = executor
        # pass_budget: max placements per pass — models the var scheduler's
        # inability to process the whole queue before the environment changes
        # (Sec. V-B2). chain_on_exit: fixed-length jobs are packed back-to-back
        # in the backfill plan, so a successor starts as soon as one ends.
        self.pass_budget = pass_budget
        self.chain_on_exit = chain_on_exit
        self.invoker_kwargs = invoker_kwargs or {}
        # worker-construction seam: gang-aware platforms substitute a factory
        # that builds pool-managed members instead of plain invokers; the
        # call signature is exactly the Invoker constructor's
        self.invoker_factory = invoker_factory or Invoker
        self.nodes: Dict[int, _NodeState] = {}
        # vacancy index: node ids whose window is open and invoker-free right
        # now — exactly the candidate set a scheduling pass has to consider
        self._vacant: set = set()
        # queued pilot jobs, length-bucketed. Fixed lengths each get a FIFO
        # deque plus an entry in the sorted ``_length_index`` while non-empty;
        # var (flexible) jobs live in their own deque. Cancellations are lazy
        # (state flip + count decrement); deques shed dead heads on access.
        self._buckets: Dict[float, Deque[PilotJob]] = {}
        self._var_q: Deque[PilotJob] = collections.deque()
        self._counts: Dict[Optional[float], int] = {}
        self._length_index: List[float] = []
        self._queued_ids: set = set()
        self.on_job_started: Optional[Callable[[PilotJob], None]] = None
        # live invokers only; exited ones fold into the aggregates below
        self.live_invokers: Dict[int, Invoker] = {}
        self.n_exited = 0
        self.exited_executed = 0      # sum of n_executed over exited invokers
        self.exited_wasted = 0        # sum of n_wasted over exited invokers
        self.exited_warm_fns = 0      # sum of warm-container sets at exit
        self.exit_log: List[Tuple[int, float, float]] = []  # (node, t_created, t_dead)
        # accounting
        self.idle_time_total = sum(w.length for w in windows)
        # per-invoker covered spans; summed exactly (fsum) so coverage does
        # not depend on the order same-instant exits happened to book them
        self._pilot_spans: List[float] = []
        self.n_started = 0
        self.n_evicted = 0
        # rolling view of recently *closed* windows — the demand-adaptive
        # supply manager reads this to match its length mix to the cluster
        self.recent_window_lengths: collections.deque = collections.deque(maxlen=64)
        self._last_expedite = -1e9
        self._horizon = max((w.end for w in windows), default=0.0)
        # The trace is exogenous and fully known: feed its open/close events
        # into the heap lazily (one sentinel at a time over a pre-sorted
        # stream) instead of parking 2xW events there for the whole day —
        # the heap stays proportional to in-flight work. Tie order matches
        # scheduling everything upfront: window events always fired first at
        # equal times (globally smallest seqs), which at_front preserves, and
        # the stream is sorted by (time, original scheduling order).
        stream = []
        for i, w in enumerate(windows):
            stream.append((w.start, 2 * i, self._window_open, w))
            stream.append((w.end, 2 * i + 1, self._window_close, w))
        stream.sort(key=lambda e: (e[0], e[1]))
        self._window_stream = stream
        self._ws_idx = 0
        if stream:
            self.sim.at_front(stream[0][0], self._feed_window_events_due)
        # reprolint: disable=RPL601 -- pass-vs-replenish/tick order only permutes which 15s pass places a queued pilot; placements touch warming (unregistered) invokers, so nothing request-visible changes — aggregates fuzz-invariant (test_tie_order.py)
        self.sim.at(0.0, self._sched_pass)

    def _derived_rng(self, tag: int, node: int) -> np.random.Generator:
        """Generator keyed to (stream tag, node, current virtual ms): two
        same-time events can swap order without reassigning draws, because
        the key depends on WHO draws and WHEN — never on pop order."""
        return np.random.default_rng(
            (self._draw_seed, tag, node, int(round(self.sim.now * 1000))))

    def _feed_window_events_due(self):
        """Fire every window event due now, then arm one sentinel for the
        next batch (only one sentinel is ever alive, so at_front's
        latest-first tie rule between sentinels never applies)."""
        stream, n = self._window_stream, len(self._window_stream)
        i = self._ws_idx
        while i < n and stream[i][0] <= self.sim.now:
            _, _, fn, w = stream[i]
            i += 1
            self._ws_idx = i
            fn(w)
        if i < n:
            self.sim.at_front(stream[i][0], self._feed_window_events_due)

    # --- trace events ---------------------------------------------------------
    def _window_open(self, w: IdleWindow):
        st = self.nodes.get(w.node)
        if st is None:
            st = self.nodes[w.node] = _NodeState(order=len(self.nodes))
        st.window = w
        st.pred_end = w.predicted_end
        if st.invoker is None:
            self._vacant.add(w.node)

    def _window_close(self, w: IdleWindow):
        st = self.nodes.get(w.node)
        if st is None or st.window is not w:
            return
        if st.invoker is not None and st.invoker.state != "dead":
            inv = st.invoker
            self.n_evicted += 1
            inv.sigterm("evict")
            # reprolint: disable=RPL601 -- fires grace seconds after a fractional trace time; the drain _exit is capped at the same instant and both paths converge on the guarded _exit (dead-state check), so tied order commutes — fuzz-invariant
            self.sim.after(self.grace, self._force_kill, inv)
        self.recent_window_lengths.append(w.length)
        st.window = None
        self._vacant.discard(w.node)

    def _force_kill(self, inv: Invoker):
        if inv.state != "dead":
            inv.sigkill()

    # --- scheduling pass ----------------------------------------------------------
    def _sched_pass(self):
        self._do_pass()
        if self.sim.now < self._horizon + 3600:
            self.sim.after(self.sched_interval, self._sched_pass)

    def _do_pass(self):
        placed = 0
        # visit vacant nodes in first-seen order — the iteration order of the
        # historical every-node scan, so seeded runs stay bit-identical
        for node in sorted(self._vacant, key=lambda n: self.nodes[n].order):
            if self.pass_budget is not None and placed >= self.pass_budget:
                break
            if self._try_place(node, self.nodes[node]):
                placed += 1
        return placed

    def _try_place(self, node: int, st: "_NodeState") -> bool:
        if st.window is None or st.invoker is not None:
            return False
        remaining_pred = st.pred_end - self.sim.now
        if remaining_pred < self.slot_s:
            # Backfill-plan refresh: the original estimate expired but the node
            # is STILL idle — Slurm's plan now carries a new predicted start
            # for the next prime job. Re-estimate with a fresh slack draw.
            actual_remaining = st.window.end - self.sim.now
            if actual_remaining < self.slot_s:
                return False
            # refreshed estimates are near-term and conservative (the plan now
            # has a concrete next prime job): slack capped at 1.1
            slack_rng = self._derived_rng(1, node)
            slack = float(np.exp(slack_rng.uniform(np.log(0.6), np.log(1.1))))
            st.pred_end = self.sim.now + actual_remaining * slack
            remaining_pred = st.pred_end - self.sim.now
            if remaining_pred < self.slot_s:
                return False
        job = self._pick_job(remaining_pred)
        if job is None:
            return False
        self._start_job(node, st, job, remaining_pred)
        return True

    # --- job queue (length buckets) -------------------------------------------
    def _bucket_head(self, ell: float) -> PilotJob:
        q = self._buckets[ell]
        while q[0].state != "queued":    # shed lazily-cancelled heads
            q.popleft()
        return q[0]

    def _count_inc(self, key: Optional[float]):
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        if n == 0 and key is not None:
            bisect.insort(self._length_index, key)

    def _count_dec(self, key: Optional[float]):
        n = self._counts[key] - 1
        if n:
            self._counts[key] = n
        else:
            del self._counts[key]
            if key is not None:
                self._length_index.pop(
                    bisect.bisect_left(self._length_index, key))

    def _pick_job(self, remaining_pred: float) -> Optional[PilotJob]:
        """Longest fixed-length job that fits the predicted window, FIFO
        within a length; a flexible (var) job only when no fixed one fits —
        the priority order of the historical whole-queue scan."""
        i = bisect.bisect_right(self._length_index, remaining_pred)
        if i:
            return self._bucket_head(self._length_index[i - 1])
        if self._counts.get(None, 0):
            for job in self._var_q:
                if job.state == "queued" and job.time_min_s <= remaining_pred:
                    return job
        return None

    def _take_job(self, job: PilotJob):
        self._queued_ids.discard(job.id)
        self._count_dec(job.length_s)
        if job.length_s is None:
            while self._var_q and self._var_q[0].state != "queued":
                self._var_q.popleft()
            if self._var_q and self._var_q[0] is job:
                self._var_q.popleft()
            else:                       # mid-queue var pick (rare)
                self._var_q.remove(job)
        else:
            q = self._buckets[job.length_s]
            assert q[0] is job          # picks always take the bucket head
            q.popleft()

    def iter_queued(self, length_s: Optional[float]) -> Iterator[PilotJob]:
        """Still-queued jobs of one length bucket in FIFO order."""
        q = self._var_q if length_s is None else self._buckets.get(length_s, ())
        for job in q:
            if job.state == "queued":
                yield job

    def _start_job(self, node: int, st: _NodeState, job: PilotJob,
                   remaining_pred: float):
        self._take_job(job)
        job.state = "running"
        if job.length_s is not None:
            duration = job.length_s
        else:
            # Slurm sizes the flexible job into the predicted window, snapped
            # down to the 2-minute slot grid
            duration = min(job.time_max_s, remaining_pred)
            duration = max(job.time_min_s, duration // self.slot_s * self.slot_s)
        # per-invoker rng keyed to (node, spawn time): its warmup and drain
        # draws are a function of the invoker's identity, never of how many
        # draws other components made first (one invoker per node at a time,
        # and an invoker lives > 0 s, so the key is unique)
        inv = self.invoker_factory(
            self.sim, self.controller, node=node,
            sched_end=self.sim.now + duration, rng=self._derived_rng(0, node),
            executor=self.executor, on_exit=self._on_invoker_exit,
            grace=self.grace, **self.invoker_kwargs)
        st.invoker = inv
        st.job = job
        inv._slurm_node = node          # backref for exit handling
        inv._slurm_start = self.sim.now
        inv._slurm_window = st.window   # the window this invoker was placed in
        self.live_invokers[inv.id] = inv
        self._vacant.discard(node)
        self.n_started += 1
        if self.on_job_started:
            self.on_job_started(job)

    def _on_invoker_exit(self, inv: Invoker):
        self.live_invokers.pop(inv.id, None)
        self.n_exited += 1
        self.exited_executed += inv.n_executed
        self.exited_wasted += inv.n_wasted
        # warm sets on idle invokers are not "warm"; wasted executions still
        # occupied containers, so they count toward having run work
        if inv.n_executed or inv.n_wasted:
            self.exited_warm_fns += len(inv.warm_fns)
        self.exit_log.append((inv.node, inv.t_created, self.sim.now))
        node = getattr(inv, "_slurm_node", None)
        st = self.nodes.get(node)
        if st is not None and st.invoker is inv:
            st.invoker = None
            if st.job is not None:
                st.job.state = "done"
                st.job = None
            if st.window is not None:
                self._vacant.add(node)
        # coverage accounting: clip pilot time at the actual end of the window
        # the invoker was PLACED in — st.window may already belong to a newer
        # window that opened on the node before this invoker finished exiting.
        w = getattr(inv, "_slurm_window", None)
        w_end = w.end if w is not None else inv.sched_end
        end_counted = min(self.sim.now, w_end)
        self._pilot_spans.append(max(0.0, end_counted - inv._slurm_start))
        # backfill plans chain fixed-length jobs back-to-back on the node
        if self.chain_on_exit and st is not None and st.window is not None:
            self._try_place(node, st)

    # --- metrics ------------------------------------------------------------------
    def submit_jobs(self, jobs: Sequence[PilotJob], expedite: bool = False):
        """Queue pilot jobs. With ``expedite``, run a quick scheduling pass
        right away (Slurm triggers its quick scheduler on job submission;
        rate-limited to once per second like sched_min_interval)."""
        for job in jobs:
            if job.length_s is None:
                self._var_q.append(job)
            else:
                self._buckets.setdefault(
                    job.length_s, collections.deque()).append(job)
            self._queued_ids.add(job.id)
            self._count_inc(job.length_s)
        if expedite and self.sim.now - self._last_expedite >= 1.0:
            self._last_expedite = self.sim.now
            # reprolint: disable=RPL601 -- same-instant expedited pass vs the periodic one: both drain the same queue through the same bucket-head picks, so running in either order places the identical job set — fuzz-invariant
            self.sim.after(0.0, self._do_pass)

    def cancel_queued(self, jobs: Sequence[PilotJob]) -> int:
        """scancel still-queued pilot jobs (supply scale-down)."""
        n = 0
        for j in jobs:
            if j.id in self._queued_ids:
                self._queued_ids.discard(j.id)
                self._count_dec(j.length_s)
                j.state = "cancelled"   # physically dropped when it surfaces
                n += 1
        return n

    def queued_counts(self) -> Dict[Optional[float], int]:
        return dict(self._counts)

    def total_executed(self) -> int:
        """Useful executions across the whole day (exited + live invokers)."""
        return self.exited_executed + sum(
            inv.n_executed for inv in self.live_invokers.values())

    def total_wasted(self) -> int:
        """Wasted executions across the whole day: completions of
        already-decided requests plus work killed mid-flight."""
        return self.exited_wasted + sum(
            inv.n_wasted for inv in self.live_invokers.values())

    def total_warm_fns(self) -> int:
        """Warm-container sets summed over exited + live invokers (counting,
        like the exited-side aggregate, only invokers that executed work —
        useful or wasted)."""
        return self.exited_warm_fns + sum(
            len(inv.warm_fns) for inv in self.live_invokers.values()
            if inv.n_executed or inv.n_wasted)

    @property
    def pilot_time(self) -> float:
        """Booked pilot coverage seconds. ``fsum`` makes the total exact,
        hence independent of exit-booking order (tie reshuffles permute the
        span list; a naive running += would drift in the last ulp)."""
        return math.fsum(self._pilot_spans)

    def coverage(self) -> float:
        """Share of idle surface covered by running pilot jobs (Slurm-level)."""
        def _live_spans():
            for inv in self.live_invokers.values():
                w = getattr(inv, "_slurm_window", None)
                w_end = w.end if w is not None else self.sim.now
                end_counted = min(self.sim.now, w_end)
                yield max(0.0, end_counted - inv._slurm_start)
        live = math.fsum(_live_spans())
        return (self.pilot_time + live) / max(self.idle_time_total, 1e-9)

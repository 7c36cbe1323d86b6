"""Deterministic discrete-event simulation engine (virtual time).

All of the paper's mechanisms (Slurm backfill passes, SIGTERM grace windows,
OpenWhisk pull loops, Kafka hand-offs) are modelled as events on one global
virtual clock, so a 24-hour production day replays in seconds and every
experiment is exactly reproducible from its seed.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
import random
from typing import Callable, List, Optional, Tuple


class Event:
    __slots__ = ("time", "seq", "fn", "args", "cancelled")

    def __init__(self, time: float, seq: int, fn: Callable, args: tuple):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self):
        self.cancelled = True

    def __lt__(self, other):  # heapq ordering: time, then insertion order
        if self.time != other.time:
            return self.time < other.time
        return self.seq < other.seq


class Simulator:
    """``tie_break`` decides how same-time, same-class events order:

    * ``"fifo"`` (default, the published configuration): insertion order —
      integer seqs, bit-for-bit the historical behaviour.
    * ``"shuffle"``: a seeded permutation — each event draws its seq from
      ``random.Random(tie_seed)``, so equal-time pops come out in random
      order. The ``at_front`` class is preserved (front events still fire
      before every normal event at the same time), and a monotone counter
      tie-breaks the measure-zero draw collision, keeping the heap a total
      order. The tie-order fuzz harness sweeps ``tie_seed`` to prove the
      published aggregates don't depend on insertion accidents.
    """

    def __init__(self, tie_break: str = "fifo", tie_seed: int = 0):
        if tie_break not in ("fifo", "shuffle"):
            raise ValueError(f"unknown tie_break: {tie_break!r}")
        self.now: float = 0.0
        self.tie_break = tie_break
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self._front_seq = itertools.count(start=-1, step=-1)
        self._tie_rng = (random.Random(tie_seed)
                         if tie_break == "shuffle" else None)
        self._tie_count = itertools.count()
        self.n_processed = 0      # lifetime count of executed events
        self._n_cancelled = 0     # cancelled events still sitting in the heap

    def _next_seq(self, front: bool):
        """Seq in the event's tie class. fifo: ints (front negative).
        shuffle: ``(draw, k)`` tuples with normal draws in [0, 1) and front
        draws in [-2, -1) — the classes stay disjoint and compare exactly
        like the integer seqs do."""
        if self._tie_rng is None:
            return next(self._front_seq) if front else next(self._seq)
        r = self._tie_rng.random()
        return (r - 2.0 if front else r, next(self._tie_count))

    def at(self, time: float, fn: Callable, *args) -> Event:
        if time < self.now - 1e-9:
            raise ValueError(f"event in the past: {time} < {self.now}")
        ev = Event(max(time, self.now), self._next_seq(False), fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def at_front(self, time: float, fn: Callable, *args) -> Event:
        """Schedule an event that, at equal times, fires BEFORE every normally
        scheduled event (negative seq). Lets a component feed a pre-sorted
        exogenous stream (e.g. trace windows) into the heap one event at a
        time while keeping the tie order of scheduling them all upfront."""
        if time < self.now - 1e-9:
            raise ValueError(f"event in the past: {time} < {self.now}")
        ev = Event(max(time, self.now), self._next_seq(True), fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, delay: float, fn: Callable, *args) -> Event:
        return self.at(self.now + delay, fn, *args)

    def cancel(self, ev: Event):
        """Cancel an event and keep the heap proportional to live work: once
        most of the heap is dead weight, rebuild it without the cancelled
        entries. (time, seq) is a total order, so the rebuild cannot change
        the pop sequence of the surviving events."""
        if ev.cancelled:
            return
        ev.cancel()
        self._n_cancelled += 1
        if self._n_cancelled > 64 and self._n_cancelled * 2 > len(self._heap):
            self._heap = [e for e in self._heap if not e.cancelled]
            heapq.heapify(self._heap)
            self._n_cancelled = 0

    def run_until(self, t_end: float, max_events: Optional[int] = None) -> int:
        """Process events with time <= t_end. Returns #events processed."""
        n = 0
        while self._heap and self._heap[0].time <= t_end:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                self._n_cancelled = max(0, self._n_cancelled - 1)
                continue
            self.now = ev.time
            # mark executed before running: a late cancel() of an event that
            # already fired (e.g. a timeout callback reaching its own handle)
            # must not count toward the heap's dead weight
            ev.cancelled = True
            ev.fn(*ev.args)
            n += 1
            if max_events is not None and n >= max_events:
                break
        self.now = max(self.now, t_end)
        self.n_processed += n
        return n

    def peek(self) -> Optional[float]:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
            self._n_cancelled = max(0, self._n_cancelled - 1)
        return self._heap[0].time if self._heap else None


class IntervalRecorder:
    """Records (start, end, tag) intervals and integrates tagged durations."""

    def __init__(self):
        self.intervals: List[Tuple[float, float, str]] = []

    def add(self, start: float, end: float, tag: str):
        if end > start:
            self.intervals.append((start, end, tag))

    def total(self, tag: str) -> float:
        return sum(e - s for s, e, t in self.intervals if t == tag)

    def timeline(self, t0: float, t1: float, step: float, tag: str) -> List[int]:
        """Count of intervals with the tag active at each sample point.

        Active at ``t`` means ``start <= t < end``; with starts and ends each
        sorted independently that count is ``#{start <= t} - #{end <= t}``,
        so the whole timeline is O((n + samples) log n) instead of
        O(samples * n)."""
        starts = sorted(s for s, e, t in self.intervals if t == tag)
        ends = sorted(e for s, e, t in self.intervals if t == tag)
        out = []
        # sample points derived from an integer index: repeated `t += step`
        # accumulates rounding error and drifts off the k*step lattice
        for k in range(int((t1 - t0) / step + 1e-9) + 1):
            t = t0 + k * step
            if t > t1:
                break
            out.append(bisect.bisect_right(starts, t)
                       - bisect.bisect_right(ends, t))
        return out

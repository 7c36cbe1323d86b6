"""Kafka-topic stand-ins with identical semantics: per-invoker FIFO topics plus
the global *fast lane* topic that every healthy invoker drains first
(paper Sec. III-C)."""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Optional

_REQ_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    fn: str
    exec_time: float
    arrival: float
    timeout: float = 60.0
    interruptible: bool = True
    tenant: str = "default"
    slo_class: str = "best_effort"  # key into the SLO policy table
    id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))
    attempts: int = 0
    via_fast_lane: bool = False
    # success | timeout | failed (died during execution) | 503 |
    # lost (reliability layer exhausted retries without a placement)
    outcome: Optional[str] = None
    reject_reason: str = ""         # on 503: no_invoker | throttled:* | ...
    t_invoked: Optional[float] = None
    t_completed: Optional[float] = None
    # live handle on the controller's pending _check_timeout event, cancelled
    # when the request reaches a terminal outcome (heap hygiene)
    timeout_ev: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def response_time(self) -> Optional[float]:
        if self.t_completed is None:
            return None
        return self.t_completed - self.arrival


class Topic:
    """FIFO queue standing in for a Kafka topic.

    Requests that reached a terminal outcome while still queued (e.g. timed
    out waiting) are dropped lazily: consumers skip them on ``pop``, and
    ``push`` sheds any dead head, so an unconsumed topic cannot accumulate an
    unbounded tail of already-decided requests during an outage."""

    def __init__(self, name: str):
        self.name = name
        self._q: Deque[Request] = collections.deque()

    def push(self, req: Request):
        self._q.append(req)
        q = self._q
        while q and q[0].outcome is not None:
            q.popleft()

    def push_front(self, req: Request):
        self._q.appendleft(req)

    def pop(self) -> Optional[Request]:
        q = self._q
        while q:
            req = q.popleft()
            if req.outcome is None:
                return req
        return None

    def drain_into(self, other: "Topic") -> int:
        """Move every live message to another topic (SIGTERM hand-off); FIFO
        order is preserved, terminal messages are dropped. Returns the number
        of messages moved."""
        n = 0
        while self._q:
            req = self._q.popleft()
            if req.outcome is None:
                other.push(req)
                n += 1
        return n

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)

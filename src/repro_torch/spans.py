"""Program spans: where the port's host time goes, recorded without a
profiler.

``span(name, id=None)`` is a context manager; when it closes it appends one
record to a bounded in-memory ring: its name, start and end, the sequence
number of the enclosing span (its cause), ``id`` and the counts that
``count(**n)`` added while it was the innermost open span. The ring holds
the last :data:`CAPACITY` records; ``records()`` reads it without clearing,
``clear()`` empties it, ``dropped()`` says how many records it pushed out.
It always records: a span costs a few microseconds of host time.

Stamps are ``time.perf_counter_ns()``, so a reader that times a stretch on
``time.perf_counter`` selects spans by it. ``profiler_ns`` maps a stamp onto
the clock of ``torch.profiler``'s events (``trace_start_ns() +
time_range.start * 1000``, the host's real-time clock) through one pair of
readings taken at import. No span is a profiler event: a
``record_function`` range would also show on the device's timeline.

Spans nest by the order they open and close, so they are opened from one
thread (the engines' loop).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, NamedTuple, Optional

CAPACITY = 65536

_clock = time.perf_counter_ns


class Record(NamedTuple):
    seq: int                     # this span's number, in the order spans open
    name: str
    start: int                   # perf_counter_ns
    end: int
    parent: Optional[int]        # seq of the enclosing span, None at the top
    id: object
    counts: Optional[Dict[str, int]]


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_open: List["_Span"] = []
_seq = 0
_dropped = 0


class _Span:
    __slots__ = ("name", "id", "seq", "parent", "start", "counts")

    def __init__(self, name: str, id: object):
        self.name = name
        self.id = id
        self.counts: Optional[Dict[str, int]] = None

    def __enter__(self) -> "_Span":
        global _seq
        self.seq = _seq
        _seq += 1
        self.parent = _open[-1].seq if _open else None
        _open.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        end = _clock()
        _open.pop()
        if len(_ring) == CAPACITY:
            _dropped += 1
        _ring.append((self.seq, self.name, self.start, end, self.parent, self.id, self.counts))
        return False


def span(name: str, id: object = None) -> _Span:
    """A span named ``name`` (``id``: the request or step it is about)."""
    return _Span(name, id)


def count(**n: int) -> None:
    """Add ``n`` to the innermost open span's counts (nothing outside one)."""
    if not _open:
        return
    top = _open[-1]
    c = top.counts
    if c is None:
        top.counts = n   # a dict of this call's own
        return
    for k, v in n.items():
        c[k] = c.get(k, 0) + v


def records() -> List[Record]:
    """The ring's records, oldest first (in the order the spans closed)."""
    return [Record._make(r) for r in _ring]


def clear() -> None:
    global _dropped
    _ring.clear()
    _dropped = 0


def dropped() -> int:
    """Records pushed out of the full ring since the last ``clear()``."""
    return _dropped


def _anchor():
    a = _clock()
    wall = time.time_ns()
    b = _clock()
    return (a + b) // 2, wall


_ANCHOR = _anchor()


def profiler_ns(t: int) -> int:
    """The stamp ``t`` on the profiler's clock, in ns."""
    return t - _ANCHOR[0] + _ANCHOR[1]

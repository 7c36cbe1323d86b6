"""Statistics over one run's requests.

A tail is over every request sent in the window: one still open when the
window closes counts with its age at that moment, so a stall cannot hide in
the tails. Quantiles are the inclusive ones of ``statistics.quantiles``
(linear between order statistics), over all the values and never a median
of chunks.
"""
from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Sequence


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q < 1, on a percent grid) of ``values``;
    None for no value, the value itself for one."""
    vals = list(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    pct = round(q * 100)
    if not 0 < pct < 100 or abs(q * 100 - pct) > 1e-9:
        raise ValueError(f"quantile {q} is not on the percent grid")
    return statistics.quantiles(vals, n=100, method="inclusive")[pct - 1]


def latencies(sends: Iterable[float], ends: Iterable[Optional[float]], stop: float) -> List[float]:
    """Each request's send -> end, or send -> ``stop`` (its age when the
    window closed) for one that has not ended (``None``)."""
    return [(stop if e is None else e) - s for s, e in zip(sends, ends)]

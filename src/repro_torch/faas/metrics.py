"""Prometheus-style metrics registry sampled on the sim clock.

Counters, gauges, and histograms are keyed ``name{label=value,...}`` exactly
like the Prometheus exposition format the paper scraped for Fig. 1/5. The
registry replaces the ad-hoc ``worker_samples`` lists: components publish into
it, and a :class:`TimeSampler` snapshots gauge values on a fixed virtual-time
grid so time series fall out for free.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Dict[str, str]) -> Tuple[str, LabelKey]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        self.value += v


class Gauge:
    """A point-in-time value; ``fn`` makes it a callback gauge (collected on
    read, like a Prometheus collector)."""
    __slots__ = ("value", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self.value = 0.0
        self.fn = fn

    def set(self, v: float):
        self.value = float(v)

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class Histogram:
    """Stores raw observations (sim scale makes that cheap) so any quantile
    can be derived exactly — no bucket-boundary error."""
    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float):
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(np.sum(self.values)) if self.values else 0.0

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        return float(np.percentile(self.values, q * 100.0))


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels) -> Gauge:
        g = self._gauges.setdefault(_key(name, labels), Gauge(fn))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        return self._histograms.setdefault(_key(name, labels), Histogram())

    # --- scraping ------------------------------------------------------------
    def counters_matching(self, name: str) -> Dict[LabelKey, Counter]:
        return {k[1]: c for k, c in self._counters.items() if k[0] == name}

    def gauges_matching(self, name: str) -> Dict[LabelKey, Gauge]:
        """All label sets of one gauge family (callback gauges included) —
        the gauge-side mirror of :meth:`counters_matching`, e.g. every
        per-gang ``gang_mesh_size``."""
        return {k[1]: g for k, g in self._gauges.items() if k[0] == name}

    def total(self, name: str) -> float:
        """Sum of a counter over all label sets."""
        return sum(c.value for c in self.counters_matching(name).values())

    def collect(self) -> Dict[str, float]:
        """One flat scrape: ``name{k=v,...} -> value`` (exposition-style)."""
        out: Dict[str, float] = {}

        def fmt(name: str, labels: LabelKey) -> str:
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

        for (name, labels), c in self._counters.items():
            out[fmt(name, labels)] = c.value
        for (name, labels), g in self._gauges.items():
            out[fmt(name, labels)] = g.read()
        for (name, labels), h in self._histograms.items():
            out[fmt(name + "_count", labels)] = h.count
            out[fmt(name + "_sum", labels)] = h.sum
        return out


@dataclasses.dataclass
class _Series:
    gauge: Gauge
    samples: List[float] = dataclasses.field(default_factory=list)


class TimeSampler:
    """Scrapes registered gauges every ``interval`` of virtual time — the sim
    equivalent of Prometheus' scrape loop."""

    def __init__(self, sim, interval: float = 10.0,
                 horizon: Optional[float] = None):
        self.sim = sim
        self.interval = interval
        self.horizon = horizon
        self._series: Dict[str, _Series] = {}
        self.times: List[float] = []
        sim.at(sim.now, self._tick)

    def track(self, name: str, gauge: Gauge):
        self._series[name] = _Series(gauge)

    def _tick(self):
        self.times.append(self.sim.now)
        for s in self._series.values():
            s.samples.append(s.gauge.read())
        if self.horizon is None or self.sim.now < self.horizon:
            self.sim.after(self.interval, self._tick)

    def series(self, name: str) -> np.ndarray:
        return np.array(self._series[name].samples)

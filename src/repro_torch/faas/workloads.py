"""Multi-tenant workload suite: named function classes with heterogeneous
execution-time distributions and arrival processes.

The paper drives HPC-Whisk with one homogeneous load (constant 10 QPS of
10 ms functions). Real FaaS traffic is a mix — short interactive calls,
heavy-tailed analytics, diurnal user-facing traffic, on/off burst sources,
and periodic batch spikes (cf. the serverless-workload taxonomies surveyed in
Besozzi et al.). Each :class:`FunctionClass` owns its execution-time
distribution, arrival process, timeout, interruptibility, tenant, and SLO
class; a :class:`WorkloadSuite` merges the classes into one sorted arrival
stream for the harvest runtime.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EXEC_DISTS = ("constant", "lognormal", "bimodal", "pareto")
ARRIVALS = ("constant", "poisson", "diurnal", "onoff", "batch")


@dataclasses.dataclass(frozen=True)
class FunctionClass:
    """One tenant-owned family of functions sharing load characteristics."""
    name: str
    tenant: str = "default"
    slo_class: str = "best_effort"      # key into the SLO policy table
    n_functions: int = 20               # distinct function names in the class
    rate: float = 1.0                   # mean arrivals per second
    arrival: str = "poisson"
    exec_dist: str = "constant"
    exec_mean: float = 0.010            # seconds
    exec_sigma: float = 0.8             # lognormal shape
    bimodal_heavy_share: float = 0.1    # bimodal: share of heavy calls
    bimodal_heavy_factor: float = 50.0  # heavy call = factor * exec_mean
    pareto_alpha: float = 1.8           # heavy tail index (alpha > 1)
    timeout: float = 60.0
    interruptible_share: float = 1.0    # share of calls opting into interruption
    # arrival-process knobs
    diurnal_period: float = 24 * 3600.0
    diurnal_amplitude: float = 0.8      # rate(t) = rate * (1 + A*sin(...))
    on_s: float = 60.0                  # onoff: mean ON duration
    off_s: float = 540.0                # onoff: mean OFF duration
    on_factor: float = 10.0             # rate multiplier while ON
    batch_every: float = 900.0          # batch: spike period
    batch_size: int = 200               # requests per spike

    def __post_init__(self):
        if self.exec_dist not in EXEC_DISTS:
            raise ValueError(f"unknown exec_dist={self.exec_dist!r}; "
                             f"allowed values: {tuple(EXEC_DISTS)}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival={self.arrival!r}; "
                             f"allowed values: {tuple(ARRIVALS)}")

    # --- execution times -----------------------------------------------------
    def sample_exec(self, rng: np.random.Generator) -> float:
        m = self.exec_mean
        if self.exec_dist == "constant":
            return m
        if self.exec_dist == "lognormal":
            # parameterised by the mean, not the median
            mu = math.log(m) - self.exec_sigma ** 2 / 2
            return float(rng.lognormal(mu, self.exec_sigma))
        if self.exec_dist == "bimodal":
            if rng.random() < self.bimodal_heavy_share:
                return m * self.bimodal_heavy_factor
            return m
        # pareto: mean = x_min * alpha / (alpha - 1)
        a = self.pareto_alpha
        x_min = m * (a - 1) / a
        return float(x_min * (1.0 + rng.pareto(a)))

    # --- arrival processes ---------------------------------------------------
    def arrival_times(self, rng: np.random.Generator,
                      duration: float) -> np.ndarray:
        if self.rate <= 0:
            return np.array([])
        if self.arrival == "constant":
            n = int(duration * self.rate)
            times = (np.arange(n) + 1) / self.rate
            return times[times < duration]
        if self.arrival == "poisson":
            return self._poisson(rng, duration, lambda t: self.rate)
        if self.arrival == "diurnal":
            a, p = self.diurnal_amplitude, self.diurnal_period
            return self._poisson(
                rng, duration,
                lambda t: self.rate * (1.0 + a * math.sin(2 * math.pi * t / p)),
                lam_max=self.rate * (1.0 + a))
        if self.arrival == "onoff":
            return self._onoff(rng, duration)
        return self._batches(duration)

    def _poisson(self, rng, duration, rate_fn, lam_max: Optional[float] = None):
        """Inhomogeneous Poisson by thinning."""
        lam_max = lam_max or self.rate
        out: List[float] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / lam_max))
            if t >= duration:
                break
            if rng.random() < rate_fn(t) / lam_max:
                out.append(t)
        return np.array(out)

    def _onoff(self, rng, duration):
        """Markov-modulated: quiet baseline, exponential ON bursts at
        ``on_factor`` times the base rate (mean overall rate ~= self.rate for
        the defaults; burstiness is the point, not the mean)."""
        out: List[float] = []
        t = 0.0
        while t < duration:
            off = float(rng.exponential(self.off_s))
            on = float(rng.exponential(self.on_s))
            # baseline trickle during OFF
            seg = self._seg_poisson(rng, t, min(t + off, duration),
                                    self.rate * 0.1)
            out.extend(seg)
            t += off
            if t >= duration:
                break
            seg = self._seg_poisson(rng, t, min(t + on, duration),
                                    self.rate * self.on_factor)
            out.extend(seg)
            t += on
        return np.array(sorted(out))

    @staticmethod
    def _seg_poisson(rng, t0: float, t1: float, lam: float) -> List[float]:
        out = []
        t = t0
        while lam > 0:
            t += float(rng.exponential(1.0 / lam))
            if t >= t1:
                break
            out.append(t)
        return out

    def _batches(self, duration):
        out: List[float] = []
        # spike times from an integer index: repeated `t += batch_every`
        # accumulates rounding error and drifts off the k*period lattice
        for k in range(1, int(duration / self.batch_every + 1e-9) + 1):
            t = k * self.batch_every
            if t >= duration:
                break
            # spread each spike over one second (client fan-out jitter);
            # clamp the jittered tail to the horizon
            out.extend(ti for i in range(self.batch_size)
                       if (ti := t + i / max(self.batch_size, 1)) < duration)
        return np.array(out)

    def fn_name(self, i: int) -> str:
        return f"{self.tenant}/{self.name}-{i % self.n_functions:03d}"


@dataclasses.dataclass
class WorkloadSuite:
    """A set of function classes generating one merged arrival stream."""
    classes: List[FunctionClass]

    def by_name(self) -> Dict[str, FunctionClass]:
        return {c.name: c for c in self.classes}

    def events(self, rng: np.random.Generator,
               duration: float) -> List[Tuple[float, FunctionClass, str]]:
        """Merged, time-sorted ``(t, cls, fn_name)`` arrivals."""
        out: List[Tuple[float, FunctionClass, str]] = []
        for cls in self.classes:
            times = cls.arrival_times(rng, duration)
            for i, t in enumerate(times):
                out.append((float(t), cls, cls.fn_name(i)))
        out.sort(key=lambda e: e[0])
        return out

    def total_rate(self) -> float:
        return sum(c.rate for c in self.classes)


def default_suite(scale: float = 1.0) -> WorkloadSuite:
    """Steady multi-tenant mix: interactive latency-class traffic, diurnal
    user-facing load, heavy-tailed best-effort analytics, and periodic batch."""
    return WorkloadSuite(classes=[
        FunctionClass(name="api", tenant="web", slo_class="latency",
                      rate=4.0 * scale, arrival="constant",
                      exec_dist="constant", exec_mean=0.010, timeout=30.0),
        FunctionClass(name="render", tenant="web", slo_class="latency",
                      rate=2.0 * scale, arrival="diurnal",
                      exec_dist="lognormal", exec_mean=0.050, exec_sigma=0.6,
                      timeout=30.0),
        FunctionClass(name="etl", tenant="data", slo_class="best_effort",
                      rate=2.0 * scale, arrival="poisson",
                      exec_dist="pareto", exec_mean=0.5, pareto_alpha=1.7,
                      timeout=120.0),
        FunctionClass(name="nightly", tenant="data", slo_class="batch",
                      rate=0.25 * scale, arrival="batch", batch_every=1200.0,
                      batch_size=240, exec_dist="bimodal", exec_mean=0.2,
                      bimodal_heavy_share=0.05, bimodal_heavy_factor=20.0,
                      timeout=300.0, interruptible_share=0.8),
    ])


def burst_suite(scale: float = 1.0) -> WorkloadSuite:
    """The steady mix plus an aggressive on/off burst tenant — the stress
    scenario for admission control and demand-adaptive pilot supply."""
    base = default_suite(scale)
    base.classes.append(
        FunctionClass(name="spiky", tenant="iot", slo_class="best_effort",
                      rate=3.0 * scale, arrival="onoff",
                      on_s=45.0, off_s=300.0, on_factor=25.0,
                      exec_dist="lognormal", exec_mean=0.030, exec_sigma=0.5,
                      timeout=60.0))
    return base


def serving_suite(scale: float = 1.0) -> WorkloadSuite:
    """Model-serving mix: a handful of heavy endpoints (sub-second to
    seconds-long decode calls) instead of many tiny functions. Execution
    time, not cold starts, dominates — the regime where *placement* decides
    tail latency (head-of-line blocking on an invoker whose accelerator-bound
    concurrency is small), stressing the Router seam rather than the warm
    container cache."""
    return WorkloadSuite(classes=[
        FunctionClass(name="chat", tenant="ml", slo_class="latency",
                      n_functions=6, rate=3.0 * scale, arrival="poisson",
                      exec_dist="lognormal", exec_mean=0.8, exec_sigma=0.6,
                      timeout=60.0),
        FunctionClass(name="embed", tenant="ml", slo_class="best_effort",
                      n_functions=4, rate=2.0 * scale, arrival="onoff",
                      on_s=45.0, off_s=300.0, on_factor=12.0,
                      exec_dist="lognormal", exec_mean=0.4, exec_sigma=0.5,
                      timeout=60.0),
    ])
